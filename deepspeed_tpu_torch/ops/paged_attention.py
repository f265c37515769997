"""Paged (blocked-KV) attention: the port of
``deepspeed_tpu/ops/pallas/paged_attention.py``.

Two public functions with the JAX package's shapes and layouts:

* :func:`paged_attention` — SplitFuse packed attention over ONE layer's
  ``[N, Hk, bs, D]`` pool (JAX ``paged_attention``, Pallas ``_kernel``);
* :func:`paged_flash_decode` — one query per sequence over the RESIDENT
  ``[L, N, Hk, bs, D]`` pool, the layer resolved by the kernel (JAX
  ``paged_flash_decode``, Pallas ``_decode_kernel``).

Each has a plain PyTorch version beside it (``*_ref``: gathered pages, fp32
einsums) that computes the same function. The wrapper dispatches on where
the query lies: a CPU tensor takes the plain version; a CUDA tensor launches
the hand-written Hopper kernel (``csrc/paged_attention.cu``) or raises —
there is no fallback. ``launch_counts`` counts kernel launches, one per
launch and nowhere else, so a run can show that it went through the kernels.

Semantics (both, as in the TPU kernels): query ``i`` of sequence ``s`` sits
at absolute position ``start_pos[s] + i`` (decode: ``pos[s]``) and attends
to slots ``j <= position`` with ``j < kv_len[s]``; masked slots contribute
an exact 0; a row with no live slot returns ``o = 0, m = -1e30, l = 0``;
logits are fp32 dots times the explicit ``sm_scale``; P is rounded to V's
dtype before the fp32-accumulated PV product.
"""

import ctypes
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30

#: kernel launches per wrapper (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"paged_attention": 0,
                                 "paged_flash_decode": 0}

_SOURCE = "paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)     # instantiated in csrc/paged_attention.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                            ctypes.c_float, _I, _P],
    "paged_flash_decode_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_float, _I, _P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernel(name: str):
    from . import _build

    fn = getattr(_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _validate_cuda(q, k_pool, v_pool, tables, D: int) -> None:
    """What the kernel takes: contiguous CUDA tensors on one device, pools in
    the query's dtype (fp32 or bf16), int32 tables, a supported head dim,
    16-byte aligned rows."""
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), *tables.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, query on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tables.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged kernels take float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("pools must have the query's dtype "
                         f"({k_pool.dtype}/{v_pool.dtype} vs {q.dtype})")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _scale(sm_scale, D) -> float:
    return 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gathered_paged_attention(q, k_pool, v_pool, block_table, pos_q, q_valid,
                             kv_len, *, sm_scale: Optional[float] = None,
                             return_stats: bool = False):
    """Attention over gathered pages with explicit masks: the plain version
    of both kernels, and the JAX package's ``"einsum"`` serving path
    (``inference/v2/model.paged_attention``).

    q: ``[S, Q, Hq, D]``; k/v_pool: ``[N, Hk, bs, D]``; block_table
    ``[S, B]``; pos_q ``[S, Q]`` absolute query positions; q_valid ``[S, Q]``
    bool; kv_len ``[S]``. Gathers every block-table page, computes the
    logits and the PV product as fp32 einsums (exact products of bf16
    inputs, fp32 sums), rounds P to V's dtype first, and masks slot ``j`` of
    query ``(s, i)`` unless ``j <= pos_q`` and ``j < kv_len`` and the query
    is valid. A row with no live slot gets ``o = 0, m = -1e30, l = 0``."""
    S, Q, Hq, D = q.shape
    _, Hk, bs, _ = k_pool.shape
    B = block_table.shape[1]
    G = Hq // Hk
    bt = block_table.long()
    kg = k_pool[bt].permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    vg = v_pool[bt].permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    qq = q.reshape(S, Q, Hk, G, D).permute(0, 2, 3, 1, 4)
    logits = torch.einsum("shgqd,shkd->shgqk", qq.float(),
                          kg.to(q.dtype).float()) * _scale(sm_scale, D)
    slot = torch.arange(B * bs, device=q.device)
    valid = ((slot[None, None] <= pos_q.long()[..., None])
             & q_valid[..., None]
             & (slot[None, None] < kv_len.long()[:, None, None]))   # [S, Q, K]
    valid = valid[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                                         # [S,Hk,G,Q]
    p = torch.where(valid, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    l = p.sum(dim=-1)
    acc = torch.einsum("shgqk,shkd->shgqd", p.to(q.dtype).float(),
                       vg.to(q.dtype).float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe_l[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(S, Q, Hq, D)
    if return_stats:
        stats = lambda a: a.permute(0, 3, 1, 2).reshape(S, Q, Hq)
        return out, stats(m), stats(l)
    return out


def paged_attention_ref(q, k_pool, v_pool, block_table, start_pos, chunk_len,
                        kv_len, *, sm_scale: Optional[float] = None,
                        return_stats: bool = False):
    """Plain PyTorch version of :func:`paged_attention`: query ``i`` sits
    at ``start_pos + i`` and is valid iff ``i < chunk_len``."""
    Q = q.shape[1]
    qidx = torch.arange(Q, device=q.device)
    q_valid = qidx[None] < chunk_len.long()[:, None]
    pos_q = start_pos.long()[:, None] + qidx[None]
    return gathered_paged_attention(q, k_pool, v_pool, block_table, pos_q,
                                    q_valid, kv_len, sm_scale=sm_scale,
                                    return_stats=return_stats)


def _resident(k_pool, v_pool, layer: int):
    """Normalize a single-layer ``[N, Hk, bs, D]`` view to the resident
    ``[L, N, Hk, bs, D]`` layout and check ``layer``."""
    if k_pool.dim() == 4:
        if layer != 0:
            raise ValueError("layer != 0 needs the [L, N, Hk, bs, D] pool")
        k_pool, v_pool = k_pool[None], v_pool[None]
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's "
                         f"{k_pool.shape[0]} layers")
    return k_pool, v_pool


def paged_flash_decode_ref(q, k_pool, v_pool, block_table, pos, kv_len, *,
                           layer: int = 0, sm_scale: Optional[float] = None,
                           return_stats: bool = False):
    """Plain PyTorch version of :func:`paged_flash_decode`: the packed plain
    version at one query per sequence over the pool's ``layer``."""
    k_pool, v_pool = _resident(k_pool, v_pool, layer)
    ones = torch.ones_like(kv_len)
    res = paged_attention_ref(q[:, None], k_pool[layer], v_pool[layer],
                              block_table, pos, ones, kv_len,
                              sm_scale=sm_scale, return_stats=return_stats)
    if return_stats:
        out, m, l = res
        return out[:, 0], m[:, 0], l[:, 0]
    return res[:, 0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _shape_checks(Hq, Hk):
    if Hq % Hk:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hk}")


def paged_attention(q, k_pool, v_pool, block_table, start_pos, chunk_len,
                    kv_len, *, sm_scale: Optional[float] = None,
                    return_stats: bool = False):
    """Paged attention over one layer's KV pool.

    Args:
      q: ``[S, Q, Hq, D]`` grouped queries (SplitFuse chunk per sequence;
        query ``i`` of sequence ``s`` has absolute position
        ``start_pos[s] + i`` and is valid iff ``i < chunk_len[s]``).
      k_pool / v_pool: ``[N, Hk, bs, D]`` physical KV pages (head-major).
      block_table: ``[S, B]`` int32 logical→physical page map.
      start_pos / chunk_len / kv_len: ``[S]`` int32.
    Returns ``[S, Q, Hq, D]``; rows of invalid queries are zero. With
    ``return_stats`` also the raw online-softmax ``(m, l)`` per row
    (``[S, Q, Hq]`` fp32).
    """
    S, Q, Hq, D = q.shape
    N, Hk, bs, _ = k_pool.shape
    _shape_checks(Hq, Hk)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, start_pos,
                                   chunk_len, kv_len, sm_scale=sm_scale,
                                   return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    tables = {"block_table": block_table, "start_pos": start_pos,
              "chunk_len": chunk_len, "kv_len": kv_len}
    _validate_cuda(q, k_pool, v_pool, tables, D)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((S, Q, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if S and Q:
        fn = _kernel("paged_attention_fwd")
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), _ptr(m), _ptr(l), block_table.data_ptr(),
                 start_pos.data_ptr(), chunk_len.data_ptr(), kv_len.data_ptr(),
                 S, Q, Hq, Hk, D, bs, block_table.shape[1],
                 k_pool.stride(0), _scale(sm_scale, D), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
        launch_counts["paged_attention"] += 1
        _check_launch("paged_attention", err)
    return (out, m, l) if return_stats else out


def paged_flash_decode(q, k_pool, v_pool, block_table, pos, kv_len, *,
                       layer: int = 0, sm_scale: Optional[float] = None,
                       return_stats: bool = False):
    """Paged flash decode over a resident multi-layer KV pool.

    Args:
      q: ``[S, Hq, D]`` — one decode query per sequence.
      k_pool / v_pool: ``[L, N, Hk, bs, D]`` resident pools (``layer`` is
        resolved by the kernel from the base pointer, so no per-layer slice
        is materialized), or a single-layer ``[N, Hk, bs, D]`` view with
        ``layer == 0``.
      block_table: ``[S, B]`` int32 logical→physical page map.
      pos: ``[S]`` int32 absolute position of each query (slot ``j``
        participates iff ``j <= pos`` and ``j < kv_len``).
      kv_len: ``[S]`` int32 tokens committed to the pool per sequence.
    Returns ``[S, Hq, D]``; with ``return_stats`` also ``(m, l)`` per row
    (``[S, Hq]`` fp32) for two-source merges.
    """
    k_pool, v_pool = _resident(k_pool, v_pool, layer)
    _, _, Hk, bs, D = k_pool.shape
    S, Hq, _ = q.shape
    _shape_checks(Hq, Hk)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, block_table, pos,
                                      kv_len, layer=layer, sm_scale=sm_scale,
                                      return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    tables = {"block_table": block_table, "pos": pos, "kv_len": kv_len}
    _validate_cuda(q, k_pool, v_pool, tables, D)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if S:
        fn = _kernel("paged_flash_decode_fwd")
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), _ptr(m), _ptr(l), block_table.data_ptr(),
                 pos.data_ptr(), kv_len.data_ptr(), S, Hq, Hk, D, bs,
                 block_table.shape[1], layer * k_pool.stride(0),
                 k_pool.stride(1), _scale(sm_scale, D), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
        launch_counts["paged_flash_decode"] += 1
        _check_launch("paged_flash_decode", err)
    return (out, m, l) if return_stats else out
