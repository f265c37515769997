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
the hand-written Hopper kernel (``csrc/paged_attention.cu``, the decode
kernel's int8 mode ``csrc/paged_attention_int8.cu``) or raises —
there is no fallback. ``launch_counts`` counts kernel launches, one per
launch and nowhere else, so a run can show that it went through the kernels.

Quantized pools: the decode kernel also takes int8 pools with fp32 per-row
scales, as ``(values, scales)`` tuples (values ``[L, N, Hk, bs, D]`` int8,
scales ``[L, N, Hk, bs]`` fp32): it dequantizes each K and V row as it reads
it, with the ``ops/quant.py`` row convention rounded to the query's dtype
(``dequant_rows_tile``), and counts its launches as
``paged_flash_decode_int8``. The plain versions dequantize on the gather.
One-byte float pools (``torch.float8_e4m3fn``) are plain storage, gathered
through a ``torch.uint8`` view and cast to the query's dtype; the kernels do
not take them. The packed kernel takes pools in the query's dtype only.

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

from .quant import dequant_rows_tile

NEG_INF = -1e30

#: kernel launches per wrapper (reset by callers that want a window's count);
#: the decode kernel's int8 mode counts under its own name
launch_counts: Dict[str, int] = {"paged_attention": 0,
                                 "paged_flash_decode": 0,
                                 "paged_flash_decode_int8": 0}

# the int8 mode's instantiations build from a source of their own, in
# parallel with the others
_SOURCES = {"paged_attention_fwd": "paged_attention.cu",
            "paged_flash_decode_fwd": "paged_attention.cu",
            "paged_flash_decode_int8_fwd": "paged_attention_int8.cu"}
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
    "paged_flash_decode_int8_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_float, _I, _P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernel(name: str):
    from . import _build

    fn = getattr(_build.load(_SOURCES[name]), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _validate_cuda(q, k_pool, v_pool, tables, D: int, scales=None) -> None:
    """What the kernel takes: contiguous CUDA tensors on one device, pools in
    the query's dtype (fp32 or bf16) — or, with ``scales``, int8 pools with
    fp32 scales of the pool's shape less its last axis — int32 tables, a
    supported head dim, 16-byte aligned rows."""
    dev = q.device
    scale_items = () if scales is None else (("k_scale", scales[0]),
                                             ("v_scale", scales[1]))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), *scale_items,
                    *tables.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, query on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tables.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged kernels take float32 or bfloat16, got {q.dtype}")
    want = q.dtype if scales is None else torch.int8
    if k_pool.dtype != want or v_pool.dtype != want:
        what = "the query's dtype" if scales is None else "int8 (with fp32 scales)"
        raise ValueError(f"pools must have {what}: got {k_pool.dtype}/"
                         f"{v_pool.dtype} for {q.dtype} queries")
    for name, t in scale_items:
        if t.dtype != torch.float32 or t.shape != k_pool.shape[:-1]:
            raise ValueError(f"{name} must be float32 {tuple(k_pool.shape[:-1])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
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


def pool_values(pool) -> torch.Tensor:
    """The values tensor of a pool argument (a tensor or ``(values,
    scales)``)."""
    return pool[0] if isinstance(pool, tuple) else pool


def storage_bits(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float tensor as ``torch.uint8`` (bit-exact), for indexing
    that float8 types lack on some devices; other tensors unchanged."""
    if t.is_floating_point() and t.element_size() == 1:
        return t.view(torch.uint8)
    return t


def gather_pages(pool, block_table, dtype) -> torch.Tensor:
    """Every block-table page of one layer's pool, ``[S, B, Hk, bs, D]`` in
    ``dtype``: ``(int8 values, scales)`` pools dequantize on the gather
    (``dequant_rows_tile``, the kernel's arithmetic), plain pools are cast
    from their storage dtype."""
    bt = block_table.long()
    if isinstance(pool, tuple):
        return dequant_rows_tile(pool[0][bt], pool[1][bt], dtype)
    return storage_bits(pool)[bt].view(pool.dtype).to(dtype)


def attention_over_pages(q, kg, vg, pos_q, q_valid, kv_len, *,
                         sm_scale: Optional[float] = None,
                         return_stats: bool = False):
    """Attention of ``q [S, Q, Hq, D]`` over gathered pages ``kg``/``vg``
    ``[S, B, Hk, bs, D]`` (in q's dtype) with explicit masks; see
    :func:`gathered_paged_attention`."""
    S, Q, Hq, D = q.shape
    _, B, Hk, bs, _ = kg.shape
    G = Hq // Hk
    kg = kg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    vg = vg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    qq = q.reshape(S, Q, Hk, G, D).permute(0, 2, 3, 1, 4)
    logits = torch.einsum("shgqd,shkd->shgqk", qq.float(),
                          kg.float()) * _scale(sm_scale, D)
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
                       vg.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe_l[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(S, Q, Hq, D)
    if return_stats:
        stats = lambda a: a.permute(0, 3, 1, 2).reshape(S, Q, Hq)
        return out, stats(m), stats(l)
    return out


def gathered_paged_attention(q, k_pool, v_pool, block_table, pos_q, q_valid,
                             kv_len, *, sm_scale: Optional[float] = None,
                             return_stats: bool = False):
    """Attention over gathered pages with explicit masks: the plain version
    of both kernels, and the JAX package's ``"einsum"`` serving path
    (``inference/v2/model.paged_attention``).

    q: ``[S, Q, Hq, D]``; k/v_pool: ``[N, Hk, bs, D]`` (or ``(int8 values,
    fp32 scales [N, Hk, bs])``); block_table ``[S, B]``; pos_q ``[S, Q]``
    absolute query positions; q_valid ``[S, Q]`` bool; kv_len ``[S]``.
    Gathers every block-table page in q's dtype (:func:`gather_pages`),
    computes the logits and the PV product as fp32 einsums (exact products
    of bf16 inputs, fp32 sums), rounds P to V's dtype first, and masks slot
    ``j`` of query ``(s, i)`` unless ``j <= pos_q`` and ``j < kv_len`` and
    the query is valid. A row with no live slot gets ``o = 0, m = -1e30,
    l = 0``."""
    return attention_over_pages(
        q, gather_pages(k_pool, block_table, q.dtype),
        gather_pages(v_pool, block_table, q.dtype), pos_q, q_valid, kv_len,
        sm_scale=sm_scale, return_stats=return_stats)


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
    """Normalize a single-layer ``[N, Hk, bs, D]`` view (or ``(values,
    scales)`` tuple of such views) to the resident ``[L, N, Hk, bs, D]``
    layout and check ``layer``."""
    add_layer = lambda p: (tuple(t[None] for t in p) if isinstance(p, tuple)
                           else p[None])
    if pool_values(k_pool).dim() == 4:
        if layer != 0:
            raise ValueError("layer != 0 needs the [L, N, Hk, bs, D] pool")
        k_pool, v_pool = add_layer(k_pool), add_layer(v_pool)
    L = pool_values(k_pool).shape[0]
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    return k_pool, v_pool


def pool_layer(pool, i: int):
    """Layer ``i``'s view of a resident pool argument, in its form."""
    return tuple(t[i] for t in pool) if isinstance(pool, tuple) else pool[i]


def paged_flash_decode_ref(q, k_pool, v_pool, block_table, pos, kv_len, *,
                           layer: int = 0, sm_scale: Optional[float] = None,
                           return_stats: bool = False):
    """Plain PyTorch version of :func:`paged_flash_decode`: the packed plain
    version at one query per sequence over the pool's ``layer``; int8
    ``(values, scales)`` pools are dequantized in the query's dtype
    (``dequant_rows_tile``) first."""
    k_pool, v_pool = _resident(k_pool, v_pool, layer)
    k_pool, v_pool = pool_layer(k_pool, layer), pool_layer(v_pool, layer)
    if isinstance(k_pool, tuple):
        k_pool = dequant_rows_tile(*k_pool, q.dtype)
        v_pool = dequant_rows_tile(*v_pool, q.dtype)
    ones = torch.ones_like(kv_len)
    res = paged_attention_ref(q[:, None], k_pool, v_pool,
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
                    interpret: Optional[bool] = None, return_stats: bool = False):
    """Paged attention over one layer's KV pool. ``interpret`` (the Pallas
    interpreter switch of the JAX function) is accepted and ignored.

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
    if isinstance(k_pool, tuple) or isinstance(v_pool, tuple):
        raise ValueError("the packed paged kernel takes pools in the query's "
                         "dtype; quantized pools run the gathered path")
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
                       interpret: Optional[bool] = None, return_stats: bool = False):
    """Paged flash decode over a resident multi-layer KV pool. ``interpret``
    (the Pallas interpreter switch of the JAX function) is accepted and
    ignored.

    Args:
      q: ``[S, Hq, D]`` — one decode query per sequence.
      k_pool / v_pool: ``[L, N, Hk, bs, D]`` resident pools (``layer`` is
        resolved by the kernel from the base pointer, so no per-layer slice
        is materialized), or a single-layer ``[N, Hk, bs, D]`` view with
        ``layer == 0``; or ``(int8 values, fp32 scales [L, N, Hk, bs])``
        tuples (of either form): the kernel's int8 mode dequantizes each
        row as it reads it.
      block_table: ``[S, B]`` int32 logical→physical page map.
      pos: ``[S]`` int32 absolute position of each query (slot ``j``
        participates iff ``j <= pos`` and ``j < kv_len``).
      kv_len: ``[S]`` int32 tokens committed to the pool per sequence.
    Returns ``[S, Hq, D]``; with ``return_stats`` also ``(m, l)`` per row
    (``[S, Hq]`` fp32) for two-source merges.
    """
    if isinstance(k_pool, tuple) != isinstance(v_pool, tuple):
        raise ValueError("k_pool and v_pool must both be tensors or both "
                         "(values, scales) tuples")
    k_pool, v_pool = _resident(k_pool, v_pool, layer)
    quantized = isinstance(k_pool, tuple)
    kq, vq = pool_values(k_pool), pool_values(v_pool)
    _, _, Hk, bs, D = kq.shape
    S, Hq, _ = q.shape
    _shape_checks(Hq, Hk)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, block_table, pos,
                                      kv_len, layer=layer, sm_scale=sm_scale,
                                      return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    tables = {"block_table": block_table, "pos": pos, "kv_len": kv_len}
    scales = (k_pool[1], v_pool[1]) if quantized else None
    _validate_cuda(q, kq, vq, tables, D, scales)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if S:
        name = "paged_flash_decode_int8" if quantized else "paged_flash_decode"
        head = (q.data_ptr(), kq.data_ptr(), vq.data_ptr())
        if quantized:
            head += (scales[0].data_ptr(), scales[1].data_ptr())
        tail = (out.data_ptr(), _ptr(m), _ptr(l), block_table.data_ptr(),
                pos.data_ptr(), kv_len.data_ptr(), S, Hq, Hk, D, bs,
                block_table.shape[1], layer * kq.stride(0), kq.stride(1))
        if quantized:
            tail += (layer * scales[0].stride(0), scales[0].stride(1))
        err = _kernel(name + "_fwd")(
            *head, *tail, _scale(sm_scale, D), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
        launch_counts[name] += 1
        _check_launch(name, err)
    return (out, m, l) if return_stats else out
