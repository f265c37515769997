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
a hand-written Hopper kernel or raises — there is no fallback.
``launch_counts`` counts kernel launches, one per launch and nowhere else.

Each kernel has two routes, chosen in the open by one rule,
:func:`paged_route`, and counted per kernel and route in ``route_counts``:
``"sm90"`` (``csrc/paged_attention_sm90.cu``, the int8 mode
``csrc/paged_attention_sm90_int8.cu``: pages staged by TMA through the block
table, QK^T and PV on ``wgmma``, decode rows' contexts split across blocks
and merged in split order) for bf16 queries over pages of 16, 32 or 64
slots; ``"cuda_core"`` (``csrc/paged_attention.cu``, the int8 mode
``csrc/paged_attention_int8.cu``: one CUDA-core tile) for fp32 and the
rest. Both routes build head dims 64, 80, 96, 128 and 256 (``_HEAD_DIMS``,
``csrc/paged_head_dims.cuh``) and refuse any other. The launch helpers
(:func:`launch_paged_attention`, :func:`launch_paged_flash_decode`) take
``route=``; a forced ``"sm90"`` on tensors it was not built for raises.
They also take ``split_tiles=``, the sm90 design's measured choice of KV
splits (:func:`split_tiles_for`), so that a script can time both sides of
it. A launch that splits is followed
by a merge launch, counted as ``paged_combine``.

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
import functools
import math
import threading
from typing import Dict, Optional

import torch

from .quant import dequant_rows_tile

NEG_INF = -1e30

#: kernel launches per wrapper (reset by callers that want a window's count);
#: the decode kernel's int8 mode counts under its own name, and so does the
#: second launch that merges the sm90 kernels' KV splits
launch_counts: Dict[str, int] = {"paged_attention": 0,
                                 "paged_flash_decode": 0,
                                 "paged_flash_decode_int8": 0,
                                 "paged_combine": 0}

ROUTES = ("sm90", "cuda_core")
#: launches per kernel and route (see :func:`paged_route`)
route_counts: Dict[str, Dict[str, int]] = {name: {route: 0 for route in ROUTES}
                                           for name in launch_counts}
_COUNTS_LOCK = threading.Lock()

# the int8 mode's instantiations build from sources of their own, in
# parallel with the others
_SOURCES = {"paged_attention_fwd": "paged_attention.cu",
            "paged_flash_decode_fwd": "paged_attention.cu",
            "paged_flash_decode_int8_fwd": "paged_attention_int8.cu",
            "paged_attention_sm90_fwd": "paged_attention_sm90.cu",
            "paged_flash_decode_int8_sm90_fwd": "paged_attention_sm90_int8.cu"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims both routes build: PAGED_HEAD_DIMS of csrc/paged_head_dims.cuh
_HEAD_DIMS = (64, 80, 96, 128, 256)
#: page sizes the sm90 kernels stage (64 / bs pages per 64-slot tile)
SM90_PAGE_SIZES = (16, 32, 64)
#: the sm90 kernels' work items: query rows per item (one warpgroup's wgmma
#: rows) and slots per tile (one ring stage). Each launch passes them with
#: its block count (:func:`sm90_grid`); the kernel refuses tiles that its
#: own decode does not use.
SM90_ROWS = 64
SM90_TILE_SLOTS = 64
_SMS: Dict[torch.device, int] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _LL, _F, _I, _P],
    "paged_flash_decode_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _LL, _LL, _F, _I, _P],
    "paged_flash_decode_int8_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                                    _LL, _F, _I, _P],
    "paged_attention_sm90_fwd": [_P] * 11 + [_I] * 7 + [_LL, _LL] + [_I] * 5 + [_F, _P],
    "paged_flash_decode_int8_sm90_fwd": [_P] * 12 + [_I] * 6 + [_LL, _LL] + [_I] * 5
                                        + [_F, _P],
}


def reset_launch_counts() -> None:
    for counts in (launch_counts, *route_counts.values()):
        for name in counts:
            counts[name] = 0


def _kernel(name: str):
    from . import _build

    fn = getattr(_build.load(_SOURCES[name]), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, err: int) -> None:
    if err >= 10000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
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


def paged_route(q, k_pool, v_pool) -> str:
    """The route of the paged kernels for these tensors: ``"sm90"`` for
    bf16 queries over bf16 pools, or int8 ``(values, scales)`` pools, at a
    head dim of ``_HEAD_DIMS`` (64, 80, 96, 128 or 256), pages of
    :data:`SM90_PAGE_SIZES` slots and GQA groups of at most
    :data:`SM90_ROWS` heads, every tensor contiguous with a 16-byte-aligned
    base (what TMA and the bulk copies take); else ``"cuda_core"``, which
    raises at a head dim it does not build either. The same rule on any
    device, so the CPU tests can ask it."""
    quantized = isinstance(k_pool, tuple)
    kv = (pool_values(k_pool), pool_values(v_pool))
    tensors = (q, *kv) + ((k_pool[1], v_pool[1]) if quantized else ())
    Hk, bs, D = kv[0].shape[-3:]
    Hq = q.shape[-2]
    want = torch.int8 if quantized else torch.bfloat16
    sm90 = (q.dtype == torch.bfloat16 and D in _HEAD_DIMS and q.shape[-1] == D
            and bs in SM90_PAGE_SIZES and Hq % Hk == 0 and Hq // Hk <= SM90_ROWS
            and all(t.dtype == want for t in kv)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors))
    return "sm90" if sm90 else "cuda_core"


@functools.lru_cache(maxsize=None)
def sm90_blocks_per_sm(D: int, G: int, decode: bool, int8: bool = False) -> int:
    """Blocks per SM of the sm90 instantiation that a launch at head dim
    ``D`` and GQA group ``G`` takes (``decode``: a launch of the decode
    kernel; ``int8``: its int8 mode), as the library that holds the kernel
    states it (``PCfg::kBlocksPerSM`` in csrc/paged_attention_sm90.cuh):
    the decode kernel's own instantiation at groups of at most 8 heads,
    else the one with the 64-row consumer. Builds that library on first
    use, so only on a machine that can build it."""
    from . import _build

    name = "paged_flash_decode_int8_sm90_fwd" if int8 else "paged_attention_sm90_fwd"
    fn = _build.load(_SOURCES[name]).paged_sm90_blocks_per_sm
    fn.argtypes, fn.restype = [_I, _I, _I], ctypes.c_int
    per_sm = fn(D, G, int(decode))
    if per_sm < 1:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    return per_sm


def split_tiles_for(S: int, Q: int, Hk: int, B: int, bs: int, sms: int,
                    per_sm: int) -> int:
    """Tiles per KV split of a decode row, from host-known shapes only. A
    launch of one query per sequence (``Q`` 1) splits each (sequence, kv
    head) pair's context into as many runs as one wave of blocks holds for
    every pair, ``min(per_sm, 2) * sms // pairs``, where ``per_sm`` is the
    launch's instantiation's (:func:`sm90_blocks_per_sm`): none when the
    pairs alone come near filling that wave, as at Llama-2-7B's serving
    shape (512 pairs) and Pythia-1B's (128 pairs, one block per SM on 132
    SMs), where a split only turns one wave into two of half the length and
    adds the merge launch. A wave counts at most two blocks an SM: at D 128
    the runs of three (11 splits at GQA 32/8) took 1.23x the time of two's
    (8 splits). A launch that may hold prompt chunks (``Q`` > 1) takes
    none: their items set its time, and the merge launch would only add to
    it. Measured on the H100 (PERF.md, Findings)."""
    n_tiles = -(-B * bs // SM90_TILE_SLOTS)
    if Q > 1:
        return n_tiles
    splits = max(1, min(per_sm, 2) * sms // (S * Hk))
    return -(-n_tiles // splits)


def sm90_grid(S: int, Q: int, G: int, Hk: int, B: int, bs: int, split_tiles: int):
    """The sm90 kernels' launch for these shapes: ``(blocks, row_tiles,
    n_splits)``. A (sequence, kv head) has ``row_tiles`` items of
    :data:`SM90_ROWS` query rows; a decode row (a sequence with chunk 1)
    splits its context into runs of ``split_tiles`` tiles of
    :data:`SM90_TILE_SLOTS` slots, ``n_splits`` of them over the table's
    width (1: no split)."""
    row_tiles = -(-Q * G // SM90_ROWS)
    n_splits = -(-(-(-B * bs // SM90_TILE_SLOTS)) // split_tiles)
    return S * Hk * (row_tiles + n_splits - 1), row_tiles, n_splits


def _route(chosen: str, route: Optional[str]) -> str:
    """``route``, or :func:`paged_route`'s ``chosen`` one; a forced
    ``"sm90"`` on tensors it was not built for raises."""
    route = route or chosen
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "sm90" and chosen != "sm90":
        raise ValueError("the sm90 route takes bf16 queries over bf16 or int8 pools, a head "
                         f"dim of {_HEAD_DIMS}, pages of {SM90_PAGE_SIZES} slots, contiguous "
                         "16-byte-aligned tensors (see paged_route)")
    return route


def _check_q(q) -> None:
    """The launch helpers read q's rows in place on either route: a strided
    q is refused here (the public functions pass a contiguous copy)."""
    if not q.is_contiguous():
        raise ValueError("q must be contiguous (paged_attention and "
                         "paged_flash_decode make a strided q so)")


def _counted(kernel: str, route: str, err: int, combined: bool = False) -> None:
    """One launch of ``kernel`` on ``route``, and one of ``paged_combine``
    after it when the launch split its decode rows' contexts."""
    with _COUNTS_LOCK:             # engine threads of several replicas
        for name in (kernel, "paged_combine") if combined else (kernel,):
            launch_counts[name] += 1
            route_counts[name][route] += 1
    _check_launch(f"{kernel} ({route})", err)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm90_launch(q, S: int, Q: int, Hq: int, Hk: int, D: int, B: int, bs: int,
                 split_tiles: Optional[int], decode: bool, int8: bool = False):
    """The sm90 launch's split workspace (None without splits) and trailing
    integers; ``split_tiles`` None takes :func:`split_tiles_for` at the
    blocks per SM of the instantiation the launch takes (``decode``: a
    launch of the decode kernel, ``int8``: of its int8 mode)."""
    if split_tiles is None:
        if q.device not in _SMS:
            _SMS[q.device] = torch.cuda.get_device_properties(q.device).multi_processor_count
        split_tiles = split_tiles_for(S, Q, Hk, B, bs, _SMS[q.device],
                                      sm90_blocks_per_sm(D, Hq // Hk, decode, int8))
    blocks, _, n_splits = sm90_grid(S, Q, Hq // Hk, Hk, B, bs, split_tiles)
    ws = None
    if n_splits > 1:
        ws = torch.empty(n_splits * S * Hq * (D + 2), dtype=torch.float32, device=q.device)
    return ws, (split_tiles, n_splits, SM90_ROWS, SM90_TILE_SLOTS, blocks)


def launch_paged_attention(q, k_pool, v_pool, block_table, start_pos, chunk_len,
                           kv_len, out, m, l, *, sm_scale: float,
                           route: Optional[str] = None,
                           split_tiles: Optional[int] = None) -> None:
    """One launch of the packed kernel into ``out`` (and ``m``, ``l`` when
    given) on ``route`` (default :func:`paged_route`'s choice) for CUDA
    tensors that :func:`paged_attention` has checked; ``split_tiles`` (sm90
    only) overrides :func:`split_tiles_for`, so that a script can time both
    sides of the choice."""
    S, Q, Hq, D = q.shape
    N, Hk, bs, _ = k_pool.shape
    B = block_table.shape[1]
    _check_q(q)
    route = _route(paged_route(q, k_pool, v_pool), route)
    tables = (block_table.data_ptr(), start_pos.data_ptr(), chunk_len.data_ptr(),
              kv_len.data_ptr())
    combined = False
    if route == "sm90":
        ws, tail = _sm90_launch(q, S, Q, Hq, Hk, D, B, bs, split_tiles, decode=False)
        combined = ws is not None
        err = _kernel("paged_attention_sm90_fwd")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(), _ptr(m),
            _ptr(l), *tables, _ptr(ws), S, Q, Hq, Hk, D, bs, B, N * Hk * bs, 0, *tail,
            sm_scale, _stream(q))
    else:
        err = _kernel("paged_attention_fwd")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(), _ptr(m),
            _ptr(l), *tables, S, Q, Hq, Hk, D, bs, B, k_pool.stride(0), sm_scale,
            _DTYPES[q.dtype], _stream(q))
    _counted("paged_attention", route, err, combined)


def launch_paged_flash_decode(q, k_pool, v_pool, block_table, pos, kv_len, out, m, l, *,
                              layer: int, sm_scale: float, route: Optional[str] = None,
                              split_tiles: Optional[int] = None) -> None:
    """One launch of the decode kernel (its int8 mode for ``(values,
    scales)`` pools) over the resident ``[L, N, Hk, bs, D]`` pools' ``layer``
    into ``out`` (and ``m``, ``l`` when given) on ``route`` (default
    :func:`paged_route`'s choice) for CUDA tensors that
    :func:`paged_flash_decode` has checked; ``split_tiles`` as for
    :func:`launch_paged_attention`."""
    quantized = isinstance(k_pool, tuple)
    name = "paged_flash_decode_int8" if quantized else "paged_flash_decode"
    kq, vq = pool_values(k_pool), pool_values(v_pool)
    L, N, Hk, bs, D = kq.shape
    S, Hq, _ = q.shape
    B = block_table.shape[1]
    _check_q(q)
    route = _route(paged_route(q, k_pool, v_pool), route)
    head = (q.data_ptr(), kq.data_ptr(), vq.data_ptr())
    if quantized:
        head += (k_pool[1].data_ptr(), v_pool[1].data_ptr())
    outs = (out.data_ptr(), _ptr(m), _ptr(l), block_table.data_ptr(), pos.data_ptr(),
            kv_len.data_ptr())
    combined = False
    if route == "sm90":
        ws, tail = _sm90_launch(q, S, 1, Hq, Hk, D, B, bs, split_tiles, decode=True,
                                int8=quantized)
        combined = ws is not None
        rows = N * Hk * bs
        if quantized:
            err = _kernel("paged_flash_decode_int8_sm90_fwd")(
                *head, *outs, _ptr(ws), S, Hq, Hk, D, bs, B, L * rows, layer * rows, *tail,
                sm_scale, _stream(q))
        else:
            err = _kernel("paged_attention_sm90_fwd")(
                *head, *outs[:5], None, outs[5], _ptr(ws), S, 1, Hq, Hk, D, bs, B,
                L * rows, layer * rows, *tail, sm_scale, _stream(q))
    else:
        tail = (S, Hq, Hk, D, bs, B, layer * kq.stride(0), kq.stride(1))
        if quantized:
            scales = k_pool[1]
            tail += (layer * scales.stride(0), scales.stride(1))
        err = _kernel(name + "_fwd")(*head, *outs, *tail, sm_scale, _DTYPES[q.dtype],
                                     _stream(q))
    _counted(name, route, err, combined)


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
    q = q.contiguous()   # e.g. sliced from a fused QKV projection
    tables = {"block_table": block_table, "start_pos": start_pos,
              "chunk_len": chunk_len, "kv_len": kv_len}
    _validate_cuda(q, k_pool, v_pool, tables, D)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((S, Q, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if S and Q:
        launch_paged_attention(q, k_pool, v_pool, block_table, start_pos, chunk_len,
                               kv_len, out, m, l, sm_scale=_scale(sm_scale, D))
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
    q = q.contiguous()   # e.g. sliced from a fused QKV projection
    tables = {"block_table": block_table, "pos": pos, "kv_len": kv_len}
    scales = (k_pool[1], v_pool[1]) if quantized else None
    _validate_cuda(q, kq, vq, tables, D, scales)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if S:
        launch_paged_flash_decode(q, k_pool, v_pool, block_table, pos, kv_len, out, m, l,
                                  layer=layer, sm_scale=_scale(sm_scale, D))
    return (out, m, l) if return_stats else out
