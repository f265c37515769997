"""Block-sparse attention: the port of
``deepspeed_tpu/ops/pallas/sparse_attention.py`` (reference
``deepspeed/ops/sparse_attention/`` and its ``SparsityConfig`` families).

Sparsity is a STATIC per-head block layout ``[H, NQ, NK]`` (numpy bool),
built by the layout builders below (Fixed, BigBird, BSLongformer, Variable,
LocalSlidingWindow; Dense is an all-ones layout). :func:`sparse_attention`
compacts it to per-(head, q-block) ascending column lists (memoised on the
layout's bytes, ``causal`` and the device) and runs:

* the forward: a hand-written Hopper kernel (a flash forward over the
  compacted columns) on CUDA tensors, its plain version
  :func:`masked_dense_attention` on CPU tensors. The kernel has two routes,
  chosen in the open by :func:`sparse_route`: ``"wgmma"``
  (``csrc/sparse_attention_sm90.cu``: TMA loads and ``wgmma`` in
  warp-specialised blocks, one 64-row query tile per work item, the items
  dealt by :func:`sm90_plan`) for bf16 on tensors TMA can describe, and
  ``"mma_sync"`` (``csrc/sparse_attention.cu``: ``mma.sync`` in bf16, the
  CUDA cores in fp32) for the rest. Both take the blocks of ``_BLOCKS``
  and the head dims of ``_HEAD_DIMS`` (``csrc/sparse_tiles.cuh``). At a
  block smaller than a work item's rows the item walks the union of its
  q-blocks' column lists, each column with a mask of the q-blocks that list
  it (:func:`union_columns`). A CUDA call that neither route was built for
  (head dim, block or dtype) raises, and so does a forced ``"wgmma"``
  launch on tensors it was not built for; nothing falls back to the other
  route;
* the backward: recomputed through the masked-dense plain function under
  autograd, as the JAX ``custom_vjp`` does (exact, O(S^2) compute; the JAX
  package computes it outside any Pallas kernel).

``launch_counts["sparse_attention_fwd"]`` counts kernel launches, one per
launch and nowhere else; ``route_counts["sparse_attention_fwd"]`` counts
them per route.
"""

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

NEG_INF = -1e30

#: kernel launches (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"sparse_attention_fwd": 0}
#: launches per route (see :func:`sparse_route`)
route_counts: Dict[str, Dict[str, int]] = {"sparse_attention_fwd": {"wgmma": 0, "mma_sync": 0}}

_SOURCES = {"mma_sync": "sparse_attention.cu", "wgmma": "sparse_attention_sm90.cu"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: what both sources build (csrc/sparse_tiles.cuh: SPARSE_HEAD_DIMS and
#: SPARSE_BLOCKS list the same)
_HEAD_DIMS = (64, 80, 96, 128, 256)
_BLOCKS = (16, 32, 64, 128, 256)
#: the wgmma kernel's tiles (csrc/sparse_attention_sm90.cu): query rows per
#: work item and keys per streamed tile. Each launch passes the number of
#: items dealt from SM90_ROWS (and, below block 64, the union's rows); the
#: kernel refuses a count its own tiles decode otherwise.
SM90_ROWS = 64
SM90_KEYS = 64
#: its blocks resident on an SM by head dim (the kernel's launch bounds)
SM90_BLOCKS_PER_SM = {64: 3, 80: 2, 96: 2, 128: 2, 256: 1}
#: query rows per work item of the mma_sync route's tiles by dtype
#: (csrc/sparse_attention.cu: MmaTiles and F32Tiles)
MMA_ROWS = {torch.bfloat16: 64, torch.float32: 32}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sparse_attention_fwd": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _I, _P],
    "sparse_attention_fwd_sm90": [_P] * 10 + [_I] * 11 + [ctypes.c_float, _I, _P],
}


def reset_launch_counts() -> None:
    for counts in (launch_counts, *route_counts.values()):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# SparsityConfig-style layout builders — [H, NQ, NK] bool, numpy (static)
# ---------------------------------------------------------------------------


def fixed_layout(num_heads: int, num_blocks: int, *, num_local_blocks: int = 4,
                 num_global_blocks: int = 1) -> np.ndarray:
    """Reference ``FixedSparsityConfig``: local band + the leading blocks of
    each local window visible globally."""
    lo = np.zeros((num_blocks, num_blocks), bool)
    for i in range(num_blocks):
        start = (i // num_local_blocks) * num_local_blocks
        lo[i, start:start + num_local_blocks] = True  # local window
        for w in range(0, i + 1, num_local_blocks):   # global columns
            lo[i, w:w + num_global_blocks] = True
    return np.repeat(lo[None], num_heads, axis=0)


def bigbird_layout(num_heads: int, num_blocks: int, *,
                   num_sliding_window_blocks: int = 3,
                   num_global_blocks: int = 1,
                   num_random_blocks: int = 1, seed: int = 0) -> np.ndarray:
    """Reference ``BigBirdSparsityConfig``: window + global + per-head random
    (drawn from ``np.random.default_rng(seed)``, as the JAX package does)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((num_heads, num_blocks, num_blocks), bool)
    half = num_sliding_window_blocks // 2
    for h in range(num_heads):
        lo = out[h]
        lo[:num_global_blocks, :] = True   # global rows attend everywhere
        lo[:, :num_global_blocks] = True   # everyone attends global columns
        for i in range(num_blocks):
            lo[i, max(0, i - half): i + half + 1] = True
            if num_blocks > num_random_blocks:
                lo[i, rng.choice(num_blocks, num_random_blocks, replace=False)] = True
    return out


def bslongformer_layout(num_heads: int, num_blocks: int, *,
                        num_sliding_window_blocks: int = 3,
                        global_block_indices=(0,)) -> np.ndarray:
    """Reference ``BSLongformerSparsityConfig``: window + symmetric globals."""
    lo = np.zeros((num_blocks, num_blocks), bool)
    half = num_sliding_window_blocks // 2
    for i in range(num_blocks):
        lo[i, max(0, i - half): i + half + 1] = True
    for g in global_block_indices:
        lo[:, g] = True
        lo[g, :] = True
    return np.repeat(lo[None], num_heads, axis=0)


def variable_layout(num_heads: int, num_blocks: int, *,
                    num_random_blocks: int = 0,
                    local_window_blocks=(4,),
                    global_block_indices=(0,),
                    horizontal_global_attention: bool = False,
                    seed: int = 0) -> np.ndarray:
    """Reference ``VariableSparsityConfig``: consecutive local windows of
    VARYING widths (the last width repeats), global COLUMNS (rows too only
    with ``horizontal_global_attention``), and optional per-head random
    blocks."""
    rng = np.random.default_rng(seed)
    out = np.zeros((num_heads, num_blocks, num_blocks), bool)
    starts, widths, i, k = [], [], 0, 0
    while i < num_blocks:
        w = local_window_blocks[min(k, len(local_window_blocks) - 1)]
        starts.append(i)
        widths.append(w)
        i += w
        k += 1
    base = np.zeros((num_blocks, num_blocks), bool)
    for s, w in zip(starts, widths):
        base[s:s + w, s:s + w] = True
    for g in global_block_indices:
        base[:, g] = True
        if horizontal_global_attention:
            base[g, :] = True
    out[:] = base[None]
    if num_random_blocks and num_blocks > num_random_blocks:
        for h in range(num_heads):  # randoms are the only per-head part
            for i in range(num_blocks):
                out[h, i, rng.choice(num_blocks, num_random_blocks,
                                     replace=False)] = True
    return out


def local_sliding_window_layout(num_heads: int, num_blocks: int, *,
                                num_sliding_window_blocks: int = 3
                                ) -> np.ndarray:
    """Reference ``LocalSlidingWindowSparsityConfig``: pure sliding window
    (= BSLongformer with no global blocks)."""
    return bslongformer_layout(
        num_heads, num_blocks,
        num_sliding_window_blocks=num_sliding_window_blocks,
        global_block_indices=())


def causal_layout(layout: np.ndarray) -> np.ndarray:
    """Intersect a layout with the block lower-triangle (blocks fully above
    the diagonal can never contribute under causal masking)."""
    nq, nk = layout.shape[1:]
    tri = np.tril(np.ones((nq, nk), bool))
    return layout & tri[None]


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _ascending(live: np.ndarray, width: int):
    """The indices of each row's set entries of ``live`` (``[..., NK]``
    bool), ascending, padded to ``width`` with the row's last one (0 for a
    row with none), as int32, and their count per row."""
    cnt = live.sum(axis=-1).astype(np.int32)
    order = np.argsort(~live, axis=-1, kind="stable")[..., :width]
    if order.shape[-1] < width:
        order = np.concatenate(
            [order, np.zeros((*order.shape[:-1], width - order.shape[-1]), order.dtype)], -1)
    last = np.take_along_axis(order, np.maximum(cnt - 1, 0)[..., None], axis=-1)
    cols = np.where(np.arange(width) < cnt[..., None], order, last)
    return cols.astype(np.int32), cnt


def union_columns(layout: np.ndarray, r: int):
    """The column lists of a work item that spans ``r`` consecutive q-blocks
    (a block smaller than the kernels' item rows; the last item may run past
    the layout): ``(cols, masks, cnt)``, ``cols`` int32 ``[H, T, NU]`` the
    ascending union of the ``r`` q-blocks' columns (``T = ceil(NQ / r)``),
    padded with the last one, ``masks`` int32 beside them, bit ``i`` set
    when q-block ``i`` of the item lists the column (0 on padding), and
    ``cnt`` int32 ``[H, T]`` the union's length. ``NU`` is a multiple of 4,
    so that every tile of ``keys / block`` columns (1, 2 or 4) lies in the
    arrays."""
    h, nq, nk = layout.shape
    t = -(-nq // r)
    lo = np.zeros((h, t * r, nk), np.int32)
    lo[:, :nq] = layout
    bits = (lo.reshape(h, t, r, nk) << np.arange(r, dtype=np.int32)[:, None]).sum(axis=2)
    nu = -(-max(int((bits != 0).sum(axis=-1).max()), 1) // 4) * 4
    cols, cnt = _ascending(bits != 0, nu)
    masks = np.take_along_axis(bits, cols, axis=-1)
    masks[np.arange(nu) >= cnt[..., None]] = 0
    return cols, masks.astype(np.int32), cnt


class CompactLayout:
    """A layout's per-(head, q-block) live columns: ``cols`` int32
    ``[H, NQ, NJ]`` (ascending, padded with the last valid column) and
    ``cnt`` int32 ``[H, NQ]`` on the device, beside the (causal-intersected)
    numpy ``layout`` the backward recomputes with."""

    def __init__(self, cols: torch.Tensor, cnt: torch.Tensor, layout: np.ndarray):
        self.cols, self.cnt, self.layout = cols, cnt, layout
        #: :func:`union_columns` on the device, by q-blocks per item
        self.unions: Dict[int, tuple] = {}
        #: the wgmma kernel's schedules on the device, by launch shape
        self.schedules: Dict[tuple, tuple] = {}

    def union(self, r: int):
        """``(cols, masks, cnt)`` of :func:`union_columns` at ``r`` q-blocks
        per item, on the device of ``cols``; made once per ``r``."""
        if r not in self.unions:
            self.unions[r] = tuple(torch.from_numpy(a).to(self.cols.device)
                                   for a in union_columns(self.layout, r))
        return self.unions[r]


_LAYOUT_CACHE: Dict[tuple, CompactLayout] = {}


def _compact_layout(layout: np.ndarray, causal: bool, device) -> CompactLayout:
    """Compact a static layout to per-(head, q-block) column lists, memoised
    on the layout's content, ``causal`` and the device (an eager serving or
    training loop passes the same layout every call)."""
    key = (layout.shape, layout.tobytes(), causal, str(device))
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    if causal:
        layout = causal_layout(layout)
    nj = max(int(layout.sum(axis=2).max()), 1)
    cols, cnt = _ascending(layout, nj)
    sl = CompactLayout(torch.from_numpy(cols).to(device),
                       torch.from_numpy(cnt).to(device), layout)
    if len(_LAYOUT_CACHE) > 64:  # bound host and device memory held by the cache
        _LAYOUT_CACHE.clear()
    _LAYOUT_CACHE[key] = sl
    return sl


# ---------------------------------------------------------------------------
# plain version (the CPU forward, and the backward everywhere)
# ---------------------------------------------------------------------------


def masked_dense_attention(q, k, v, layout, *, causal: bool, sm_scale: float,
                           block_q: int, block_k: int):
    """``[B, H, S, D]`` attention with the block layout expanded to a dense
    mask: fp32 logits (exact products of bf16 inputs), softmax over the
    live keys, rows with no live key give 0, P rounded to q's dtype before
    the fp32-accumulated PV product."""
    sq, sk = q.shape[2], k.shape[2]
    lo = torch.as_tensor(np.asarray(layout, bool), device=q.device)
    mask = lo.repeat_interleave(block_q, dim=1).repeat_interleave(block_k, dim=2)
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()[None]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    logits = torch.where(mask[None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[None], probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel wrapper and the public op
# ---------------------------------------------------------------------------


def _kernel(name: str, route: str):
    from . import _build

    fn = getattr(_build.load(_SOURCES[route]), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _validate_cuda(q, k, v, sl: CompactLayout, block: int) -> None:
    """What the kernels take: contiguous CUDA q/k/v of one dtype (fp32 or
    bf16) and shape, a supported head dim and block, 16-byte aligned."""
    for name, t in (("k", k), ("v", v), ("cols", sl.cols), ("cnt", sl.cnt)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's shape and dtype "
                             f"({tuple(t.shape)} {t.dtype})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the sparse kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {_HEAD_DIMS}")
    if block not in _BLOCKS:
        raise ValueError(f"block {block} not in {_BLOCKS}")


def sparse_route(q, k, v) -> str:
    """The forward kernel's route for these tensors: ``"wgmma"`` for bf16 at
    a head dim of ``_HEAD_DIMS`` when TMA can describe every tensor
    (contiguous, so rows of ``H * D`` elements, with 16-byte-aligned bases);
    else ``"mma_sync"``. Both routes take the blocks of ``_BLOCKS``. The
    same rule on any device, so the CPU tests can ask it."""
    tma = (q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS
           and all(t.dtype == q.dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in (q, k, v)))
    return "wgmma" if tma else "mma_sync"


def item_lengths(layout: np.ndarray, B: int, block: int, causal: bool) -> np.ndarray:
    """The live key tiles of each of the wgmma kernel's work items, by item
    index ``u = (b H + h) T + t`` (``T = ceil(S / SM90_ROWS)`` query tiles),
    as its producer counts them. At a block of at least ``SM90_KEYS``, from
    the compacted columns: ``block / SM90_KEYS`` tiles per live column of
    the item's q-block, less, under causal, the tiles wholly above the
    item's last row (only the diagonal column's, since the ``layout`` given
    is the causal-intersected one). Below it, from the union of the item's
    q-blocks' columns (:func:`union_columns`): one tile per ``SM90_KEYS /
    block`` union columns, the last one padded; none lies above the item
    under causal, as every listed column is at or below its q-block."""
    H, nq, _ = layout.shape
    rows, keys = SM90_ROWS, SM90_KEYS
    if block < keys:
        cnt = union_columns(layout, rows // block)[2]
        return np.tile((-(-cnt // (keys // block))).reshape(-1), B)
    per = block // keys
    q0 = np.arange(nq * block // rows) * rows
    iq = q0 // block
    n = layout.sum(axis=2)[:, iq] * per                       # [H, T]
    if causal:
        above = (iq[:, None] * block + np.arange(per)[None] * keys
                 > (q0 + rows - 1)[:, None]).sum(axis=1)      # [T]
        n = n - layout[:, iq, iq] * above[None]
    return np.tile(n.reshape(-1), B)


def sm90_plan(lengths, blocks: int):
    """``(offsets + ids, grid)`` for the wgmma kernel's items of these
    ``lengths``: dealt over ``blocks`` persistent blocks, longest first
    (:func:`schedule`)."""
    from .flash_attention import schedule

    offsets, ids = schedule([int(x) for x in lengths], blocks)
    return offsets + ids, len(offsets) - 1


def _sm90_schedule(sl: CompactLayout, q, block: int, causal: bool):
    """``(schedule, grid, items)``: :func:`sm90_plan` for ``q``'s card as an
    int32 tensor there, its number of blocks and the number of items,
    which the kernel holds against its own decode; made once per layout and
    launch shape."""
    B, S, H, D = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    key = (B, block, sms, SM90_ROWS, SM90_BLOCKS_PER_SM[D])
    if key not in sl.schedules:
        lengths = item_lengths(sl.layout, B, block, causal)
        plan, grid = sm90_plan(lengths, sms * SM90_BLOCKS_PER_SM[D])
        sl.schedules[key] = (torch.tensor(plan, dtype=torch.int32, device=q.device),
                             grid, len(lengths))
    return sl.schedules[key]


def launch_sparse_fwd(q, k, v, out, sl: CompactLayout, *, causal: bool, sm_scale: float,
                      block: int, route: Optional[str] = None) -> None:
    """One launch of the forward kernel into ``out`` on ``route`` (default
    :func:`sparse_route`'s choice) for CUDA tensors that ``_validate_cuda``
    has checked. A forced ``"wgmma"`` on tensors it was not built for
    raises before any launch."""
    chosen = sparse_route(q, k, v)
    route = route or chosen
    if route not in _SOURCES:
        raise ValueError(f"route must be one of {sorted(_SOURCES)}, got {route!r}")
    if route == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma route takes contiguous bf16 tensors with 16-byte "
                         f"aligned bases and a head dim of {_HEAD_DIMS} (see sparse_route)")
    B, S, H, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rows = SM90_ROWS if route == "wgmma" else MMA_ROWS.get(q.dtype, 0)
    union = (0, 0, 0, 0, 0)   # (cols, masks, cnt, items per head, width) below the rows
    if 0 < block < rows:
        u = sl.union(rows // block)
        union = (*(t.data_ptr() for t in u), u[2].shape[1], u[0].shape[2])
    lists = (sl.cols.data_ptr(), sl.cnt.data_ptr(), *union[:3])
    shape = (B, S, H, D, block, sl.cols.shape[1], sl.cols.shape[2], *union[3:])
    if route == "wgmma":
        sched, grid, items = _sm90_schedule(sl, q, block, causal)
        err = _kernel("sparse_attention_fwd_sm90", route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lists,
            sched.data_ptr(), grid, items, *shape, sm_scale, int(causal), stream)
    else:
        err = _kernel("sparse_attention_fwd", route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lists, *shape,
            sm_scale, int(causal), _DTYPES[q.dtype], stream)
    launch_counts["sparse_attention_fwd"] += 1
    route_counts["sparse_attention_fwd"][route] += 1
    if err >= 10000:
        raise RuntimeError(f"sparse_attention_fwd ({route}): cuTensorMapEncodeTiled "
                           f"failed: CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"sparse_attention_fwd ({route}) launch failed: cudaError_t {err}")


def _sparse_forward(q, k, v, sl: CompactLayout, causal: bool, sm_scale: float,
                    block: int) -> torch.Tensor:
    """The forward over ``[B, S, H, D]`` tensors: the kernel on CUDA
    tensors (read in place, no transpose), the plain version on CPU ones."""
    if q.device.type == "cpu":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return masked_dense_attention(qt, kt, vt, sl.layout, causal=causal,
                                      sm_scale=sm_scale, block_q=block,
                                      block_k=block).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_attention: unsupported device {q.device}")
    _validate_cuda(q, k, v, sl, block)
    out = torch.empty_like(q)
    if q.numel():
        launch_sparse_fwd(q, k, v, out, sl, causal=causal, sm_scale=sm_scale, block=block)
    return out


class _SparseAttention(torch.autograd.Function):
    """Forward through the kernel (or its plain version on the CPU);
    backward recomputed through :func:`masked_dense_attention` (the JAX
    ``_sparse_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, sl, causal, sm_scale, block):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (sl.layout, causal, sm_scale, block)
        return _sparse_forward(q, k, v, sl, causal, sm_scale, block)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        layout, causal, sm_scale, block = ctx.cfg
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            qt, kt, vt = (x.transpose(1, 2) for x in qkv)
            out = masked_dense_attention(qt, kt, vt, layout, causal=causal,
                                         sm_scale=sm_scale, block_q=block,
                                         block_k=block).transpose(1, 2)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None, None, None)


def sparse_attention(q, k, v, layout: np.ndarray, *, causal: bool = True,
                     sm_scale: Optional[float] = None, block: int = 64,
                     interpret: Optional[bool] = None):
    """Block-sparse attention over ``[B, S, H, D]`` tensors.

    ``layout``: static numpy bool ``[H, S/block, S/block]`` (see the
    builders above). Only the layout's nonzero blocks are computed in the
    forward; the backward recomputes through the masked-dense plain
    function. ``interpret`` (the Pallas interpreter switch) is accepted and
    ignored. Any strides are taken: the kernels read contiguous copies of
    views that are not (a transposed ``[B, H, S, D]`` tensor, a slice of a
    fused QKV tensor)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    if sq % block:
        raise ValueError(f"seq {sq} must be a multiple of block {block}")
    nq = sq // block
    if layout.shape != (h, nq, nq):
        raise ValueError(f"layout shape {layout.shape} != {(h, nq, nq)}")
    layout = np.ascontiguousarray(layout.astype(bool))
    sl = _compact_layout(layout, causal, q.device)
    return _SparseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), sl,
                                  causal, float(sm_scale), block)
