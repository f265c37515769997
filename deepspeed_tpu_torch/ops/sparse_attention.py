"""Block-sparse attention: the port of
``deepspeed_tpu/ops/pallas/sparse_attention.py`` (reference
``deepspeed/ops/sparse_attention/`` and its ``SparsityConfig`` families).

Sparsity is a STATIC per-head block layout ``[H, NQ, NK]`` (numpy bool),
built by the layout builders below (Fixed, BigBird, BSLongformer, Variable,
LocalSlidingWindow; Dense is an all-ones layout). :func:`sparse_attention`
compacts it to per-(head, q-block) ascending column lists (memoised on the
layout's bytes, ``causal`` and the device) and runs:

* the forward: the hand-written Hopper kernel ``csrc/sparse_attention.cu``
  (a flash forward over the compacted columns) on CUDA tensors, its plain
  version :func:`masked_dense_attention` on CPU tensors. A CUDA call the
  kernel was not built for (head dim, block or dtype) raises;
* the backward: recomputed through the masked-dense plain function under
  autograd, as the JAX ``custom_vjp`` does (exact, O(S^2) compute; the JAX
  package computes it outside any Pallas kernel).

``launch_counts["sparse_attention_fwd"]`` counts kernel launches, one per
launch and nowhere else.
"""

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

NEG_INF = -1e30

#: kernel launches (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"sparse_attention_fwd": 0}

_SOURCE = "sparse_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)   # instantiated in csrc/sparse_attention.cu
_BLOCKS = (64, 128)      # layout blocks the kernel's 64-row tiles divide
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _I, _I, _P]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


class CompactLayout:
    """A layout's per-(head, q-block) live columns: ``cols`` int32
    ``[H, NQ, NJ]`` (ascending, padded with the last valid column) and
    ``cnt`` int32 ``[H, NQ]`` on the device, beside the (causal-intersected)
    numpy ``layout`` the backward recomputes with."""

    def __init__(self, cols: torch.Tensor, cnt: torch.Tensor, layout: np.ndarray):
        self.cols, self.cnt, self.layout = cols, cnt, layout


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
    h, nq, _ = layout.shape
    cnt = layout.sum(axis=2).astype(np.int32)                   # [H, NQ]
    nj = max(int(cnt.max()), 1)
    cols = np.zeros((h, nq, nj), np.int32)
    for hh in range(h):
        for i in range(nq):
            idx = np.nonzero(layout[hh, i])[0]
            if len(idx):
                cols[hh, i, :len(idx)] = idx
                cols[hh, i, len(idx):] = idx[-1]
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


def _kernel():
    from . import _build

    fn = _build.load(_SOURCE).sparse_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def _validate_cuda(q, k, v, sl: CompactLayout, block: int) -> None:
    """What the kernel takes: contiguous CUDA q/k/v of one dtype (fp32 or
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
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    sl.cols.data_ptr(), sl.cnt.data_ptr(), B, S, H, D, block,
                    sl.cols.shape[1], sl.cols.shape[2], sm_scale, int(causal),
                    _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    launch_counts["sparse_attention_fwd"] += 1
    if err != 0:
        raise RuntimeError(f"sparse_attention_fwd launch failed: cudaError_t {err}")
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
    ignored."""
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
    return _SparseAttention.apply(q, k, v, sl, causal, float(sm_scale), block)
