"""Flash attention, forward and backward: the port of
``deepspeed_tpu/ops/pallas/flash_attention.py``.

:func:`flash_attention` takes ``[B, S, H, D]`` queries and unexpanded GQA
keys/values ``[B, S, Hk, D]`` (query head ``h`` reads kv head
``h // (H // Hk)``), as the JAX function does, and is differentiable: a
``torch.autograd.Function`` whose forward launches the forward kernel and
saves ``(q, k, v, o, L)``, and whose backward launches the dK/dV kernel and
the dQ kernel.

Each of the three kernels has two routes, chosen in the open by one rule,
:func:`flash_route`, and counted per kernel and route in ``route_counts``:
``"wgmma"`` (``csrc/flash_attention_sm90.cu``: TMA loads and ``wgmma`` in
persistent, warp-specialised blocks, Q-stationary for the forward and dQ,
KV-stationary for dK/dV, their units dealt longest first by
:func:`schedule`) for bf16 at every head dim built (64, 80, 96, 128,
256) on tensors TMA can describe, and ``"mma_sync"``
(``csrc/flash_attention.cu``: ``mma.sync`` in bf16, the CUDA
cores in fp32) for the rest. A forced ``"wgmma"`` launch on tensors it was
not built for raises; nothing falls back to the other route.

Each kernel has a plain PyTorch version beside it that computes the same
function with the same roundings: :func:`flash_attention_ref` (forward, with
``L``) and :func:`flash_attention_bwd_ref`. A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. ``launch_counts`` counts kernel launches, one per launch and nowhere
else.

Numerics (the JAX kernels'): logits are fp32 dots of the storage-dtype
inputs times ``sm_scale``; P is rounded to V's dtype before PV; O is
``acc / l`` (``l == 0`` divides by 1) in q's dtype; ``L = m + log l`` fp32
``[B, H, S]``. Backward: ``delta = rowsum(fp32(dO) * fp32(O))`` is taken
before dO is rounded to q's dtype; ``p = exp(s - L)``; P is rounded to dO's
dtype for dV; ``dS`` is rounded to q's dtype before each product;
``sm_scale`` is folded into dS for dK and applied at the end for dQ. The
JAX package sums the GQA group's dK/dV partials in q's dtype outside its
kernel; the port sums them in fp32 inside it.
"""

import ctypes
import heapq
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30
#: the JAX function's default tiles (the kernels here tile themselves)
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512

#: kernel launches per wrapper (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"flash_attention_fwd": 0,
                                 "flash_attention_bwd_dkdv": 0,
                                 "flash_attention_bwd_dq": 0}

_SOURCES = {"mma_sync": "flash_attention.cu", "wgmma": "flash_attention_sm90.cu"}
#: launches per kernel and route (see :func:`flash_route`)
route_counts: Dict[str, Dict[str, int]] = {name: {"wgmma": 0, "mma_sync": 0}
                                           for name in launch_counts}
#: the wgmma kernels' tiles (csrc/flash_attention_sm90.cu) by kernel and head
#: dim: rows of a unit's stationary tile (queries for the forward and dQ,
#: keys for dK/dV), rows of each item streamed past it. Each launch passes
#: the count of units and items dealt from these; the kernel refuses a count
#: that its own tiles decode otherwise.
SM90_TILES = {"flash_attention_fwd": {64: (128, 128), 80: (128, 128), 96: (128, 128),
                                     128: (128, 128), 256: (128, 64)},
              "flash_attention_bwd_dkdv": {64: (128, 64), 80: (128, 64), 96: (128, 64),
                                           128: (128, 64), 256: (64, 64)},
              "flash_attention_bwd_dq": {64: (128, 128), 80: (128, 64), 96: (128, 64),
                                         128: (128, 64), 256: (128, 32)}}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims both csrc/flash_attention*.cu sources build
#: (csrc/flash_head_dims.cuh)
_HEAD_DIMS = tuple(SM90_TILES["flash_attention_fwd"])
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_attention_fwd_sm90": [_P] * 6 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dkdv_sm90": [_P] * 9 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dq_sm90": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
}
_SCHEDULES: Dict[tuple, tuple] = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, *route_counts.values()):
        for name in counts:
            counts[name] = 0


def _kernel(name: str, route: str = "mma_sync"):
    from . import _build

    fn = getattr(_build.load(_SOURCES[route]), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, err: int) -> None:
    if err >= 10000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _scale(sm_scale, D) -> float:
    return 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)


def kernel_takes(q: torch.Tensor) -> bool:
    """Whether the kernels are built for ``q``: a CUDA tensor of a dtype and
    head dim that ``csrc/flash_attention.cu`` instantiates (any length)."""
    return q.is_cuda and q.dtype in _DTYPES and q.shape[-1] in _HEAD_DIMS


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention takes q [B, S, H, D] and k/v "
                         f"[B, S, Hk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(self-attention: same batch, sequence and head dim)")
    if H % k.shape[2]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[2]}")


def _validate_cuda(tensors: Dict[str, torch.Tensor], dtype, D: int) -> None:
    """What the kernels take: contiguous CUDA tensors on one device, fp32 or
    bf16 operands of one dtype, a head dim that is instantiated, 16-byte
    aligned rows."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, others on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        want = torch.float32 if name in ("lse", "delta") else dtype
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mask(S, causal, device):
    if not causal:
        return None
    pos = torch.arange(S, device=device)
    return pos[:, None] >= pos[None, :]                       # [q, k]


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """Plain PyTorch version of the forward kernel: fp32 logits over the
    grouped heads, softmax, P rounded to V's dtype, fp32 PV. Returns O in
    q's dtype ``[B, S, H, D]`` (and ``L`` fp32 ``[B, H, S]``)."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * _scale(sm_scale, D)
    mask = _mask(S, causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                        # [B, Hk, G, S]
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / safe_l.permute(0, 3, 1, 2)[..., None]).to(q.dtype).reshape(B, S, H, D)
    if return_lse:
        return o, (m + torch.log(safe_l)).reshape(B, H, S)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            sm_scale: Optional[float] = None):
    """Plain PyTorch version of the two backward kernels: ``(dq, dk, dv)``
    from the forward's residuals ``(q, k, v, o, L)`` and the cotangent
    ``do``, with the kernels' roundings (see the module docstring)."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = _scale(sm_scale, D)
    delta = (do.float() * o.float()).sum(dim=-1)              # [B, S, H]
    do_c = do.to(q.dtype)
    qg = q.reshape(B, S, Hk, G, D)
    dog = do_c.reshape(B, S, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(B, Hk, G, S)[..., None])
    mask = _mask(S, causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do_c.dtype).float(), dog.float())
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), v.float())
    ds = p * (dp - delta.reshape(B, S, Hk, G).permute(0, 2, 3, 1)[..., None])
    dk = torch.einsum("bhgqk,bqhgd->bkhd", (ds * scale).to(q.dtype).float(), qg.float())
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float()) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def flash_route(q, k, v, do=None) -> str:
    """The route of every flash kernel for these tensors (``do`` for the
    backward kernels): ``"wgmma"`` for bf16 at a head dim that is built
    (``_HEAD_DIMS``) when TMA can describe every tensor (contiguous, so
    rows of ``heads * D`` elements, with 16-byte-aligned bases); else
    ``"mma_sync"``. The same rule on any device, so the CPU tests can ask
    it."""
    tensors = (q, k, v) if do is None else (q, k, v, do)
    tma = (q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS
           and all(t.dtype == q.dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in tensors))
    return "wgmma" if tma else "mma_sync"


def unit_lengths(kernel: str, B: int, S: int, H: int, Hk: int, D: int, causal: bool):
    """The wgmma ``kernel``'s work units by index ``u``, as the kernel
    decodes them, and the number of items of each.

    Forward and dQ: ``(b, query head, query tile)``, query tile ``u // (B
    H)``, batch and head from ``u % (B H)``; its items are the key tiles at
    or below the query tile's diagonal (all of them when not causal). dK/dV:
    ``(b, kv head, key tile)``, key tile ``u // (B Hk)``; its items are the
    group's ``H // Hk`` heads times the query tiles at or below the key
    tile's diagonal."""
    tile, step = SM90_TILES[kernel][D]
    n_tiles, n_steps = -(-S // tile), -(-S // step)
    if kernel == "flash_attention_bwd_dkdv":
        return [H // Hk * (n_steps - (u // (B * Hk) * tile // step if causal else 0))
                for u in range(n_tiles * B * Hk)]
    return [min(n_steps, (u // (B * H) * tile + tile - 1) // step + 1) if causal else n_steps
            for u in range(n_tiles * B * H)]


def schedule(lengths, blocks: int):
    """The persistent blocks' work for units of these ``lengths`` (items
    each): units sorted longest first (ties by index), each dealt to the
    block with the fewest items so far (ties to the lowest block). Returns
    ``(offsets, ids)``: block ``i`` computes units ``ids[offsets[i]:offsets[i
    + 1]]``, each from start to end, so every unit's sums run in a fixed
    order whatever the schedule."""
    blocks = max(1, min(blocks, len(lengths)))
    heap = [(0, i) for i in range(blocks)]
    per = [[] for _ in range(blocks)]
    for u in sorted(range(len(lengths)), key=lambda u: (-lengths[u], u)):
        load, i = heapq.heappop(heap)
        per[i].append(u)
        heapq.heappush(heap, (load + lengths[u], i))
    offsets, ids = [0], []
    for units in per:
        ids += units
        offsets.append(len(ids))
    return offsets, ids


def _schedule_tensor(kernel: str, q, Hk: int, causal: bool):
    """``(schedule, blocks, units, items)``: :func:`schedule` of ``kernel``'s
    units for one block per SM of ``q``'s card as an int32 tensor there
    (offsets, then ids), its number of blocks, and the number of units and
    of their items in all, which the kernel holds against its own decode;
    made once per kernel and shape."""
    B, S, H, D = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    key = (kernel, B, S, H, Hk, D, causal, sms, q.device)
    if key not in _SCHEDULES:
        lengths = unit_lengths(kernel, B, S, H, Hk, D, causal)
        offsets, ids = schedule(lengths, sms)
        _SCHEDULES[key] = (torch.tensor(offsets + ids, dtype=torch.int32, device=q.device),
                           len(offsets) - 1, len(lengths), sum(lengths))
    return _SCHEDULES[key]


def _route(tensors, route: Optional[str]) -> str:
    """``route``, or :func:`flash_route`'s choice for ``tensors``; a forced
    ``"wgmma"`` on tensors it was not built for raises."""
    chosen = flash_route(*tensors)
    route = route or chosen
    if route not in _SOURCES:
        raise ValueError(f"route must be one of {sorted(_SOURCES)}, got {route!r}")
    if route == "wgmma" and chosen != "wgmma":
        raise ValueError("the wgmma route takes contiguous bf16 tensors with 16-byte "
                         f"aligned bases and a head dim in {_HEAD_DIMS} (see flash_route)")
    return route


def _counted(kernel: str, route: str, err: int) -> None:
    launch_counts[kernel] += 1
    route_counts[kernel][route] += 1
    _check_launch(f"{kernel} ({route})", err)


def launch_fwd(q, k, v, o, lse, *, causal: bool, sm_scale: float,
               route: Optional[str] = None):
    """One launch of the forward kernel into ``o`` and ``lse`` on ``route``
    (default :func:`flash_route`'s choice) for CUDA tensors that
    ``flash_attention_forward`` has checked."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    route = _route((q, k, v), route)
    if route == "wgmma":
        sched, grid, units, items = _schedule_tensor("flash_attention_fwd", q, Hk, causal)
        err = _kernel("flash_attention_fwd_sm90", route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            sched.data_ptr(), grid, units, items, B, S, H, Hk, D, sm_scale, int(causal),
            _stream(q))
    else:
        err = _kernel("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, S, H, Hk, D, sm_scale, int(causal), _DTYPES[q.dtype], _stream(q))
    _counted("flash_attention_fwd", route, err)


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            sm_scale: Optional[float] = None):
    """The forward kernel: ``(o, L)`` for ``[B, S, H, D]`` q and
    ``[B, S, Hk, D]`` k/v. CPU tensors take :func:`flash_attention_ref`."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    scale = _scale(sm_scale, D)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=scale,
                                   return_lse=True)
    _validate_cuda({"q": q, "k": k, "v": v}, q.dtype, D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel():
        launch_fwd(q, k, v, o, lse, causal=causal, sm_scale=scale)
    return o, lse


def launch_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, *, causal: bool, sm_scale: float,
                    route: Optional[str] = None):
    """One launch of the dK/dV kernel into ``dk``/``dv`` on ``route``
    (default :func:`flash_route`'s choice) for CUDA tensors that
    ``flash_attention_backward`` has checked (``do`` in q's dtype, ``delta``
    fp32 ``[B, H, S]``)."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    route = _route((q, k, v, do), route)
    if route == "wgmma":
        sched, grid, units, items = _schedule_tensor("flash_attention_bwd_dkdv", q, Hk, causal)
        err = _kernel("flash_attention_bwd_dkdv_sm90", route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), sched.data_ptr(), grid, units,
            items, B, S, H, Hk, D, sm_scale, int(causal), _stream(q))
    else:
        err = _kernel("flash_attention_bwd_dkdv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, Hk, D,
            sm_scale, int(causal), _DTYPES[q.dtype], _stream(q))
    _counted("flash_attention_bwd_dkdv", route, err)


def launch_bwd_dq(q, k, v, do, lse, delta, dq, *, causal: bool, sm_scale: float,
                  route: Optional[str] = None):
    """One launch of the dQ kernel into ``dq`` (see :func:`launch_bwd_dkdv`)."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    route = _route((q, k, v, do), route)
    if route == "wgmma":
        sched, grid, units, items = _schedule_tensor("flash_attention_bwd_dq", q, Hk, causal)
        err = _kernel("flash_attention_bwd_dq_sm90", route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), sched.data_ptr(), grid, units, items, B, S, H,
            Hk, D, sm_scale, int(causal), _stream(q))
    else:
        err = _kernel("flash_attention_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, S, H, Hk, D, sm_scale,
            int(causal), _DTYPES[q.dtype], _stream(q))
    _counted("flash_attention_bwd_dq", route, err)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """The dK/dV and dQ kernels: ``(dq, dk, dv)``. ``delta`` is taken here
    from the fp32 ``do`` and ``o``, before ``do`` is rounded to q's dtype.
    CPU tensors take :func:`flash_attention_bwd_ref`."""
    _check_shapes(q, k, v)
    scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       sm_scale=scale)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    do_c = do.to(q.dtype).contiguous()
    _validate_cuda({"q": q, "k": k, "v": v, "do": do_c, "lse": lse,
                    "delta": delta}, q.dtype, q.shape[-1])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        launch_bwd_dkdv(q, k, v, do_c, lse, delta, dk, dv, causal=causal, sm_scale=scale)
        launch_bwd_dq(q, k, v, do_c, lse, delta, dq, causal=causal, sm_scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, residuals ``(q, k, v, o, L)``, backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_forward(q, k, v, causal=causal, sm_scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do.contiguous(),
                                              causal=ctx.causal,
                                              sm_scale=ctx.scale)
        return dq, dk, dv, None, None


def check_block(name: str, length: int, block: int, default: int) -> None:
    """Refuse a block size the JAX function refuses. JAX fits the block to
    the length (the largest halving, down to 128, that divides it) and
    raises unless the fitted block divides the length. The kernels here
    choose their own tiles and mask a ragged length, so the default, which
    leaves the tiling to them, takes any length; any other value is checked
    as the JAX function checks it."""
    if isinstance(block, bool) or not isinstance(block, int) or block <= 0:
        raise ValueError(f"{name} must be a positive int, got {block!r}")
    if block == default:
        return
    fitted = min(block, length)
    while fitted > 128 and length % fitted:
        fitted //= 2
    if length % fitted:
        raise ValueError(f"{name}={block} does not tile the length {length} (fitted to "
                         f"{fitted}), as the JAX function requires")


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
                    interpret: Optional[bool] = None):
    """Flash attention over ``[B, S, H, D]`` tensors (JAX
    ``flash_attention``), differentiable. GQA: k/v stay ``[B, S, Hk, D]``;
    no repeated K/V is ever made. ``sm_scale`` defaults to ``1/sqrt(D)``.
    ``block_q`` / ``block_k`` are the JAX function's TPU tiles: checked as
    it checks them (:func:`check_block`), then unused, since the kernels
    tile themselves; the result does not depend on them. ``interpret`` (the
    Pallas interpreter switch) is accepted and ignored. Any strides are
    taken: the kernels read contiguous copies of views that are not."""
    _check_shapes(q, k, v)
    check_block("block_q", q.shape[1], block_q, DEFAULT_BLOCK_Q)
    check_block("block_k", k.shape[1], block_k, DEFAULT_BLOCK_K)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 bool(causal), _scale(sm_scale, q.shape[-1]))
