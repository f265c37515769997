"""Flash attention, forward and backward: the port of
``deepspeed_tpu/ops/pallas/flash_attention.py``.

:func:`flash_attention` takes ``[B, S, H, D]`` queries and unexpanded GQA
keys/values ``[B, S, Hk, D]`` (query head ``h`` reads kv head
``h // (H // Hk)``), as the JAX function does, and is differentiable: a
``torch.autograd.Function`` whose forward launches the forward kernel and
saves ``(q, k, v, o, L)``, and whose backward launches the dK/dV kernel and
the dQ kernel (``csrc/flash_attention.cu``).

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

_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)     # instantiated in csrc/flash_attention.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
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
        err = _kernel("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], D, scale, int(causal),
            _DTYPES[q.dtype], _stream(q))
        launch_counts["flash_attention_fwd"] += 1
        _check_launch("flash_attention_fwd", err)
    return o, lse


def launch_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, *, causal: bool, sm_scale: float):
    """One launch of the dK/dV kernel into ``dk``/``dv`` (CUDA tensors that
    ``flash_attention_backward`` has checked; ``do`` in q's dtype, ``delta``
    fp32 ``[B, H, S]``)."""
    B, S, H, D = q.shape
    err = _kernel("flash_attention_bwd_dkdv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], D,
        sm_scale, int(causal), _DTYPES[q.dtype], _stream(q))
    launch_counts["flash_attention_bwd_dkdv"] += 1
    _check_launch("flash_attention_bwd_dkdv", err)


def launch_bwd_dq(q, k, v, do, lse, delta, dq, *, causal: bool, sm_scale: float):
    """One launch of the dQ kernel into ``dq`` (see :func:`launch_bwd_dkdv`)."""
    B, S, H, D = q.shape
    err = _kernel("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2], D, sm_scale,
        int(causal), _DTYPES[q.dtype], _stream(q))
    launch_counts["flash_attention_bwd_dq"] += 1
    _check_launch("flash_attention_bwd_dq", err)


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
    Pallas interpreter switch) is accepted and ignored."""
    _check_shapes(q, k, v)
    check_block("block_q", q.shape[1], block_q, DEFAULT_BLOCK_Q)
    check_block("block_k", k.shape[1], block_k, DEFAULT_BLOCK_K)
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 _scale(sm_scale, q.shape[-1]))
