"""Fused Adam update: the port of ``deepspeed_tpu/ops/pallas/fused_adam.py``.

:func:`adam_update` keeps the JAX API — one tensor in, ``(update, m, v)``
out — and :func:`multi_tensor_adam` is what the optimizer calls: ONE launch
of the hand-written kernel (``csrc/fused_adam.cu``) over every tensor of a
parameter tree, through a device table of per-tensor pointers and a list of
64 K-element chunks. It updates ``m`` and ``v`` in place, and either writes
the update ``u`` into given buffers or applies ``p += u`` in place (no ``u``
buffer at all; the same fp32 ``p + u`` the engine computes).

:func:`adam_update_ref` is the plain PyTorch version of the kernel's
per-element arithmetic (the Pallas kernel's order of operations, bias
correction as ``1 - exp(step * ln beta)``). Wrappers take it only for CPU
tensors; CUDA tensors launch the kernel or raise. ``launch_counts`` counts
kernel launches.
"""

import ctypes
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: kernel launches (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"fused_adam": 0}

_SOURCE = "fused_adam.cu"
CHUNK = 1 << 16            # elements per block of the multi-tensor launch
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURE = [_P, _P, ctypes.c_int, ctypes.c_int] + [_F] * 10 + [ctypes.c_int, _P]

# device table of the last tensor list, keyed by its pointers and sizes:
# the engine's buffers are persistent, so a training run builds it once
_table_cache: Dict[tuple, tuple] = {}


def reset_launch_counts() -> None:
    launch_counts["fused_adam"] = 0


def _kernel():
    from . import _build

    fn = _build.load(_SOURCE).fused_adam_apply
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def bias_corrections(b1: float, b2: float, step, bias_correction: bool,
                     pow_correction: bool = False):
    """``(1 - exp(step * ln b1), 1 - exp(step * ln b2))`` in float32, as the
    TPU kernel computes ``beta ** step`` (a ``ln`` constant times the fp32
    step); ``(1, 1)`` when bias correction is off. The exp is rounded once
    from double: numpy's float32 exp can be an ulp off, which
    ``1 - beta ** step`` magnifies by up to ``1 / (1 - beta)``.
    ``pow_correction`` takes ``1 - beta ** step`` with the power rounded once
    from double instead, as the JAX package's plain update (XLA's pow)."""
    if not bias_correction:
        return 1.0, 1.0
    f = np.float32
    if pow_correction:
        bc = [f(1) - f(float(f(b)) ** step) for b in (b1, b2)]
    else:
        bc = [f(1) - f(math.exp(f(f(step) * f(math.log(b))))) for b in (b1, b2)]
    return float(bc[0]), float(bc[1])


def _hyper(lr, b1, b2, eps, weight_decay, bias_correction, step, pow_correction=False):
    f = lambda x: float(np.float32(x))
    bc1, bc2 = bias_corrections(b1, b2, step, bias_correction, pow_correction)
    return dict(lr=f(lr), b1=f(b1), omb1=f(1 - b1), b2=f(b2), omb2=f(1 - b2),
                eps=f(eps), wd=f(weight_decay),
                lr_wd=f(np.float32(lr) * np.float32(weight_decay)),
                bc1=bc1, bc2=bc2)


def adam_update_ref(g, m, v, p, lr, b1, b2, eps, weight_decay, adam_w_mode,
                    bias_correction, step, pow_correction=False):
    """Plain PyTorch version of the kernel on one tensor: returns
    ``(update, new_m, new_v)`` in float32 (the JAX ``adam_update``
    contract), with the kernel's order of operations. ``pow_correction``:
    see :func:`bias_corrections`."""
    h = _hyper(lr, b1, b2, eps, weight_decay, bias_correction, step, pow_correction)
    g = g.float()
    p = torch.zeros_like(g) if p is None else p.float()
    if not adam_w_mode and weight_decay:
        g = g + h["wd"] * p
    m = h["b1"] * m.float() + h["omb1"] * g
    v = h["b2"] * v.float() + h["omb2"] * g * g
    m_hat = m / h["bc1"]
    v_hat = v / h["bc2"]
    u = (-h["lr"]) * m_hat / (torch.sqrt(v_hat) + h["eps"])
    if adam_w_mode and weight_decay:
        u = u - h["lr_wd"] * p
    return u, m, v


def _device_table(tensors: Sequence[Sequence[Optional[torch.Tensor]]], device):
    """(table, chunks, n_chunks) device arrays for the multi-tensor launch:
    a row (g, p, m, v, u, numel) per tensor and a (tensor, start) pair per
    chunk; cached on the pointers, so persistent buffers build it once."""
    rows = [tuple(0 if t is None else t.data_ptr() for t in ts) + (ts[0].numel(),)
            for ts in tensors]
    key = tuple(rows)
    hit = _table_cache.get(key)
    if hit is None:
        chunks = [(i, s) for i, r in enumerate(rows) for s in range(0, r[-1], CHUNK)]
        table = torch.tensor(rows, dtype=torch.int64).to(device)
        clist = torch.tensor(chunks or [(0, 0)], dtype=torch.int64).to(device)
        hit = (table, clist, len(chunks))
        _table_cache.clear()
        _table_cache[key] = hit
    return hit


def multi_tensor_adam(grads: List[torch.Tensor], exp_avgs: List[torch.Tensor],
                      exp_avg_sqs: List[torch.Tensor], params: List[torch.Tensor], *,
                      lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                      weight_decay: float = 0.0, adam_w_mode: bool = True,
                      bias_correction: bool = True, step: int = 1,
                      updates: Optional[List[torch.Tensor]] = None,
                      pow_correction: bool = False) -> None:
    """One fused Adam step over lists of fp32 tensors. ``exp_avgs`` and
    ``exp_avg_sqs`` are updated in place; with ``updates`` the update ``u``
    is written there, else ``params`` are updated in place (``p += u``).
    One kernel launch for the whole list on the card; the plain version per
    tensor on the CPU. ``pow_correction``: see :func:`bias_corrections` (the
    kernel takes the two corrections as arguments)."""
    b1, b2 = betas
    n = len(grads)
    if not (len(exp_avgs) == len(exp_avg_sqs) == len(params) == n) or (
            updates is not None and len(updates) != n):
        raise ValueError("grads, exp_avgs, exp_avg_sqs, params (and updates) "
                         "must have one entry per tensor")
    if n == 0:
        return
    if grads[0].device.type == "cpu":
        for i in range(n):
            u, m, v = adam_update_ref(grads[i], exp_avgs[i], exp_avg_sqs[i],
                                      params[i], lr, b1, b2, eps, weight_decay,
                                      adam_w_mode, bias_correction, step,
                                      pow_correction)
            exp_avgs[i].copy_(m)
            exp_avg_sqs[i].copy_(v)
            if updates is not None:
                updates[i].copy_(u)
            else:
                params[i].add_(u)
        return
    dev = grads[0].device
    groups = [(grads[i], params[i], exp_avgs[i], exp_avg_sqs[i],
               None if updates is None else updates[i]) for i in range(n)]
    for ts in groups:
        for t in ts:
            if t is None:
                continue
            if t.device != dev:
                raise ValueError(f"fused_adam: tensor on {t.device}, grads on {dev}")
            if t.dtype != torch.float32:
                raise ValueError(f"fused_adam takes float32 tensors, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("fused_adam takes contiguous tensors")
            if t.numel() != ts[0].numel():
                raise ValueError("fused_adam: g, p, m, v (and u) sizes differ")
    table, chunks, n_chunks = _device_table(groups, dev)
    h = _hyper(lr, b1, b2, eps, weight_decay, bias_correction, step, pow_correction)
    err = _kernel()(table.data_ptr(), chunks.data_ptr(), n_chunks, CHUNK,
                    h["lr"], h["b1"], h["omb1"], h["b2"], h["omb2"], h["eps"],
                    h["wd"], h["lr_wd"], h["bc1"], h["bc2"], int(adam_w_mode),
                    torch.cuda.current_stream(dev).cuda_stream)
    launch_counts["fused_adam"] += 1
    if err != 0:
        raise RuntimeError(f"fused_adam launch failed: cudaError_t {err}")


def adam_update(g, m, v, p, lr, b1, b2, eps, weight_decay, adam_w_mode,
                bias_correction, step):
    """One fused Adam update on a single tensor (JAX ``adam_update``). All
    math fp32. Returns ``(update, new_m, new_v)`` shaped like the input."""
    if g.device.type == "cpu":
        return adam_update_ref(g, m, v, p, lr, b1, b2, eps, weight_decay,
                               adam_w_mode, bias_correction, step)
    g32 = g.float().contiguous()
    m32 = m.float().clone().contiguous()
    v32 = v.float().clone().contiguous()
    p32 = torch.zeros_like(g32) if p is None else p.float().contiguous()
    u = torch.empty_like(g32)
    multi_tensor_adam([g32], [m32], [v32], [p32], lr=lr, betas=(b1, b2), eps=eps,
                      weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                      bias_correction=bias_correction, step=step, updates=[u])
    return u, m32, v32
