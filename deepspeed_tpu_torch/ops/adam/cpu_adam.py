"""Host Adam of ZeRO-Offload: the port of ``deepspeed_tpu/ops/adam/cpu_adam.py``.

Reference ``DeepSpeedCPUAdam`` (``deepspeed/ops/adam/cpu_adam.py:13`` over
``csrc/adam/cpu_adam_impl.cpp``): the optimizer step runs on the host,
against fp32 master weights and Adam moments that never reach the card.
The kernel is the port's own copy of the JAX package's C++ source,
``ops/csrc/host/cpu_adam.cpp``, built with ``g++`` at first use
(``ops/_build.load_host``) and bound with ``ctypes``; it runs on the CPU
here as on the card's host. A failed build raises: nothing falls back.

``DeepSpeedCPUAdam`` owns the host state of a whole parameter tree: the fp32
masters and ``exp_avg`` / ``exp_avg_sq`` as contiguous CPU tensors (pageable:
only the engine's transfer ring is pinned). ``step`` takes the gradient
tree (fp32, or bf16, which the kernel widens in its loop), updates the
masters and moments in place and returns the masters (copies) or their bf16
rounding (``emit_bf16``), written into ``out`` when the caller gives
buffers. ``begin_step`` + ``step_slices`` is the same update walked over
element ranges of the leaves (the engine's ring chunks): one step counted
for the whole walk, and the kernel's update being elementwise, the same
bits as ``step``. ``cpu_adam_reference`` is the same update in plain torch
fp32 operations, in the kernel's order, for the tests.
"""

import ctypes
import ctypes.util
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: kernel launches: one per leaf update, or per slice of a leaf on a walk
#: (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"cpu_adam": 0}

_SOURCE = "cpu_adam.cpp"
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _F, _F, _I, _I, _I, _P, _I]


def reset_launch_counts() -> None:
    launch_counts["cpu_adam"] = 0


class CPUAdamBuilder:
    """Build (``g++``, at first use) and load the host Adam library (the JAX
    package's ``CPUAdamBuilder``)."""

    NAME = "cpu_adam"

    def load(self) -> ctypes.CDLL:
        from .._build import load_host

        lib = load_host(_SOURCE)
        for fn in (lib.dstpu_cpu_adam, lib.dstpu_cpu_adam_bf16g):
            if fn.argtypes is None:
                fn.argtypes = _SIGNATURE
                fn.restype = None
        return lib

    def is_compatible(self) -> bool:
        try:
            self.load()
            return True
        except (OSError, RuntimeError):
            return False


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _host_fp32(p) -> torch.Tensor:
    """A contiguous fp32 CPU copy (never an alias of the caller's tensor)."""
    return torch.as_tensor(p).detach().to("cpu", torch.float32, copy=True).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


class DeepSpeedCPUAdam:
    """Host-resident Adam over a parameter tree (torch tensors on any device,
    or numpy arrays). Float leaves get fp32 masters and zero moments; other
    leaves pass through untouched (their moments are None)."""

    def __init__(self, params: Any, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True,
                 nthreads: int = 0):
        self.lib = CPUAdamBuilder().load()
        self.lr = float(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.bias_correction = bool(bias_correction)
        self.nthreads = int(nthreads)
        self.step_count = 0
        leaves, self._spec = pytree.tree_flatten(params)
        leaves = [torch.as_tensor(p) for p in leaves]
        self._p = [_host_fp32(p) if _is_float(p) else p for p in leaves]
        self._m = [torch.zeros_like(p) if _is_float(p) else None for p in self._p]
        self._v = [torch.zeros_like(p) if _is_float(p) else None for p in self._p]

    # the state as trees of the parameters' structure (live tensors) ------
    @property
    def master(self):
        return pytree.tree_unflatten(self._p, self._spec)

    @property
    def exp_avg(self):
        return pytree.tree_unflatten(self._m, self._spec)

    @property
    def exp_avg_sq(self):
        return pytree.tree_unflatten(self._v, self._spec)

    def leaves(self) -> Tuple[List[Any], List[Any], List[Any]]:
        """The masters and both moments, flat in tree order (live tensors)."""
        return self._p, self._m, self._v

    def _leaf_step(self, p, m, v, g, lr, out_bf16):
        fn = self.lib.dstpu_cpu_adam_bf16g if g.dtype == torch.bfloat16 else \
            self.lib.dstpu_cpu_adam
        fn(_ptr(p), _ptr(m), _ptr(v), _ptr(g), p.numel(), lr, self.b1, self.b2,
           self.eps, self.weight_decay, self.step_count, int(self.adamw_mode),
           int(self.bias_correction), _ptr(out_bf16), self.nthreads)
        launch_counts["cpu_adam"] += 1

    def step(self, grads: Any, lr: Optional[float] = None, emit_bf16: bool = False,
             out: Optional[Any] = None) -> Any:
        """One fused update over the whole tree; returns the updated masters
        (copies) or, with ``emit_bf16``, their round-to-nearest-even bf16
        copies made in the same pass. ``out`` (a tree or list of CPU tensors
        congruent with the parameters) receives the result instead: bf16
        buffers with ``emit_bf16``, else buffers of any float dtype that the
        masters are copied into; it is returned."""
        self.step_count += 1
        lr_t = self.lr if lr is None else float(lr)
        flat_g = pytree.tree_leaves(grads)
        if len(flat_g) != len(self._p):
            raise ValueError(f"{len(flat_g)} gradient leaves for {len(self._p)} parameters")
        flat_out = pytree.tree_leaves(out) if out is not None else [None] * len(self._p)
        results = []
        for p, m, v, g, o in zip(self._p, self._m, self._v, flat_g, flat_out):
            if m is None:                       # a non-float leaf passes through
                results.append(p)
                continue
            g = torch.as_tensor(g).detach()
            if g.device.type != "cpu" or g.dtype not in (torch.float32, torch.bfloat16):
                g = g.to("cpu", torch.float32)
            g = g.contiguous()
            if g.shape != p.shape:
                raise ValueError(f"gradient of shape {tuple(g.shape)} for a parameter of "
                                 f"shape {tuple(p.shape)}")
            ob = None
            if emit_bf16:
                ob = o if o is not None else torch.empty(p.shape, dtype=torch.bfloat16)
                if (ob.dtype != torch.bfloat16 or ob.device.type != "cpu"
                        or not ob.is_contiguous() or ob.shape != p.shape):
                    raise ValueError("emit_bf16 writes contiguous bf16 CPU tensors of "
                                     "the parameters' shapes")
            self._leaf_step(p, m, v, g, lr_t, ob)
            if emit_bf16:
                results.append(ob)
            elif o is not None:
                o.copy_(p)
                results.append(o)
            else:
                results.append(p.clone())
        return out if out is not None else pytree.tree_unflatten(results, self._spec)

    def begin_step(self) -> int:
        """Count one optimizer step (the bias correction's ``t``) for a walk
        of :meth:`step_slices` over the leaves; returns the count."""
        self.step_count += 1
        return self.step_count

    def step_slices(self, slices, lr: Optional[float] = None,
                    emit_bf16: bool = False) -> None:
        """Update element ranges of leaves at the step counted by the last
        :meth:`begin_step`: ``slices`` holds ``(leaf, a, b, grad, out)``, the
        flattened leaf's elements ``[a, b)``, their gradient (a contiguous
        1-D CPU tensor, fp32 or bf16) and a contiguous 1-D CPU tensor that
        receives their bf16 rounding (``emit_bf16``) or a copy of the
        updated masters (None: nothing)."""
        lr_t = self.lr if lr is None else float(lr)
        for i, a, b, g, o in slices:
            p, m, v = (x.view(-1)[a:b] for x in (self._p[i], self._m[i], self._v[i]))
            if g.shape != p.shape or not g.is_contiguous() or g.device.type != "cpu":
                raise ValueError(f"slice [{a}, {b}) of leaf {i}: a gradient of shape "
                                 f"{tuple(g.shape)} on {g.device}")
            if emit_bf16 and (o is None or o.dtype != torch.bfloat16
                              or not o.is_contiguous() or o.shape != p.shape):
                raise ValueError("emit_bf16 writes contiguous bf16 CPU slices")
            self._leaf_step(p, m, v, g, lr_t, o if emit_bf16 else None)
            if o is not None and not emit_bf16:
                o.copy_(p)

    # -- checkpoint support ----------------------------------------------
    def state_dict(self):
        return {"step": self.step_count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq, "master": self.master}

    @staticmethod
    def _restore(dst: List[Any], src: Any, what: str) -> None:
        """Copy ``src``'s leaves into ``dst`` IN PLACE (float leaves as fp32;
        non-float leaves keep their dtype)."""
        leaves = pytree.tree_leaves(src)
        live = [d for d in dst if d is not None]
        if len(leaves) != len(live):
            raise ValueError(f"{what}: {len(leaves)} leaves, the optimizer's {len(live)}")
        with torch.no_grad():
            for d, s in zip(live, leaves):
                s = torch.as_tensor(s)
                if s.shape != d.shape:
                    raise ValueError(f"{what}: shape {tuple(s.shape)}, the optimizer's "
                                     f"{tuple(d.shape)}")
                d.copy_(s)

    def load_state_dict(self, sd) -> None:
        self.step_count = int(sd["step"])
        self._restore(self._m, sd["exp_avg"], "exp_avg")
        self._restore(self._v, sd["exp_avg_sq"], "exp_avg_sq")
        self._restore(self._p, sd["master"], "master")

    def reseed_masters(self, params) -> None:
        """Overwrite the fp32 masters from a (loaded) parameter tree, keeping
        the moments: what a checkpoint without host optimizer state gives."""
        self._restore(self._p, params, "master")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

_libm = None


def _powf(base: float, exp: float) -> np.float32:
    """``powf`` of the C library, which the kernel's ``std::pow(float,
    float)`` calls: the bias correction rounded as the kernel rounds it."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        _libm = lib
    return np.float32(_libm.powf(base, exp))


def _fma(a, b, c) -> torch.Tensor:
    """``fmaf(a, b, c)`` elementwise: ``a * b + c`` rounded once to float32.
    The product of two floats is exact in float64 and the sum is rounded to
    float64 and then to float32. Two roundings differ from one only where
    the float64 sum lies exactly halfway between two floats and the exact
    sum does not: the sum's exact error (TwoSum) then says which way to
    round."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    d = s - f.double()
    toward = torch.where(d > 0, torch.tensor(float("inf")), torch.tensor(float("-inf")))
    g = torch.nextafter(f, toward.float())
    tie = (d != 0) & (s == (f.double() + g.double()) / 2)
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), g, f)


def cpu_adam_reference(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, lr: float, betas: Sequence[float] = (0.9, 0.999),
                       eps: float = 1e-8, weight_decay: float = 0.0,
                       adamw_mode: bool = True, bias_correction: bool = True,
                       step: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's update of one leaf in plain torch float32 operations, in
    its order and with its four fused multiply-adds (scalars rounded to
    float32 as the C ABI passes them): returns new ``(p, m, v)``; the inputs
    are not modified. ``g`` may be bf16 (widened exactly)."""
    f32 = np.float32
    b1, b2, lr, eps, wd = f32(betas[0]), f32(betas[1]), f32(lr), f32(eps), f32(weight_decay)
    bc1 = bc2 = f32(1.0)
    if bias_correction:
        bc1 = f32(1.0) - _powf(b1, f32(step))
        bc2 = f32(1.0) - _powf(b2, f32(step))
    t = lambda x: torch.tensor(float(x), dtype=torch.float32)
    g = g.float()
    if not adamw_mode:
        g = _fma(t(wd), p, g)
    m = _fma(t(b1), m, t(f32(1.0) - b1) * g)
    v = _fma(t(b2), v, t(f32(1.0) - b2) * g * g)
    # divisors as whole tensors: torch divides by a 0-dim CPU tensor as a
    # multiplication by its reciprocal, which rounds twice. The square root
    # is taken in float64 and rounded once to float32, which is the
    # correctly rounded float32 root (torch's float32 sqrt on the CPU is
    # within half an ulp plus a little, not correctly rounded)
    full = lambda x: torch.full_like(m, float(x))
    root = (v / full(bc2)).double().sqrt().float()
    upd = t(-lr) * (m / full(bc1)) / (root + t(eps))
    if adamw_mode:
        upd = _fma(t(-(lr * wd)), p, upd)
    return p + upd, m, v
