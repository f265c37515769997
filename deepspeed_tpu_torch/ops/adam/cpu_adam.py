"""Host Adam of ZeRO-Offload: the port of ``deepspeed_tpu/ops/adam/cpu_adam.py``.

Reference ``DeepSpeedCPUAdam`` (``deepspeed/ops/adam/cpu_adam.py:13`` over
``csrc/adam/cpu_adam_impl.cpp``): the optimizer step runs on the host,
against fp32 master weights and Adam moments that never reach the card.
The kernel is the port's own version of the JAX package's C++ source,
``ops/csrc/host/cpu_adam.cpp``, built with ``g++`` at first use
(``ops/_build.load_host``) and bound with ``ctypes``; it runs on the CPU
here as on the card's host. A failed build raises: nothing falls back.

The library has three routes of one loop, bitwise equal: ``avx512``,
``avx2`` and ``scalar`` (:data:`ROUTES`). An optimizer takes the widest
route the CPU runs (:func:`best_route`) unless ``route`` names another;
naming one the CPU lacks raises. Its threads are a pool the library starts
once and sizes by the CPUs the process may use.

``DeepSpeedCPUAdam`` owns the host state of a whole parameter tree: the fp32
masters and ``exp_avg`` / ``exp_avg_sq`` as contiguous CPU tensors (pageable:
only the engine's transfer ring is pinned). ``step`` takes the gradient
tree (fp32, or bf16, which the kernel widens in its loop), updates the
masters and moments in place in one library call and returns the masters
(copies) or their bf16 rounding (``emit_bf16``), written into ``out`` when
the caller gives buffers. ``begin_step`` + ``step_slices`` is the same
update walked over element ranges of the leaves (the engine's ring chunks),
one library call a chunk: one step counted for the whole walk, and the
kernel's update being elementwise, the same bits as ``step``.
``cpu_adam_reference`` is the same update in plain torch fp32 operations,
in the kernel's order, for the tests.
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
#: library calls: one per ``step`` (per gradient dtype) or ``step_slices``
call_counts: Dict[str, int] = {"cpu_adam": 0}
#: the launches of ``launch_counts`` by the route that ran them
route_counts: Dict[str, int] = {"avx512": 0, "avx2": 0, "scalar": 0}

#: the library's routes, by their id in its C ABI
ROUTES = ("scalar", "avx2", "avx512")

_SOURCE = "cpu_adam.cpp"
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _F, _F, _I, _I, _I, _P, _I]
_SLICES_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I]


def reset_launch_counts() -> None:
    for counts in (launch_counts, call_counts, route_counts):
        for name in counts:
            counts[name] = 0


class CPUAdamBuilder:
    """Build (``g++``, at first use) and load the host Adam library (the JAX
    package's ``CPUAdamBuilder``)."""

    NAME = "cpu_adam"

    def load(self) -> ctypes.CDLL:
        from .._build import load_host

        lib = load_host(_SOURCE)
        if lib.dstpu_cpu_adam.argtypes is None:
            for fn in (lib.dstpu_cpu_adam, lib.dstpu_cpu_adam_bf16g):
                fn.argtypes = _SIGNATURE
                fn.restype = None
            for fn in (lib.dstpu_cpu_adam_slices, lib.dstpu_cpu_adam_slices_bf16g):
                fn.argtypes = _SLICES_SIGNATURE
                fn.restype = _I
            for fn in (lib.dstpu_cpu_adam_routes, lib.dstpu_cpu_adam_best_route,
                       lib.dstpu_cpu_adam_threads):
                fn.argtypes = []
                fn.restype = _I
            for fn in (lib.dstpu_cpu_adam_set_stream, lib.dstpu_cpu_adam_set_prefetch):
                fn.argtypes = [_I]
                fn.restype = _I
            lib.dstpu_host_stream.argtypes = [_I, _P, _P, _P, _P, _P, ctypes.c_int64, _I]
            lib.dstpu_host_stream.restype = ctypes.c_double
        return lib

    def is_compatible(self) -> bool:
        try:
            self.load()
            return True
        except (OSError, RuntimeError):
            return False


def supported_routes() -> Tuple[str, ...]:
    """The routes this CPU runs, in :data:`ROUTES` order."""
    mask = CPUAdamBuilder().load().dstpu_cpu_adam_routes()
    return tuple(r for i, r in enumerate(ROUTES) if mask >> i & 1)


def best_route() -> str:
    """The widest route this CPU runs (the one the per-leaf C entries take)."""
    return ROUTES[CPUAdamBuilder().load().dstpu_cpu_adam_best_route()]


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _host_fp32(p) -> torch.Tensor:
    """A contiguous fp32 CPU copy (never an alias of the caller's tensor)."""
    return torch.as_tensor(p).detach().to("cpu", torch.float32, copy=True).contiguous()


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


class DeepSpeedCPUAdam:
    """Host-resident Adam over a parameter tree (torch tensors on any device,
    or numpy arrays). Float leaves get fp32 masters and zero moments; other
    leaves pass through untouched (their moments are None).

    ``nthreads`` caps the threads a call uses; 0 takes all CPUs the process
    may use. ``route`` forces one of :data:`ROUTES` (None: :func:`best_route`);
    a route this CPU lacks raises ``ValueError``. It may be set later too."""

    def __init__(self, params: Any, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True,
                 nthreads: int = 0, route: Optional[str] = None):
        self.lib = CPUAdamBuilder().load()
        self.lr = float(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.bias_correction = bool(bias_correction)
        self.nthreads = int(nthreads)
        self.route = route
        self.step_count = 0
        leaves, self._spec = pytree.tree_flatten(params)
        leaves = [torch.as_tensor(p) for p in leaves]
        self._p = [_host_fp32(p) if _is_float(p) else p for p in leaves]
        self._m = [torch.zeros_like(p) if _is_float(p) else None for p in self._p]
        self._v = [torch.zeros_like(p) if _is_float(p) else None for p in self._p]

    @property
    def route(self) -> str:
        return self._route

    @route.setter
    def route(self, route: Optional[str]) -> None:
        if route is None:
            route = best_route()
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
        if route not in supported_routes():
            raise ValueError(f"the {route} route needs CPU features this host lacks "
                             f"(it runs {supported_routes()})")
        self._route = route

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

    def _launch(self, items, lr: float) -> None:
        """One library call per gradient dtype over ``items``: ``(p, m, v, g,
        out)`` with p, m, v fp32 views, g fp32 or bf16 of p's shape, out a
        bf16 tensor of p's shape or None, all contiguous CPU tensors."""
        for dtype, fn in ((torch.float32, self.lib.dstpu_cpu_adam_slices),
                          (torch.bfloat16, self.lib.dstpu_cpu_adam_slices_bf16g)):
            group = [it for it in items if it[3].dtype == dtype]
            if not group:
                continue
            p, m, v, g, out = zip(*group)
            emit = any(o is not None for o in out)
            err = fn(len(group), _pointers(p), _pointers(m), _pointers(v), _pointers(g),
                     _pointers(out) if emit else None,
                     (ctypes.c_int64 * len(group))(*[t.numel() for t in p]), lr, self.b1,
                     self.b2, self.eps, self.weight_decay, self.step_count,
                     int(self.adamw_mode), int(self.bias_correction),
                     ROUTES.index(self.route), self.nthreads)
            if err:
                raise ValueError(f"the host Adam library refused the {self.route} route")
            launch_counts["cpu_adam"] += len(group)
            route_counts[self.route] += len(group)
            call_counts["cpu_adam"] += 1

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
        items, results = [], []
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
            items.append((p, m, v, g, ob))
            results.append(ob if emit_bf16 else o)
        self._launch(items, lr_t)
        if not emit_bf16:
            results = [p if m is None else p.clone() if o is None else o.copy_(p)
                       for p, m, o in zip(self._p, self._m, results)]
        return out if out is not None else pytree.tree_unflatten(results, self._spec)

    def begin_step(self) -> int:
        """Count one optimizer step (the bias correction's ``t``) for a walk
        of :meth:`step_slices` over the leaves; returns the count."""
        self.step_count += 1
        return self.step_count

    def step_slices(self, slices, lr: Optional[float] = None,
                    emit_bf16: bool = False) -> None:
        """Update element ranges of leaves at the step counted by the last
        :meth:`begin_step`, in one library call: ``slices`` holds ``(leaf, a,
        b, grad, out)``, the flattened leaf's elements ``[a, b)``, their
        gradient (a contiguous 1-D CPU tensor, fp32 or bf16) and a contiguous
        1-D CPU tensor that receives their bf16 rounding (``emit_bf16``) or a
        copy of the updated masters (None: nothing)."""
        lr_t = self.lr if lr is None else float(lr)
        items = []
        for i, a, b, g, o in slices:
            p, m, v = (x.view(-1)[a:b] for x in (self._p[i], self._m[i], self._v[i]))
            if (g.shape != p.shape or not g.is_contiguous() or g.device.type != "cpu"
                    or g.dtype not in (torch.float32, torch.bfloat16)):
                raise ValueError(f"slice [{a}, {b}) of leaf {i}: a {g.dtype} gradient of "
                                 f"shape {tuple(g.shape)} on {g.device}")
            if emit_bf16 and (o is None or o.dtype != torch.bfloat16
                              or not o.is_contiguous() or o.shape != p.shape):
                raise ValueError("emit_bf16 writes contiguous bf16 CPU slices")
            items.append((p, m, v, g, o if emit_bf16 else None))
        self._launch(items, lr_t)
        if not emit_bf16:
            for (p, *_), (*_, o) in zip(items, slices):
                if o is not None:
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
    round. An infinite or NaN sum is no tie: it is what one rounding gives."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    d = s - f.double()
    toward = torch.where(d > 0, torch.tensor(float("inf")), torch.tensor(float("-inf")))
    g = torch.nextafter(f, toward.float())
    tie = torch.isfinite(s) & (d != 0) & (s == (f.double() + g.double()) / 2)
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), g, f)


def bf16_reference(p: torch.Tensor) -> torch.Tensor:
    """The kernel's bf16 emission of fp32 ``p`` in plain torch integer
    operations: round to nearest even on the bits, a NaN keeping its sign
    and top payload bits with the quiet bit set (``.to(torch.bfloat16)``
    agrees but for the NaN's bits)."""
    x = p.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    hi = x >> 16
    out = torch.where((x & 0x7FFFFFFF) > 0x7F800000, hi | 0x40, (x + 0x7FFF + (hi & 1)) >> 16)
    return out.to(torch.int16).view(torch.bfloat16)      # the low 16 bits


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
