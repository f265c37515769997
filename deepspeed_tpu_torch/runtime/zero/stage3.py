"""ZeRO stage 3's gather-on-use over the flat partition.

The JAX package's stage 3 shards the parameters and lets XLA all-gather
each one where the step uses it (``deepspeed_tpu/runtime/zero/sharding.py``);
the reference gathers each module's parameters in a hook before its
forward and again before its backward, and frees them after. Here the
granule is a *unit*: a top-level subtree of the parameter tree, in tree
order (``embed``, ``layer_0`` ... ``layer_{L-1}``, ``final_norm``,
``lm_head`` for a ``TransformerLM``), whose leaves are a contiguous range
of the flat layout (``partition.py``).

Each unit owns one storage of the compute dtype, and the loss function runs
on fixed leaf tensors that alias it (``set_`` views with their own version
counters). The storage is empty (``resize_(0)``) until the unit is needed:

* a ``TorchFunctionMode`` sees every torch call of the forward, of the
  backward's Python code and of a remat recompute; the first call that
  touches a tensor living in an empty unit's storage gathers the unit (the
  ranks' fp32 parts of it cast to the compute dtype, ``all_gather_range``),
  so any loss function, not only ``TransformerLM``'s, runs on gathered
  weights;
* a saved-tensors hook marks every saved tensor that lives in a unit's
  storage, and unpacking it in the backward gathers the unit again;
* in the forward at most :data:`MAX_LIVE` units stay gathered: the least
  recently used one that the current call does not touch is freed; in the
  backward a unit is freed once every one of its leaves has its gradient
  (a remat recompute gathers the units it runs on, and they stay until
  their gradients are done, so a recompute of the whole loss keeps every
  unit it ran on);
* a post-accumulate-grad hook on each leaf copies its gradient into the
  unit's gradient buffer and drops it; once the unit's last leaf has its
  gradient, the buffer is mean-reduced in fp32 and this rank's part added
  into its ``shard_grad`` (``reduce_scatter_range``), or, while the caller defers
  the reduction (``no_sync``), added into a full local fp32 buffer
  (``local``) that the caller reduce-scatters later. :meth:`finish` reduces
  the units whose gradients did not all arrive (a leaf the loss does not
  reach), in unit order, and frees every unit.

The gradient half is :class:`UnitReduce`, which stage 2 uses alone: its
fp32 masters are whole on every rank, and each unit's gradients are
reduced into the shard accumulator as the backward finishes them, so no
rank holds a full gradient buffer (JAX: the gradient accumulators take a
dp-sharded spec from stage 2, ``sharding.py``).

Every rank runs the same collectives in the same order as long as the
ranks' graphs are the same, which data parallelism gives.
"""

import collections
import contextlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import _disable_current_modes

from .partition import FlatPartition

#: units the forward keeps gathered at once (more only while one call
#: touches more)
MAX_LIVE = 2


def tree_units(paths: Sequence[tuple]) -> List[Tuple[str, int, int]]:
    """``(name, first leaf, end leaf)`` for each top-level subtree, from the
    key paths of the flattened tree (``tree_flatten_with_path``); a leaf at
    the top level is a unit of its own."""
    units: List[Tuple[str, int, int]] = []
    for i, path in enumerate(paths):
        key = str(path[0]).strip("[]'.") if path else ""
        if units and units[-1][0] == key and len(path) > 1:
            units[-1] = (key, units[-1][1], i + 1)
        else:
            units.append((key, i, i + 1))
    return units


def _storage_key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):    # a tensor without a storage
        return None


class _Saved:
    """A saved tensor that lives in unit ``unit``'s storage."""
    __slots__ = ("unit", "tensor")

    def __init__(self, unit: int, tensor: torch.Tensor):
        self.unit, self.tensor = unit, tensor


class _GatherOnUse(TorchFunctionMode):
    def __init__(self, units: "UnitGather"):
        super().__init__()
        self.units = units

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        units = self.units
        if not units.busy:
            need = units.units_in(itertools.chain(args, kwargs.values()))
            if need:
                units.use(need)
        return func(*args, **kwargs)


class UnitReduce:
    """The gradients of the leaves over ``part``, reduced into
    ``shard_grad`` a unit at a time as the backward finishes each unit: a
    leaf's post-accumulate-grad hook (:meth:`grad_hook`) copies its
    gradient into the unit's buffer and drops it; once the unit's last
    trainable leaf (``trainable``, default all) has its gradient, the buffer
    is mean-reduced in fp32 and this rank's part added into ``shard_grad``
    (``reduce_scatter_range``, buckets of ``reduce_bucket`` elements), or,
    while :attr:`defer` is set (``no_sync``), added into the full local fp32
    buffer :attr:`local`. At most the units whose leaves are arriving hold
    a buffer at once."""

    def __init__(self, part: FlatPartition, units: Sequence[Tuple[str, int, int]],
                 shard_grad: torch.Tensor, reduce_bucket: int,
                 trainable: Optional[Sequence[bool]] = None):
        self.part, self.shard_grad, self.reduce_bucket = part, shard_grad, reduce_bucket
        trainable = [True] * len(part.shapes) if trainable is None else list(trainable)
        #: per unit: (name, first leaf, end leaf, flat lo, flat hi)
        self.units = []
        for name, i0, i1 in units:
            lo = part.offsets[i0] if i1 > i0 else 0
            hi = part.offsets[i1 - 1] + part.numels[i1 - 1] if i1 > i0 else 0
            self.units.append((name, i0, i1, lo, hi))
        self._need = [sum(trainable[i0:i1]) for _, i0, i1, _, _ in self.units]
        self._left = list(self._need)
        self._grad_buf: Dict[int, torch.Tensor] = {}
        self._reduced = set()
        self.busy = False
        #: add the units' gradients into ``local`` instead of reducing them
        self.defer = False
        self.local: Optional[torch.Tensor] = None
        #: the most bytes of unit gradient buffers alive at once
        self.peak_buffer_bytes = 0

    def grad_hook(self, u: int, off: int):
        """The post-accumulate-grad hook of the leaf at element ``off`` of
        unit ``u``."""
        def hook(p: torch.Tensor) -> None:
            self.busy = True
            try:
                buf = self._grad_buf.get(u)
                if buf is None:
                    _, _, _, lo, hi = self.units[u]
                    buf = self._grad_buf[u] = torch.zeros(hi - lo, dtype=p.grad.dtype,
                                                          device=p.grad.device)
                    self.peak_buffer_bytes = max(self.peak_buffer_bytes, sum(
                        b.numel() * b.element_size() for b in self._grad_buf.values()))
                buf[off:off + p.numel()].copy_(p.grad.reshape(-1))
                p.grad = None
                self._left[u] -= 1
                if self._left[u] == 0:
                    self._reduce(u)
            finally:
                self.busy = False
        return hook

    def _reduce(self, u: int) -> None:
        """The unit's gradients (zeros where none arrived) into the shard
        accumulator, or into ``local`` while deferred."""
        _, i0, i1, lo, hi = self.units[u]
        buf = self._grad_buf.pop(u, None)
        if buf is None:
            buf = torch.zeros(hi - lo, dtype=self.shard_grad.dtype,
                              device=self.shard_grad.device)
        with torch.no_grad():
            if self.defer:
                if self.local is None:
                    self.local = torch.zeros(self.part.padded, dtype=self.shard_grad.dtype,
                                             device=self.shard_grad.device)
                self.local[lo:hi].add_(buf)
            else:
                self.part.reduce_scatter_range(buf, lo, hi, self.shard_grad,
                                               self.reduce_bucket)
        self._reduced.add(u)
        self._left[u] = self._need[u]
        self._unit_done(u)

    def _unit_done(self, u: int) -> None:
        """Called once unit ``u``'s gradients are reduced."""

    def finish(self) -> None:
        """After a backward: reduce every unit with trainable leaves not
        reduced yet (a leaf the loss does not reach), in unit order, so
        every rank calls the same collectives."""
        self.busy = True
        try:
            for u in range(len(self.units)):
                if u not in self._reduced and self._need[u]:
                    self._reduce(u)
        finally:
            self.busy = False
        self._reduced.clear()


class UnitGather(UnitReduce):
    """The compute-dtype leaves of stage 3 over ``part`` (one per leaf, in
    tree order: :attr:`leaves`), gathered a unit at a time from ``shard``
    (this rank's fp32 masters) on use, their gradients reduce-scattered
    into ``shard_grad`` a unit at a time (:class:`UnitReduce`), after
    which the unit is freed."""

    def __init__(self, part: FlatPartition, units: Sequence[Tuple[str, int, int]],
                 shard: torch.Tensor, shard_grad: torch.Tensor, dtype: torch.dtype,
                 gather_bucket: int, reduce_bucket: int):
        super().__init__(part, units, shard_grad, reduce_bucket)
        self.shard, self.dtype, self.gather_bucket = shard, dtype, gather_bucket
        dev = shard.device
        self.leaves: List[torch.Tensor] = []
        self._storages, self._writers = [], []
        self._by_storage: Dict[int, int] = {}
        for u, (_, i0, i1, lo, hi) in enumerate(self.units):
            storage = torch.empty(hi - lo, dtype=dtype, device=dev).untyped_storage()
            alias = lambda off, shape: torch.empty(0, dtype=dtype, device=dev).set_(
                storage, off, shape)
            for i in range(i0, i1):
                leaf = alias(part.offsets[i] - lo, part.shapes[i]).requires_grad_(True)
                leaf.register_post_accumulate_grad_hook(self.grad_hook(u, part.offsets[i] - lo))
                self.leaves.append(leaf)
            self._writers.append(alias(0, (hi - lo,)))
            self._storages.append(storage)
            self._by_storage[storage._cdata] = u
            storage.resize_(0)
        size = torch.empty(0, dtype=dtype).element_size()
        self._nbytes = [(hi - lo) * size for _, _, _, lo, hi in self.units]
        self._live: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self.backward = False
        #: the most units, and their bytes, gathered at once, and the unit
        #: gathers, in the forward and in the backward
        self.peak_units = {"forward": 0, "backward": 0}
        self.peak_bytes = {"forward": 0, "backward": 0}
        self.gathers = {"forward": 0, "backward": 0}

    @property
    def live(self) -> List[str]:
        """The names of the units gathered now."""
        return [self.units[u][0] for u in self._live]

    # -- gather and free ------------------------------------------------
    def units_in(self, args) -> Optional[set]:
        need = None
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor):
                    u = self._by_storage.get(_storage_key(t))
                    if u is not None:
                        need = need or set()
                        need.add(u)
        return need

    def use(self, need) -> None:
        """Gather the units in ``need`` that are not, mark them used; in the
        forward, free the least recently used others past ``MAX_LIVE``."""
        for u in need:
            if u in self._live:
                self._live.move_to_end(u)
            else:
                self._gather(u)
        if not self.backward:
            extra = max(0, len(self._live) - MAX_LIVE)
            for u in [u for u in self._live if u not in need][:extra]:
                self._free(u)
        phase = "backward" if self.backward else "forward"
        self.peak_units[phase] = max(self.peak_units[phase], len(self._live))
        self.peak_bytes[phase] = max(self.peak_bytes[phase],
                                     sum(self._nbytes[u] for u in self._live))

    def _gather(self, u: int) -> None:
        _, _, _, lo, hi = self.units[u]
        self.busy = True
        try:
            self._storages[u].resize_(self._nbytes[u])
            # out of sight of the dispatch modes around the call (a remat
            # region's, which would record or replay the gather's ops)
            with torch.no_grad(), _disable_current_modes():
                self.part.all_gather_range(self.shard, lo, hi, self._writers[u],
                                           self.gather_bucket)
        finally:
            self.busy = False
        self._live[u] = None
        self.gathers["backward" if self.backward else "forward"] += 1

    def _free(self, u: int) -> None:
        self._storages[u].resize_(0)
        del self._live[u]

    def free_all(self) -> None:
        for u in list(self._live):
            self._free(u)

    # -- gradients -------------------------------------------------------
    def _unit_done(self, u: int) -> None:
        # its gradients are done: the unit is not needed again this backward
        if u in self._live:
            self._free(u)

    def finish(self) -> None:
        """After a backward: reduce every unit not reduced yet (in unit
        order), free every unit."""
        super().finish()
        self.free_all()

    # -- the contexts ------------------------------------------------------
    def _pack(self, t: torch.Tensor):
        u = self._by_storage.get(_storage_key(t))
        return t if u is None else _Saved(u, t)

    def _unpack(self, x):
        if type(x) is _Saved:
            self.use((x.unit,))
            return x.tensor
        return x

    @contextlib.contextmanager
    def on_use(self):
        """Run a forward (and its backward) inside: units gather as they are
        touched, and every unit is free again on leaving."""
        try:
            with _GatherOnUse(self), torch.autograd.graph.saved_tensors_hooks(
                    self._pack, self._unpack):
                yield
        finally:
            self.backward = False
            self.free_all()

    def run_backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()`` inside :meth:`on_use`. ``Tensor.backward`` is a
        torch function, and a mode's handler runs its call with the mode
        popped, so the backward (and the remat recompute in it) would run
        without gathering: the autograd engine is called directly, with the
        mode in force (its thread state reaches the engine's threads)."""
        self.backward = True
        try:
            torch.autograd.Variable._execution_engine.run_backward(
                (loss,), (torch.ones_like(loss),), False, False, (), True, True)
        finally:
            self.backward = False
