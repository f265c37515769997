"""ZeRO as sharding rules: the port of
``deepspeed_tpu/runtime/zero/sharding.py``.

The JAX package expresses ZeRO declaratively, a ``PartitionSpec`` per tensor
over the mesh. These rules keep that vocabulary: a spec is a plain tuple
with one entry per dim, ``None``, an axis name or a tuple of names (the
entries of the JAX ``PartitionSpec``), and :meth:`ZeroShardingRules.shardings`
maps specs to ``torch.distributed.tensor`` placements over the topology's
``DeviceMesh``. The port's engine partitions by a flat layout instead
(``partition.py``: DeepSpeed's own stage-1/2/3 partition); the rules say
which state each stage shards.

Stage semantics (over the "fsdp" axes = dp_outer x ep x sp):
  0: replicate params, grads, optimizer state (plain DP)
  1: shard optimizer state (+ fp32 master params, which are optimizer state)
  2: + accumulated gradients sharded
  3: + parameters sharded

ZeRO claims the largest free dim divisible by the fsdp axis size, and leaves
small or indivisible params replicated (the analogue of stage 3's
``param_persistence_threshold``). MiCS (``mics_shard_size``) shards over the
expert axis, which the port's topology does not build yet.
"""

import math
from typing import Optional, Sequence, Tuple

from torch.utils import _pytree as pytree

from ...parallel.topology import Topology

Spec = Tuple


def _spec_tuple(spec: Optional[Sequence], ndim: int) -> Spec:
    t = tuple(spec) if spec is not None else ()
    return t + (None,) * (ndim - len(t))


def _axes_in_spec(spec: Spec) -> set:
    used = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x))


def shard_param_spec(shape: Sequence[int],
                     base_spec: Optional[Sequence],
                     shard_axes: Tuple[str, ...],
                     axis_size: int,
                     min_size_to_shard: int = 2 ** 11) -> Spec:
    """Add ZeRO sharding over ``shard_axes`` to ``base_spec``.

    Picks the largest dim divisible by ``axis_size`` that the base (model
    parallel) spec leaves free, preferring earlier dims on ties. Params
    smaller than ``min_size_to_shard`` keep the base spec."""
    ndim = len(shape)
    base = _spec_tuple(base_spec, ndim)
    if axis_size == 1 or math.prod(shape or (1,)) < min_size_to_shard:
        return base
    if set(shard_axes) & _axes_in_spec(base):
        return base   # the model shards over (some of) these axes already
    best, best_size = -1, 0
    for d in range(ndim):
        if base[d] is None and shape[d] % axis_size == 0 and shape[d] > best_size:
            best, best_size = d, shape[d]
    if best < 0:
        return base
    new = list(base)
    new[best] = tuple(shard_axes) if len(shard_axes) > 1 else shard_axes[0]
    return tuple(new)


class ZeroShardingRules:
    """Resolved sharding policy for one engine instance."""

    def __init__(self, stage: int, topo: Topology, *,
                 mics_shard_size: int = -1,
                 min_size_to_shard: int = 2 ** 11):
        if mics_shard_size and mics_shard_size > 0:
            raise NotImplementedError(
                f"mics_shard_size={mics_shard_size} is not ported yet: MiCS shards over "
                "the expert axis, which the port's topology does not build: ROADMAP.md "
                "Queue A item 8 (parallelism side paths)")
        self.stage = stage
        self.topo = topo
        self.min_size_to_shard = min_size_to_shard
        self.fsdp_axes: Tuple[str, ...] = tuple(topo.fsdp_axes)
        self.fsdp_size = topo.axis_size(*self.fsdp_axes)

    # -- per-tensor specs ------------------------------------------------
    def param_spec(self, shape, base_spec: Optional[Sequence]) -> Spec:
        if self.stage >= 3:
            return shard_param_spec(shape, base_spec, self.fsdp_axes, self.fsdp_size,
                                    self.min_size_to_shard)
        return _spec_tuple(base_spec, len(shape))

    def opt_state_spec(self, shape, base_spec: Optional[Sequence]) -> Spec:
        if self.stage >= 1:
            return shard_param_spec(shape, base_spec, self.fsdp_axes, self.fsdp_size,
                                    self.min_size_to_shard)
        return _spec_tuple(base_spec, len(shape))

    def grad_accum_spec(self, shape, base_spec: Optional[Sequence]) -> Spec:
        if self.stage >= 2:
            return shard_param_spec(shape, base_spec, self.fsdp_axes, self.fsdp_size,
                                    self.min_size_to_shard)
        return _spec_tuple(base_spec, len(shape))

    # -- tree-level helpers ----------------------------------------------
    def param_spec_tree(self, params, base_specs=None):
        return self._map_tree(params, base_specs, self.param_spec)

    def opt_spec_tree(self, params, base_specs=None):
        return self._map_tree(params, base_specs, self.opt_state_spec)

    def grad_spec_tree(self, params, base_specs=None):
        return self._map_tree(params, base_specs, self.grad_accum_spec)

    def _map_tree(self, params, base_specs, fn):
        if base_specs is None:
            return pytree.tree_map(lambda p: fn(tuple(p.shape), None), params)
        specs, _ = pytree.tree_flatten(base_specs, is_leaf=_is_spec)
        leaves, tree = pytree.tree_flatten(params)
        if len(specs) != len(leaves):
            raise ValueError(f"base_specs has {len(specs)} specs for {len(leaves)} params")
        return pytree.tree_unflatten([fn(tuple(p.shape), s) for p, s in zip(leaves, specs)],
                                     tree)

    def shardings(self, spec_tree):
        """Each spec as ``torch.distributed.tensor`` placements over the
        topology's mesh (one mesh dim, the dp ranks): ``(Shard(d),)`` for
        the dim that names an fsdp axis of size > 1, else
        ``(Replicate(),)``. Use them with ``topo.mesh``, e.g.
        ``distribute_tensor(t, topo.mesh, placements)``."""
        from torch.distributed.tensor import Replicate, Shard

        live = {a for a in self.fsdp_axes if self.topo.axis_size(a) > 1}

        def place(spec):
            for d, entry in enumerate(spec):
                names = entry if isinstance(entry, tuple) else (entry,)
                if live & set(names):
                    return (Shard(d),)
            return (Replicate(),)

        return pytree.tree_map(place, spec_tree, is_leaf=_is_spec)
