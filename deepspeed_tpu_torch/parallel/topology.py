"""The parallel topology: named mesh axes over ``torch.distributed``.

Port of ``deepspeed_tpu/parallel/topology.py``. The JAX package lays its
devices out as a five-axis ``Mesh`` ``(pp, dp_outer, ep, sp, tp)`` and names
a group by its axes; the data-parallel group is the axis pair
``(dp_outer, ep)``. Here each rank is one process and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world, whose
dimension groups are the process groups that ``comm`` collectives run over
when they are given axis names.

This port builds the data-parallel and the tensor-parallel axes: ``pp``,
``ep`` or ``sp`` above 1 raise ``NotImplementedError`` (ROADMAP.md Queue A
item 8), so ``dp_outer`` is the dp axis and the other size-1 axes need no
group. The mesh is ``(dp, tp)`` with ``tp`` innermost, as the JAX mesh puts
it: the ranks of one tp row are consecutive, ``rank = dp_index * tp +
tp_index``, and each tp row and each dp column is a process group.
"""

import dataclasses
from typing import Optional, Tuple

PP_AXIS = "pp"
DP_OUTER_AXIS = "dp_outer"
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"
DP_AXIS = "dp"   # the mesh dimension of the data-parallel ranks
ALL_AXES = (PP_AXIS, DP_OUTER_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Parallelism degrees; dp is inferred from the world size."""
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    dp: Optional[int] = None  # None => infer

    def resolve_dp(self, world: int) -> int:
        denom = self.pp * self.sp * self.tp
        if world % denom != 0:
            raise ValueError(f"world size {world} not divisible by pp*sp*tp={denom}")
        dp = world // denom
        if self.dp is not None and self.dp != dp:
            raise ValueError(f"data_parallel_size={self.dp} inconsistent with "
                             f"world={world}, pp*sp*tp={denom}")
        if dp % self.ep != 0:
            raise ValueError(f"expert parallel size {self.ep} must divide dp size {dp}")
        return dp


class Topology:
    """The resolved topology of this process's world (the process group's
    size, 1 when none is up)."""

    def __init__(self, spec: TopologySpec = TopologySpec()):
        from .. import comm

        over = {k: getattr(spec, k) for k in ("pp", "ep", "sp") if getattr(spec, k) > 1}
        if over:
            raise NotImplementedError(
                f"parallel axes {over} are not ported yet: ROADMAP.md Queue A item 8 "
                "(pipeline, expert and sequence parallelism)")
        self.spec = spec
        self.world_size = comm.get_world_size()
        self.dp_size = spec.resolve_dp(self.world_size)
        self.tp_size = int(spec.tp)
        self.pp_size = self.ep_size = self.sp_size = 1
        self.dp_outer_size = self.dp_size
        self._sizes = {PP_AXIS: 1, DP_OUTER_AXIS: self.dp_size, EP_AXIS: 1, SP_AXIS: 1,
                       TP_AXIS: self.tp_size, DP_AXIS: self.dp_size}
        self.mesh = None
        if self.world_size > 1:
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh

            if not comm.is_initialized() or dist.get_world_size() != self.world_size:
                raise ValueError(f"a mesh of {self.world_size} ranks needs a process group "
                                 "of that size (comm.init_distributed)")
            # gloo carries CUDA tensors too; a mesh over it is a host mesh
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self.mesh = init_device_mesh(device_type, (self.dp_size, self.tp_size),
                                         mesh_dim_names=(DP_AXIS, TP_AXIS))

    # ---- group-like accessors (reference deepspeed/utils/groups.py) -----
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return (DP_OUTER_AXIS, EP_AXIS)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """The axes ZeRO shards over: dp and sp, whose ranks replicate
        data-parallel state (JAX ``Topology.fsdp_axes``)."""
        return (DP_OUTER_AXIS, EP_AXIS, SP_AXIS)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return ALL_AXES

    def axis_size(self, *names: str) -> int:
        s = 1
        for n in names:
            if n not in self._sizes:
                raise ValueError(f"unknown mesh axis {n!r}; known: {sorted(self._sizes)}")
            s *= self._sizes[n]
        return s

    def group(self, *names: str):
        """The process group over the named axes (only axes of size above 1
        count; collectives over a size-1 axis never ask for one)."""
        live = {DP_AXIS if n == DP_OUTER_AXIS else n
                for n in names if self.axis_size(n) > 1}
        if live == {DP_AXIS}:
            return self.mesh.get_group(DP_AXIS)
        if live == {TP_AXIS}:
            return self.mesh.get_group(TP_AXIS)
        if live == {DP_AXIS, TP_AXIS}:
            import torch.distributed as dist

            return dist.group.WORLD
        raise ValueError(f"no process group for axes {names} (sizes "
                         f"{[self.axis_size(n) for n in names]})")

    @property
    def dp_group(self):
        """The data-parallel process group (None at dp size 1)."""
        return self.mesh.get_group(DP_AXIS) if self.dp_size > 1 else None

    @property
    def tp_group(self):
        """The tensor-parallel process group of this rank's tp row (None at
        tp size 1)."""
        return self.mesh.get_group(TP_AXIS) if self.tp_size > 1 else None

    def filter_spec(self, spec, shape) -> tuple:
        """Drop spec entries whose dim does not divide over their mesh axes
        (JAX ``Topology.filter_spec``: e.g. GQA kv heads fewer than tp, which
        AutoTP replicates). A spec is a tuple of axis names, tuples of names
        or None, one per leading dim."""
        entries = list(spec) + [None] * (len(shape) - len(spec))

        def ok(i, entry):
            if entry is None:
                return False
            names = entry if isinstance(entry, tuple) else (entry,)
            return shape[i] % self.axis_size(*names) == 0

        return tuple(e if ok(i, e) else None for i, e in enumerate(entries))

    def __repr__(self):
        return (f"Topology(pp={self.pp_size}, dp={self.dp_size} (outer={self.dp_outer_size},"
                f" ep={self.ep_size}), sp={self.sp_size}, tp={self.tp_size},"
                f" world={self.world_size})")


# the process's topology, set by initialize() (reference: groups module globals)
_TOPOLOGY: Optional[Topology] = None


def set_topology(topo: Topology) -> None:
    global _TOPOLOGY
    _TOPOLOGY = topo


def get_topology() -> Topology:
    """The topology set last, or a data-parallel one over the current world
    (rebuilt when the world has changed since)."""
    global _TOPOLOGY
    from .. import comm

    if _TOPOLOGY is None or _TOPOLOGY.world_size != comm.get_world_size():
        _TOPOLOGY = Topology()
    return _TOPOLOGY


def reset_topology() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None
