"""The collective communication layer over ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py`` (reference ``deepspeed.comm``,
``comm/comm.py:222-520``). The JAX package names a "group" by mesh axes and
runs its collectives inside ``shard_map``; here each process is one rank and
a collective takes ``axis``: ``None`` (the world), a ``torch.distributed``
process group, or mesh-axis names (``"dp"``, ``("dp_outer", "ep")``) that
the topology (``parallel/topology.py``) resolves to a group. Over an axis
of size 1 every collective is the identity and launches nothing, so a
single process needs no process group at all.

Collectives keep the JAX signatures. ``all_reduce`` and ``broadcast``
reduce into their argument in place and return it (PyTorch idiom: the flat
gradient buffer is reduced where it lies); the others return new tensors.
A mean is a sum followed by a division, since gloo has no ``AVG``.

Every collective appends one entry to the comms ledger
(``utils/comms_logging.py``) when it is enabled (``configure``).

``init_distributed`` reads the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or an
explicit ``init_method`` such as ``file://``; the backend defaults to NCCL
when a card is present and gloo otherwise. Gloo also carries CUDA tensors
(through host memory), which is how two ranks share one card.
"""

import datetime
import math
import os
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import _pytree

from ..telemetry.collective import record_launch
from ..utils.comms_logging import CommsLogger, timed_op
from ..utils.logging import logger

Axis = Union[None, str, Sequence[str], "dist.ProcessGroup"]

_COMMS_LOGGER = CommsLogger()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue A item 8 "
                               "(pipeline and model parallelism)")


def get_comms_logger() -> CommsLogger:
    return _COMMS_LOGGER


def configure(comms_logger=None, **kwargs):
    """Reference ``dist.configure``: enable and shape comms logging."""
    if comms_logger is not None:
        _COMMS_LOGGER.configure(enabled=comms_logger.enabled, verbose=comms_logger.verbose,
                                prof_all=comms_logger.prof_all,
                                prof_ops=comms_logger.prof_ops, debug=comms_logger.debug)
    if kwargs:
        _COMMS_LOGGER.configure(**kwargs)


def log_summary(show_straggler: bool = False):
    return _COMMS_LOGGER.log_summary(world_size=get_world_size(),
                                     show_straggler=show_straggler)


def log_compressed(op: str, logical_bytes: int, wire_bytes: int, latency_s: float = 0.0,
                   link: Optional[str] = None, axes=None, impl: Optional[str] = None) -> None:
    """Ledger entry of a compressed collective (``comm/compressed.py``):
    ``logical_bytes`` is what the exact collective would have moved,
    ``wire_bytes`` what its int8 payload and scales moved."""
    _COMMS_LOGGER.append(op, int(logical_bytes), latency_s, wire_bytes=int(wire_bytes),
                         hop_class=link)
    record_launch(op, shape=(int(logical_bytes),), axes=_axes_names(axes), impl=impl,
                  link=link)


def _axes_names(axes) -> Optional[Sequence[str]]:
    """A flight-record ``axes`` field: names as given, a process group by
    its name."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return (axes,)
    if isinstance(axes, dist.ProcessGroup):
        return (axes.group_name,)
    return tuple(str(a) for a in axes)


def log_local(op: str, nbytes: int) -> None:
    """Ledger entry for LOCAL (device-memory) traffic an implementation
    choice implies, such as the paged-decode pool bytes
    (``inference/v2/model.py``: the einsum path's gathered copy against the
    kernels' in-place page reads). No collective runs."""
    _COMMS_LOGGER.append(op, int(nbytes))


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------


def default_backend() -> str:
    from ..accelerator import get_accelerator

    acc = get_accelerator()
    return acc.communication_backend_name() if acc.is_available() else "gloo"


def init_distributed(dist_backend: Optional[str] = None, auto_mpi_discovery: bool = True,
                     timeout=None, init_method: Optional[str] = None, rank: int = -1,
                     world_size: int = -1) -> None:
    """Join the process group (reference ``init_distributed``,
    ``comm.py:619``; the JAX package's parameter order). A no-op when it is
    up already, and at world size 1 without an ``init_method`` (no
    rendezvous, as the JAX package). Else ``rank`` and ``world_size`` come
    from the arguments, the launcher's ``RANK`` / ``WORLD_SIZE`` or, with
    ``auto_mpi_discovery``, an OpenMPI launch (:func:`mpi_discovery`), and
    the rendezvous from ``init_method`` or ``MASTER_ADDR`` / ``MASTER_PORT``
    (``env://``). ``timeout`` is seconds or a ``timedelta``."""
    if dist.is_initialized():
        return
    world = world_size if world_size > 0 else int(os.environ.get("WORLD_SIZE", "1"))
    if auto_mpi_discovery and world == 1 and "OMPI_COMM_WORLD_SIZE" in os.environ:
        mpi_rank, world = mpi_discovery()
        rank = rank if rank >= 0 else mpi_rank
    if world == 1 and init_method is None:
        return
    rank = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    backend = dist_backend or default_backend()
    kw = {}
    if timeout is not None:
        kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                         else datetime.timedelta(seconds=float(timeout)))
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank() % max(1, torch.cuda.device_count()))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, **kw)
    logger.info(f"torch.distributed initialized: rank {rank} of {world}, backend {backend}")


def mpi_discovery() -> Tuple[int, int]:
    """OpenMPI environment discovery (reference ``comm.py:688``):
    ``(rank, world_size)``, (0, 1) outside an ``mpirun`` launch."""
    return (int(os.environ.get("OMPI_COMM_WORLD_RANK", "0")),
            int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1")))


def initialize_mesh_device(mesh_shape: Sequence[int], mesh_dim_names: Sequence[str]):
    """Reference ``initialize_mesh_device``: a ``DeviceMesh`` of
    ``mesh_shape`` over the world's ranks, with ``mesh_dim_names``
    (``cuda`` over NCCL, else ``cpu``). A ``DeviceMesh`` needs the process
    group, even for one rank: call ``init_distributed`` first (with an
    ``init_method`` at world size 1)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not is_initialized():
        raise RuntimeError("initialize_mesh_device needs the process group: call "
                           "init_distributed first (at world size 1 with an init_method)")
    shape = tuple(int(d) for d in mesh_shape)
    world = get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks, the world "
                         f"has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(mesh_dim_names))


def is_available() -> bool:
    return dist.is_available()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy_process_group() -> None:
    from ..parallel.topology import reset_topology

    reset_topology()
    if is_initialized():
        dist.destroy_process_group()


def get_rank(group=None) -> int:
    """This process's rank in the world (or in ``group``)."""
    if not is_initialized():
        return 0
    return dist.get_rank(group) if group is not None else dist.get_rank()


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _axis_tuple(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _is_names(axis) -> bool:
    return isinstance(axis, (str, tuple, list))


def get_world_size(axis: Axis = None) -> int:
    """World size, or the size of ``axis`` (a group or mesh-axis names)."""
    if axis is None:
        return dist.get_world_size() if is_initialized() else 1
    if _is_names(axis):
        from ..parallel.topology import get_topology

        return get_topology().axis_size(*_axis_tuple(axis))
    return dist.get_world_size(axis)


def _group(axis: Axis):
    """The process group of ``axis`` (None for the world)."""
    if axis is None:
        return None
    if _is_names(axis):
        from ..parallel.topology import get_topology

        return get_topology().group(*_axis_tuple(axis))
    return axis


def axis_index(axis: Axis = None) -> int:
    """This rank's index along ``axis``."""
    if get_world_size(axis) == 1:
        return 0
    group = _group(axis)
    return dist.get_rank(group) if group is not None else dist.get_rank()


def get_world_group():
    """The whole world's group (None before any process group is up)."""
    return dist.group.WORLD if is_initialized() else None


def new_group(ranks: Sequence[int], axis: Axis = None):
    """Reference ``dist.new_group(ranks)``: a group of ``ranks``, indices
    along ``axis`` (default: the world). Every rank of the world must call
    it, as ``torch.distributed.new_group`` requires."""
    ranks = [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"duplicate ranks in group: {ranks}")
    size = get_world_size(axis)
    if ranks and (min(ranks) < 0 or max(ranks) >= size):
        raise ValueError(f"ranks {ranks} outside axis of size {size}")
    group = _group(axis)
    if group is not None:
        ranks = [dist.get_global_rank(group, r) for r in ranks]
    return dist.new_group(ranks)


def get_all_ranks_from_group(group=None) -> list:
    if group is None:
        return list(range(get_world_size()))
    return dist.get_process_group_ranks(group)


def get_global_rank(group=None, group_rank: int = 0) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def barrier(name: str = "barrier", axis: Axis = None) -> None:
    # recorded with its NAME: two ranks both "at a barrier" may be at
    # different barriers, which is exactly a desync
    with timed_op(_COMMS_LOGGER, "barrier", 0, detail=name):
        if get_world_size(axis) > 1:
            dist.barrier(group=_group(axis))


def broadcast_host_data(data: Any, src: int = 0) -> Any:
    """Broadcast a picklable host object from rank ``src`` to every rank
    (reference object broadcast); the object itself at world size 1."""
    if get_world_size() == 1:
        return data
    box = [data]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_REDUCE_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, axis: Axis = None, op: str = "sum") -> torch.Tensor:
    """SUM / MEAN / MAX / MIN all-reduce over ``axis``, IN PLACE on ``x``
    (returned). MEAN is a SUM divided by the axis size."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    if op == "mean" and not x.is_floating_point():
        raise ValueError("a mean all-reduce needs a floating tensor")
    size = get_world_size(axis)
    with timed_op(_COMMS_LOGGER, "all_reduce", _nbytes(x)):
        if size > 1:
            dist.all_reduce(x, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]), group=_group(axis))
            if op == "mean":
                x.div_(size)
    return x


def gather_stack(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """The ranks' ``x`` stacked in rank order, ``[size, *x.shape]``, with no
    ledger entry (the compressed collectives log one entry for the whole
    operation, as the JAX package's do)."""
    size = get_world_size(axis)
    x = x.contiguous()
    out = torch.empty((size * x.numel(),), dtype=x.dtype, device=x.device)
    if size > 1:
        dist.all_gather_into_tensor(out, x.reshape(-1), group=_group(axis))
    else:
        out.copy_(x.reshape(-1))
    return out.view((size,) + tuple(x.shape))


def exchange(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Tile i of dim 0 of ``x`` to rank i; the tiles received in rank order
    (the all-to-all of equal tiles), with no ledger entry."""
    size = get_world_size(axis)
    x = x.contiguous()
    recv = torch.empty_like(x)
    if size > 1:
        dist.all_to_all_single(recv, x, group=_group(axis))
    else:
        recv.copy_(x)
    return recv


def all_gather(x: torch.Tensor, axis: Axis = None, *, tiled: bool = True,
               gather_dim: int = 0) -> torch.Tensor:
    """All-gather over ``axis`` (reference ``all_gather_into_tensor``):
    ``tiled=True`` concatenates the ranks' tensors along ``gather_dim``;
    ``tiled=False`` stacks them in a new axis at ``gather_dim``."""
    size = get_world_size(axis)
    with timed_op(_COMMS_LOGGER, "all_gather", _nbytes(x)):
        stacked = gather_stack(x, axis)
    if not tiled:
        return stacked.movedim(0, gather_dim)
    if gather_dim == 0 and x.dim() > 0:
        return stacked.reshape((size * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(list(stacked.unbind(0)), dim=gather_dim)


def reduce_scatter(x: torch.Tensor, axis: Axis = None, *, scatter_dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """Reduce, then scatter ``scatter_dim`` in equal tiles over ``axis``
    (reference ``reduce_scatter_tensor``): this rank's tile of the sum (or
    the mean with ``op="mean"``)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported reduce op {op}")
    size = get_world_size(axis)
    if x.shape[scatter_dim] % size:
        raise ValueError(f"scatter dim {scatter_dim} of {tuple(x.shape)} not divisible "
                         f"by axis size {size}")
    moved = x.movedim(scatter_dim, 0).contiguous()
    with timed_op(_COMMS_LOGGER, "reduce_scatter", _nbytes(x)):
        out = torch.empty((moved.shape[0] // size,) + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        if size > 1:
            dist.reduce_scatter_tensor(out, moved, group=_group(axis))
        else:
            out.copy_(moved)
    if op == "mean":
        out.div_(size)
    return out.movedim(0, scatter_dim)


def all_to_all(x: torch.Tensor, axis: Axis = None, *, split_dim: int = 0,
               concat_dim: int = 0, tiled: bool = True) -> torch.Tensor:
    """All-to-all over ``axis`` (reference ``all_to_all_single``): tile i of
    ``split_dim`` goes to rank i, and the tiles received are concatenated
    along ``concat_dim`` in rank order. ``tiled=False``: ``split_dim`` has
    the axis size and is removed, and a new axis of that size is inserted
    at ``concat_dim`` (``lax.all_to_all`` semantics)."""
    size = get_world_size(axis)
    if x.shape[split_dim] % size:
        raise ValueError(f"split dim {split_dim} of {tuple(x.shape)} not divisible by "
                         f"axis size {size}")
    moved = x.movedim(split_dim, 0)
    with timed_op(_COMMS_LOGGER, "all_to_all", _nbytes(x)):
        recv = exchange(moved, axis)
    if not tiled:
        if x.shape[split_dim] != size:
            raise ValueError(f"untiled all_to_all: split dim {split_dim} of "
                             f"{tuple(x.shape)} must equal the axis size {size}")
        return recv.movedim(0, concat_dim)
    tiles = recv.view((size, moved.shape[0] // size) + tuple(moved.shape[1:]))
    return torch.cat([t.movedim(0, split_dim) for t in tiles.unbind(0)], dim=concat_dim)


def all_to_all_single(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """All-to-all of equal tiles of dim 0 (reference ``all_to_all_single``)."""
    return all_to_all(x, axis, split_dim=0, concat_dim=0)


def broadcast(x: torch.Tensor, axis: Axis = None, src: int = 0) -> torch.Tensor:
    """Broadcast ``x`` from index ``src`` of ``axis`` to all its ranks, IN
    PLACE on ``x`` (returned)."""
    size = get_world_size(axis)
    with timed_op(_COMMS_LOGGER, "broadcast", _nbytes(x)):
        if size > 1:
            group = _group(axis)
            dist.broadcast(x, src=get_global_rank(group, src), group=group)
    return x


def reduce(x: torch.Tensor, axis: Axis = None, dst: int = 0, op: str = "sum") -> torch.Tensor:
    """Reduce to index ``dst`` of ``axis``, IN PLACE on ``x`` (returned);
    every other rank gets zeros (the JAX package's explicit form of "output
    only valid on dst")."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    size, group = get_world_size(axis), _group(axis)
    with timed_op(_COMMS_LOGGER, "reduce", _nbytes(x)):
        if size > 1:
            dist.reduce(x, dst=get_global_rank(group, dst),
                        op=getattr(dist.ReduceOp, _REDUCE_OPS[op]), group=group)
    if axis_index(axis) != dst:
        return x.zero_()
    return x.div_(size) if op == "mean" else x


def gather(x: torch.Tensor, axis: Axis = None, dst: int = 0,
           gather_dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``gather_dim`` on index ``dst``
    of ``axis``; zeros of that shape on every other rank."""
    size = get_world_size(axis)
    with timed_op(_COMMS_LOGGER, "gather", _nbytes(x)):
        stacked = gather_stack(x, axis)
    full = torch.cat(list(stacked.unbind(0)), dim=gather_dim) if size > 1 else x.clone()
    return full if axis_index(axis) == dst else full.zero_()


def scatter(x: torch.Tensor, axis: Axis = None, src: int = 0,
            scatter_dim: int = 0) -> torch.Tensor:
    """This rank's ``scatter_dim`` tile of index ``src``'s ``x`` (reference
    ``dist.scatter`` with a stacked input); ``x`` is unchanged."""
    size = get_world_size(axis)
    if x.shape[scatter_dim] % size:
        raise ValueError(f"scatter dim {scatter_dim} of {tuple(x.shape)} not divisible "
                         f"by axis size {size}")
    with timed_op(_COMMS_LOGGER, "scatter", _nbytes(x)):
        src_val = x.clone()
        if size > 1:
            group = _group(axis)
            dist.broadcast(src_val, src=get_global_rank(group, src), group=group)
    width = x.shape[scatter_dim] // size
    return src_val.narrow(scatter_dim, axis_index(axis) * width, width).contiguous()


def all_reduce_coalesced(xs, axis: Axis = None, op: str = "sum"):
    """:func:`all_reduce` of every tensor of the tree ``xs`` (lists, tuples,
    dicts), IN PLACE, in one collective per dtype and device over their
    concatenation; the ledger gets one entry per tensor, as in the JAX
    package. Returns ``xs``."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    leaves, _ = _pytree.tree_flatten(xs)
    buckets = {}
    for t in leaves:
        _COMMS_LOGGER.append("all_reduce", _nbytes(t))
        buckets.setdefault((t.dtype, t.device), []).append(t)
    if get_world_size(axis) > 1:
        for ts in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                            group=_group(axis))
            if op == "mean":
                flat.div_(get_world_size(axis))
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))
    return xs


def all_gather_coalesced(xs, axis: Axis = None, *, tiled: bool = True, gather_dim: int = 0):
    """:func:`all_gather` of every tensor of the tree ``xs``; a tree of the
    same structure."""
    leaves, spec = _pytree.tree_flatten(xs)
    return _pytree.tree_unflatten(
        [all_gather(t, axis, tiled=tiled, gather_dim=gather_dim) for t in leaves], spec)


class MeshGroup:
    """A rank subset of an axis (the JAX package's ``MeshGroup``; the
    reference's ``new_group(ranks)`` as data): indices ``ranks`` along
    ``axis``, whose size is ``axis_size``. :func:`group_all_reduce` reduces
    over the members with one collective over the whole axis."""

    def __init__(self, axis: Axis, ranks: Sequence[int], axis_size: int):
        self.axis = axis
        self.ranks = tuple(int(r) for r in ranks)
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"duplicate ranks in group: {ranks}")
        if self.ranks and (min(self.ranks) < 0 or max(self.ranks) >= axis_size):
            raise ValueError(f"ranks {ranks} outside axis of size {axis_size}")

    def size(self) -> int:
        return len(self.ranks)


def group_all_reduce(x: torch.Tensor, axis: Axis = None, op: str = "sum",
                     group: Optional[MeshGroup] = None) -> torch.Tensor:
    """:func:`all_reduce` over the members of ``group`` along ``axis``:
    members get the reduction over the members (IN PLACE on ``x``), other
    ranks keep ``x``. One collective over the whole axis, the non-members
    contributing the op's neutral element (the JAX package's masked
    form)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    if group is None:
        return all_reduce(x, axis, op)
    member = axis_index(axis) in group.ranks
    if op in ("sum", "mean"):
        contrib = x.clone() if member else torch.zeros_like(x)
    else:
        lo, hi = ((-float("inf"), float("inf")) if x.is_floating_point()
                  else (torch.iinfo(x.dtype).min, torch.iinfo(x.dtype).max))
        contrib = x.clone() if member else torch.full_like(x, lo if op == "max" else hi)
    all_reduce(contrib, axis, "sum" if op == "mean" else op)
    if op == "mean":
        contrib = contrib / group.size()
    return x.copy_(contrib) if member else x


def monitored_barrier(group=None, timeout=None, wait_all_ranks: bool = False,
                      name: str = "monitored_barrier") -> None:
    """Reference ``monitored_barrier`` with the ``timeout`` enforced on any
    backend: the barrier over ``group`` (an axis as in :func:`barrier`;
    ``None`` the world) runs on a helper thread, and one that does not
    finish within ``timeout`` (seconds or a ``timedelta``) raises
    :class:`TimeoutError` naming it. After a timeout the caller must exit:
    the helper thread is left inside the barrier. ``None`` is a plain
    blocking barrier. ``wait_all_ranks`` is accepted for the signature and
    unused, as in the JAX package."""
    if timeout is None:
        barrier(name, group)
        return
    import threading

    secs = (timeout.total_seconds() if hasattr(timeout, "total_seconds")
            else float(timeout))
    done = threading.Event()
    err: list = []

    def _run():
        try:
            barrier(name, group)
        except BaseException as e:  # surfaced on the caller's thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=_run, daemon=True, name=f"monitored-barrier-{name}").start()
    if not done.wait(max(0.0, secs)):
        raise TimeoutError(f"monitored_barrier {name!r} did not complete within {secs:g}s: "
                           f"a rank is missing or a collective is wedged (rank "
                           f"{get_rank()} of {get_world_size()})")
    if err:
        raise err[0]


def log_chunked(op: str, nbytes: int, wire_bytes: Optional[int] = None,
                axes: Optional[Sequence[str]] = None) -> None:
    """Ledger entry of a ring-chunked collective: one entry for the chunk
    hops of one ring pass, so totals match a fused collective's."""
    _COMMS_LOGGER.append(op, int(nbytes), wire_bytes=wire_bytes)
    record_launch(op, shape=(int(nbytes),), axes=_axes_names(axes), impl="ring")


def ppermute(x, axis, perm):
    raise _not_ported("ppermute (pipeline point-to-point)")


def send_next_recv_prev(x, axis):
    raise _not_ported("send_next_recv_prev (pipeline point-to-point)")


def send_prev_recv_next(x, axis):
    raise _not_ported("send_prev_recv_next (pipeline point-to-point)")


# ---------------------------------------------------------------------------
# capability probes (reference comm.py:200-260)
# ---------------------------------------------------------------------------


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def has_all_reduce_coalesced() -> bool:
    return True


def has_coalescing_manager() -> bool:
    return False  # no coalescing context manager: all_reduce_coalesced takes the bucket


# reference-compat aliases
allreduce_fn = all_reduce
inference_all_reduce = all_reduce
allgather_fn = all_gather
reduce_scatter_fn = reduce_scatter
all_gather_into_tensor = all_gather
reduce_scatter_tensor = reduce_scatter
