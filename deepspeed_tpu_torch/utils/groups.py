"""Parallel-group accessors (reference ``deepspeed/utils/groups.py``).

Port of ``deepspeed_tpu/utils/groups.py``. As in the JAX package a group is
named by mesh axes of the live topology (``parallel/topology.py``): the
accessors return the axis names that ``comm`` collectives take as ``axis``,
and the topology resolves them to a ``torch.distributed`` process group.
The data-parallel and the model-parallel (tensor) axes are ported; the
expert and sequence groups raise (ROADMAP.md Queue A item 8).
"""

from typing import Tuple, Union

from ..parallel.topology import get_topology

Axis = Union[str, Tuple[str, ...]]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"the {what} group is not ported yet: ROADMAP.md Queue A "
                               "item 8 (expert and sequence parallelism)")


def initialize(ep_size: int = 1, mpu=None) -> None:
    """Reference ``groups.initialize``: with ``ep_size`` 1 the topology
    stays as it is; an expert-parallel axis is the parallelism side paths'
    work. ``mpu`` is ignored with a warning, as in the JAX package: the
    topology's axes supersede an external model-parallel unit."""
    if mpu is not None:
        from .logging import logger

        logger.warning("groups.initialize: ignoring mpu=%r; the topology's mesh axes "
                       "define the groups (parallel/topology.py)", mpu)
    if ep_size != 1:
        raise _not_ported(f"expert-parallel (ep_size={ep_size})")


def _get_data_parallel_group() -> Axis:
    return get_topology().dp_axes


def _get_data_parallel_world_size() -> int:
    return get_topology().dp_size


def _get_data_parallel_rank() -> int:
    from .. import comm

    return comm.axis_index(get_topology().dp_axes)


def _clone_world_group() -> Axis:
    return get_topology().all_axes


def _get_model_parallel_group() -> Axis:
    """The tensor-parallel axis: ``comm`` resolves it to this rank's tp row."""
    return "tp"


def _get_model_parallel_world_size() -> int:
    return get_topology().tp_size


def _get_expert_parallel_group(group_name: str = "ep"):
    raise _not_ported("expert-parallel")


def _get_expert_data_parallel_group(group_name: str = "ep"):
    raise _not_ported("expert-data-parallel")


def _get_sequence_parallel_group():
    raise _not_ported("sequence-parallel")
