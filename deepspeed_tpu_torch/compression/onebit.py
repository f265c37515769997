"""Error-feedback sign compression: the part of
``deepspeed_tpu/compression/onebit.py`` that needs no packed transport.

``ErrorFeedbackState`` (which ``comm.compressed.allreduce_feedback_init``
builds), ``init_error_feedback``, ``onebit_compress``,
``compressed_allreduce`` (the one-phase transport: the compensated
``sign * scale`` tensor mean-reduced at ``comm_dtype`` width) and
``server_error_shape``. The bit-packed two-phase ``packed_allreduce`` and
the 1-bit optimizers that train over it (``build_onebit_optimizer``,
``onebit_train_step_factory``) are not ported yet: ROADMAP.md Queue A item 8.
"""

import math
from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class ErrorFeedbackState(NamedTuple):
    """Residuals a compressed reduction carries into its next call:
    ``worker_error`` shaped like this rank's input, ``server_error`` like
    the shard it reduces."""
    worker_error: Any
    server_error: Any


def init_error_feedback(grads_like) -> ErrorFeedbackState:
    """Zero fp32 residuals shaped like every tensor of ``grads_like``."""
    zeros = lambda g: torch.zeros_like(g, dtype=torch.float32)
    return ErrorFeedbackState(worker_error=pytree.tree_map(zeros, grads_like),
                              server_error=pytree.tree_map(zeros, grads_like))


def onebit_compress(x: torch.Tensor, error: torch.Tensor):
    """Error-feedback sign compression (reference ``runtime/comm/nccl.py:16``
    ``compressed_allreduce`` step 1): returns (compensated sign * scale, new
    error); the scale keeps the l1 norm."""
    comp = x.float() + error
    q = torch.sign(comp) * comp.abs().mean()
    return q, comp - q


def compressed_allreduce(x: torch.Tensor, error: torch.Tensor, axis,
                         comm_dtype=torch.float32):
    """One-phase 1-bit-style all-reduce: compress with error feedback, then
    mean-reduce the ``sign * scale`` tensor over ``axis`` at ``comm_dtype``
    width. Returns (the fp32 mean, the new error)."""
    from .. import comm

    q, new_error = onebit_compress(x, error)
    reduced = comm.all_reduce(q.to(comm_dtype), axis, op="mean").float()
    return reduced, new_error


def server_error_shape(shape, world: int) -> Tuple[int]:
    """Shape of one rank's server-error chunk for a leaf of ``shape`` under
    the JAX package's ``packed_allreduce`` over ``world`` ranks."""
    n = math.prod(shape)
    pad = -n % (8 * world)
    return ((n + pad) // world,)
