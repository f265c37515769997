"""The tensor-parallel region boundaries as autograd functions.

The JAX package writes tensor parallelism declaratively (parameter specs,
GSPMD inserting the collectives); the port writes it out in Megatron's
form. Activations outside a tp region are replicated over the ``tp`` axis;
a column-parallel product enters a region and a row-parallel product leaves
it:

* :func:`copy_to_tp` — identity forward, sum all-reduce backward (the
  replicated input of column-parallel products, each rank contributing the
  gradient of its own columns);
* :func:`reduce_from_tp` — sum all-reduce forward, identity backward (the
  partial sums of row-parallel products);
* :func:`gather_from_tp` — all-gather along a dim forward, this rank's
  slice backward (a sharded result made replicated); ``grad="reduce_scatter"``
  sums the cotangent over the ranks first, for a gathered value that each
  rank then consumes differently;
* :func:`scatter_to_tp` — this rank's slice forward, all-gather backward;
* :func:`all_to_all_tp` — the all-to-all between two sharded dims and its
  inverse as the backward.

Every collective's result is the same on every rank of the axis, so a
replicated leaf's gradient comes out bitwise equal on the tp ranks.
"""

import torch

from .. import comm
from .topology import TP_AXIS


def _all_reduce(x, axis):
    return comm.all_reduce(x.contiguous().clone(), axis, op="sum")


def _gather(x, dim, axis):
    return comm.all_gather(x.contiguous(), axis, gather_dim=dim % x.dim())


def _slice(x, dim, axis):
    size = comm.get_world_size(axis)
    n = x.shape[dim] // size
    return x.narrow(dim, comm.axis_index(axis) * n, n).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, reduce_grad):
        ctx.dim, ctx.axis, ctx.reduce_grad = dim, axis, reduce_grad
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = comm.reduce_scatter(g.contiguous(), ctx.axis, scatter_dim=ctx.dim % g.dim())
            return g, None, None, None
        return _slice(g, ctx.dim, ctx.axis), None, None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.axis), None, None


class _AllToAllTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, axis):
        ctx.dims, ctx.axis = (split_dim, concat_dim), axis
        return comm.all_to_all(x.contiguous(), axis, split_dim=split_dim,
                               concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (comm.all_to_all(g.contiguous(), ctx.axis, split_dim=concat_dim,
                                concat_dim=split_dim), None, None, None)


def tp_size(axis=TP_AXIS) -> int:
    return comm.get_world_size(axis)


def copy_to_tp(x: torch.Tensor, axis=TP_AXIS) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``axis``."""
    return x if tp_size(axis) == 1 else _CopyToTP.apply(x, axis)


def reduce_from_tp(x: torch.Tensor, axis=TP_AXIS) -> torch.Tensor:
    """Sum over ``axis`` forward; identity backward."""
    return x if tp_size(axis) == 1 else _ReduceFromTP.apply(x, axis)


def gather_from_tp(x: torch.Tensor, dim: int = -1, axis=TP_AXIS,
                   grad: str = "slice") -> torch.Tensor:
    """All-gather along ``dim`` (rank order) forward. Backward: this rank's
    slice of the gradient (``grad="slice"``: the gathered value feeds
    replicated computation) or its slice of the gradient summed over the
    ranks (``grad="reduce_scatter"``)."""
    if grad not in ("slice", "reduce_scatter"):
        raise ValueError(f"grad must be slice or reduce_scatter, got {grad!r}")
    if tp_size(axis) == 1:
        return x
    return _GatherFromTP.apply(x, dim, axis, grad == "reduce_scatter")


def scatter_to_tp(x: torch.Tensor, dim: int = -1, axis=TP_AXIS) -> torch.Tensor:
    """This rank's equal slice of ``dim`` forward; all-gather backward."""
    return x if tp_size(axis) == 1 else _ScatterToTP.apply(x, dim, axis)


def all_to_all_tp(x: torch.Tensor, split_dim: int, concat_dim: int,
                  axis=TP_AXIS) -> torch.Tensor:
    """``comm.all_to_all`` forward; the inverse all-to-all backward."""
    if tp_size(axis) == 1:
        return x
    return _AllToAllTP.apply(x, split_dim, concat_dim, axis)
