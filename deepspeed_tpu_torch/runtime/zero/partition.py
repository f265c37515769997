"""The flat partition of ZeRO stages 1-3 over several ranks.

DeepSpeed's own layout (reference ``stage_1_and_2.py`` /
``partition_parameters.py``): the parameter leaves are laid end to end, in
tree order, in one flat buffer padded to ``padded = shard * world``
elements, and rank r owns the contiguous slice ``[r * shard, (r + 1) *
shard)``, ``shard = ceil(n / world)``. A leaf may straddle ranks; the part
of leaf i that rank r owns is its *fragment* (:meth:`FlatPartition.span`).
Moving a whole flat buffer between the full and the sharded form is one
collective per direction (per bucket): :meth:`all_gather_flat` and
:meth:`reduce_scatter_flat`. :meth:`gather` and :meth:`scatter` move one
leaf for the accessors (``utils/tensor_fragment.py``) and checkpoints.

The JAX package shards each leaf on its largest divisible dim instead
(``sharding.py``); the math is the same, and values, not layouts, are
compared between the two.
"""

import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ... import comm


class FlatPartition:
    """The flat layout of ``shapes`` over ``world`` ranks, as seen from
    ``rank``; collectives run over ``axis`` (``comm`` axis names)."""

    def __init__(self, shapes: Sequence[Sequence[int]], world: int, rank: int, axis):
        self.shapes: List[Tuple[int, ...]] = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets = [0] + list(itertools.accumulate(self.numels))[:-1]
        self.numel = sum(self.numels)
        self.world, self.rank, self.axis = world, rank, axis
        self.shard = max(1, -(-self.numel // world))
        self.padded = self.shard * world
        self.start = rank * self.shard

    def span(self, i: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """``(a, b)``: the elements ``[a, b)`` of flattened leaf i that
        ``rank`` (this rank by default) owns; ``a == b`` when none."""
        r = self.rank if rank is None else rank
        o, n = self.offsets[i], self.numels[i]
        lo, hi = max(o, r * self.shard), min(o + n, (r + 1) * self.shard)
        return lo - o, max(lo, hi) - o

    def leaf(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i as a view of a full flat buffer."""
        o = self.offsets[i]
        return flat[o:o + self.numels[i]].view(self.shapes[i])

    def fragment(self, shard: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's fragment of leaf i: a 1-D view of a shard buffer."""
        a, b = self.span(i)
        base = self.offsets[i] + a - self.start
        return shard[base:base + b - a]

    def gather(self, shard: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i in full, assembled from every rank's fragment of it (a
        collective: every rank calls it)."""
        spans = [self.span(i, r) for r in range(self.world)]
        m = max(b - a for a, b in spans)
        out = torch.empty(self.numels[i], dtype=shard.dtype, device=shard.device)
        if m:
            send = torch.zeros(m, dtype=shard.dtype, device=shard.device)
            mine = self.fragment(shard, i)
            send[:mine.numel()] = mine
            got = comm.all_gather(send, self.axis)
            at = 0
            for r, (a, b) in enumerate(spans):
                out[at:at + b - a] = got[r * m:r * m + b - a]
                at += b - a
        return out.view(self.shapes[i])

    def scatter(self, shard: torch.Tensor, i: int, value: torch.Tensor) -> None:
        """Write this rank's fragment of a full value of leaf i into
        ``shard`` (no collective: every rank holds ``value``)."""
        a, b = self.span(i)
        self.fragment(shard, i).copy_(value.reshape(-1)[a:b])

    def _buckets(self, bucket_elems: int):
        width = max(1, min(self.shard, bucket_elems // self.world))
        for a in range(0, self.shard, width):
            yield a, min(self.shard, a + width)

    def all_gather_flat(self, shard: torch.Tensor, bucket_elems: int,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full flat buffer ``[padded]`` from every rank's ``shard``
        (written into ``out`` when given), one all-gather per bucket of at
        most ``bucket_elems`` elements."""
        if out is None and self.padded <= bucket_elems:
            return comm.all_gather(shard, self.axis)
        if out is None:
            out = torch.empty(self.padded, dtype=shard.dtype, device=shard.device)
        rows = out.view(self.world, self.shard)
        for a, b in self._buckets(bucket_elems):
            rows[:, a:b] = comm.all_gather(shard[a:b], self.axis).view(self.world, b - a)
        return out

    def reduce_scatter_flat(self, full: torch.Tensor, shard: torch.Tensor,
                            bucket_elems: int, accumulate: bool) -> None:
        """Mean-reduce the full flat buffer ``[padded]`` across the ranks
        into this rank's ``shard`` (added to it with ``accumulate``, else
        written), in fp32 whatever ``full``'s dtype, one reduce-scatter per
        bucket of at most ``bucket_elems`` elements."""
        rows = full.view(self.world, self.shard)
        for a, b in self._buckets(bucket_elems):
            piece = rows[:, a:b].to(shard.dtype).reshape(-1)
            red = comm.reduce_scatter(piece, self.axis, op="mean")
            if accumulate:
                shard[a:b].add_(red)
            else:
                shard[a:b].copy_(red)
