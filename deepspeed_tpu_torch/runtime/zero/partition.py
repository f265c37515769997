"""The flat partition of ZeRO stages 1-3 over several ranks.

DeepSpeed's own layout (reference ``stage_1_and_2.py`` /
``partition_parameters.py``): the parameter leaves are laid end to end, in
tree order, in one flat buffer padded to ``padded = shard * world``
elements, and rank r owns the contiguous slice ``[r * shard, (r + 1) *
shard)``, ``shard = ceil(n / world)``. A leaf may straddle ranks; the part
of leaf i that rank r owns is its *fragment* (:meth:`FlatPartition.span`).
Moving a whole flat buffer between the full and the sharded form is one
collective per direction (per bucket): :meth:`all_gather_flat` and
:meth:`reduce_scatter_flat`. Stage 3 moves one contiguous range of the
layout at a time (a unit of leaves, ``runtime/zero/stage3.py``):
:meth:`all_gather_range` (a broadcast from each rank that owns part of
the range) and :meth:`reduce_scatter_range` (an fp32 all-reduce of the
range, of which each rank keeps its part). :meth:`gather` and
:meth:`scatter` move one leaf for the accessors
(``utils/tensor_fragment.py``) and checkpoints.

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
        return self.gather_fragment(self.fragment(shard, i), i)

    def gather_fragment(self, mine: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i in full from this rank's fragment ``mine`` of it (any 1-D
        tensor of the fragment's length, e.g. an optimizer moment) and every
        other rank's (a collective)."""
        spans = [self.span(i, r) for r in range(self.world)]
        m = max(b - a for a, b in spans)
        out = torch.empty(self.numels[i], dtype=mine.dtype, device=mine.device)
        if m:
            send = torch.zeros(m, dtype=mine.dtype, device=mine.device)
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

    def range_parts(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Per rank, the elements ``[a, b)`` of the flat range ``[lo, hi)``
        that it owns (``a == b`` when none), in rank order."""
        parts = []
        for r in range(self.world):
            a = min(max(lo, r * self.shard), hi)
            parts.append((a, max(a, min(hi, (r + 1) * self.shard))))
        return parts

    def all_gather_range(self, shard: torch.Tensor, lo: int, hi: int, out: torch.Tensor,
                         bucket_elems: int) -> None:
        """Write the flat elements ``[lo, hi)`` into ``out`` (``[hi - lo]``, in
        ``out``'s dtype: the cast commutes with the gather) from the ranks'
        shards: each rank that owns a part broadcasts it, in buckets of at
        most ``bucket_elems`` elements (a range mostly lies in one or two
        ranks' shards, so no rank sends padding)."""
        for r, (a, b) in enumerate(self.range_parts(lo, hi)):
            for c in range(a, b, max(1, bucket_elems)):
                k = min(bucket_elems, b - c)
                piece = out[c - lo:c - lo + k]
                if r == self.rank:
                    piece.copy_(shard[c - self.start:c - self.start + k])
                comm.broadcast(piece, self.axis, src=r)

    def reduce_scatter_range(self, full: torch.Tensor, lo: int, hi: int,
                             shard: torch.Tensor, bucket_elems: int) -> None:
        """Mean-reduce ``full`` (this rank's values of the flat elements
        ``[lo, hi)``, any dtype) across the ranks in fp32 and add this rank's
        part of the result into ``shard``: one all-reduce per bucket of at
        most ``bucket_elems`` elements (the range's parts are uneven across
        the ranks, so an all-reduce moves fewer bytes than a reduce-scatter
        padded to the longest part)."""
        a_me, b_me = self.range_parts(lo, hi)[self.rank]
        for c in range(lo, hi, max(1, bucket_elems)):
            k = min(bucket_elems, hi - c)
            piece = full[c - lo:c - lo + k].to(shard.dtype, copy=True)
            comm.all_reduce(piece, self.axis, op="mean")
            x0, x1 = max(a_me, c), min(b_me, c + k)
            if x1 > x0:
                shard[x0 - self.start:x1 - self.start].add_(piece[x0 - c:x1 - c])
