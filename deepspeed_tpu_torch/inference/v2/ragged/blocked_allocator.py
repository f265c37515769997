"""KV-block free-list allocator.

Reference ``BlockedAllocator`` (``inference/v2/ragged/blocked_allocator.py:11``):
O(1) allocate/free over a fixed pool of KV-cache blocks. Block 0 is reserved
as the *trash block* — padded token writes in the ragged kernel land there, so
the device scatter (``index_put_``) needs no branches."""

from typing import List

import numpy as np


class BlockedAllocator:
    TRASH_BLOCK = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the trash block)")
        self.num_blocks = num_blocks
        # simple LIFO free list over blocks 1..N-1 (0 is trash)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> np.ndarray:
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: want {n}, have {len(self._free)}")
        out = np.array([self._free.pop() for _ in range(n)], np.int32)
        return out

    def free(self, blocks) -> None:
        for b in np.asarray(blocks).reshape(-1).tolist():
            if b == self.TRASH_BLOCK:
                raise ValueError("cannot free the trash block")
            if b < 0 or b >= self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(int(b))
