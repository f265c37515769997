"""Per-sequence state for ragged batching.

Reference ``DSSequenceDescriptor`` (``inference/v2/ragged/
sequence_descriptor.py:59``): tracks a sequence's token history, KV block
table, and scheduling state across engine steps."""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DSSequenceDescriptor:
    uid: int
    prompt_tokens: np.ndarray                  # full prompt
    seen_tokens: int = 0                       # tokens whose KV is cached
    blocks: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    max_new_tokens: int = 256
    eos_token_id: Optional[int] = None
    done: bool = False
    # prefix-cache state: the hash chain of this sequence's committed FULL
    # blocks (prefix_index.chain_hashes prefix) — seeded with the matched
    # chain on a cache hit, extended as decode/prefill fills blocks — and
    # how many prompt tokens admission mapped from the index (prefilled-for
    # -free; the serving tier's blocks-saved/hit-rate accounting)
    hash_chain: List[str] = field(default_factory=list)
    prefix_reused_tokens: int = 0

    @property
    def prompt_remaining(self) -> int:
        return max(0, len(self.prompt_tokens) - self.seen_tokens)

    @property
    def in_prefill(self) -> bool:
        return self.prompt_remaining > 0

    def next_tokens(self, budget: int) -> np.ndarray:
        """Tokens to schedule next: a prompt chunk, or the last sampled/prompt
        token for decode."""
        if self.in_prefill:
            n = min(budget, self.prompt_remaining)
            return self.prompt_tokens[self.seen_tokens:self.seen_tokens + n]
        if self.done or budget < 1:
            return np.zeros((0,), np.int32)
        last = self.generated[-1] if self.generated else int(self.prompt_tokens[-1])
        return np.array([last], np.int32)

    def blocks_needed(self, n_new: int, block_size: int) -> int:
        total = self.seen_tokens + n_new
        need = -(-total // block_size)  # ceil
        return max(0, need - len(self.blocks))
