"""Sequence state manager.

Reference ``DSStateManager`` (``inference/v2/ragged/ragged_manager.py:19``):
uid → :class:`DSSequenceDescriptor` registry plus capacity accounting shared
with the KV cache."""

from typing import Dict, Optional

import numpy as np

from .kv_cache import BlockedKVCache
from .sequence_descriptor import DSSequenceDescriptor


class DSStateManager:
    def __init__(self, kv_cache: BlockedKVCache, max_tracked_sequences: int = 2048):
        self.kv_cache = kv_cache
        self.max_tracked = max_tracked_sequences
        self._seqs: Dict[int, DSSequenceDescriptor] = {}

    def __contains__(self, uid: int) -> bool:
        return uid in self._seqs

    def __len__(self) -> int:
        return len(self._seqs)

    def get(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def create(self, uid: int, prompt_tokens, max_new_tokens: int = 256,
               eos_token_id: Optional[int] = None) -> DSSequenceDescriptor:
        if uid in self._seqs:
            raise ValueError(f"uid {uid} already tracked")
        if len(self._seqs) >= self.max_tracked:
            raise RuntimeError("too many tracked sequences")
        seq = DSSequenceDescriptor(uid=uid,
                                   prompt_tokens=np.asarray(prompt_tokens, np.int32),
                                   max_new_tokens=max_new_tokens,
                                   eos_token_id=eos_token_id)
        self._seqs[uid] = seq
        return seq

    def release(self, uid: int) -> None:
        seq = self._seqs.pop(uid, None)
        if seq is not None:
            self.kv_cache.free(seq)

    def active(self):
        return [s for s in self._seqs.values() if not s.done]

    def all(self):
        return list(self._seqs.values())
