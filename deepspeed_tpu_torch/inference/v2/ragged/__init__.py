"""Ragged batching substrate: allocator, descriptors, paged KV, packing.

Port of ``deepspeed_tpu/inference/v2/ragged/`` (reference
``deepspeed/inference/v2/ragged/``).
"""

from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache
from .prefix_index import ROOT_HASH, PrefixIndex, chain_hashes, hash_block
from .ragged_manager import DSStateManager
from .ragged_wrapper import RaggedBatch, RaggedBatchWrapper
from .sequence_descriptor import DSSequenceDescriptor

__all__ = ["BlockedAllocator", "BlockedKVCache", "DSStateManager",
           "RaggedBatch", "RaggedBatchWrapper", "DSSequenceDescriptor",
           "PrefixIndex", "chain_hashes", "hash_block", "ROOT_HASH"]
