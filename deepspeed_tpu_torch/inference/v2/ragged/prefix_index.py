"""Content-addressed prefix index over full KV blocks (vLLM-style
prefix caching, the FastGen ragged engine's missing reuse tier).

Every *full* (token-aligned) KV block a sequence commits is content
addressed by a hash chain: ``hash = sha256(parent_hash || block tokens)``,
so a block's digest names the ENTIRE token prefix up to and including the
block — two sequences share a digest iff they share the whole prefix, and
the KV rows inside the page are therefore identical (causal attention: the
KV at position p is a function of tokens 0..p only). The index maps digest
→ physical page id, letting :meth:`~.kv_cache.BlockedKVCache`-backed
engines map a new sequence's matching prefix straight onto already-written
pages and prefill only the uncached tail.

Lifecycle contract (refcounts live in ``BlockedKVCache.refs``):

* a page referenced by live sequences (``refs > 0``) is pinned;
* a REGISTERED page whose last sequence released it (``refs == 0``) stays
  in the index as *reclaimable* — it still counts as a free block for
  admission, and :meth:`evict` hands it back to the allocator in LRU order
  when a reservation actually needs the capacity;
* an unregistered page returns to the allocator the moment ``refs`` hits 0
  (the pre-index behavior, bit-identical when the index is off).

Content addressing makes eviction order safe: a child entry whose parent
was evicted is merely unreachable (longest-prefix lookups walk the chain
from the root and stop at the first miss) until its own eviction; a
re-registered parent under a NEW page re-links it — digests, not page ids,
are the identity.

Host-side and stdlib-only: hashing 32-token blocks is nanoseconds next to
a forward pass.
"""

import hashlib
from typing import Dict, List, Optional

import numpy as np

#: the hash-chain root: the digest "parent" of a sequence's first block
ROOT_HASH = "root"


def hash_block(parent: str, tokens) -> str:
    """Digest of one full block: sha256 over the parent digest and the
    block's token ids (int32 little-endian bytes)."""
    h = hashlib.sha256()
    h.update(parent.encode("ascii"))
    h.update(np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes())
    return h.hexdigest()


def chain_hashes(tokens, block_size: int, parent: str = ROOT_HASH) -> List[str]:
    """The full-block hash chain of a token sequence (partial tail blocks
    are NOT hashed — only immutable, token-aligned full blocks are ever
    shared)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    out: List[str] = []
    for i in range(len(tokens) // block_size):
        parent = hash_block(parent, tokens[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


class PrefixIndex:
    """digest → physical page id, with LRU bookkeeping for reclaim.

    The index holds no refcounts itself — ``BlockedKVCache.refs`` is the
    single owner count (sequences mapping the page); the index only marks
    which pages are *content addressed* and therefore worth keeping alive
    at ``refs == 0``.
    """

    def __init__(self):
        self.entries: Dict[str, int] = {}       # digest -> page id
        self.by_page: Dict[int, str] = {}       # page id -> digest
        self._lru: Dict[str, int] = {}          # digest -> last-touch tick
        self._tick = 0
        # counters (engine ReuseStats reads these for the serving gauges)
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.entries)

    def _touch(self, digest: str) -> None:
        self._tick += 1
        self._lru[digest] = self._tick

    # ------------------------------------------------------------------
    def lookup(self, hashes: List[str]) -> List[int]:
        """Pages of the longest registered prefix of ``hashes`` (possibly
        empty). Touches every matched entry so hot prefixes survive LRU
        eviction."""
        self.lookups += 1
        pages: List[int] = []
        for h in hashes:
            page = self.entries.get(h)
            if page is None:
                break
            self._touch(h)
            pages.append(page)
        if pages:
            self.hits += 1
        return pages

    def register(self, digest: str, page: int) -> bool:
        """Advertise ``page`` as holding the full block named by ``digest``.
        First writer wins: a digest already registered (another sequence
        committed the same content first) or a page already advertising a
        different digest keeps its existing entry — the caller's page then
        simply stays private and dies with its refcount."""
        if digest in self.entries or page in self.by_page:
            return False
        self.entries[digest] = page
        self.by_page[page] = digest
        self._touch(digest)
        return True

    def holds_page(self, page: int) -> bool:
        return page in self.by_page

    def touch_page(self, page: int) -> None:
        digest = self.by_page.get(page)
        if digest is not None:
            self._touch(digest)

    # ------------------------------------------------------------------
    def reclaimable_pages(self, refs: Dict[int, int]) -> List[int]:
        """Registered pages no live sequence maps — free capacity that is
        merely *cached* (counted by ``BlockedKVCache.free_blocks``)."""
        return [p for p in self.by_page if refs.get(p, 0) <= 0]

    def evict(self, n: int, refs: Dict[int, int]) -> List[int]:
        """Drop up to ``n`` reclaimable entries in LRU order and return
        their pages for the allocator's free list. Pages with live
        references are never candidates."""
        cand = sorted(self.reclaimable_pages(refs),
                      key=lambda p: self._lru.get(self.by_page[p], 0))
        out: List[int] = []
        for page in cand[:max(0, n)]:
            digest = self.by_page.pop(page)
            del self.entries[digest]
            self._lru.pop(digest, None)
            self.evictions += 1
            out.append(page)
        return out

    def drop_page(self, page: int) -> Optional[str]:
        """Forget one page's entry (explicit invalidation — e.g. a test
        poking at pool contents). Returns the dropped digest."""
        digest = self.by_page.pop(page, None)
        if digest is not None:
            del self.entries[digest]
            self._lru.pop(digest, None)
        return digest
