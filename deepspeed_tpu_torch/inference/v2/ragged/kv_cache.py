"""Paged (blocked) KV cache on device.

Port of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``: one K and one V
pool per model, ``[L, num_blocks, Hk, block_size, D]`` (head-major, so each
head's page is a contiguous ``[block_size, D]`` tile the paged kernels read
row by row), living on the engine's device across steps; block reservation is
host-side via :class:`BlockedAllocator`.

``dtype=torch.int8`` selects quantized storage: the pools hold int8 rows and
per-row fp32 scales ``[L, num_blocks, Hk, block_size]`` ride beside them
(one absmax scale per (page, slot, head) row, the ``ops/quant.py``
``quantize_rows`` convention). Writers quantize on scatter; readers
dequantize on the gathered (einsum) path or hand the ``(values, scales)``
pair to the paged flash-decode kernel, which dequantizes each page row as it
reads it. Any float dtype (``torch.float8_e4m3fn``) is plain storage: rows
are cast on write and cast back on read. One-byte float pools are indexed
through a ``torch.uint8`` view (bit-exact), since advanced indexing of
float8 tensors is not implemented on every device.

Residency contract: where the JAX engine donates the pools through every
jitted step and installs the returned arrays, the port updates the pool
tensors IN PLACE (``index_put_`` in the model's scatters). :meth:`update` is
therefore a no-op kept so the engine code reads the same as the reference.
The decode kernel reads the committed pool where it lives: it is given the
pool's base pointer and strides and resolves (layer, physical page) itself,
so neither a per-layer slice nor a gathered copy is ever materialized.

Sharing contract (``enable_prefix_index=True``): pages carry a host-side
refcount (``refs``) so several sequences can map one physical page
(content-addressed prefix reuse, :mod:`prefix_index`). :meth:`free` only
returns a page to the allocator when its LAST owner releases it; a page
the :class:`~.prefix_index.PrefixIndex` still advertises survives at
``refs == 0`` as *reclaimable* cache — it counts toward
:attr:`free_blocks` (admission math is unchanged) and is evicted LRU-first
the moment a reservation actually needs the capacity. Shared pages are
read-only by construction: only token-aligned FULL blocks are ever
registered/mapped, appends land in fresh pages past them, and the one
write that could touch a shared page (re-running the final prompt token of
a fully-cached prompt) goes through :meth:`cow_fork` first."""

from typing import Dict, List, Optional

import torch

from ....accelerator import resolve_device
from .blocked_allocator import BlockedAllocator
from .prefix_index import PrefixIndex


def _zeros(shape, dtype, device) -> torch.Tensor:
    """Zero bits are 0.0 in every storage dtype: one-byte dtypes are made as
    uint8 and viewed (a float8 fill is not implemented on every device)."""
    if torch.empty((), dtype=dtype).element_size() == 1:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


class BlockedKVCache:
    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device="cuda", enable_prefix_index: bool = False):
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.allocator = BlockedAllocator(num_blocks)
        #: page id -> number of live sequence owners (1 for private pages;
        #: maintained whether or not the index is on, so free() is one path)
        self.refs: Dict[int, int] = {}
        self.index: Optional[PrefixIndex] = (PrefixIndex()
                                             if enable_prefix_index else None)
        self.cow_forks = 0
        shape = (num_layers, num_blocks, kv_heads, block_size, head_dim)
        dev = resolve_device(device)
        self.k = _zeros(shape, dtype, dev)
        self.v = _zeros(shape, dtype, dev)
        # int8 storage: per-row scales live beside the pool (scale 1.0 for
        # never-written slots keeps dequant of the zero payload exactly zero)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
            self.v_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def pool_args(self):
        """The (kv_k, kv_v) pools the model functions read and write: the
        tensors, or ``(values, scales)`` tuples when the pool stores
        quantized rows (the model keys its dequant paths on the tuple)."""
        if self.quantized:
            return (self.k, self.k_scale), (self.v, self.v_scale)
        return self.k, self.v

    def pool_nbytes(self) -> int:
        """Total device bytes both pools (and the int8 scales) hold."""
        n = 2 * self.k.numel() * self.k.element_size()
        if self.quantized:
            n += 2 * self.k_scale.numel() * self.k_scale.element_size()
        return n

    @property
    def free_blocks(self) -> int:
        """Pages a reservation can obtain: the allocator free list PLUS
        reclaimable index pages (registered, zero live owners) — cached
        content is capacity, not occupancy, so the admission invariant
        (`can_schedule` worst-case commitment) is unchanged by caching."""
        n = self.allocator.free_blocks
        if self.index is not None:
            n += len(self.index.reclaimable_pages(self.refs))
        return n

    def _allocate(self, n: int) -> List[int]:
        """Allocate ``n`` fresh private pages, evicting reclaimable index
        entries (LRU) when the raw free list runs short."""
        if self.index is not None and n > self.allocator.free_blocks:
            evicted = self.index.evict(n - self.allocator.free_blocks,
                                       self.refs)
            if evicted:
                self.allocator.free(evicted)
        pages = self.allocator.allocate(n).tolist()
        for p in pages:
            self.refs[p] = 1
        return pages

    def reserve(self, seq, n_new_tokens: int) -> None:
        """Ensure ``seq`` has blocks for ``n_new_tokens`` more tokens."""
        need = seq.blocks_needed(n_new_tokens, self.block_size)
        if need:
            seq.blocks.extend(self._allocate(need))

    def share(self, pages) -> None:
        """Map already-written pages into one more sequence's block table
        (prefix-cache hit). Resurrecting a reclaimable index page is the
        same operation: refs 0 -> 1 pins it again."""
        for p in pages:
            self.refs[p] = self.refs.get(p, 0) + 1

    def release(self, page: int) -> None:
        """Drop one owner. The page returns to the allocator only when it
        is truly dead: zero owners AND not advertised by the prefix index
        (registered pages linger as reclaimable cache)."""
        r = self.refs.get(page, 0) - 1
        if r > 0:
            self.refs[page] = r
            return
        self.refs.pop(page, None)
        if self.index is not None and self.index.holds_page(page):
            self.index.touch_page(page)   # reclaimable from now; LRU-stamp
            return
        self.allocator.free([page])

    def free(self, seq) -> None:
        for p in seq.blocks:
            self.release(p)
        seq.blocks = []

    def cow_fork(self, page: int) -> int:
        """Copy-on-write fork: allocate a private page and copy ``page``'s
        payload (all layers, and the int8 scales when quantized) so the
        caller can write into its copy without corrupting the shared
        original. The caller still owns its reference on ``page`` and must
        :meth:`release` it after swapping the fork into the block table."""
        (new,) = self._allocate(1)
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                t[:, new] = t[:, page]
        self.cow_forks += 1
        return new

    def assert_conservation(self, live_block_lists) -> None:
        """Pool-conservation invariant: every non-trash page is accounted
        exactly once across {allocator free list} ∪ {pages with live owners}
        ∪ {reclaimable index pages}, live refcounts equal the number of
        sequences mapping each page, and nothing is both free and
        referenced. ``live_block_lists``: the block tables of every tracked
        sequence."""
        owners: Dict[int, int] = {}
        for blocks in live_block_lists:
            for p in blocks:
                owners[p] = owners.get(p, 0) + 1
        if owners != {p: r for p, r in self.refs.items() if r > 0}:
            raise AssertionError(
                f"refcount drift: sequences map {owners} but refs say "
                f"{self.refs}")
        free = set(self.allocator._free)
        held = set(self.refs)
        cached = (set(self.index.reclaimable_pages(self.refs))
                  if self.index is not None else set())
        if free & held or free & cached or held & cached:
            raise AssertionError(
                f"page in two states: free∩held={free & held} "
                f"free∩cached={free & cached} held∩cached={held & cached}")
        every = free | held | cached
        expect = set(range(1, self.num_blocks))
        if every != expect:
            raise AssertionError(
                f"pool leak/double-free: missing={expect - every} "
                f"extra={every - expect}")

    def update(self, k, v) -> None:
        """No-op: the model functions wrote the pools in place. Kept so the
        engine reads like the JAX engine, which installs donated pools
        here; it checks that what is handed back (tensors, or ``(values,
        scales)`` tuples) is what :meth:`pool_args` handed out."""
        same = lambda a, b: (all(x is y for x, y in zip(a, b))
                             if isinstance(a, tuple) else a is b)
        want_k, want_v = self.pool_args()
        if not (same(k, want_k) and same(v, want_v)):
            raise ValueError("the port updates the KV pools in place; "
                             "update() takes the pools it handed out")
