"""The port's ragged-batching substrate against the JAX package's.

The allocator, sequence descriptor, prefix index and packing are host code
the port keeps its own copies of; these tests drive both packages through
the same operations and require identical results: the same packed arrays
from ``RaggedBatchWrapper.pack``, the same block ids, digests, refcounts and
free lists, and the same copied payload on a copy-on-write fork.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import ragged as jr
from deepspeed_tpu.inference.v2.ragged.sequence_descriptor import \
    DSSequenceDescriptor as JSeq
from deepspeed_tpu_torch.inference.v2 import ragged as tr
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
    DSSequenceDescriptor as TSeq

PACK_FIELDS = ("tokens", "positions", "gather_idx", "block_table", "kv_len",
               "logits_idx", "start_pos", "chunk_len")


def _seqs(cls, rng_seed):
    rng = np.random.default_rng(rng_seed)
    out = []
    for uid, (plen, seen, blocks, gen) in enumerate(
            [(5, 0, [1, 2], []), (3, 3, [3], [44]), (40, 16, [4, 5, 6, 7, 8], []),
             (9, 8, [9, 10], [])]):
        s = cls(uid=100 + uid,
                prompt_tokens=rng.integers(0, 97, plen).astype(np.int32))
        s.seen_tokens, s.blocks, s.generated = seen, list(blocks), list(gen)
        out.append(s)
    return out


@pytest.mark.parametrize("budget,chunk", [(16, 8), (64, 32)])
def test_pack_arrays_identical(budget, chunk):
    kw = dict(token_budget=budget, max_seqs=6, max_chunk=chunk,
              max_blocks_per_seq=8)
    jw, tw = jr.RaggedBatchWrapper(**kw), tr.RaggedBatchWrapper(**kw)
    js, ts = _seqs(JSeq, 7), _seqs(TSeq, 7)
    jsched, tsched, left = [], [], budget
    for a, b in zip(js, ts):
        n = min(left, chunk)
        if n < 1:
            break
        ja, tb = a.next_tokens(n), b.next_tokens(n)
        np.testing.assert_array_equal(ja, tb)
        jsched.append((a, ja))
        tsched.append((b, tb))
        left -= len(ja)
    jb, tb = jw.pack(jsched, 8), tw.pack(tsched, 8)
    for f in PACK_FIELDS:
        ja, ta = getattr(jb, f), getattr(tb, f)
        assert ja.dtype == ta.dtype, f
        np.testing.assert_array_equal(ja, ta, err_msg=f)
    assert (jb.uids, jb.num_tokens, jb.sample_slots) == \
        (tb.uids, tb.num_tokens, tb.sample_slots)


def test_pack_rejects_the_same_overflows():
    for kw, sched_len, blocks in [
            (dict(token_budget=4, max_seqs=4, max_chunk=8), 6, 1),
            (dict(token_budget=16, max_seqs=4, max_chunk=4), 6, 1),
            (dict(token_budget=16, max_seqs=4, max_chunk=8,
                  max_blocks_per_seq=2), 3, 3)]:
        for pkg, cls in ((jr, JSeq), (tr, TSeq)):
            s = cls(uid=0, prompt_tokens=np.arange(10, dtype=np.int32))
            s.blocks = list(range(1, blocks + 1))
            with pytest.raises(ValueError):
                pkg.RaggedBatchWrapper(**kw).pack(
                    [(s, s.next_tokens(sched_len))], 4)


def test_allocator_behaviour_matches():
    ja, ta = jr.BlockedAllocator(9), tr.BlockedAllocator(9)
    assert ja.free_blocks == ta.free_blocks == 8   # block 0 is the trash block
    for op, arg in [("allocate", 3), ("free", [2]), ("allocate", 2),
                    ("free", [1, 3]), ("allocate", 5)]:
        a, b = getattr(ja, op)(arg), getattr(ta, op)(arg)
        if op == "allocate":
            np.testing.assert_array_equal(a, b)
        assert ja.free_blocks == ta.free_blocks
    for alloc in (ja, ta):
        with pytest.raises(RuntimeError):
            alloc.allocate(100)
        with pytest.raises(ValueError):
            alloc.free([0])
    b = ta.allocate(1)
    ta.free(b)
    with pytest.raises(ValueError):
        ta.free(b)


def test_sequence_descriptor_matches():
    for cls in (JSeq, TSeq):
        seq = cls(uid=1, prompt_tokens=np.arange(10, dtype=np.int32))
        np.testing.assert_array_equal(seq.next_tokens(4), np.arange(4))
        seq.seen_tokens = 10
        assert not seq.in_prefill
        assert seq.blocks_needed(1, block_size=4) == 3


def test_prefix_index_digests_lookup_and_eviction_match():
    toks = np.arange(37, dtype=np.int32) * 3 % 97
    assert jr.chain_hashes(toks, 8) == tr.chain_hashes(toks, 8)
    assert jr.hash_block(jr.ROOT_HASH, toks[:8]) == \
        tr.hash_block(tr.ROOT_HASH, toks[:8])
    hashes = tr.chain_hashes(toks, 8)
    results = []
    for pkg in (jr, tr):
        idx = pkg.PrefixIndex()
        reg = [idx.register(h, p) for h, p in zip(hashes, [5, 6, 7, 8])]
        dup = idx.register(hashes[0], 9)
        hit = idx.lookup(hashes[:2] + ["x"])
        refs = {5: 1, 6: 0, 7: 0, 8: 0}
        evicted = idx.evict(2, refs)
        after = idx.lookup(hashes)
        results.append((reg, dup, hit, sorted(idx.reclaimable_pages(refs)),
                        evicted, after, idx.lookups, idx.hits, idx.evictions))
    assert results[0] == results[1]


def _kv_ops(kv, pkg, seq_cls):
    """Share / fork / release / evict a few pages; returns the observable
    state after each operation."""
    s1 = seq_cls(uid=1, prompt_tokens=np.arange(20, dtype=np.int32))
    kv.reserve(s1, 20)
    hashes = pkg.chain_hashes(s1.prompt_tokens, 4)
    for h, p in zip(hashes, s1.blocks):
        kv.index.register(h, p)
    s2 = seq_cls(uid=2, prompt_tokens=np.arange(20, dtype=np.int32))
    pages = kv.index.lookup(hashes)
    kv.share(pages)
    s2.blocks = list(pages)
    fork = kv.cow_fork(s2.blocks[-1])
    kv.release(s2.blocks[-1])
    s2.blocks[-1] = fork
    states = [(sorted(kv.refs.items()), kv.free_blocks, fork)]
    kv.assert_conservation([s1.blocks, s2.blocks])
    kv.free(s1)
    kv.assert_conservation([s2.blocks])
    states.append((sorted(kv.refs.items()), kv.free_blocks))
    s3 = seq_cls(uid=3, prompt_tokens=np.arange(60, dtype=np.int32))
    kv.reserve(s3, 60)                    # needs more than the raw free list
    kv.assert_conservation([s2.blocks, s3.blocks])
    states.append((sorted(kv.refs.items()), kv.free_blocks, list(s3.blocks),
                   kv.index.evictions))
    return states, fork


def test_kv_cache_sharing_cow_and_conservation_match():
    import jax.numpy as jnp

    L, N, Hk, bs, D = 2, 24, 2, 4, 8
    jkv = jr.BlockedKVCache(L, N, bs, Hk, D, dtype=jnp.float32,
                            enable_prefix_index=True)
    tkv = tr.BlockedKVCache(L, N, bs, Hk, D, dtype=torch.float32,
                            device="cpu", enable_prefix_index=True)
    payload = np.random.default_rng(0).standard_normal(
        (L, N, Hk, bs, D)).astype(np.float32)
    jkv.k = jnp.asarray(payload)
    tkv.k.copy_(torch.from_numpy(payload))
    js, jfork = _kv_ops(jkv, jr, JSeq)
    ts, tfork = _kv_ops(tkv, tr, TSeq)
    assert js == ts
    np.testing.assert_array_equal(np.asarray(jkv.k[:, jfork]),
                                  tkv.k[:, tfork].numpy())
    with pytest.raises(AssertionError):
        tkv.assert_conservation([])       # live pages must be accounted for


def test_kv_cache_update_is_in_place():
    kv = tr.BlockedKVCache(1, 4, 4, 1, 8, dtype=torch.float32, device="cpu")
    k, v = kv.pool_args()
    kv.update(k, v)
    assert kv.pool_nbytes() == 2 * 4 * 4 * 8 * 4
    with pytest.raises(ValueError):
        kv.update(k.clone(), v)
