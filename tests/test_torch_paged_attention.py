"""Parity of the port's paged-attention functions with the JAX package.

The same numpy inputs (from a seed) go through the JAX Pallas kernels
(``deepspeed_tpu/ops/pallas/paged_attention.py``, interpret mode on the CPU,
as the JAX package's own tests run them) and through the port's wrappers,
which take their plain PyTorch versions on CPU tensors. Tolerances: 2e-5 in
float32 (the two differ only in summation order), 2e-2 in bfloat16 (inputs
are rounded identically; outputs may land one bf16 ulp apart, 2^-8 relative
at magnitudes below ~2).

The hand-written CUDA kernels themselves are held against the same plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_flash_decode as jax_paged_flash_decode)
from deepspeed_tpu_torch.ops import paged_attention as port

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _tables(S, B, bs, kv_lens, first_block=1):
    """A block table that gives every sequence its own pages (block 0 is
    the trash block) and the number of pages used."""
    bt = np.zeros((S, B), np.int32)
    nxt = first_block
    for s in range(S):
        for b in range(-(-max(int(kv_lens[s]), 1) // bs)):
            bt[s, b] = nxt
            nxt += 1
    return bt, nxt


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _packed_case(rng, S, Q, Hq, Hk, D, bs, B, kv_lens, chunk_lens):
    bt, used = _tables(S, B, bs, kv_lens)
    N = used + 3
    q = rng.standard_normal((S, Q, Hq, D)).astype(np.float32)
    k = rng.standard_normal((N, Hk, bs, D)).astype(np.float32)
    v = rng.standard_normal((N, Hk, bs, D)).astype(np.float32)
    kv_len = np.asarray(kv_lens, np.int32)
    chunk_len = np.asarray(chunk_lens, np.int32)
    start = kv_len - chunk_len
    return q, k, v, bt, start, chunk_len, kv_len


def _run_packed(case, dtype, sm_scale, stats):
    q, k, v, bt, start, chunk, kvl = case
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (bt, start, chunk, kvl)]
    want = jax_paged_attention(jq, jk, jv, *[j for j, _ in ints],
                               sm_scale=sm_scale, interpret=True,
                               return_stats=stats)
    got = port.paged_attention(tq, tk, tv, *[t for _, t in ints],
                               sm_scale=sm_scale, return_stats=stats)
    return got, want


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 2), (6, 1)])
def test_packed_matches_jax_gqa(Hq, Hk, stats):
    """SplitFuse mix at three GQA ratios: a full prompt chunk, a partial
    chunk over a partially filled last page, decode rows, an empty slot."""
    rng = np.random.default_rng(0)
    case = _packed_case(rng, S=4, Q=8, Hq=Hq, Hk=Hk, D=32, bs=4, B=16,
                        kv_lens=[8, 13, 29, 0], chunk_lens=[8, 5, 1, 0])
    got, want = _run_packed(case, "float32", None, stats)
    if stats:
        for g, w in zip(got, want):
            _close(g, w, "float32")
        assert np.all(got[1][3].numpy() == np.float32(-1e30))  # empty slot m
        assert not got[2][3].numpy().any()                      # empty slot l
        got = got[0]
    else:
        _close(got, want, "float32")
    assert not got[3].numpy().any()       # the empty slot is exactly zero
    assert not got[1, 5:].numpy().any()   # padded queries are exactly zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_matches_jax_sm_scale_and_dtype(dtype):
    rng = np.random.default_rng(1)
    case = _packed_case(rng, S=3, Q=4, Hq=4, Hk=2, D=64, bs=8, B=8,
                        kv_lens=[12, 20, 1], chunk_lens=[4, 4, 1])
    for g, w in zip(*_run_packed(case, dtype, 0.37, True)):
        _close(g, w, dtype)


def _decode_case(rng, L, S, Hq, Hk, D, bs, B, kv_lens, pos):
    bt, used = _tables(S, B, bs, kv_lens)
    N = used + 2
    q = rng.standard_normal((S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((L, N, Hk, bs, D)).astype(np.float32)
    v = rng.standard_normal((L, N, Hk, bs, D)).astype(np.float32)
    return q, k, v, bt, np.asarray(pos, np.int32), np.asarray(kv_lens, np.int32)


def _run_decode(case, dtype, layer, sm_scale, stats):
    q, k, v, bt, pos, kvl = case
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (bt, pos, kvl)]
    want = jax_paged_flash_decode(jq, jk, jv, *[j for j, _ in ints],
                                  layer=layer, sm_scale=sm_scale,
                                  interpret=True, return_stats=stats)
    got = port.paged_flash_decode(tq, tk, tv, *[t for _, t in ints],
                                  layer=layer, sm_scale=sm_scale,
                                  return_stats=stats)
    return got, want


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 2), (6, 1)])
def test_decode_matches_jax_resident_pool(Hq, Hk, stats):
    """Layer 2 of a 3-layer resident pool; kv lengths with an empty slot, a
    partial last page, and query positions both past kv_len (the decode
    loop's frozen pool) and inside it (masking by position)."""
    rng = np.random.default_rng(2)
    case = _decode_case(rng, L=3, S=4, Hq=Hq, Hk=Hk, D=32, bs=8, B=8,
                        kv_lens=[0, 7, 23, 40], pos=[0, 9, 11, 45])
    got, want = _run_decode(case, "float32", 2, None, stats)
    if stats:
        for g, w in zip(got, want):
            _close(g, w, "float32")
        got = got[0]
    else:
        _close(got, want, "float32")
    assert not got[0].numpy().any()       # kv_len 0 -> exact zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_sm_scale_and_dtype(dtype):
    rng = np.random.default_rng(3)
    case = _decode_case(rng, L=2, S=3, Hq=8, Hk=2, D=64, bs=4, B=16,
                        kv_lens=[5, 33, 60], pos=[5, 40, 59])
    for g, w in zip(*_run_decode(case, dtype, 1, 0.21, True)):
        _close(g, w, dtype)


def test_decode_single_layer_view_and_layer_check():
    rng = np.random.default_rng(4)
    q, k, v, bt, pos, kvl = _decode_case(rng, L=1, S=2, Hq=4, Hk=2, D=32,
                                         bs=8, B=4, kv_lens=[3, 17],
                                         pos=[3, 17])
    args = [torch.from_numpy(a) for a in (q, k[0], v[0], bt, pos, kvl)]
    out = port.paged_flash_decode(*args)
    full = port.paged_flash_decode(*args[:1], torch.from_numpy(k),
                                   torch.from_numpy(v), *args[3:])
    assert torch.equal(out, full)
    with pytest.raises(ValueError):
        port.paged_flash_decode(*args, layer=1)
    with pytest.raises(ValueError):
        port.paged_flash_decode(args[0], torch.from_numpy(k),
                                torch.from_numpy(v), *args[3:], layer=1)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(5)
    q, k, v, bt, start, chunk, kvl = _packed_case(
        rng, S=2, Q=4, Hq=4, Hk=2, D=32, bs=4, B=8, kv_lens=[6, 9],
        chunk_lens=[4, 2])
    args = [torch.from_numpy(a) for a in (q, k, v, bt, start, chunk, kvl)]
    before = dict(port.launch_counts)
    out = port.paged_attention(*args)
    assert torch.equal(out, port.paged_attention_ref(*args))
    assert port.launch_counts == before
