"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip here with a reason. On a
machine with a card (which has no JAX) run them without the JAX test
harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports only torch, numpy and the port.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import paged_attention as port

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tables(S, B, bs, kv_lens):
    bt = np.zeros((S, B), np.int32)
    nxt = 1
    for s in range(S):
        for b in range(-(-max(int(kv_lens[s]), 1) // bs)):
            bt[s, b] = nxt
            nxt += 1
    return bt, nxt


def _packed(rng, dtype, S, Q, Hq, Hk, D, bs, B, kv_lens, chunk_lens):
    bt, used = _tables(S, B, bs, kv_lens)
    dev = torch.device("cuda")
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kv = np.asarray(kv_lens)
    ch = np.asarray(chunk_lens)
    return (f(S, Q, Hq, D), f(used + 1, Hk, bs, D), f(used + 1, Hk, bs, D),
            i(bt), i(kv - ch), i(ch), i(kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_kernels_match_plain_versions_on_card(dtype, D):
    """Both kernels against their plain versions: a GQA ratio, ragged
    lengths incl. 0 and a partial page, stats on and off."""
    _need_card()
    rng = np.random.default_rng(6)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    args = _packed(rng, dtype, S=4, Q=16, Hq=32, Hk=8, D=D, bs=32, B=8,
                   kv_lens=[16, 45, 200, 0], chunk_lens=[16, 13, 1, 0])
    for stats in (False, True):
        got = port.paged_attention(*args, return_stats=stats)
        want = port.paged_attention_ref(*args, return_stats=stats)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    q, k, v, bt, _, _, kvl = args
    kr = torch.stack([k, k.flip(0)])
    vr = torch.stack([v, v.flip(0)])
    qd = q[:, 0].contiguous()
    for stats in (False, True):
        got = port.paged_flash_decode(qd, kr, vr, bt, kvl, kvl, layer=1,
                                      return_stats=stats)
        want = port.paged_flash_decode_ref(qd, kr, vr, bt, kvl, kvl, layer=1,
                                           return_stats=stats)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_wrappers_count_launches_and_reject_bad_inputs():
    _need_card()
    rng = np.random.default_rng(7)
    args = _packed(rng, torch.bfloat16, S=2, Q=4, Hq=8, Hk=8, D=64, bs=16, B=4,
                   kv_lens=[4, 20], chunk_lens=[4, 2])
    port.reset_launch_counts()
    port.paged_attention(*args)
    assert port.launch_counts == {"paged_attention": 1, "paged_flash_decode": 0}
    q, k, v, *rest = args
    with pytest.raises(ValueError, match="dtype"):
        port.paged_attention(q, k.float(), v.float(), *rest)
    with pytest.raises(ValueError, match="head_dim"):
        port.paged_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous(), *rest)
    with pytest.raises(ValueError, match="int32"):
        port.paged_attention(q, k, v, rest[0].long(), *rest[1:])
    assert port.launch_counts["paged_attention"] == 1


def test_engine_kernel_path_matches_einsum_path_on_card():
    """The engine's kernel path and its einsum path give the same greedy
    tokens in float32 on a small seeded model."""
    _need_card()
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=97, hidden_size=128,
                            intermediate_size=192, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256,
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (7, 19, 40)]
    outs = []
    for backend in ("pallas", "einsum"):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16,
            attn_backend=backend), device="cuda")
        outs.append(eng.generate(prompts, max_new_tokens=12))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
