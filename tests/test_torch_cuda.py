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

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam as adam
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
@pytest.mark.parametrize("D", [64, 128])
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

    cfg = TransformerConfig(vocab_size=97, hidden_size=256,
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


def _close(got, want, tol):
    """Within ``tol`` of the reference's largest magnitude: the kernels sum
    in another order, and in bf16 a value may round one ulp apart."""
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_match_plain_versions_on_card(D, dtype, causal):
    """Forward (O, L) and both backward kernels against the plain versions:
    GQA 8/2 and a sequence that is not a multiple of the tile."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    B, S, H, Hk = 2, 200, 8, 2
    q, k, v, do = r(B, S, H, D), r(B, S, Hk, D), r(B, S, Hk, D), r(B, S, H, D)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    got = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        _close(g, w, 2 * tol)


def test_flash_wrapper_counts_launches_and_rejects_bad_inputs():
    _need_card()
    q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    fa.reset_launch_counts()
    fa.flash_attention(q, k, k).sum().backward()
    assert fa.launch_counts == {"flash_attention_fwd": 1,
                                "flash_attention_bwd_dkdv": 1,
                                "flash_attention_bwd_dq": 1}
    with pytest.raises(ValueError, match="dtype|float32 or bfloat16"):
        fa.flash_attention_forward(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_forward(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   k[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                                   k, k)
    assert fa.launch_counts["flash_attention_fwd"] == 1


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_kernel_matches_plain_version_on_card(adam_w_mode, bias_correction):
    """One launch over odd-sized tensors (16-byte and scalar paths, several
    chunks) against the plain version, in place and into ``updates``."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = [1, 7, 4096, adam.CHUNK + 5, 3 * adam.CHUNK]
    r = lambda n, s=1.0: s * torch.randn(n, generator=gen, device="cuda")
    g = [r(n, 0.1) for n in sizes]
    p = [r(n) for n in sizes]
    m = [r(n, 0.01) for n in sizes]
    v = [r(n, 0.001).abs() for n in sizes]
    kw = dict(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction, step=5)
    want = [adam.adam_update_ref(*a, 3e-4, 0.9, 0.95, 1e-8, 0.1, adam_w_mode,
                                 bias_correction, 5) for a in zip(g, m, v, p)]
    adam.reset_launch_counts()
    mu, vu, u = [x.clone() for x in m], [x.clone() for x in v], [torch.empty_like(x) for x in g]
    adam.multi_tensor_adam(g, mu, vu, p, updates=u, **kw)
    mi, vi, pi = [x.clone() for x in m], [x.clone() for x in v], [x.clone() for x in p]
    adam.multi_tensor_adam(g, mi, vi, pi, **kw)
    assert adam.launch_counts["fused_adam"] == 2
    for i, (wu, wm, wv) in enumerate(want):
        for got, ref in ((u[i], wu), (mu[i], wm), (vu[i], wv), (mi[i], wm), (vi[i], wv),
                         (pi[i], p[i] + wu)):
            _close(got, ref, 1e-6)
    with pytest.raises(ValueError, match="float32"):
        adam.multi_tensor_adam([g[0].half()], [m[0]], [v[0]], [p[0]], lr=1e-3)


def test_auto_attention_takes_flash_kernels_at_ragged_length_on_card():
    """``auto`` on the card runs the flash kernels at a sequence that is not
    a multiple of 128, and agrees with the plain attention."""
    _need_card()
    from deepspeed_tpu_torch.models.transformer import attention_core

    gen = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").requires_grad_(True)
    q, k, v = r(2, 200, 8, 64), r(2, 200, 2, 64), r(2, 200, 2, 64)
    fa.reset_launch_counts()
    out = attention_core(q, k, v, impl="auto")
    out.sum().backward()
    assert fa.launch_counts == {"flash_attention_fwd": 1,
                                "flash_attention_bwd_dkdv": 1,
                                "flash_attention_bwd_dq": 1}
    _close(out.detach(), attention_core(q, k, v, impl="xla").detach(), 1e-4)


def test_config_adamw_launches_fused_adam_kernel_on_card():
    """The config route (``build_optimizer``) takes the kernel for tensors
    on the card: one launch per step over the whole tree."""
    _need_card()
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    tx = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 0.1})
    params = {"a": torch.ones(5, device="cuda"), "b": {"c": torch.ones(3, 7, device="cuda")}}
    grads = {"a": torch.full((5,), 0.5, device="cuda"),
             "b": {"c": torch.full((3, 7), -0.5, device="cuda")}}
    state = tx.init(params)
    adam.reset_launch_counts()
    state = tx.apply(grads, state, params)
    assert adam.launch_counts["fused_adam"] == 1 and state.step == 1
    # step 1 with bias correction: u = -lr * sign(g) - lr * wd * p
    _close(params["a"], torch.full((5,), 1 - 1e-3 - 1e-4, device="cuda"), 1e-6)
    _close(params["b"]["c"], torch.full((3, 7), 1 + 1e-3 - 1e-4, device="cuda"), 1e-6)
