"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip here with a reason. On a
machine with a card (which has no JAX) run them without the JAX test
harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports only torch, numpy, the port and the gloo-world launcher
``tests/torch_dist_worker.py`` (torch only).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam as adam
from deepspeed_tpu_torch.ops import paged_attention as port
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.sparse_attention import (
    bigbird_layout, fixed_layout, launch_counts as sparse_launches,
    masked_dense_attention, sparse_attention)

from .torch_dist_worker import run_world

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
    assert port.launch_counts == {"paged_attention": 1, "paged_flash_decode": 0,
                                  "paged_flash_decode_int8": 0}
    q, k, v, *rest = args
    with pytest.raises(ValueError, match="dtype"):
        port.paged_attention(q, k.float(), v.float(), *rest)
    with pytest.raises(ValueError, match="head_dim"):
        port.paged_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous(), *rest)
    with pytest.raises(ValueError, match="int32"):
        port.paged_attention(q, k, v, rest[0].long(), *rest[1:])
    assert port.launch_counts["paged_attention"] == 1


def _int8_pools(k, v):
    """``(values, scales)`` pools quantized from fp pools (``quantize_rows``)."""
    return quant.quantize_rows(k), quant.quantize_rows(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_int8_mode_matches_plain_version_on_card(dtype, D):
    """The decode kernel's int8 mode against its plain version (dequantize
    the layer with ``dequant_rows_tile``, then the plain decode): GQA 32/8
    and MHA, layer 1 of 2, ragged lengths incl. 0 and a partial page."""
    _need_card()
    rng = np.random.default_rng(9)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for Hq, Hk in ((32, 8), (8, 8)):
        q, k, v, bt, _, _, kvl = _packed(
            rng, dtype, S=4, Q=1, Hq=Hq, Hk=Hk, D=D, bs=32, B=8,
            kv_lens=[16, 45, 200, 0], chunk_lens=[1, 1, 1, 0])
        kp, vp = _int8_pools(torch.stack([k.flip(0), k]), torch.stack([v.flip(0), v]))
        qd = q[:, 0].contiguous()
        port.reset_launch_counts()
        for stats in (False, True):
            got = port.paged_flash_decode(qd, kp, vp, bt, kvl, kvl, layer=1,
                                          return_stats=stats)
            want = port.paged_flash_decode_ref(qd, kp, vp, bt, kvl, kvl, layer=1,
                                               return_stats=stats)
            for g, w in zip(got if stats else [got], want if stats else [want]):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        assert port.launch_counts["paged_flash_decode_int8"] == 2
        assert port.launch_counts["paged_flash_decode"] == 0


def test_decode_int8_wrapper_rejects_bad_pools_on_card():
    _need_card()
    rng = np.random.default_rng(10)
    q, k, v, bt, _, _, kvl = _packed(rng, torch.bfloat16, S=2, Q=1, Hq=8, Hk=8,
                                     D=64, bs=16, B=4, kv_lens=[4, 20],
                                     chunk_lens=[1, 1])
    (kq, ks), (vq, vs) = _int8_pools(k, v)
    qd = q[:, 0].contiguous()
    with pytest.raises(ValueError, match="float32"):
        port.paged_flash_decode(qd, (kq, ks.double()), (vq, vs), bt, kvl, kvl)
    with pytest.raises(ValueError, match="float32"):
        port.paged_flash_decode(qd, (kq, ks[..., :-1].contiguous()), (vq, vs),
                                bt, kvl, kvl)
    with pytest.raises(ValueError, match="int8"):
        port.paged_flash_decode(qd, (kq.float(), ks), (vq.float(), vs), bt, kvl, kvl)
    with pytest.raises(ValueError, match="head_dim"):
        port.paged_flash_decode(qd[..., :32].contiguous(),
                                (kq[..., :32].contiguous(), ks),
                                (vq[..., :32].contiguous(), vs), bt, kvl, kvl)


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
def test_engine_on_quantized_pools_on_card(kv):
    """An int8 engine's fused decode launches the int8 mode (its prompt
    chunks take the gathered path); a float8 engine serves on the gathered
    path. Greedy float32 tokens equal those of the same engine with its
    decode on the gathered path."""
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
    for decode in ("auto", "einsum"):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16,
            kv_cache_dtype=kv, decode_attn_backend=decode), device="cuda")
        assert eng.attn_impl == "einsum"
        kernel = kv == "int8" and decode == "auto"
        assert eng.decode_attn_impl == ("pallas" if kernel else "einsum")
        port.reset_launch_counts()
        outs.append(eng.generate(prompts, max_new_tokens=12))
        assert (port.launch_counts["paged_flash_decode_int8"] > 0) == kernel
        assert port.launch_counts["paged_attention"] == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_float8_cast_beyond_its_range_on_card():
    """On the card torch's float8_e4m3fn cast gives NaN once a value rounds
    above 448, as the JAX ``astype`` does (the CPU build of torch that the
    CPU tests run saturates instead; tests/test_torch_kv_quant.py)."""
    _need_card()
    x = torch.tensor([448.0, 464.0, 470.0, -1000.0, 3.0], device="cuda")
    y = x.to(torch.float8_e4m3fn).float().tolist()
    assert y[:2] == [448.0, 448.0] and y[4] == 3.0
    assert all(np.isnan(y[2:4]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,block", [(64, 64), (128, 64), (128, 128)])
def test_sparse_kernel_matches_plain_version_on_card(D, block, dtype, causal):
    """The sparse forward kernel against the masked-dense plain version on a
    bigbird layout (random blocks above the diagonal) and a layout with
    empty q-blocks; the backward through the entry point equals autograd
    through the plain version."""
    _need_card()
    B, S, H = 2, 1024, 4
    nb = S // block
    gen = torch.Generator(device="cuda").manual_seed(11)
    r = lambda: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    q, k, v = r(), r(), r()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    empty = np.zeros((H, nb, nb), bool)
    empty[:, 2:, 1] = True                          # q-blocks 0, 1 have nothing
    for layout in (bigbird_layout(H, nb, seed=1), empty):
        sparse_launches["sparse_attention_fwd"] = 0
        got = sparse_attention(q, k, v, layout, causal=causal, block=block)
        assert sparse_launches["sparse_attention_fwd"] == 1
        lo = layout if not causal else layout & np.tril(np.ones((nb, nb), bool))
        want = masked_dense_attention(*(x.transpose(1, 2) for x in (q, k, v)), lo,
                                      causal=causal, sm_scale=D ** -0.5,
                                      block_q=block, block_k=block).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[:, :2 * block].float().any()
    qg, kg, vg = (x.float().requires_grad_(True) for x in (q, k, v))
    layout = fixed_layout(H, nb, num_local_blocks=2)
    (sparse_attention(qg, kg, vg, layout, causal=causal, block=block) ** 2).sum().backward()
    ref = [x.detach().clone().requires_grad_(True) for x in (qg, kg, vg)]
    lo = layout if not causal else layout & np.tril(np.ones((nb, nb), bool))
    (masked_dense_attention(*(x.transpose(1, 2) for x in ref), lo, causal=causal,
                            sm_scale=D ** -0.5, block_q=block, block_k=block)
     ** 2).sum().backward()
    for a, b in zip((qg, kg, vg), ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_sparse_kernel_rejects_what_it_was_not_built_for_on_card():
    _need_card()
    x = torch.randn(1, 256, 2, 32, device="cuda", dtype=torch.bfloat16)
    lo = np.ones((2, 4, 4), bool)
    with pytest.raises(ValueError, match="head_dim"):
        sparse_attention(x, x, x, lo, block=64)
    y = torch.randn(1, 256, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block"):
        sparse_attention(y, y, y, np.ones((2, 8, 8), bool), block=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sparse_attention(y.half(), y.half(), y.half(), lo, block=64)


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


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_kernels_match_plain_versions_on_card(dtype, tied):
    """Forward (lse, tgt), dl, dh and dK against the plain versions at a
    ragged token count, hidden size and vocab (several backward chunks),
    untied [E, V] and tied [V, E] heads, targets incl. -1."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(7)
    T, E, V = 517, 200, 1931
    h = torch.randn(T, E, generator=gen, device="cuda").to(dtype)
    k = 0.05 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(dtype).T if tied else k.to(dtype)
    t = torch.randint(-1, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    fl.reset_launch_counts()
    lse, tgt = fl.fused_nll_forward(h, k, t)
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, t)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_r, rtol=1e-5, atol=1e-4)
    g_lse = torch.rand(T, generator=gen, device="cuda") / T
    g_tgt = -(torch.rand(T, generator=gen, device="cuda") > 0.5).float() / T
    old = fl.WORKSPACE_BYTES
    fl.WORKSPACE_BYTES = T * 512 * h.element_size()    # 4 chunks of 512 columns
    try:
        dh, dk = fl.fused_nll_backward(h, k, t, lse_r, g_lse, g_tgt)
    finally:
        fl.WORKSPACE_BYTES = old
    want = fl.fused_nll_bwd_ref(h, k, t, lse_r, g_lse, g_tgt)
    for g, w in zip((dh, dk), want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        _close(g, w, tol)
    assert fl.launch_counts == {"fused_loss_fwd": 1, "fused_loss_dlogits": 4,
                                "fused_loss_dh": 4, "fused_loss_dk": 4}
    # rows of 400 bytes (h, the tied [V, E] head) take TMA; an untied row of
    # V = 1931 bf16 (3862 bytes) does not, and fp32 never does
    route = "wgmma" if dtype == torch.bfloat16 and tied else "mma_sync"
    assert fl.route_counts == {"wgmma": 0, "mma_sync": 0, route: 12}


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("T, E, V, vc", [(517, 200, 1928, 512), (4103, 520, 4104, 1536)])
def test_fused_loss_wgmma_route_matches_plain_versions_on_card(T, E, V, vc, tied):
    """The wgmma route (TMA + wgmma, csrc/fused_loss_sm90.cu) against the
    plain versions at token counts and hidden sizes that are no multiple of
    its 128 x 256 x 64 tile, a vocab that is no multiple of 128, several
    chunks (the last one ragged), untied and tied heads and targets incl.
    -1; the larger shape gives each block several output tiles. dl, dh and
    dK on that route, and one dl chunk against the plain dl."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(9)
    h = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)
    k = 0.05 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(torch.bfloat16).T if tied else k.to(torch.bfloat16)
    t = torch.randint(-1, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    kvt, base = fl._layout(k)
    assert fl.backward_route(h, base) == "wgmma"
    lse, _ = fl.fused_nll_fwd_ref(h, k, t)
    g_lse = torch.rand(T, generator=gen, device="cuda") / T
    g_tgt = -(torch.rand(T, generator=gen, device="cuda") > 0.5).float() / T
    old = fl.WORKSPACE_BYTES
    fl.WORKSPACE_BYTES = T * vc * h.element_size()
    fl.reset_launch_counts()
    try:
        dh, dk = fl.fused_nll_backward(h, k, t, lse, g_lse, g_tgt)
    finally:
        fl.WORKSPACE_BYTES = old
    n_chunks = -(-V // vc)
    assert fl.route_counts == {"wgmma": 3 * n_chunks, "mma_sync": 0}
    want = fl.fused_nll_bwd_ref(h, k, t, lse, g_lse, g_tgt)
    for g, w in zip((dh, dk), want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w, 2e-2)
    # the last (ragged) chunk's dl, and the workspace columns past it hold 0
    v0 = (n_chunks - 1) * vc
    width = V - v0
    ws = torch.full((T, vc), float("nan"), device="cuda").to(torch.bfloat16)
    fl.launch_dlogits(h, base, t, lse, g_lse, g_tgt, ws, v0, width, kvt, "wgmma")
    _close(ws[:, :width], fl.fused_dlogits_ref(h, k, t, lse, g_lse, g_tgt, v0, width), 2e-2)
    tile_end = min(vc, -(-width // 256) * 256)
    assert torch.all(ws[:, width:tile_end] == 0)


def test_fused_loss_routes_refuse_what_they_were_not_built_for_on_card():
    """Forcing the wgmma route on operands TMA cannot describe raises before
    any launch; an unknown route raises too."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    T, E, V = 64, 128, 1931
    h = torch.zeros(T, E, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(E, V, device="cuda", dtype=torch.bfloat16)
    t = torch.zeros(T, device="cuda", dtype=torch.int32)
    f = torch.zeros(T, device="cuda")
    ws = torch.empty(T, 2048, device="cuda", dtype=torch.bfloat16)
    assert fl.backward_route(h, k) == "mma_sync"
    fl.reset_launch_counts()
    with pytest.raises(ValueError, match="wgmma route"):
        fl.launch_dlogits(h, k, t, f, f, f, ws, 0, V, 0, "wgmma")
    with pytest.raises(ValueError, match="route must be"):
        fl.launch_dk(h, ws, k, 0, V, 0, "tiles")
    assert sum(fl.route_counts.values()) == 0


def test_auto_loss_takes_fused_kernels_for_gpt2_vocab_on_card():
    """``loss_impl: auto`` on the card runs the fused kernels at a vocab of
    50257 (not a multiple of 128) and agrees with the dense loss."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl
    from deepspeed_tpu_torch.sequence import sharded_lm_loss

    gen = torch.Generator(device="cuda").manual_seed(8)
    h = torch.randn(2, 64, 96, generator=gen, device="cuda").requires_grad_(True)
    k = (0.05 * torch.randn(96, 50257, generator=gen, device="cuda")).requires_grad_(True)
    tokens = torch.randint(0, 50257, (2, 64), generator=gen, device="cuda")
    fl.reset_launch_counts()
    got = sharded_lm_loss(h, k, tokens)
    g_got = torch.autograd.grad(got, (h, k))
    assert fl.launch_counts["fused_loss_fwd"] == 1 and fl.launch_counts["fused_loss_dk"] >= 1
    want = sharded_lm_loss(h, k, tokens, loss_impl="xla")
    g_want = torch.autograd.grad(want, (h, k))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(g_got, g_want):
        _close(g, w, 1e-4)


def test_fp16_model_with_auto_loss_trains_through_dense_loss_on_card():
    """The fused-loss kernels are built for fp32 and bf16 only: an fp16
    model under an fp16 engine with ``loss_impl: auto`` trains through the
    dense loss, launching none of them, and its loss falls."""
    _need_card()
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, init_params,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import fused_loss as fl

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=2, num_kv_heads=1, max_seq_len=64,
                            dtype=torch.float16, loss_impl="auto")
    params = init_params(cfg, seed=3, device="cuda", dtype=torch.float32)
    engine = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                            model_parameters=params,
                            config={"train_micro_batch_size_per_gpu": 2,
                                    "gradient_accumulation_steps": 1,
                                    "optimizer": {"type": "adamw", "params": {"lr": 3e-3}},
                                    "fp16": {"enabled": True, "initial_scale_power": 8},
                                    "steps_per_print": 10**9})[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = torch.randint(0, 256, (2, 64), generator=gen, device="cuda")
    fl.reset_launch_counts()
    losses = [float(engine.train_batch(batch)) for _ in range(6)]
    assert all(n == 0 for n in fl.launch_counts.values()), fl.launch_counts
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_checkpoint_round_trip_is_bitwise_on_card(tmp_path):
    """Save after two steps, load into a fresh engine on the card: the
    masters, moments, step and LR are bitwise the saved ones, and the next
    step gives the same loss as the engine that was saved."""
    _need_card()
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, init_params,
                                            make_loss_fn)
    from torch.utils import _pytree as pytree

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=2, num_kv_heads=1, max_seq_len=128,
                            dtype=torch.bfloat16)
    init = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True}, "steps_per_print": 10**9}
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = torch.randint(0, 256, (4, 128), generator=gen, device="cuda")

    def engine():
        p = pytree.tree_map(lambda x: x.clone(), init)
        return dst.initialize(model=make_loss_fn(TransformerLM(cfg, p)), model_parameters=p,
                              config=config)[0]

    def state(e):
        return list(e._masters) + pytree.tree_leaves(e.state.opt_state) + [
            e.state.step, e.get_lr()[0]]

    first = engine()
    for _ in range(2):
        first.train_batch(batch)
    first.save_checkpoint(str(tmp_path))
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path))
    for a, b in zip(state(resumed), state(first)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert float(resumed.train_batch(batch)) == float(first.train_batch(batch))


@pytest.mark.parametrize("block", [2048, 512, 128])
@pytest.mark.parametrize("n", [1, 2048, 2048 * 37 + 37])
def test_quant_kernels_match_plain_versions_on_card(n, block):
    """quantize (nearest and stochastic) and dequantize bitwise against
    their plain versions; the stochastic kernel draws the plain version's
    Philox words, and its pad lanes stay 0."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n + block)
    x = torch.randn(n, generator=gen, device="cuda")
    nb = -(-n // block)
    quant.reset_launch_counts()
    q, s, shape = quant.quantize_int8(x, block)
    q_ref, s_ref = quant.quantize_ref(x, n, nb, block)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert torch.equal(quant.dequantize_int8(q, s, shape), quant.dequantize_ref(q, s, n))
    seed = quant.draw_seed(torch.Generator().manual_seed(3))
    q_sr, s_sr, _ = quant.quantize_int8(x, block, stochastic=True,
                                        key=torch.Generator().manual_seed(3))
    assert torch.equal(q_sr, quant.quantize_ref(x, n, nb, block, seed)[0])
    assert torch.equal(s_sr, s) and bool((q_sr.view(-1)[n:] == 0).all())
    assert quant.launch_counts == {"quantize_int8": 1, "quantize_int8_sr": 1,
                                   "dequantize_int8": 1}
    with pytest.raises(ValueError, match="block"):
        quant.quantize_int8(x, 100)


def test_two_rank_gloo_step_on_card(tmp_path):
    """Two ranks share cuda:0 over gloo for one int8-compressed step: 2
    quantize and 2 dequantize launches per rank, the masters bitwise equal
    across the ranks."""
    _need_card()
    rng = np.random.default_rng(0)
    from deepspeed_tpu_torch.models import convert, init_params
    from deepspeed_tpu_torch.models.transformer import TransformerConfig

    model = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
                 num_heads=4, num_kv_heads=2, max_seq_len=32)
    params = convert._flatten(init_params(TransformerConfig(**model), device="cpu",
                                          dtype=torch.float32))
    inputs = {"model": model, "params": convert._nest({k: v.numpy() for k, v in params.items()}),
              "batches": [rng.integers(0, 97, (8, 32)).astype(np.int64)],
              "config": {"train_micro_batch_size_per_gpu": 2,
                         "gradient_accumulation_steps": 2, "steps_per_print": 10**9,
                         "training_fastpath": {"attn_impl": "xla", "loss_impl": "xla"}}}
    r0, r1 = run_world("cuda_step", 2, tmp_path, inputs, timeout=300)
    assert r0["mode"] == "int8" and r0["loss"] == r1["loss"]
    want = {"quantize_int8": 2, "quantize_int8_sr": 0, "dequantize_int8": 2}
    assert r0["launches"] == r1["launches"] == want
    for a, b in zip(r0["masters"], r1["masters"]):
        np.testing.assert_array_equal(a, b)
