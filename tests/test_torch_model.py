"""The port's serving forward against the JAX package's, on the same weights.

A tiny model (2 layers, hidden 64, vocab 97) is initialized by the JAX
package; ``params_from_jax`` hands the same numpy weights to the port. Both
packages then run the same packed batches through ``ragged_forward`` and
the same fused chunk through ``decode_loop`` in float32, with ``attn_impl``
both ``"pallas"`` (JAX: the Pallas kernels in interpret mode; port: the
kernel wrappers, which take their plain versions on CPU tensors) and
``"einsum"``. Logits must agree within 1e-4 (float32; the packages sum in
different orders through two layers and an fp32 lm head), greedy tokens
exactly, and the KV pools written in place by the port must match the
pools the JAX functions return.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.inference.v2.ragged import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
    DSSequenceDescriptor
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf

LOGIT_TOL = 1e-4
FAMILIES = {
    "llama": dict(num_kv_heads=2),
    "gpt2": dict(norm="layernorm", activation="gelu", position="learned",
                 tie_embeddings=True),
}


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def tiny_pair(family="llama", seed=0, **overrides):
    """(JAX config, port config, numpy params) for one tiny model."""
    base = {**dict(vocab_size=97, hidden_size=64, intermediate_size=96,
                   num_layers=2, num_heads=4, max_seq_len=128),
            **FAMILIES[family], **overrides}
    jcfg = jtf.TransformerConfig(**base, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**base, dtype=torch.float32)
    params = jtf.TransformerLM(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, tcfg, _np_tree(params)


def _pools(cfg, N, bs):
    shape = (cfg.num_layers, N, cfg.kv_heads, bs, cfg.head_dim)
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
            torch.zeros(shape), torch.zeros(shape))


def _batches(bs):
    """Two packed steps over three sequences: step 1 prefills A and B whole
    and C's first chunk; step 2 decodes A and B and prefills C's rest."""
    rng = np.random.default_rng(11)
    wrapper = RaggedBatchWrapper(token_budget=32, max_seqs=4, max_chunk=12,
                                 max_blocks_per_seq=8)
    seqs = [DSSequenceDescriptor(uid=u, prompt_tokens=rng.integers(
        0, 97, n).astype(np.int32)) for u, n in enumerate((11, 5, 20))]
    nxt = 1
    for s in seqs:
        s.blocks = list(range(nxt, nxt + 5))
        nxt += 5
    steps = []
    for chunks in ((11, 5, 12), (1, 1, 8)):
        sched = []
        for s, n in zip(seqs, chunks):
            toks = s.next_tokens(n) if s.in_prefill else np.asarray([7], np.int32)
            sched.append((s, toks))
        steps.append(wrapper.pack(sched, bs))
        for s, toks in sched:
            s.seen_tokens += len(toks)
    return steps, seqs


ARGS = ("tokens", "positions", "gather_idx", "block_table", "kv_len",
        "logits_idx", "start_pos", "chunk_len")


@pytest.mark.parametrize("attn_impl", ["pallas", "einsum"])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_ragged_forward_and_decode_loop_match_jax(family, attn_impl):
    jcfg, tcfg, params_np = tiny_pair(family)
    tparams = convert.params_from_jax(params_np, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    bs, N = 4, 20
    jk, jv, tk, tv = _pools(tcfg, N, bs)
    steps, seqs = _batches(bs)
    for batch in steps:
        jl, jk, jv = jmodel.ragged_forward(
            jparams, jcfg, jk, jv, *[jnp.asarray(getattr(batch, a)) for a in ARGS],
            attn_impl=attn_impl)
        tl, tk2, tv2 = tmodel.ragged_forward(
            tparams, tcfg, tk, tv, *[torch.from_numpy(getattr(batch, a)) for a in ARGS],
            attn_impl=attn_impl)
        assert tk2 is tk and tv2 is tv                  # written in place
        rows = batch.sample_slots
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    # one fused decode chunk over the cache both packages just wrote
    S, B, n = 4, 8, 6
    tokens0 = np.zeros(S, np.int32)
    pos0 = np.zeros(S, np.int32)
    bt = np.zeros((S, B), np.int32)
    active = np.zeros(S, bool)
    for i, s in enumerate(seqs):
        tokens0[i], pos0[i], active[i] = 3 + i, s.seen_tokens, True
        bt[i, :len(s.blocks)] = s.blocks
    jt, jk, jv = jmodel.decode_loop(
        jparams, jcfg, jk, jv, jnp.asarray(tokens0), jnp.asarray(pos0),
        jnp.asarray(bt), jnp.asarray(active), jax.random.PRNGKey(0),
        jnp.float32(1.0), n_steps=n, attn_impl=attn_impl)
    tt, _, _ = tmodel.decode_loop(
        tparams, tcfg, tk, tv, torch.from_numpy(tokens0),
        torch.from_numpy(pos0), torch.from_numpy(bt), torch.from_numpy(active),
        None, 1.0, n_steps=n, attn_impl=attn_impl)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_params_from_jax_round_trip_and_checks():
    _, tcfg, params_np = tiny_pair("llama")
    tparams = convert.params_from_jax(params_np, tcfg, device="cpu")
    flat_np = convert._flatten(params_np)
    flat_t = convert._flatten(tparams)
    assert set(flat_np) == set(flat_t) == set(convert.param_shapes(tcfg))
    for k, a in flat_np.items():
        assert flat_t[k].dtype == torch.float32
        np.testing.assert_array_equal(flat_t[k].numpy(), a)   # no transpose
    bad = convert._nest({**flat_np, "final_norm/scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        convert.params_from_jax(bad, tcfg, device="cpu")
    missing = convert._nest({k: v for k, v in flat_np.items() if k != "lm_head/kernel"})
    with pytest.raises(ValueError, match="lm_head/kernel"):
        convert.params_from_jax(missing, tcfg, device="cpu")


def test_init_params_shapes_and_seed():
    _, tcfg, _ = tiny_pair("gpt2")
    a = convert.init_params(tcfg, seed=3, device="cpu", dtype=torch.float32)
    b = convert.init_params(tcfg, seed=3, device="cpu", dtype=torch.float32)
    fa, fb = convert._flatten(a), convert._flatten(b)
    assert {k: tuple(v.shape) for k, v in fa.items()} == convert.param_shapes(tcfg)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_rope_matches_jax(interleaved, rotary_pct):
    D = 16
    rot = int(D * rotary_pct)
    jc, js = jtf.rope_table(32, rot, 10000.0)
    tc, ts = ttf.rope_table(32, rot, 10000.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    x = np.random.default_rng(0).standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = np.array([[0, 3, 7, 8, 31], [1, 2, 3, 4, 5]])
    want = jtf.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos),
                          interleaved=interleaved)
    got = ttf.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos),
                         interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["gelu", "gelu_exact", "relu", "quick_gelu"])
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        ttf.apply_activation(name, torch.from_numpy(x)).numpy(),
        np.asarray(jtf.apply_activation(name, jnp.asarray(x))), atol=1e-6)


def test_merge_partial_attention_matches_jax():
    rng = np.random.default_rng(1)
    o1, o2 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    m1, m2 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    l1, l2 = rng.uniform(0.5, 3, (2, 3, 4)).astype(np.float32)
    m2[0], l2[0] = -1e30, 0.0               # an empty partial set
    args = (o1, m1, l1, o2, m2, l2)
    np.testing.assert_allclose(
        ttf.merge_partial_attention(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jtf.merge_partial_attention(*map(jnp.asarray, args))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset,size", [("llama_config", "7b"),
                                         ("llama_config", "tiny"),
                                         ("gpt2_config", "small"),
                                         ("mixtral_config", "tiny"),
                                         ("mixtral_config", "8x7b")])
def test_presets_match_jax(preset, size):
    j, t = getattr(jtf, preset)(size), getattr(ttf, preset)(size)
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("head_dim", "kv_heads", "rotary_dim", "qkv_bias", "out_bias",
                 "ffn_bias"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_left_out_families_raise():
    _, tcfg, _ = tiny_pair("llama")
    for over in (dict(position="alibi"), dict(layer_windows=(None, 4))):
        special = dataclasses.replace(tcfg, **over)
        tmodel.check_supported(special)            # served on the einsum path
        assert tmodel.special_attention(special)
    assert not tmodel.special_attention(tcfg)
    tmodel.check_supported(dataclasses.replace(tcfg, num_experts=4))   # MoE is served
    with pytest.raises(NotImplementedError, match="deliberate differences"):
        tmodel.check_supported(dataclasses.replace(tcfg, no_lm_head=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.tp_decode_matmul(None, None, "tp")


# a CLIP-text-like model at 2 layers (clip_text_model's fields as the
# loaders map them: pre-LN LayerNorm, quick_gelu, learned positions, no LM
# head); the token ids stay below the hidden width, since the JAX loss then
# indexes the hidden dims with them
HEADLESS = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
                num_heads=4, max_seq_len=32, norm="layernorm", activation="quick_gelu",
                position="learned", no_lm_head=True, tie_embeddings=False)
HEADLESS_TOL = 1e-5


def test_headless_forward_and_loss_match_jax():
    """A model without an LM head: the forward is the final-norm hidden
    states and the loss ``causal_lm_loss`` over them within HEADLESS_TOL of
    the JAX package's, the gradients within 1e-4 relative (float32; the
    packages sum in other orders through two layers)."""
    jcfg = jtf.TransformerConfig(**HEADLESS, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**HEADLESS, dtype=torch.float32)
    jm = jtf.TransformerLM(jcfg)
    params = _np_tree(jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"])
    assert "lm_head" not in params
    toks = np.random.default_rng(12).integers(0, HEADLESS["hidden_size"], (2, 16))
    want_h = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(toks, jnp.int32)))
    jloss, jgrad = jax.jit(jax.value_and_grad(jtf.make_loss_fn(jm)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks, jnp.int32))

    tp = convert.params_from_jax(params, tcfg, device="cpu")
    model = ttf.TransformerLM(tcfg, tp)
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        got_h = model(tokens)
    assert tuple(got_h.shape) == (2, 16, HEADLESS["hidden_size"])
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=HEADLESS_TOL, atol=HEADLESS_TOL)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in convert._flatten(tp).items()}
    loss = ttf.make_loss_fn(model)(convert._nest(leaves), tokens)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=HEADLESS_TOL)
    want_g = convert._flatten(_np_tree(jgrad))
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), want_g[k], rtol=1e-4,
                                   atol=HEADLESS_TOL, err_msg=k)
