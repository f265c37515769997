"""ALiBi and windowed families in the port's ragged engine against the JAX
package's.

Four tiny float32 models, initialized by the JAX package and handed to the
port with ``params_from_jax``: pre-scale ALiBi with the embedding layernorm
(bloom), post-scale ALiBi at a head count that is not a power of two (mpt,
6 heads), mixed windows ``(None, 4)`` with ``attn_scale=1.0`` (gpt-neo) and
a uniform window of 6 over GQA (starcoder2). ``ragged_forward`` over two
packed steps (prompts longer than the window, crossing pages of 4 slots)
and a fused ``decode_loop`` over the cache they wrote must give logits and
pools within 1e-5 of the JAX functions and the same greedy tokens; the
engine's ``generate`` must give the JAX engine's greedy streams. The
engine resolves both attention paths to the einsum (the decode with source
``fallback``), and ``attn_backend="pallas"`` is refused with the JAX
engine's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.models.transformer import TransformerLM
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.models import params_from_jax
from tests.test_torch_model import ARGS, _batches, _pools, tiny_pair

TOL = 1e-5
LAYERNORM = dict(norm="layernorm", activation="gelu")
FAMILIES = {
    "bloom": dict(LAYERNORM, position="alibi", embed_norm=True, tie_embeddings=True),
    "mpt": dict(LAYERNORM, activation="gelu_exact", position="alibi",
                alibi_post_scale=True, norm_bias=False, mlp_bias=False,
                attn_qkv_bias=False, attn_out_bias=False, tie_embeddings=True,
                hidden_size=48, num_heads=6),
    "gpt_neo": dict(LAYERNORM, position="learned", attn_scale=1.0,
                    layer_windows=(None, 4), attn_qkv_bias=False, tie_embeddings=True),
    "starcoder2": dict(LAYERNORM, position="rope", num_kv_heads=2, layer_windows=(6, 6)),
}
ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=4, max_blocks_per_seq=24,
              dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family):
    return tiny_pair("llama", **FAMILIES[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ragged_forward_and_decode_loop_match_jax(family):
    jcfg, tcfg, params_np = _pair(family)
    tparams = params_from_jax(params_np, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    bs, N = 4, 20
    jk, jv, tk, tv = _pools(tcfg, N, bs)
    steps, seqs = _batches(bs)
    for batch in steps:
        jl, jk, jv = jmodel.ragged_forward(
            jparams, jcfg, jk, jv, *[jnp.asarray(getattr(batch, a)) for a in ARGS])
        tl, _, _ = tmodel.ragged_forward(
            tparams, tcfg, tk, tv, *[torch.from_numpy(getattr(batch, a)) for a in ARGS])
        rows = batch.sample_slots
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)

    S, B, n = 4, 8, 6
    tokens0, pos0 = np.zeros(S, np.int32), np.zeros(S, np.int32)
    bt, active = np.zeros((S, B), np.int32), np.zeros(S, bool)
    for i, s in enumerate(seqs):
        tokens0[i], pos0[i], active[i] = 3 + i, s.seen_tokens, True
        bt[i, :len(s.blocks)] = s.blocks
    jt, jk, jv = jmodel.decode_loop(
        jparams, jcfg, jk, jv, jnp.asarray(tokens0), jnp.asarray(pos0), jnp.asarray(bt),
        jnp.asarray(active), jax.random.PRNGKey(0), jnp.float32(1.0), n_steps=n)
    tt, _, _ = tmodel.decode_loop(
        tparams, tcfg, tk, tv, torch.from_numpy(tokens0), torch.from_numpy(pos0),
        torch.from_numpy(bt), torch.from_numpy(active), None, 1.0, n_steps=n)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    # the kernel path computes plain causal attention: refused by name
    with pytest.raises(ValueError, match="plain scaled causal"):
        tmodel.ragged_forward(tparams, tcfg, tk, tv,
                              *[torch.from_numpy(getattr(steps[0], a)) for a in ARGS],
                              attn_impl="pallas")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_generate_matches_jax(family):
    jcfg, tcfg, params_np = _pair(family)
    jeng = JEngine(TransformerLM(jcfg), params_np, JEC(**ENGINE))
    teng = TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"), TEC(**ENGINE),
                   device="cpu")
    assert (teng.attn_impl, teng.decode_attn_impl, teng.decode_attn_source) == \
        ("einsum", "einsum", "fallback")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (9, 23, 30)]
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not teng.state_manager.all()


@pytest.mark.parametrize("family", ["bloom", "gpt_neo"])
def test_pallas_backend_is_refused_as_in_jax(family):
    jcfg, tcfg, params_np = _pair(family)
    with pytest.raises(ValueError, match="plain scaled causal") as jerr:
        JEngine(TransformerLM(jcfg), params_np, JEC(**ENGINE, attn_backend="pallas"))
    tparams = params_from_jax(params_np, tcfg, device="cpu")
    with pytest.raises(ValueError, match="plain scaled causal") as terr:
        TEngine(tcfg, tparams, TEC(**ENGINE, attn_backend="pallas"), device="cpu")
    assert str(terr.value) == str(jerr.value)
    # an explicit decode pin demotes with the one-time warning, as in JAX
    eng = TEngine(tcfg, tparams, TEC(**ENGINE, decode_attn_backend="pallas"),
                  device="cpu")
    assert (eng.attn_impl, eng.decode_attn_impl, eng.decode_attn_source) == \
        ("einsum", "einsum", "fallback")
