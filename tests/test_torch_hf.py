"""The port's HF checkpoint loader against the JAX package's.

For every decoder family the JAX loader maps, the same tiny HF model that
``tests/unit/test_hf_loading.py`` builds (two layers, hidden 64, a seeded
``torch.manual_seed``) goes through both ``config_from_hf`` /
``params_from_hf``: the port's config equals JAX's on every field but the
dtype, its parameter tree (float32 tensors on the CPU) equals JAX's
bitwise, and its dense float32 forward gives JAX's logits within 1e-5 (the
CLIP text encoder has no LM head: its config and tree convert, and the
port's model and server refuse it by name). State dicts of numpy arrays
convert like torch ones. bert / distilbert raise ``NotImplementedError``
naming ROADMAP.md Queue A item 10, an unknown ``model_type`` the JAX
loader's ``ValueError``. ``transformers`` is needed only here, imported in
the test bodies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import hf as jhf
from deepspeed_tpu.models.transformer import TransformerLM as JLM
from deepspeed_tpu_torch.inference import config_from_hf, params_from_hf
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.transformer import lm_forward

TOL = 1e-5
NO_DROPOUT = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
FALCON = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)


def _mpt_attn(tf):
    return tf.models.mpt.configuration_mpt.MptAttentionConfig(alibi=True, attn_pdrop=0.0)


# family -> (HF model class, HF config class, config kwargs), the tiny
# models of tests/unit/test_hf_loading.py
FAMILIES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig", dict(LLAMA, tie_word_embeddings=False)),
    "llama_bias": ("LlamaForCausalLM", "LlamaConfig",
                   dict(LLAMA, attention_bias=True, tie_word_embeddings=False)),
    "mistral": ("MistralForCausalLM", "MistralConfig",
                dict(LLAMA, sliding_window=None, tie_word_embeddings=False)),
    "mixtral": ("MixtralForCausalLM", "MixtralConfig",
                dict(LLAMA, num_local_experts=4, num_experts_per_tok=2,
                     tie_word_embeddings=False)),
    "qwen2": ("Qwen2ForCausalLM", "Qwen2Config", dict(LLAMA, tie_word_embeddings=False)),
    "qwen2_moe": ("Qwen2MoeForCausalLM", "Qwen2MoeConfig",
                  dict(LLAMA, num_experts=4, num_experts_per_tok=2,
                       moe_intermediate_size=48, shared_expert_intermediate_size=96,
                       decoder_sparse_step=2, norm_topk_prob=False, mlp_only_layers=[],
                       tie_word_embeddings=False, output_router_logits=False)),
    "phi3": ("Phi3ForCausalLM", "Phi3Config",
             dict(LLAMA, tie_word_embeddings=False, resid_pdrop=0.0, embd_pdrop=0.0,
                  attention_dropout=0.0, pad_token_id=0)),
    "gpt2": ("GPT2LMHeadModel", "GPT2Config",
             dict(vocab_size=96, n_embd=48, n_layer=2, n_head=4, n_positions=32,
                  resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
    "falcon7b": ("FalconForCausalLM", "FalconConfig",
                 dict(FALCON, multi_query=True, parallel_attn=True,
                      new_decoder_architecture=False, bias=False, alibi=False)),
    "falcon40b": ("FalconForCausalLM", "FalconConfig",
                  dict(FALCON, num_kv_heads=2, multi_query=False, parallel_attn=True,
                       new_decoder_architecture=True, bias=False, alibi=False)),
    "falcon_rw": ("FalconForCausalLM", "FalconConfig",
                  dict(FALCON, multi_query=False, parallel_attn=False,
                       new_decoder_architecture=False, bias=True, alibi=True)),
    "gpt_neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig",
                 dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, rotary_pct=0.25,
                      max_position_embeddings=64, use_parallel_residual=True,
                      hidden_dropout=0.0, attention_dropout=0.0)),
    "opt": ("OPTForCausalLM", "OPTConfig",
            dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 activation_function="relu", do_layer_norm_before=True, dropout=0.0,
                 attention_dropout=0.0)),
    "bloom": ("BloomForCausalLM", "BloomConfig",
              dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4,
                   hidden_dropout=0.0, attention_dropout=0.0)),
    "gptj": ("GPTJForCausalLM", "GPTJConfig",
             dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                  rotary_dim=8, **NO_DROPOUT)),
    "gpt_neo": ("GPTNeoForCausalLM", "GPTNeoConfig",
                dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                     attention_types=[[["global", "local"], 1]], window_size=4,
                     max_position_embeddings=64, resid_dropout=0.0, embed_dropout=0.0,
                     attention_dropout=0.0)),
    "phi": ("PhiForCausalLM", "PhiConfig",
            dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4, partial_rotary_factor=0.5,
                 max_position_embeddings=64, resid_pdrop=0.0, embd_pdrop=0.0,
                 attention_dropout=0.0)),
    "starcoder2": ("Starcoder2ForCausalLM", "Starcoder2Config",
                   dict(LLAMA, use_bias=True, sliding_window=4, tie_word_embeddings=True,
                        residual_dropout=0.0, embedding_dropout=0.0,
                        attention_dropout=0.0)),
    "stablelm": ("StableLmForCausalLM", "StableLmConfig",
                 dict(LLAMA, partial_rotary_factor=0.5, use_qkv_bias=False,
                      use_parallel_residual=False, qk_layernorm=False,
                      tie_word_embeddings=False, attention_dropout=0.0,
                      hidden_dropout=0.0)),
    "mpt": ("MptForCausalLM", "MptConfig",
            dict(vocab_size=128, d_model=96, n_layers=2, n_heads=6, max_seq_len=64,
                 no_bias=True, attn_config=_mpt_attn)),
    "clip_text_model": ("CLIPTextModel", "CLIPTextConfig",
                        dict(vocab_size=99, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             max_position_embeddings=32)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hf_model(family, seed):
    tf = pytest.importorskip("transformers")
    model_cls, cfg_cls, kw = FAMILIES[family]
    kw = {k: (v(tf) if callable(v) else v) for k, v in kw.items()}
    torch.manual_seed(seed)
    return getattr(tf, model_cls)(getattr(tf, cfg_cls)(**kw)).eval()


def _flat(tree):
    return {k: np.asarray(v) for k, v in convert._flatten(tree).items()}


@pytest.mark.parametrize("seed, family", list(enumerate(FAMILIES)),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_family_converts_as_the_jax_loader_does(seed, family):
    hf = _hf_model(family, seed)
    jcfg, jparams = jhf.params_from_hf(hf)
    tcfg, tparams = params_from_hf(hf, device="cpu")
    assert config_from_hf(hf.config) == tcfg
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    want, got = _flat(jparams), _flat(tparams)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k

    toks = np.random.default_rng(seed).integers(0, tcfg.vocab_size, (2, 10))
    if tcfg.no_lm_head:
        # the forward returns the final-norm hidden states, as JAX's does
        # (compared below); serving one is refused on purpose
        with pytest.raises(NotImplementedError, match="no_lm_head.*deliberate"):
            tmodel.check_supported(tcfg)
    # MoE blocks route dropless in both packages (exact routing, no drops)
    dropless = tcfg.num_experts > 0
    jmodel = JLM(dataclasses.replace(jcfg, dtype=jnp.float32, moe_dropless=dropless))
    ref = np.asarray(jax.jit(jmodel.apply)({"params": jparams},
                                           jnp.asarray(toks, jnp.int32)))
    tcfg32 = dataclasses.replace(tcfg, dtype=torch.float32, moe_dropless=dropless)
    with torch.no_grad():
        out = lm_forward(tcfg32, tparams, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_numpy_state_dict_and_dict_config_convert_alike():
    hf = _hf_model("gpt_neo", 0)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    cfg_a, a = params_from_hf(sd, hf.config.to_dict(), device="cpu")
    cfg_b, b = params_from_hf(hf, device="cpu")
    assert cfg_a == cfg_b and cfg_a.layer_windows == (None, 4)
    fa, fb = _flat(a), _flat(b)
    assert all(np.array_equal(fa[k], fb[k]) for k in fb)
    with pytest.raises(ValueError, match="hf_config"):
        params_from_hf(sd, device="cpu")


@pytest.mark.parametrize("model_type", ["bert", "distilbert"])
def test_encoders_raise_naming_their_item(model_type):
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        config_from_hf({"model_type": model_type, "vocab_size": 8})
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        params_from_hf({}, {"model_type": model_type}, device="cpu")


def test_unknown_model_type_raises_the_jax_error():
    with pytest.raises(ValueError, match="unsupported") as jerr:
        jhf.config_from_hf({"model_type": "resnet"})
    with pytest.raises(ValueError, match="unsupported") as terr:
        config_from_hf({"model_type": "resnet"})
    assert str(terr.value) == str(jerr.value)
