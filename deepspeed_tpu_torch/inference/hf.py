"""HuggingFace checkpoint ingestion for the port.

Port of ``deepspeed_tpu/inference/hf.py``: map a HF architecture's config
to the port's :class:`TransformerConfig` and convert its state dict (torch
tensors or numpy arrays, HF's own names and shapes) into the flax-layout
parameter tree, which ``models/convert.params_from_jax`` then places on the
device. The converters build the same float32 numpy tree, leaf for leaf, as
the JAX package's. The module reads configs as dicts (or objects with
``to_dict()``) and never imports ``transformers``.

Decoder families: llama / mistral / internlm (RoPE + GQA + SwiGLU), mixtral
and qwen2_moe (MoE), qwen2 (qkv bias), phi3 (fused qkv / gate_up), gpt2
(learned positions, GELU), falcon (its three fused-qkv layouts, parallel
residual, optional ALiBi), gpt_neox (partial rotary), opt (position offset
2, ReLU), bloom (ALiBi, embedding layernorm), gptj (rotate-every-two
rotary, biased lm_head), gpt_neo (unscaled attention, alternating local
windows), phi, starcoder2 (sliding window), stablelm, mpt (post-scale
ALiBi, bias-free norms) and clip_text_model (no LM head: the model returns
its hidden states and trains on them; serving it raises, as a deliberate
difference). The encoder families (bert,
distilbert) need ``models/bert.py`` and raise.
"""

from typing import Any, Dict

import numpy as np

from ..models.transformer import TransformerConfig

_ENCODERS = ("bert", "distilbert")


def _t(x) -> np.ndarray:
    # torch tensor -> numpy (cpu)
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


def _norm_p(sd: Dict[str, Any], key: str) -> Dict[str, Any]:
    """Norm params with the bias picked up when the checkpoint has one."""
    d = {"scale": _t(sd[key + ".weight"])}
    if key + ".bias" in sd:
        d["bias"] = _t(sd[key + ".bias"])
    return d


def _as_dict(hf_config) -> Dict[str, Any]:
    return hf_config if isinstance(hf_config, dict) else hf_config.to_dict()


def config_from_hf(hf_config) -> TransformerConfig:
    """Map a HF config object/dict to ``TransformerConfig`` (reference policy
    matching in ``replace_policy.py``)."""
    d = _as_dict(hf_config)
    mt = d.get("model_type", "")
    if mt in _ENCODERS:
        raise NotImplementedError(
            f"HF model_type '{mt}' is an encoder (models/bert.py), which is not "
            "ported yet: ROADMAP.md Queue A item 10")
    if mt in ("llama", "mistral", "mixtral", "qwen2", "qwen2_moe", "phi3",
              "internlm"):
        cfg = dict(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            max_seq_len=d.get("max_position_embeddings", 4096),
            norm="rmsnorm", activation="swiglu", position="rope",
            rope_theta=d.get("rope_theta", 10000.0),
            norm_eps=d.get("rms_norm_eps", 1e-6),
            tie_embeddings=d.get("tie_word_embeddings", False))
        if mt == "llama" and d.get("attention_bias"):
            # llama with attention_bias=True (e.g. internlm exports)
            cfg.update(attn_qkv_bias=True, attn_out_bias=True)
        if mt == "internlm":
            # reference module_inject/containers/internlm.py: llama layout
            # with optional q/k/v/o biases ("bias": true configs)
            cfg.update(attn_qkv_bias=d.get("bias", True),
                       attn_out_bias=d.get("bias", True))
        if mt == "mixtral":
            cfg.update(num_experts=d.get("num_local_experts", 8),
                       moe_top_k=d.get("num_experts_per_tok", 2))
        if mt in ("qwen2", "qwen2_moe"):
            # qwen2: rmsnorm model with q/k/v biases (no out/mlp bias)
            cfg.update(attn_qkv_bias=True)
        if mt == "qwen2_moe":
            if d.get("mlp_only_layers"):
                raise ValueError("qwen2_moe mlp_only_layers is not supported "
                                 "(mixed dense/MoE stacks)")
            cfg.update(num_experts=d.get("num_experts", 60),
                       moe_top_k=d.get("num_experts_per_tok", 4),
                       moe_every=d.get("decoder_sparse_step", 1),
                       # HF rule: layer i is MoE iff (i+1) % step == 0
                       moe_offset=(d.get("decoder_sparse_step", 1) - 1),
                       moe_intermediate_size=d.get("moe_intermediate_size"),
                       moe_shared_expert_size=d.get(
                           "shared_expert_intermediate_size", 0),
                       moe_norm_topk=d.get("norm_topk_prob", False))
        return TransformerConfig(**cfg)
    if mt == "gpt2":
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["n_embd"],
            intermediate_size=d.get("n_inner") or 4 * d["n_embd"],
            num_layers=d["n_layer"], num_heads=d["n_head"],
            max_seq_len=d["n_positions"], norm="layernorm", activation="gelu",
            position="learned", norm_eps=d.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=True)
    if mt == "falcon":
        n_head = d["num_attention_heads"]
        if d.get("multi_query", False) and not d.get("new_decoder_architecture"):
            n_kv = 1
        else:
            n_kv = d.get("num_kv_heads") or n_head
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d.get("ffn_hidden_size") or 4 * d["hidden_size"],
            num_layers=d["num_hidden_layers"], num_heads=n_head,
            num_kv_heads=n_kv,
            max_seq_len=d.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu",
            position="alibi" if d.get("alibi") else "rope",
            rope_theta=d.get("rope_theta", 10000.0),
            norm_eps=d.get("layer_norm_epsilon", 1e-5),
            parallel_residual=d.get("parallel_attn", True),
            # 7b-style: one input_layernorm feeds attn AND mlp; the
            # new_decoder_architecture (40b+) has separate ln_attn/ln_mlp
            parallel_shared_norm=not d.get("new_decoder_architecture", False),
            attn_qkv_bias=d.get("bias", False), attn_out_bias=d.get("bias", False),
            mlp_bias=d.get("bias", False), tie_embeddings=True)
    if mt == "gpt_neox":
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="rope",
            rope_theta=d.get("rotary_emb_base", 10000.0),
            rotary_pct=d.get("rotary_pct", 0.25),
            norm_eps=d.get("layer_norm_eps", 1e-5),
            parallel_residual=d.get("use_parallel_residual", True),
            tie_embeddings=False)
    if mt == "opt":
        if d.get("word_embed_proj_dim", d["hidden_size"]) != d["hidden_size"]:
            raise ValueError("OPT with word_embed_proj_dim != hidden_size "
                             "(125m-style projection) is not supported")
        if not d.get("do_layer_norm_before", True):
            raise ValueError("OPT 350m-style post-layernorm is not supported")
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["ffn_dim"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation="relu" if d.get("activation_function", "relu") == "relu"
            else "gelu",
            position="learned", pos_offset=2,
            tie_embeddings=d.get("tie_word_embeddings", True))
    if mt == "bloom":
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=4 * d["hidden_size"],
            num_layers=d["n_layer"], num_heads=d["n_head"],
            max_seq_len=d.get("max_position_embeddings") or 2048,
            norm="layernorm", activation="gelu", position="alibi",
            norm_eps=d.get("layer_norm_epsilon", 1e-5),
            embed_norm=True,  # word_embeddings_layernorm
            attn_qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_embeddings=True)
    if mt == "gptj":
        dh = d["n_embd"] // d["n_head"]
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["n_embd"],
            intermediate_size=d.get("n_inner") or 4 * d["n_embd"],
            num_layers=d["n_layer"], num_heads=d["n_head"],
            max_seq_len=d["n_positions"], norm="layernorm", activation="gelu",
            position="rope", rotary_pct=(d.get("rotary_dim") or dh) / dh,
            rotary_interleaved=True,  # rotate-every-two pairing
            norm_eps=d.get("layer_norm_epsilon", 1e-5),
            parallel_residual=True, parallel_shared_norm=True,  # single ln_1
            attn_qkv_bias=False, attn_out_bias=False, mlp_bias=True,
            lm_head_bias=True, tie_embeddings=False)
    if mt == "gpt_neo":
        # expand attention_types [[["global","local"], N/2]] to per-layer
        kinds = []
        for group, repeat in d["attention_types"]:
            kinds.extend(list(group) * repeat)
        windows = tuple(d.get("window_size", 256) if k == "local" else None
                        for k in kinds)
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d.get("intermediate_size") or 4 * d["hidden_size"],
            num_layers=d["num_layers"], num_heads=d["num_heads"],
            max_seq_len=d.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="learned",
            norm_eps=d.get("layer_norm_epsilon", 1e-5),
            attn_scale=1.0,  # gpt-neo attention is famously unscaled
            layer_windows=windows if any(w for w in windows) else None,
            attn_qkv_bias=False, attn_out_bias=True, mlp_bias=True,
            tie_embeddings=True)
    if mt == "starcoder2":
        sw = d.get("sliding_window")
        return TransformerConfig(
            # sliding window (all released checkpoints: 4096) = a uniform
            # local-attention window on every layer
            layer_windows=((sw,) * d["num_hidden_layers"]) if sw else None,
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 4096),
            norm="layernorm", activation="gelu", position="rope",
            rope_theta=d.get("rope_theta", 10000.0),
            norm_eps=d.get("norm_epsilon", 1e-5),
            attn_qkv_bias=d.get("use_bias", True),
            attn_out_bias=d.get("use_bias", True),
            mlp_bias=d.get("use_bias", True),
            tie_embeddings=d.get("tie_word_embeddings", True))
    if mt == "stablelm":
        if d.get("use_parallel_residual"):
            raise ValueError("stablelm use_parallel_residual=True unsupported "
                             "with its per-branch norms")
        if d.get("qk_layernorm"):
            raise ValueError("stablelm qk_layernorm is not supported")
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 4096),
            norm="layernorm", activation="swiglu", position="rope",
            rope_theta=d.get("rope_theta", 10000.0),
            rotary_pct=d.get("partial_rotary_factor", 0.25),
            norm_eps=d.get("layer_norm_eps", 1e-5),
            attn_qkv_bias=d.get("use_qkv_bias", False), attn_out_bias=False,
            mlp_bias=False,
            tie_embeddings=d.get("tie_word_embeddings", False))
    if mt == "mpt":
        ac = d.get("attn_config") or {}
        if not isinstance(ac, dict):
            ac = ac.to_dict() if hasattr(ac, "to_dict") else vars(ac)
        if not ac.get("alibi", True):
            raise ValueError("mpt without alibi (learned-pos variants) "
                             "is not supported")
        if ac.get("softmax_scale") is not None:
            raise ValueError("mpt attn_config.softmax_scale is not supported "
                             "(custom attention scaling)")
        if ac.get("clip_qkv") is not None:
            raise ValueError("mpt attn_config.clip_qkv is not supported")
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["d_model"],
            # HF MptMLP hardcodes 4*d_model and bias-free projections
            # (modeling_mpt.MptMLP), independent of expansion_ratio/no_bias
            intermediate_size=4 * d["d_model"],
            num_layers=d["n_layers"], num_heads=d["n_heads"],
            max_seq_len=d.get("max_seq_len", 2048),
            norm="layernorm", activation="gelu_exact", position="alibi",
            alibi_post_scale=True,  # mpt: qk * softmax_scale + raw alibi
            norm_eps=d.get("layer_norm_epsilon", 1e-5),
            # HF modeling_mpt hardcodes bias=False on Wqkv/out_proj/MLP and
            # norm bias None regardless of no_bias — so do we
            norm_bias=False, attn_qkv_bias=False, attn_out_bias=False,
            mlp_bias=False,
            tie_embeddings=True)
    if mt == "clip_text_model":
        # HF ACT2FN['gelu'] is EXACT erf gelu; our 'gelu' activation is the
        # tanh approximation (what the gpt2 families need) — reject rather
        # than silently diverge per layer
        if d.get("hidden_act", "quick_gelu") != "quick_gelu":
            raise ValueError(f"clip hidden_act {d.get('hidden_act')!r} "
                             "unsupported (quick_gelu only)")
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 77),
            norm="layernorm", activation="quick_gelu",
            position="learned", norm_eps=d.get("layer_norm_eps", 1e-5),
            attn_qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            no_lm_head=True, tie_embeddings=False)
    if mt == "phi":
        if d.get("qk_layernorm"):
            raise ValueError("phi qk_layernorm checkpoints are not supported")
        return TransformerConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"], num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
            max_seq_len=d.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="rope",
            rope_theta=d.get("rope_theta", 10000.0),
            rotary_pct=d.get("partial_rotary_factor", 0.5),
            norm_eps=d.get("layer_norm_eps", 1e-5),
            parallel_residual=True, parallel_shared_norm=True,
            attn_qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            lm_head_bias=True, tie_embeddings=False)
    raise ValueError(f"unsupported HF model_type '{mt}' (supported: llama, "
                     "mistral, mixtral, qwen2, qwen2_moe, phi3, gpt2, falcon, "
                     "gpt_neox, opt, bloom, gptj, gpt_neo, phi, starcoder2, "
                     "stablelm, mpt, internlm, clip_text_model, bert, "
                     "distilbert)")


def _llama_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """llama-naming converter; also serves layernorm-family members of the
    same naming scheme (starcoder2, stablelm): norm biases, o_proj bias, and
    a non-gated c_fc/c_proj MLP are picked up when present."""
    h, hk, dh, dm = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
    norm_p = lambda key: _norm_p(sd, key)
    p: Dict[str, Any] = {"embed": {"embedding": _t(sd["model.embed_tokens.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        attn = {
            "q_proj": {"kernel": _t(sd[pre + "self_attn.q_proj.weight"]).T
                       .reshape(dm, h, dh)},
            "k_proj": {"kernel": _t(sd[pre + "self_attn.k_proj.weight"]).T
                       .reshape(dm, hk, dh)},
            "v_proj": {"kernel": _t(sd[pre + "self_attn.v_proj.weight"]).T
                       .reshape(dm, hk, dh)},
            "o_proj": {"kernel": _t(sd[pre + "self_attn.o_proj.weight"]).T
                       .reshape(h, dh, dm)},
        }
        if pre + "self_attn.q_proj.bias" in sd:  # qwen2/starcoder2 qkv bias
            attn["q_proj"]["bias"] = _t(sd[pre + "self_attn.q_proj.bias"]).reshape(h, dh)
            attn["k_proj"]["bias"] = _t(sd[pre + "self_attn.k_proj.bias"]).reshape(hk, dh)
            attn["v_proj"]["bias"] = _t(sd[pre + "self_attn.v_proj.bias"]).reshape(hk, dh)
        if pre + "self_attn.o_proj.bias" in sd:  # starcoder2
            attn["o_proj"]["bias"] = _t(sd[pre + "self_attn.o_proj.bias"])
        layer = {
            "attn": attn,
            "attn_norm": norm_p(pre + "input_layernorm"),
            "mlp_norm": norm_p(pre + "post_attention_layernorm"),
        }
        if cfg.num_experts > 0 and (
                i % cfg.moe_every == cfg.moe_offset % cfg.moe_every):
            if pre + "block_sparse_moe.gate.weight" in sd:  # mixtral naming
                gate = _t(sd[pre + "block_sparse_moe.gate.weight"]).T
                ws, vs, w2s = [], [], []
                for e in range(cfg.num_experts):
                    ep = pre + f"block_sparse_moe.experts.{e}."
                    ws.append(_t(sd[ep + "w1.weight"]).T)   # gate_proj [D,F]
                    vs.append(_t(sd[ep + "w3.weight"]).T)   # up_proj
                    w2s.append(_t(sd[ep + "w2.weight"]).T)  # down_proj [F,D]
                layer["moe"] = {
                    "router": {"kernel": gate},
                    "expert_gate_proj": np.stack(ws),
                    "expert_up_proj": np.stack(vs),
                    "expert_down_proj": np.stack(w2s),
                }
            else:  # qwen2_moe naming (+ always-on shared expert)
                gate = _t(sd[pre + "mlp.gate.weight"]).T
                ws, vs, w2s = [], [], []
                for e in range(cfg.num_experts):
                    ep = pre + f"mlp.experts.{e}."
                    ws.append(_t(sd[ep + "gate_proj.weight"]).T)
                    vs.append(_t(sd[ep + "up_proj.weight"]).T)
                    w2s.append(_t(sd[ep + "down_proj.weight"]).T)
                sh = pre + "mlp.shared_expert."
                layer["moe"] = {
                    "router": {"kernel": gate},
                    "expert_gate_proj": np.stack(ws),
                    "expert_up_proj": np.stack(vs),
                    "expert_down_proj": np.stack(w2s),
                    "shared_gate_proj": _t(sd[sh + "gate_proj.weight"]).T,
                    "shared_up_proj": _t(sd[sh + "up_proj.weight"]).T,
                    "shared_down_proj": _t(sd[sh + "down_proj.weight"]).T,
                    "shared_router": _t(sd[pre + "mlp.shared_expert_gate.weight"]).T,
                }
        elif pre + "mlp.c_fc.weight" in sd:  # starcoder2 non-gated mlp
            mlp = {"up_proj": {"kernel": _t(sd[pre + "mlp.c_fc.weight"]).T},
                   "down_proj": {"kernel": _t(sd[pre + "mlp.c_proj.weight"]).T}}
            if pre + "mlp.c_fc.bias" in sd:  # use_bias=False has none
                mlp["up_proj"]["bias"] = _t(sd[pre + "mlp.c_fc.bias"])
                mlp["down_proj"]["bias"] = _t(sd[pre + "mlp.c_proj.bias"])
            layer["mlp"] = mlp
        else:
            layer["mlp"] = {
                "gate_proj": {"kernel": _t(sd[pre + "mlp.gate_proj.weight"]).T},
                "up_proj": {"kernel": _t(sd[pre + "mlp.up_proj.weight"]).T},
                "down_proj": {"kernel": _t(sd[pre + "mlp.down_proj.weight"]).T},
            }
        p[f"layer_{i}"] = layer
    p["final_norm"] = norm_p("model.norm")
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _t(sd["lm_head.weight"]).T}
    return p


def _gpt2_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["transformer.wte.weight"])},
        "pos_embed": _t(sd["transformer.wpe.weight"]),
    }
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        # HF GPT-2 Conv1D stores [in, out]; qkv fused along out
        w = _t(sd[pre + "attn.c_attn.weight"])    # [D, 3D]
        b = _t(sd[pre + "attn.c_attn.bias"])      # [3D]
        qw, kw, vw = np.split(w, 3, axis=1)
        qb, kb, vb = np.split(b, 3)
        proj_w = _t(sd[pre + "attn.c_proj.weight"])  # [D, D]
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": qw.reshape(dm, h, dh), "bias": qb.reshape(h, dh)},
                "k_proj": {"kernel": kw.reshape(dm, h, dh), "bias": kb.reshape(h, dh)},
                "v_proj": {"kernel": vw.reshape(dm, h, dh), "bias": vb.reshape(h, dh)},
                "o_proj": {"kernel": proj_w.reshape(h, dh, dm),
                           "bias": _t(sd[pre + "attn.c_proj.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "ln_1.weight"]),
                          "bias": _t(sd[pre + "ln_1.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "ln_2.weight"]),
                         "bias": _t(sd[pre + "ln_2.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.c_fc.weight"]),
                            "bias": _t(sd[pre + "mlp.c_fc.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.c_proj.weight"]),
                              "bias": _t(sd[pre + "mlp.c_proj.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["transformer.ln_f.weight"]),
                       "bias": _t(sd["transformer.ln_f.bias"])}
    return p


def _phi3_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """Phi-3: llama family with FUSED qkv_proj and gate_up_proj weights."""
    h, hk, dh, dm = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
    f = cfg.intermediate_size
    p: Dict[str, Any] = {"embed": {"embedding": _t(sd["model.embed_tokens.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        qkv = _t(sd[pre + "self_attn.qkv_proj.weight"])      # [(h+2hk)dh, D]
        qw, kw, vw = np.split(qkv, [h * dh, (h + hk) * dh], axis=0)
        gu = _t(sd[pre + "mlp.gate_up_proj.weight"])         # [2F, D]
        gw, uw = np.split(gu, 2, axis=0)
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": qw.T.reshape(dm, h, dh)},
                "k_proj": {"kernel": kw.T.reshape(dm, hk, dh)},
                "v_proj": {"kernel": vw.T.reshape(dm, hk, dh)},
                "o_proj": {"kernel": _t(sd[pre + "self_attn.o_proj.weight"]).T
                           .reshape(h, dh, dm)},
            },
            "attn_norm": {"scale": _t(sd[pre + "input_layernorm.weight"])},
            "mlp_norm": {"scale": _t(sd[pre + "post_attention_layernorm.weight"])},
            "mlp": {"gate_proj": {"kernel": gw.T}, "up_proj": {"kernel": uw.T},
                    "down_proj": {"kernel": _t(sd[pre + "mlp.down_proj.weight"]).T}},
        }
    p["final_norm"] = {"scale": _t(sd["model.norm.weight"])}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _t(sd["lm_head.weight"]).T}
    return p


def _split_falcon_qkv(w, cfg: TransformerConfig, d: Dict[str, Any],
                      is_bias: bool = False):
    """Un-fuse falcon's query_key_value along its three historical layouts.
    ``is_bias``: the fused bias vector shares the layout minus the input dim."""
    h, hk, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    dm = () if is_bias else (cfg.hidden_size,)
    if d.get("new_decoder_architecture", False):
        # per kv-group: [q * (h/hk), k, v] heads interleaved
        g = h // hk
        w = w.reshape(hk, g + 2, dh, *dm)
        qw = w[:, :g].reshape(h, dh, *dm)
        kw = w[:, g].reshape(hk, dh, *dm)
        vw = w[:, g + 1].reshape(hk, dh, *dm)
    elif d.get("multi_query", False):
        # [all q heads, one k, one v]
        qw = w[: h * dh].reshape(h, dh, *dm)
        kw = w[h * dh: (h + 1) * dh].reshape(1, dh, *dm)
        vw = w[(h + 1) * dh:].reshape(1, dh, *dm)
    else:
        # per head [q, k, v] interleaved (falcon-rw)
        w = w.reshape(h, 3, dh, *dm)
        qw, kw, vw = w[:, 0], w[:, 1], w[:, 2]
    if is_bias:
        return qw, kw, vw
    # torch [out, in] slices -> flax [in, heads, dh]
    to_flax = lambda a: np.transpose(a, (2, 0, 1))
    return to_flax(qw), to_flax(kw), to_flax(vw)


def _falcon_params(sd: Dict[str, Any], cfg: TransformerConfig,
                   d: Dict[str, Any]) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["transformer.word_embeddings.weight"])}}
    new_arch = d.get("new_decoder_architecture", False)
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        qw, kw, vw = _split_falcon_qkv(
            _t(sd[pre + "self_attention.query_key_value.weight"]), cfg, d)
        layer = {
            "attn": {
                "q_proj": {"kernel": qw}, "k_proj": {"kernel": kw},
                "v_proj": {"kernel": vw},
                "o_proj": {"kernel": _t(sd[pre + "self_attention.dense.weight"]).T
                           .reshape(h, dh, dm)},
            },
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.dense_h_to_4h.weight"]).T},
                "down_proj": {"kernel": _t(sd[pre + "mlp.dense_4h_to_h.weight"]).T},
            },
        }
        if d.get("bias", False):  # falcon-rw style checkpoints carry biases
            qb, kb, vb = _split_falcon_qkv(
                _t(sd[pre + "self_attention.query_key_value.bias"]), cfg, d,
                is_bias=True)
            layer["attn"]["q_proj"]["bias"] = qb
            layer["attn"]["k_proj"]["bias"] = kb
            layer["attn"]["v_proj"]["bias"] = vb
            layer["attn"]["o_proj"]["bias"] = _t(sd[pre + "self_attention.dense.bias"])
            layer["mlp"]["up_proj"]["bias"] = _t(sd[pre + "mlp.dense_h_to_4h.bias"])
            layer["mlp"]["down_proj"]["bias"] = _t(sd[pre + "mlp.dense_4h_to_h.bias"])
        if new_arch:
            layer["attn_norm"] = {"scale": _t(sd[pre + "ln_attn.weight"]),
                                  "bias": _t(sd[pre + "ln_attn.bias"])}
            layer["mlp_norm"] = {"scale": _t(sd[pre + "ln_mlp.weight"]),
                                 "bias": _t(sd[pre + "ln_mlp.bias"])}
        else:
            layer["attn_norm"] = {"scale": _t(sd[pre + "input_layernorm.weight"]),
                                  "bias": _t(sd[pre + "input_layernorm.bias"])}
            if not (cfg.parallel_residual and cfg.parallel_shared_norm):
                # sequential falcon-rw keeps a post-attention norm
                layer["mlp_norm"] = {
                    "scale": _t(sd[pre + "post_attention_layernorm.weight"]),
                    "bias": _t(sd[pre + "post_attention_layernorm.bias"])}
        p[f"layer_{i}"] = layer
    p["final_norm"] = {"scale": _t(sd["transformer.ln_f.weight"]),
                       "bias": _t(sd["transformer.ln_f.bias"])}
    return p


def _neox_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["gpt_neox.embed_in.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"gpt_neox.layers.{i}."
        # fused qkv, per-head [q, k, v] interleaved: [h, 3, dh, D]
        w = _t(sd[pre + "attention.query_key_value.weight"]).reshape(h, 3, dh, dm)
        b = _t(sd[pre + "attention.query_key_value.bias"]).reshape(h, 3, dh)
        to_flax = lambda a: np.transpose(a, (2, 0, 1))
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": to_flax(w[:, 0]), "bias": b[:, 0]},
                "k_proj": {"kernel": to_flax(w[:, 1]), "bias": b[:, 1]},
                "v_proj": {"kernel": to_flax(w[:, 2]), "bias": b[:, 2]},
                "o_proj": {"kernel": _t(sd[pre + "attention.dense.weight"]).T
                           .reshape(h, dh, dm),
                           "bias": _t(sd[pre + "attention.dense.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "input_layernorm.weight"]),
                          "bias": _t(sd[pre + "input_layernorm.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "post_attention_layernorm.weight"]),
                         "bias": _t(sd[pre + "post_attention_layernorm.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.dense_h_to_4h.weight"]).T,
                            "bias": _t(sd[pre + "mlp.dense_h_to_4h.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.dense_4h_to_h.weight"]).T,
                              "bias": _t(sd[pre + "mlp.dense_4h_to_h.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["gpt_neox.final_layer_norm.weight"]),
                       "bias": _t(sd["gpt_neox.final_layer_norm.bias"])}
    p["lm_head"] = {"kernel": _t(sd["embed_out.weight"]).T}
    return p


def _opt_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["model.decoder.embed_tokens.weight"])},
        # OPT's table embeds position+2 — rows align with our pos_offset=2
        "pos_embed": _t(sd["model.decoder.embed_positions.weight"]),
    }
    for i in range(cfg.num_layers):
        pre = f"model.decoder.layers.{i}."
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": _t(sd[pre + "self_attn.q_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.q_proj.bias"]).reshape(h, dh)},
                "k_proj": {"kernel": _t(sd[pre + "self_attn.k_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.k_proj.bias"]).reshape(h, dh)},
                "v_proj": {"kernel": _t(sd[pre + "self_attn.v_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.v_proj.bias"]).reshape(h, dh)},
                "o_proj": {"kernel": _t(sd[pre + "self_attn.out_proj.weight"]).T
                           .reshape(h, dh, dm),
                           "bias": _t(sd[pre + "self_attn.out_proj.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "self_attn_layer_norm.weight"]),
                          "bias": _t(sd[pre + "self_attn_layer_norm.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "final_layer_norm.weight"]),
                         "bias": _t(sd[pre + "final_layer_norm.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "fc1.weight"]).T,
                            "bias": _t(sd[pre + "fc1.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "fc2.weight"]).T,
                              "bias": _t(sd[pre + "fc2.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["model.decoder.final_layer_norm.weight"]),
                       "bias": _t(sd["model.decoder.final_layer_norm.bias"])}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _t(sd["lm_head.weight"]).T}
    return p


def _bloom_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["transformer.word_embeddings.weight"])},
        "embed_norm": {
            "scale": _t(sd["transformer.word_embeddings_layernorm.weight"]),
            "bias": _t(sd["transformer.word_embeddings_layernorm.bias"])},
    }
    to_flax = lambda a: np.transpose(a, (2, 0, 1))  # [h,dh,D] -> [D,h,dh]
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        # fused qkv, per-head [q, k, v] interleaved (bloom layout)
        w = _t(sd[pre + "self_attention.query_key_value.weight"]).reshape(
            h, 3, dh, dm)
        b = _t(sd[pre + "self_attention.query_key_value.bias"]).reshape(h, 3, dh)
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": to_flax(w[:, 0]), "bias": b[:, 0]},
                "k_proj": {"kernel": to_flax(w[:, 1]), "bias": b[:, 1]},
                "v_proj": {"kernel": to_flax(w[:, 2]), "bias": b[:, 2]},
                "o_proj": {"kernel": _t(sd[pre + "self_attention.dense.weight"])
                           .T.reshape(h, dh, dm),
                           "bias": _t(sd[pre + "self_attention.dense.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "input_layernorm.weight"]),
                          "bias": _t(sd[pre + "input_layernorm.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "post_attention_layernorm.weight"]),
                         "bias": _t(sd[pre + "post_attention_layernorm.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.dense_h_to_4h.weight"]).T,
                            "bias": _t(sd[pre + "mlp.dense_h_to_4h.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.dense_4h_to_h.weight"]).T,
                              "bias": _t(sd[pre + "mlp.dense_4h_to_h.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["transformer.ln_f.weight"]),
                       "bias": _t(sd["transformer.ln_f.bias"])}
    return p


def _gptj_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {"embed": {"embedding": _t(sd["transformer.wte.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": _t(sd[pre + "attn.q_proj.weight"]).T
                           .reshape(dm, h, dh)},
                "k_proj": {"kernel": _t(sd[pre + "attn.k_proj.weight"]).T
                           .reshape(dm, h, dh)},
                "v_proj": {"kernel": _t(sd[pre + "attn.v_proj.weight"]).T
                           .reshape(dm, h, dh)},
                "o_proj": {"kernel": _t(sd[pre + "attn.out_proj.weight"]).T
                           .reshape(h, dh, dm)},
            },
            # single ln_1 feeds both branches (parallel_shared_norm)
            "attn_norm": {"scale": _t(sd[pre + "ln_1.weight"]),
                          "bias": _t(sd[pre + "ln_1.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.fc_in.weight"]).T,
                            "bias": _t(sd[pre + "mlp.fc_in.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.fc_out.weight"]).T,
                              "bias": _t(sd[pre + "mlp.fc_out.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["transformer.ln_f.weight"]),
                       "bias": _t(sd["transformer.ln_f.bias"])}
    p["lm_head"] = {"kernel": _t(sd["lm_head.weight"]).T,
                    "bias": _t(sd["lm_head.bias"])}
    return p


def _gpt_neo_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["transformer.wte.weight"])},
        "pos_embed": _t(sd["transformer.wpe.weight"]),
    }
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        # gpt-neo uses nn.Linear ([out, in] — transpose), unlike gpt2 Conv1D
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": _t(sd[pre + "attn.attention.q_proj.weight"])
                           .T.reshape(dm, h, dh)},
                "k_proj": {"kernel": _t(sd[pre + "attn.attention.k_proj.weight"])
                           .T.reshape(dm, h, dh)},
                "v_proj": {"kernel": _t(sd[pre + "attn.attention.v_proj.weight"])
                           .T.reshape(dm, h, dh)},
                "o_proj": {"kernel": _t(sd[pre + "attn.attention.out_proj.weight"])
                           .T.reshape(h, dh, dm),
                           "bias": _t(sd[pre + "attn.attention.out_proj.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "ln_1.weight"]),
                          "bias": _t(sd[pre + "ln_1.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "ln_2.weight"]),
                         "bias": _t(sd[pre + "ln_2.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.c_fc.weight"]).T,
                            "bias": _t(sd[pre + "mlp.c_fc.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.c_proj.weight"]).T,
                              "bias": _t(sd[pre + "mlp.c_proj.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["transformer.ln_f.weight"]),
                       "bias": _t(sd["transformer.ln_f.bias"])}
    return p


def _phi_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    h, hk, dh, dm = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {"embed": {"embedding": _t(sd["model.embed_tokens.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": _t(sd[pre + "self_attn.q_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.q_proj.bias"]).reshape(h, dh)},
                "k_proj": {"kernel": _t(sd[pre + "self_attn.k_proj.weight"]).T
                           .reshape(dm, hk, dh),
                           "bias": _t(sd[pre + "self_attn.k_proj.bias"]).reshape(hk, dh)},
                "v_proj": {"kernel": _t(sd[pre + "self_attn.v_proj.weight"]).T
                           .reshape(dm, hk, dh),
                           "bias": _t(sd[pre + "self_attn.v_proj.bias"]).reshape(hk, dh)},
                "o_proj": {"kernel": _t(sd[pre + "self_attn.dense.weight"]).T
                           .reshape(h, dh, dm),
                           "bias": _t(sd[pre + "self_attn.dense.bias"])},
            },
            # phi: one input_layernorm feeds attn AND mlp (parallel residual)
            "attn_norm": {"scale": _t(sd[pre + "input_layernorm.weight"]),
                          "bias": _t(sd[pre + "input_layernorm.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.fc1.weight"]).T,
                            "bias": _t(sd[pre + "mlp.fc1.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.fc2.weight"]).T,
                              "bias": _t(sd[pre + "mlp.fc2.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["model.final_layernorm.weight"]),
                       "bias": _t(sd["model.final_layernorm.bias"])}
    p["lm_head"] = {"kernel": _t(sd["lm_head.weight"]).T,
                    "bias": _t(sd["lm_head.bias"])}
    return p


def _mpt_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """MPT: ALiBi, fused Wqkv in [q | k | v] blocks, bias-free everywhere
    (HF modeling_mpt hardcodes bias-free Linears and biasless norms),
    exact-erf GELU (reference mpt-class containers)."""
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    norm_p = lambda key: _norm_p(sd, key)
    p: Dict[str, Any] = {"embed": {"embedding": _t(sd["transformer.wte.weight"])}}
    for i in range(cfg.num_layers):
        pre = f"transformer.blocks.{i}."
        w = _t(sd[pre + "attn.Wqkv.weight"])                 # [3D, D]
        qw, kw, vw = (a.T.reshape(dm, h, dh) for a in np.split(w, 3, axis=0))
        attn = {"q_proj": {"kernel": qw}, "k_proj": {"kernel": kw},
                "v_proj": {"kernel": vw},
                "o_proj": {"kernel": _t(sd[pre + "attn.out_proj.weight"]).T
                           .reshape(h, dh, dm)}}
        mlp = {"up_proj": {"kernel": _t(sd[pre + "ffn.up_proj.weight"]).T},
               "down_proj": {"kernel": _t(sd[pre + "ffn.down_proj.weight"]).T}}
        p[f"layer_{i}"] = {
            "attn": attn,
            "attn_norm": norm_p(pre + "norm_1"),
            "mlp_norm": norm_p(pre + "norm_2"),
            "mlp": mlp,
        }
    p["final_norm"] = norm_p("transformer.norm_f")
    return p


def _clip_text_params(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """CLIPTextModel (reference ``module_inject/containers/clip.py``): pre-LN
    causal text encoder; our Block IS its layer layout (ln1→attn→add,
    ln2→mlp→add), so the map is mechanical."""
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": _t(sd["text_model.embeddings.token_embedding.weight"])},
        "pos_embed": _t(sd["text_model.embeddings.position_embedding.weight"]),
    }
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}."
        p[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": _t(sd[pre + "self_attn.q_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.q_proj.bias"]).reshape(h, dh)},
                "k_proj": {"kernel": _t(sd[pre + "self_attn.k_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.k_proj.bias"]).reshape(h, dh)},
                "v_proj": {"kernel": _t(sd[pre + "self_attn.v_proj.weight"]).T
                           .reshape(dm, h, dh),
                           "bias": _t(sd[pre + "self_attn.v_proj.bias"]).reshape(h, dh)},
                "o_proj": {"kernel": _t(sd[pre + "self_attn.out_proj.weight"]).T
                           .reshape(h, dh, dm),
                           "bias": _t(sd[pre + "self_attn.out_proj.bias"])},
            },
            "attn_norm": {"scale": _t(sd[pre + "layer_norm1.weight"]),
                          "bias": _t(sd[pre + "layer_norm1.bias"])},
            "mlp_norm": {"scale": _t(sd[pre + "layer_norm2.weight"]),
                         "bias": _t(sd[pre + "layer_norm2.bias"])},
            "mlp": {
                "up_proj": {"kernel": _t(sd[pre + "mlp.fc1.weight"]).T,
                            "bias": _t(sd[pre + "mlp.fc1.bias"])},
                "down_proj": {"kernel": _t(sd[pre + "mlp.fc2.weight"]).T,
                              "bias": _t(sd[pre + "mlp.fc2.bias"])},
            },
        }
    p["final_norm"] = {"scale": _t(sd["text_model.final_layer_norm.weight"]),
                       "bias": _t(sd["text_model.final_layer_norm.bias"])}
    return p


def _numpy_tree(sd: Dict[str, Any], cfg: TransformerConfig, d: Dict[str, Any]):
    """The flax-layout numpy tree of a decoder family's state dict."""
    mt = d.get("model_type", "")
    if mt in ("llama", "mistral", "mixtral", "qwen2", "qwen2_moe",
              "starcoder2", "stablelm", "internlm"):
        return _llama_params(sd, cfg)
    if mt == "phi3":
        return _phi3_params(sd, cfg)
    if mt == "falcon":
        return _falcon_params(sd, cfg, d)
    if mt == "gpt_neox":
        return _neox_params(sd, cfg)
    if mt == "opt":
        return _opt_params(sd, cfg)
    if mt == "bloom":
        return _bloom_params(sd, cfg)
    if mt == "gptj":
        return _gptj_params(sd, cfg)
    if mt == "gpt_neo":
        return _gpt_neo_params(sd, cfg)
    if mt == "phi":
        return _phi_params(sd, cfg)
    if mt == "mpt":
        return _mpt_params(sd, cfg)
    if mt == "clip_text_model":
        return _clip_text_params(sd, cfg)
    return _gpt2_params(sd, cfg)


def params_from_hf(model_or_state_dict, hf_config=None, *, device="cuda"):
    """Convert a HF model (anything with ``.state_dict()`` and ``.config``)
    or a state dict of torch tensors or numpy arrays with its ``hf_config``
    into ``(TransformerConfig, params)``: the port's nested tree of float32
    tensors on ``device``, ready for ``InferenceEngineV2`` or the training
    engine."""
    from ..accelerator import resolve_device
    from ..models.convert import params_from_jax

    device = resolve_device(device)      # raises at once without a card
    if hasattr(model_or_state_dict, "state_dict"):
        sd = model_or_state_dict.state_dict()
        hf_config = hf_config or model_or_state_dict.config
    else:
        sd = dict(model_or_state_dict)
        if hf_config is None:
            raise ValueError("pass hf_config when giving a raw state_dict")
    d = _as_dict(hf_config)
    cfg = config_from_hf(d)
    return cfg, params_from_jax(_numpy_tree(sd, cfg, d), cfg, device=device)
