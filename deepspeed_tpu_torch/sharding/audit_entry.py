"""Audit entries of the AutoTP contract per family.

Port of ``deepspeed_tpu/sharding/audit_entry.py``. :func:`toy_hf_checkpoint`
(the fixture generator: a tiny checkpoint of a family in its raw HF layout,
numpy, seeded) and :func:`family_engine` (the checkpoint through
``autotp_initialize``) are ported whole. The audit itself traces the
engine's compiled train step and reconciles its collectives with the comm
planner's records; the port has no traced graph of the step, so
:func:`family_audit_report` and the family entries raise naming ROADMAP.md
Queue A item 9 (``analysis/*``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

#: the families toy_hf_checkpoint draws
FAMILIES = ("llama", "mistral", "gpt_neox", "mixtral")


def toy_hf_checkpoint(family: str, *, vocab: int = 64, dm: int = 32,
                      ff: int = 64, layers: int = 2, heads: int = 4,
                      seed: int = 0) -> Tuple[Dict[str, np.ndarray],
                                              Dict[str, Any]]:
    """(state_dict, hf_config) for a tiny checkpoint of ``family`` in the
    family's genuine raw layout — what ``torch.save``d weights look like
    after numpy conversion, so ``params_from_hf`` exercises its real path."""
    rng = np.random.default_rng(seed)
    w = lambda *shape: rng.normal(0.0, 0.02, shape).astype(np.float32)
    ones = lambda n: np.ones((n,), np.float32)
    zeros = lambda n: np.zeros((n,), np.float32)
    sd: Dict[str, np.ndarray] = {}

    if family in ("llama", "mistral", "mixtral"):
        kv = heads // 2 if family == "mistral" else heads
        dh = dm // heads
        sd["model.embed_tokens.weight"] = w(vocab, dm)
        for i in range(layers):
            pre = f"model.layers.{i}."
            sd[pre + "self_attn.q_proj.weight"] = w(heads * dh, dm)
            sd[pre + "self_attn.k_proj.weight"] = w(kv * dh, dm)
            sd[pre + "self_attn.v_proj.weight"] = w(kv * dh, dm)
            sd[pre + "self_attn.o_proj.weight"] = w(dm, heads * dh)
            sd[pre + "input_layernorm.weight"] = ones(dm)
            sd[pre + "post_attention_layernorm.weight"] = ones(dm)
            if family == "mixtral":
                sd[pre + "block_sparse_moe.gate.weight"] = w(4, dm)
                for e in range(4):
                    ep = pre + f"block_sparse_moe.experts.{e}."
                    sd[ep + "w1.weight"] = w(ff, dm)   # gate_proj
                    sd[ep + "w3.weight"] = w(ff, dm)   # up_proj
                    sd[ep + "w2.weight"] = w(dm, ff)   # down_proj
            else:
                sd[pre + "mlp.gate_proj.weight"] = w(ff, dm)
                sd[pre + "mlp.up_proj.weight"] = w(ff, dm)
                sd[pre + "mlp.down_proj.weight"] = w(dm, ff)
        sd["model.norm.weight"] = ones(dm)
        sd["lm_head.weight"] = w(vocab, dm)
        cfg = {"model_type": "mixtral" if family == "mixtral"
               else family,
               "vocab_size": vocab, "hidden_size": dm,
               "intermediate_size": ff, "num_hidden_layers": layers,
               "num_attention_heads": heads, "num_key_value_heads": kv,
               "max_position_embeddings": 64, "rms_norm_eps": 1e-6,
               "tie_word_embeddings": False}
        if family == "mixtral":
            cfg.update(num_local_experts=4, num_experts_per_tok=2)
        return sd, cfg

    if family == "gpt_neox":
        dh = dm // heads
        sd["gpt_neox.embed_in.weight"] = w(vocab, dm)
        for i in range(layers):
            pre = f"gpt_neox.layers.{i}."
            # fused qkv, per-head [q, k, v] interleaved: [h*3*dh, D]
            sd[pre + "attention.query_key_value.weight"] = w(heads * 3 * dh, dm)
            sd[pre + "attention.query_key_value.bias"] = zeros(heads * 3 * dh)
            sd[pre + "attention.dense.weight"] = w(dm, heads * dh)
            sd[pre + "attention.dense.bias"] = zeros(dm)
            sd[pre + "input_layernorm.weight"] = ones(dm)
            sd[pre + "input_layernorm.bias"] = zeros(dm)
            sd[pre + "post_attention_layernorm.weight"] = ones(dm)
            sd[pre + "post_attention_layernorm.bias"] = zeros(dm)
            sd[pre + "mlp.dense_h_to_4h.weight"] = w(ff, dm)
            sd[pre + "mlp.dense_h_to_4h.bias"] = zeros(ff)
            sd[pre + "mlp.dense_4h_to_h.weight"] = w(dm, ff)
            sd[pre + "mlp.dense_4h_to_h.bias"] = zeros(dm)
        sd["gpt_neox.final_layer_norm.weight"] = ones(dm)
        sd["gpt_neox.final_layer_norm.bias"] = zeros(dm)
        sd["embed_out.weight"] = w(vocab, dm)
        cfg = {"model_type": "gpt_neox", "vocab_size": vocab,
               "hidden_size": dm, "intermediate_size": ff,
               "num_hidden_layers": layers, "num_attention_heads": heads,
               "max_position_embeddings": 64, "rotary_pct": 0.25,
               "layer_norm_eps": 1e-5, "use_parallel_residual": True}
        return sd, cfg

    raise ValueError(f"unknown toy family {family!r} (have {FAMILIES})")


def family_engine(family: str, *, tp: int = 2, zero_stage: int = 3,
                  batch: int = 8, planner: bool = True, device: str = "cuda"):
    """(engine, batch) for a toy ``family`` checkpoint auto-sharded at
    ``tp`` x ZeRO-``zero_stage`` through the whole AutoTP path. At tp > 1
    ZeRO stages 2-3 raise naming ROADMAP.md Queue A item 8, and an engine
    refuses ``comm_planner`` (item 9), so ``planner`` is accepted and
    unused. ``device``: the card unless the caller asks for the CPU."""
    import torch

    from .autotp import autotp_initialize

    sd, hf_cfg = toy_hf_checkpoint(family)
    config = {"train_micro_batch_size_per_gpu": batch,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "tensor_parallel": {"enabled": tp > 1, "tp_size": tp},
              "zero_optimization": {"stage": zero_stage},
              "steps_per_print": 10**9}
    engine, *_ = autotp_initialize(sd, hf_cfg, config=config, device=device)
    gen = torch.Generator().manual_seed(1)
    # the global batch: ``batch`` sequences for each dp replica
    toks = torch.randint(0, hf_cfg["vocab_size"], (batch * engine.dp_world, 16),
                         generator=gen)
    return engine, engine._shape_batch(toks.to(engine.device))


def family_audit_report(family: str):
    """The JAX package traces and compiles the auto-sharded train step and
    audits it against the ledger's plan records; the port has no traced
    graph to audit."""
    raise NotImplementedError(
        f"family_audit_report({family!r}) needs a traced graph of the train step, "
        "which the port does not have yet: ROADMAP.md Queue A item 9 (analysis/*)")


def llama():
    return family_audit_report("llama")


def mistral():
    return family_audit_report("mistral")


def gpt_neox():
    return family_audit_report("gpt_neox")


def mixtral():
    return family_audit_report("mixtral")
