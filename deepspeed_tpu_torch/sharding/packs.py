"""Built-in rule packs: the Megatron TP vocabulary as explicit rule sets.

Port of ``deepspeed_tpu/sharding/packs.py``, whole.

One generic pack covers the whole normalized parameter vocabulary the HF
ingestion layer (``inference/hf.py``) and the toy ``TransformerLM`` share —
``q/k/v/gate/up`` column-parallel, ``o/down`` row-parallel, embeddings and
untied heads vocab/hidden-sharded, MoE expert stacks over ``ep`` (the
reference ``module_inject/auto_tp.py`` name classification, made
declarative).  Family packs (llama / mistral / gpt2 / gpt-neox / mixtral
— the HF model-family tree shapes) restrict that vocabulary to exactly the
rules their family's tree exercises, so each pack is a complete, auditable
statement of how its family shards and nothing more.

``models/transformer.py::param_specs`` delegates here.
"""

from __future__ import annotations

from typing import Dict, Optional

from .rules import Rule, RuleSet

TP = "tp"
EP = "ep"

# --- the shared Megatron vocabulary, one decision per rule ----------------
# Priorities encode the reference classifier's if/elif ladder: expert stacks
# first (an expert_down_proj is an expert, not a down_proj), then per-role
# bias/kernel splits (bias above kernel so `q_proj/bias` never takes the
# kernel spec), embeddings and heads last.

_EXPERT_RULES = (
    # MoE expert stacks [E, ...] shard over ep; down_proj also row-splits
    Rule(r"expert.*down_proj", (EP, TP, None), priority=40,
         note="expert down: ep-stacked row-parallel"),
    Rule(r"expert", (EP, None, TP), priority=36, ndim=3,
         note="expert up/gate: ep-stacked column-parallel"),
    Rule(r"expert", (EP,), priority=35,
         note="other expert leaves: shard the expert dim"),
)

_QKV_RULES = (
    Rule(r"(q_proj|k_proj|v_proj)/bias$", (TP, None), priority=31, ndim=2,
         note="qkv bias [H, Dh]: shard heads with the kernel"),
    Rule(r"(q_proj|k_proj|v_proj)/bias$", (TP,), priority=31,
         note="qkv bias [H*Dh]: shard the fused head dim"),
    Rule(r"q_proj|k_proj|v_proj", (None, TP, None), priority=30, ndim=3,
         note="qkv DenseGeneral kernel [D, H, Dh]: column-parallel heads"),
    Rule(r"q_proj|k_proj|v_proj", (None, TP), priority=30,
         note="qkv kernel [D, H*Dh]: column-parallel"),
)

_MLP_IN_RULES = (
    Rule(r"(gate_proj|up_proj)/bias$", (TP,), priority=28,
         note="mlp-in bias [F]: shards with the column output"),
    Rule(r"gate_proj|up_proj", (None, TP), priority=27, ndim=2,
         note="mlp-in kernel [D, F]: column-parallel"),
    Rule(r"gate_proj|up_proj", (TP,), priority=27,
         note="mlp-in, other rank: shard the leading dim"),
)

_O_RULES = (
    Rule(r"o_proj/bias$", (None,), priority=26,
         note="attn-out bias [D]: row-parallel output replicates"),
    Rule(r"o_proj", (TP, None, None), priority=25, ndim=3,
         note="attn-out DenseGeneral kernel [H, Dh, D]: row-parallel heads"),
    Rule(r"o_proj", (TP, None), priority=25,
         note="attn-out kernel [H*Dh, D]: row-parallel"),
)

_MLP_OUT_RULES = (
    Rule(r"down_proj/bias$", (None,), priority=24,
         note="mlp-out bias [D]: row-parallel output replicates"),
    Rule(r"down_proj", (TP, None), priority=23, ndim=2,
         note="mlp-out kernel [F, D]: row-parallel"),
    Rule(r"down_proj", (), priority=23,
         note="mlp-out, other rank: replicate"),
)

_EMBED_RULES = (
    Rule(r"embed", (None, TP), priority=20, ndim=2,
         note="embedding table [V, D] (and learned pos table): shard hidden"),
)

_HEAD_RULES = (
    Rule(r"lm_head/bias$", (TP,), priority=18,
         note="head bias [V]: shards with the vocab-sharded output"),
    Rule(r"lm_head", (None, TP), priority=17, ndim=2,
         note="untied head kernel [D, V]: vocab-sharded"),
)

_DENSE_RULES = _QKV_RULES + _MLP_IN_RULES + _O_RULES + _MLP_OUT_RULES


def generic_pack() -> RuleSet:
    """The full vocabulary: any normalized HF-shaped tree shards under it.
    ``models/transformer.py::param_specs`` is this pack, verbatim."""
    return RuleSet(
        _EXPERT_RULES + _DENSE_RULES + _EMBED_RULES + _HEAD_RULES,
        name="generic", axes=(TP, EP))


def llama_pack() -> RuleSet:
    """llama-shaped trees: rmsnorm (scale only), gated swiglu MLP, rope,
    untied head, no biases anywhere."""
    return RuleSet(_DENSE_RULES + _EMBED_RULES + _HEAD_RULES,
                   name="llama", axes=(TP,))


def mistral_pack() -> RuleSet:
    """mistral-shaped trees: llama layout with grouped kv heads + sliding
    window — the sharding decisions are the llama set."""
    return RuleSet(_DENSE_RULES + _EMBED_RULES + _HEAD_RULES,
                   name="mistral", axes=(TP,))


def gpt2_pack() -> RuleSet:
    """gpt2-shaped trees: learned position table, layernorm with biases,
    biased projections, tied head (no lm_head leaves)."""
    return RuleSet(_DENSE_RULES + _EMBED_RULES,
                   name="gpt2", axes=(TP,))


def gpt_neox_pack() -> RuleSet:
    """gpt-neox-shaped trees: layernorm with biases, biased projections,
    non-gated MLP, untied embed_out head."""
    return RuleSet(_DENSE_RULES + _EMBED_RULES + _HEAD_RULES,
                   name="gpt_neox", axes=(TP,))


def mixtral_pack() -> RuleSet:
    """mixtral-shaped trees: llama layout + block-sparse MoE expert stacks
    (experts over ep; router replicated by omission)."""
    return RuleSet(_EXPERT_RULES + _DENSE_RULES + _EMBED_RULES + _HEAD_RULES,
                   name="mixtral", axes=(TP, EP))


PACKS: Dict[str, object] = {
    "generic": generic_pack,
    "llama": llama_pack,
    "mistral": mistral_pack,
    "gpt2": gpt2_pack,
    "gpt_neox": gpt_neox_pack,
    "mixtral": mixtral_pack,
}


def get_pack(name: str) -> RuleSet:
    try:
        return PACKS[name]()
    except KeyError:
        raise KeyError(f"unknown rule pack {name!r} "
                       f"(built-ins: {sorted(PACKS)})") from None


def pack_for_config(cfg) -> RuleSet:
    """Pick the family pack for a ``TransformerConfig`` (the shape the HF
    ingestion layer normalized a checkpoint into) by its structural
    features, not its name — zero model-specific code at the call site."""
    if getattr(cfg, "num_experts", 0) > 0:
        return mixtral_pack()
    if getattr(cfg, "position", "rope") == "learned":
        if getattr(cfg, "tie_embeddings", False):
            return gpt2_pack()
        return gpt_neox_pack()  # opt-style learned-pos untied head
    if getattr(cfg, "norm", "rmsnorm") == "layernorm":
        return gpt_neox_pack()
    if getattr(cfg, "num_kv_heads", None) not in (
            None, 0, getattr(cfg, "num_heads", None)):
        return mistral_pack()  # grouped-query llama variant
    return llama_pack()
