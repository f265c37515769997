"""Megatron-LM GPT checkpoint ingestion.

Port of ``deepspeed_tpu/inference/megatron.py``. Reference: ``module_inject/containers/megatron_gpt.py`` (+
``megatron_gpt_moe.py``) inject fused kernels into Megatron-LM GPT models,
and ``runtime/state_dict_factory.py`` MegatronSDLoader re-partitions their
TP shards — including the checkpoint-version switch for the fused
query-key-value head layout (``split_query_key_value:277``: ckpt_ver 0
stores ``[q | k | v]`` blocks, 1.0 per-(head, row) triples, 2.0 per-head
``[q, k, v]`` — 1.0/2.0 TP-split as a plain slice).

The flow: merge raw TP shards with
``checkpoint.state_dict_factory.SDLoader`` (which speaks both QKV layouts),
then map the merged dict to the flax-layout ``TransformerLM`` tree here:
:func:`megatron_params` builds the same float32 numpy tree, leaf for leaf,
as the JAX package's converter, and ``models.params_from_jax`` places it on
the device (the card unless the caller asks for the CPU).
``params_to_megatron`` is the exact inverse, for export and round trips.
Everything here runs on the host: it is file conversion.
"""

from typing import Any, Dict, Optional

import numpy as np

from ..models.transformer import TransformerConfig

_PRE = "model.language_model."


def load_megatron_checkpoint(path: str, trust_pickle: bool = False):
    """Load a real Megatron-LM ``model_optim_rng.pt`` (torch pickle) to
    ``(args_dict, flat_numpy_state_dict)`` ready for :func:`megatron_config`
    + :func:`megatron_params`. torch (cpu) deserializes; everything leaves
    as numpy so no torch state lingers.

    Reference flow: ``ds_to_universal``/``MegatronSDLoader`` read the same
    files (``state_dict_factory.py`` ``SDLoaderBase.load``)."""
    import torch

    # Megatron checkpoints pickle an argparse.Namespace for ``args``; allow
    # just that type under the safe (weights_only) loader so untrusted
    # checkpoints cannot execute arbitrary pickled code. ``trust_pickle=True``
    # is the explicit opt-in for checkpoints carrying exotic objects.
    import argparse
    import contextlib
    import pickle
    # Real Megatron checkpoints pickle argparse.Namespace (``args``) and the
    # numpy RNG state tuple (``rng_state[*]['np_rng_state']``); allowlist
    # exactly those, scoped to this one load (torch >= 2.5 context manager)
    # so the process-global weights_only allowlist is not widened for
    # unrelated torch.load callers.
    _ma = getattr(np, "_core", getattr(np, "core", None)).multiarray
    allow = [argparse.Namespace, np.ndarray, np.dtype,
             np.dtypes.Float64DType, np.dtypes.UInt32DType,
             _ma._reconstruct]
    can_allowlist = hasattr(torch.serialization, "add_safe_globals")  # >= 2.4
    if hasattr(torch.serialization, "safe_globals"):  # >= 2.5, scoped
        scope = torch.serialization.safe_globals(allow)
    elif can_allowlist:
        # torch 2.4.x: no context manager — snapshot and restore so the
        # process-global allowlist is not widened for unrelated torch.load
        # callers after this function returns
        @contextlib.contextmanager
        def _scoped():
            before = list(torch.serialization.get_safe_globals())
            torch.serialization.add_safe_globals(allow)
            try:
                yield
            finally:
                torch.serialization.clear_safe_globals()
                torch.serialization.add_safe_globals(before)
        scope = _scoped()
    else:
        scope = contextlib.nullcontext()
    try:
        with scope:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # path typos / bad zips propagate as-is above; only the safe
        # loader's pickle rejection routes here. Full unpickling executes
        # arbitrary pickled code, so it ALWAYS requires the explicit opt-in
        # — including on torch < 2.4, where the missing allowlist means even
        # ordinary checkpoints need it (upgrade torch for the safe loader).
        if not trust_pickle:
            hint = ("exotic pickled objects, or a corrupt file — "
                    "trust_pickle will not fix corruption" if can_allowlist
                    else f"torch {torch.__version__} cannot allowlist "
                    "argparse.Namespace; upgrade to torch >= 2.4")
            raise ValueError(
                f"safe load of {path} failed ({hint}); pass "
                "trust_pickle=True only for files you trust")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    args = ckpt.get("args")
    if args is not None and not isinstance(args, dict):
        def scalarish(v):
            return (isinstance(v, (int, float, bool, str, type(None)))
                    or (isinstance(v, (list, tuple))
                        and all(isinstance(e, (int, float, bool, str)) for e in v)))
        # lists survive: Megatron-DeepSpeed stores num_experts as nargs='+'
        args = {k: v for k, v in vars(args).items() if scalarish(v)}

    flat: Dict[str, Any] = {}

    def walk(node, prefix=""):
        if hasattr(node, "detach"):
            t = node.detach().cpu()
            if t.is_floating_point():
                t = t.float()
            flat[prefix.rstrip(".")] = t.numpy()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")

    if "model" in ckpt:
        # real layout is ckpt["model"]["language_model"]... — re-add the
        # "model." prefix the _PRE-keyed converters expect
        walk(ckpt["model"], "model.")
    else:
        walk(ckpt)
    return args or {}, flat


def megatron_config(args: Dict[str, Any],
                    sd: Optional[Dict[str, Any]] = None) -> TransformerConfig:
    """Map Megatron-LM ``args`` (as stored in its checkpoints) to our config.
    Classic GPT: learned positions, LayerNorm, (tanh) GELU, tied embeddings.
    DeepSpeed-MoE training (reference ``megatron_gpt_moe`` container): pass
    ``num_experts``/``top_k``; pass the merged state dict ``sd`` as well so
    the MoE layer placement (``--expert-interval`` spacing) is derived from
    where the checkpoint actually has gate weights.
    """
    d = dict(args)
    ne = d.get("num_experts", 0) or 0
    if isinstance(ne, (list, tuple)):  # Megatron-DeepSpeed --num-experts nargs='+'
        if len(set(ne)) > 1:
            raise ValueError(f"per-layer expert counts {ne} are not supported")
        ne = ne[0] if ne else 0
    ne = int(ne)
    if ne <= 1:  # Megatron-DeepSpeed's dense default is num_experts=[1]
        ne = 0
    k = int(d.get("top_k", d.get("topk", 1)))
    every, offset = 1, 0
    if ne and sd is not None:
        moe_layers = sorted(
            i for i in range(d["num_layers"])
            if f"{_PRE}transformer.layers.{i}.mlp.deepspeed_moe.gate.wg.weight"
            in sd)
        if not moe_layers:
            ne = 0
        else:
            every = (moe_layers[1] - moe_layers[0]
                     if len(moe_layers) > 1 else d["num_layers"])
            offset = moe_layers[0]
            # Block gates on layer_idx % every == offset % every, so the
            # pattern must start at offset % every (a dense PREFIX before
            # the first MoE layer is not expressible)
            if (offset >= every
                    or moe_layers != list(range(offset, d["num_layers"],
                                                every))):
                raise ValueError(
                    f"irregular MoE layer placement {moe_layers} cannot be "
                    "expressed as (moe_every, moe_offset)")
    return TransformerConfig(
        num_experts=ne,
        moe_every=every, moe_offset=offset,
        # DeepSpeed-MoE --topk defaults to 1; top1gating combines with the
        # RAW softmax probability (no top-k renormalization), top2+ with the
        # normalized weights (reference sharded_moe.py top1/top2gating)
        moe_top_k=k, moe_norm_topk=(k >= 2),
        vocab_size=d["padded_vocab_size"] if "padded_vocab_size" in d
        else d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d.get("ffn_hidden_size") or 4 * d["hidden_size"],
        num_layers=d["num_layers"], num_heads=d["num_attention_heads"],
        max_seq_len=d.get("max_position_embeddings", 1024),
        norm="layernorm", activation="gelu", position="learned",
        norm_eps=d.get("layernorm_epsilon", 1e-5),
        attn_qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_embeddings=True)


def _split_qkv(w, b, cfg: TransformerConfig, version: int):
    """Un-fuse query_key_value per the checkpoint version (reference
    ``split_query_key_value``, ``state_dict_factory.py:277``):
    v0 = ``[(3*H*Dh), D]`` blocks [q | k | v]; v1.0 = ``[(H*Dh*3), D]``
    per-(head, row) triple; v2.0 = ``[(H*3*Dh), D]`` per-head [q, k, v].
    w: [3*H*Dh, D]; b: [3*H*Dh] or None."""
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    if version == 0:  # [q | k | v] blocks
        qw, kw, vw = (a.reshape(h, dh, dm) for a in np.split(w, 3, axis=0))
        if b is not None:
            qb, kb, vb = (a.reshape(h, dh) for a in np.split(b, 3))
    elif version == 1:  # [h, dh, 3]
        w = w.reshape(h, dh, 3, dm)
        qw, kw, vw = w[:, :, 0], w[:, :, 1], w[:, :, 2]   # [h, dh, D]
        if b is not None:
            b = b.reshape(h, dh, 3)
            qb, kb, vb = b[:, :, 0], b[:, :, 1], b[:, :, 2]
    else:             # v2.0: per-head [q, k, v] blocks of dh
        w = w.reshape(h, 3, dh, dm)
        qw, kw, vw = w[:, 0], w[:, 1], w[:, 2]            # [h, dh, D]
        if b is not None:
            b = b.reshape(h, 3, dh)
            qb, kb, vb = b[:, 0], b[:, 1], b[:, 2]
    to_flax = lambda a: np.ascontiguousarray(np.transpose(a, (2, 0, 1)))
    out = {
        "q_proj": {"kernel": to_flax(qw)},
        "k_proj": {"kernel": to_flax(kw)},
        "v_proj": {"kernel": to_flax(vw)},
    }
    if b is not None:
        out["q_proj"]["bias"] = np.ascontiguousarray(qb)
        out["k_proj"]["bias"] = np.ascontiguousarray(kb)
        out["v_proj"]["bias"] = np.ascontiguousarray(vb)
    return out


def megatron_params(sd: Dict[str, Any], cfg: TransformerConfig,
                    version: int = 2) -> Dict[str, Any]:
    """Merged (single-TP) Megatron-GPT state dict → TransformerLM params."""
    def t(key):
        x = sd[key]
        if hasattr(x, "detach"):
            x = x.detach().cpu().float().numpy()
        return np.asarray(x, np.float32)

    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    p: Dict[str, Any] = {
        "embed": {"embedding": t(_PRE + "embedding.word_embeddings.weight")},
        "pos_embed": t(_PRE + "embedding.position_embeddings.weight"),
    }
    for i in range(cfg.num_layers):
        pre = _PRE + f"transformer.layers.{i}."
        attn = _split_qkv(
            t(pre + "attention.query_key_value.weight"),
            t(pre + "attention.query_key_value.bias")
            if pre + "attention.query_key_value.bias" in sd else None,
            cfg, version)
        attn["o_proj"] = {
            "kernel": np.ascontiguousarray(
                t(pre + "attention.dense.weight").T.reshape(h, dh, dm)),
            "bias": t(pre + "attention.dense.bias")}
        layer = {
            "attn": attn,
            "attn_norm": {"scale": t(pre + "input_layernorm.weight"),
                          "bias": t(pre + "input_layernorm.bias")},
            "mlp_norm": {"scale": t(pre + "post_attention_layernorm.weight"),
                         "bias": t(pre + "post_attention_layernorm.bias")},
        }
        moe_pre = pre + "mlp.deepspeed_moe."
        if moe_pre + "gate.wg.weight" in sd:
            # DeepSpeed-MoE layer (reference moe/layer.py:73: MOELayer with
            # TopKGate.wg + Experts.deepspeed_experts ParallelMLP copies).
            # The expert count comes from the CHECKPOINT (router rows), not
            # the possibly-absent args entry.
            wg = t(moe_pre + "gate.wg.weight")
            n_exp = wg.shape[0]
            if cfg.num_experts != n_exp:
                raise ValueError(
                    f"layer {i}: checkpoint has {n_exp} experts but the "
                    f"config says {cfg.num_experts} — build the config with "
                    "megatron_config(args, sd=merged_state_dict)")
            ups, dns, upb, dnb = [], [], [], []
            for e_i in range(n_exp):
                ep = moe_pre + f"experts.deepspeed_experts.{e_i}."
                ups.append(t(ep + "dense_h_to_4h.weight").T)
                dns.append(t(ep + "dense_4h_to_h.weight").T)
                upb.append(t(ep + "dense_h_to_4h.bias"))
                dnb.append(t(ep + "dense_4h_to_h.bias"))
            layer["moe"] = {
                "router": {"kernel": wg.T},
                "expert_up_proj": np.stack(ups),
                "expert_down_proj": np.stack(dns),
                "expert_up_bias": np.stack(upb),
                "expert_down_bias": np.stack(dnb),
            }
        else:
            layer["mlp"] = {
                "up_proj": {"kernel": t(pre + "mlp.dense_h_to_4h.weight").T,
                            "bias": t(pre + "mlp.dense_h_to_4h.bias")},
                "down_proj": {"kernel": t(pre + "mlp.dense_4h_to_h.weight").T,
                              "bias": t(pre + "mlp.dense_4h_to_h.bias")},
            }
        p[f"layer_{i}"] = layer
    p["final_norm"] = {
        "scale": t(_PRE + "transformer.final_layernorm.weight"),
        "bias": t(_PRE + "transformer.final_layernorm.bias")}
    return p


def params_to_megatron(params: Dict[str, Any], cfg: TransformerConfig,
                       version: int = 2) -> Dict[str, np.ndarray]:
    """TransformerLM params → Megatron-GPT state dict (export / round-trip).
    Inverse of :func:`megatron_params` for the same checkpoint version."""
    h, dh, dm = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    a = lambda x: np.asarray(x, np.float32)
    sd: Dict[str, np.ndarray] = {
        _PRE + "embedding.word_embeddings.weight": a(params["embed"]["embedding"]),
        _PRE + "embedding.position_embeddings.weight": a(params["pos_embed"]),
    }
    for i in range(cfg.num_layers):
        lp = params[f"layer_{i}"]
        pre = _PRE + f"transformer.layers.{i}."
        # flax [D, h, dh] -> megatron rows [h, dh, D]
        rows = lambda n: np.transpose(a(lp["attn"][n]["kernel"]), (1, 2, 0))
        qw, kw, vw = rows("q_proj"), rows("k_proj"), rows("v_proj")
        bias_of = lambda n: a(lp["attn"][n]["bias"])
        has_b = "bias" in lp["attn"]["q_proj"]
        if version == 0:   # [q | k | v] blocks
            w = np.concatenate([x.reshape(h * dh, dm) for x in (qw, kw, vw)])
            if has_b:
                b = np.concatenate([bias_of(n).reshape(h * dh)
                                    for n in ("q_proj", "k_proj", "v_proj")])
        elif version == 1:  # [h, dh, 3]
            w = np.stack([qw, kw, vw], axis=2).reshape(3 * h * dh, dm)
            if has_b:
                b = np.stack([bias_of("q_proj"), bias_of("k_proj"),
                              bias_of("v_proj")], axis=2).reshape(3 * h * dh)
        else:               # v2.0: per-head [q, k, v]
            w = np.stack([qw, kw, vw], axis=1).reshape(3 * h * dh, dm)
            if has_b:
                b = np.stack([bias_of("q_proj"), bias_of("k_proj"),
                              bias_of("v_proj")], axis=1).reshape(3 * h * dh)
        sd[pre + "attention.query_key_value.weight"] = np.ascontiguousarray(w)
        if has_b:
            sd[pre + "attention.query_key_value.bias"] = np.ascontiguousarray(b)
        sd[pre + "attention.dense.weight"] = np.ascontiguousarray(
            a(lp["attn"]["o_proj"]["kernel"]).reshape(h * dh, dm).T)
        sd[pre + "attention.dense.bias"] = a(lp["attn"]["o_proj"]["bias"])
        sd[pre + "input_layernorm.weight"] = a(lp["attn_norm"]["scale"])
        sd[pre + "input_layernorm.bias"] = a(lp["attn_norm"]["bias"])
        sd[pre + "post_attention_layernorm.weight"] = a(lp["mlp_norm"]["scale"])
        sd[pre + "post_attention_layernorm.bias"] = a(lp["mlp_norm"]["bias"])
        if "moe" in lp:
            mp = lp["moe"]
            if "expert_gate_proj" in mp or "shared_up_proj" in mp:
                raise ValueError(
                    "megatron export supports only ParallelMLP-style experts "
                    "(up/down + biases); gated (swiglu) or shared-expert MoE "
                    "trees have no Megatron-DeepSpeed representation")
            if "expert_up_bias" not in mp:
                raise ValueError(
                    "megatron ParallelMLP experts carry biases; this MoE "
                    "tree has none (ffn_bias=False config)")
            moe_pre = pre + "mlp.deepspeed_moe."
            sd[moe_pre + "gate.wg.weight"] = np.ascontiguousarray(
                a(mp["router"]["kernel"]).T)
            up, down = a(mp["expert_up_proj"]), a(mp["expert_down_proj"])
            upb, dnb = a(mp["expert_up_bias"]), a(mp["expert_down_bias"])
            for e_i in range(up.shape[0]):
                ep = moe_pre + f"experts.deepspeed_experts.{e_i}."
                sd[ep + "dense_h_to_4h.weight"] = np.ascontiguousarray(up[e_i].T)
                sd[ep + "dense_h_to_4h.bias"] = upb[e_i]
                sd[ep + "dense_4h_to_h.weight"] = np.ascontiguousarray(down[e_i].T)
                sd[ep + "dense_4h_to_h.bias"] = dnb[e_i]
        else:
            sd[pre + "mlp.dense_h_to_4h.weight"] = np.ascontiguousarray(
                a(lp["mlp"]["up_proj"]["kernel"]).T)
            sd[pre + "mlp.dense_h_to_4h.bias"] = a(lp["mlp"]["up_proj"]["bias"])
            sd[pre + "mlp.dense_4h_to_h.weight"] = np.ascontiguousarray(
                a(lp["mlp"]["down_proj"]["kernel"]).T)
            sd[pre + "mlp.dense_4h_to_h.bias"] = a(lp["mlp"]["down_proj"]["bias"])
    sd[_PRE + "transformer.final_layernorm.weight"] = a(params["final_norm"]["scale"])
    sd[_PRE + "transformer.final_layernorm.bias"] = a(params["final_norm"]["bias"])
    return sd
