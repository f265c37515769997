"""Parameters for the port: conversion from the JAX package's tree, and
seeded initialization on the device.

The port keeps the flax parameter layout of
``deepspeed_tpu/models/transformer.py`` unchanged — nested dictionaries keyed
``embed/embedding``, ``layer_{i}/{attn_norm, attn/{q,k,v,o}_proj,
mlp_norm, mlp/{gate,up,down}_proj}``, ``final_norm``, ``lm_head`` — with the
DenseGeneral kernel layouts ``[in, heads, head_dim]`` (q/k/v) and
``[heads, head_dim, out]`` (o). The serving forward reshapes these to 2-D
matrices as views, so no weight is ever transposed or copied. This module is
the one place where those layouts are stated and checked.
"""

import math
from typing import Dict

import numpy as np
import torch

from .transformer import TransformerConfig


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """``"/"``-joined parameter path -> shape. Layer i holds an MoE block
    (``layer_i/moe/...``) in place of its ``mlp`` when :func:`is_moe_layer`
    says so."""
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Hq, Hk, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    shapes = {"embed/embedding": (V, H)}
    if cfg.position == "learned":
        shapes["pos_embed"] = (cfg.max_seq_len + cfg.pos_offset, H)

    def norm(prefix):
        shapes[f"{prefix}/scale"] = (H,)
        if cfg.norm == "layernorm" and cfg.norm_bias:
            shapes[f"{prefix}/bias"] = (H,)

    def dense(prefix, shape, bias):
        shapes[f"{prefix}/kernel"] = shape
        if bias:
            shapes[f"{prefix}/bias"] = shape[1:]

    if cfg.embed_norm:
        norm("embed_norm")
    for i in range(cfg.num_layers):
        p = f"layer_{i}"
        norm(f"{p}/attn_norm")
        dense(f"{p}/attn/q_proj", (H, Hq, D), cfg.qkv_bias)
        dense(f"{p}/attn/k_proj", (H, Hk, D), cfg.qkv_bias)
        dense(f"{p}/attn/v_proj", (H, Hk, D), cfg.qkv_bias)
        shapes[f"{p}/attn/o_proj/kernel"] = (Hq, D, H)
        if cfg.out_bias:
            shapes[f"{p}/attn/o_proj/bias"] = (H,)
        if not (cfg.parallel_residual and cfg.parallel_shared_norm):
            norm(f"{p}/mlp_norm")
        if is_moe_layer(cfg, i):
            shapes.update(moe_shapes(cfg, f"{p}/moe"))
            continue
        if cfg.activation == "swiglu":
            dense(f"{p}/mlp/gate_proj", (H, F_), cfg.ffn_bias)
        dense(f"{p}/mlp/up_proj", (H, F_), cfg.ffn_bias)
        dense(f"{p}/mlp/down_proj", (F_, H), cfg.ffn_bias)
    norm("final_norm")
    if not (cfg.tie_embeddings or cfg.no_lm_head):
        dense("lm_head", (H, V), cfg.lm_head_bias)
    return shapes


def is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    """Layer i holds an MoE block: ``i % moe_every == moe_offset %
    moe_every`` (HF qwen2_moe's ``decoder_sparse_step``), as in the JAX
    block."""
    return cfg.num_experts > 0 and i % cfg.moe_every == cfg.moe_offset % cfg.moe_every


def moe_shapes(cfg: TransformerConfig, prefix: str) -> Dict[str, tuple]:
    """The MoE block's leaves under ``prefix`` (JAX ``moe/layer.py``)."""
    D, E = cfg.hidden_size, cfg.num_experts
    F_ = cfg.moe_intermediate_size or cfg.intermediate_size
    swiglu = cfg.activation == "swiglu"
    shapes = {f"{prefix}/router/kernel": (D, E)}
    if swiglu:
        shapes[f"{prefix}/expert_gate_proj"] = (E, D, F_)
    shapes[f"{prefix}/expert_up_proj"] = (E, D, F_)
    shapes[f"{prefix}/expert_down_proj"] = (E, F_, D)
    if cfg.ffn_bias:
        shapes[f"{prefix}/expert_up_bias"] = (E, F_)
        shapes[f"{prefix}/expert_down_bias"] = (E, D)
        if swiglu:
            shapes[f"{prefix}/expert_gate_bias"] = (E, F_)
    fs = cfg.moe_shared_expert_size
    if fs:
        shapes.update({f"{prefix}/shared_gate_proj": (D, fs),
                       f"{prefix}/shared_up_proj": (D, fs),
                       f"{prefix}/shared_down_proj": (fs, D),
                       f"{prefix}/shared_router": (D, 1)})
    if cfg.moe_use_residual:
        shapes[f"{prefix}/residual_up_proj"] = (D, F_)
        shapes[f"{prefix}/residual_down_proj"] = (F_, D)
        if swiglu:
            shapes[f"{prefix}/residual_gate_proj"] = (D, F_)
        shapes[f"{prefix}/residual_coefficient"] = (D, 2)
    return shapes


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _nest(flat):
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_jax(params_np, cfg: TransformerConfig, device="cuda"):
    """The JAX package's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.device_get(model.init(...)["params"])``) as the port's parameters:
    the same nested keys, each leaf a contiguous float32 tensor on
    ``device`` with its flax layout unchanged. Raises on a missing, extra or
    misshapen leaf."""
    from ..accelerator import resolve_device

    dev = resolve_device(device)
    flat = _flatten(params_np)
    want = param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(want) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(want))}")
    out = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != want[path]:
            raise ValueError(f"{path}: shape {arr.shape} != {want[path]}")
        # a contiguous copy: converters hand over transposed views
        out[path] = torch.from_numpy(np.array(arr, np.float32, order="C")).to(dev)
    return _nest(out)


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Seeded random weights drawn on ``device`` from a ``torch.Generator``
    (so a full-size model never exists on the host): norm scales 1, biases
    0, embeddings N(0, 1), kernels N(0, 1/fan_in) — the flax initializers'
    scales, which keep activations O(1) through a deep stack. An expert
    stack ``[E, in, out]`` has fan-in ``E * in``, as flax's ``lecun_normal``
    counts a leading dimension as a receptive field."""
    from ..accelerator import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for path, shape in param_shapes(cfg).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "scale":
            t = torch.ones(shape, dtype=dtype, device=dev)
        elif leaf.endswith("bias"):
            t = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            if path in ("embed/embedding", "pos_embed"):
                std = 1.0
            elif path.endswith("o_proj/kernel") or leaf.startswith("expert_"):
                std = 1.0 / math.sqrt(shape[0] * shape[1])
            else:
                std = 1.0 / math.sqrt(shape[0])
            t = torch.empty(shape, dtype=dtype, device=dev)
            t.normal_(0.0, std, generator=gen)
        out[path] = t
    return _nest(out)
