"""Transformer configuration, the shared numerics, and the training model.

Port of ``deepspeed_tpu/models/transformer.py``: the config (same field
names, so a JAX config converts field by field), the rotary table and its
two pairings, the activations, the flash combine, ``attention_core``, the
causal LM as an ``nn.Module`` (``TransformerLM``), ``causal_lm_loss``,
``make_loss_fn`` and the family presets.

Parameters keep the flax layout of ``models/convert.py`` (nested dicts keyed
by the flax paths), so one parameter tree serves the trainer and
``InferenceEngineV2``; the functional pieces below (``_norm``, ``_dense``,
``_mlp``, ``_embed``, ``_lm_logits``, ...) are the one definition of the
numerics that both the serving forward (``inference/v2/model.py``) and the
training forward run.
"""

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..moe import layer as moe_layer
from ..ops.quant import fold_in


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1376
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None          # GQA; None -> = num_heads
    max_seq_len: int = 2048
    # family switches
    norm: str = "rmsnorm"                       # rmsnorm (llama) | layernorm (gpt2)
    norm_bias: bool = True                      # mpt: LayerNorm without bias
    activation: str = "swiglu"                  # swiglu | gelu | gelu_exact | relu | quick_gelu
    position: str = "rope"                      # rope (llama) | learned (gpt2) | alibi (falcon-rw)
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dropout: float = 0.0                        # on the attention output, given a seed
    # architecture flags (None = follow the norm-type heuristic)
    attn_qkv_bias: Optional[bool] = None
    attn_out_bias: Optional[bool] = None
    mlp_bias: Optional[bool] = None
    parallel_residual: bool = False             # falcon / gpt-neox / gpt-j
    parallel_shared_norm: bool = False          # falcon-7b: one norm feeds both
    rotary_pct: float = 1.0                     # gpt-neox partial rotary
    rotary_interleaved: bool = False            # gpt-j rotate-every-two pairs
    pos_offset: int = 0                         # OPT: learned pos ids offset 2
    embed_norm: bool = False                    # bloom word_embeddings_layernorm
    alibi_post_scale: bool = False
    lm_head_bias: bool = False                  # gpt-j / phi biased lm_head
    no_lm_head: bool = False                    # clip text encoder: the hidden states
    vocab_parallel_loss: bool = False           # tp-sharded CE (sequence/cross_entropy.py)
    attn_scale: Optional[float] = None          # gpt-neo trains UNSCALED (1.0)
    layer_windows: Optional[Any] = None         # gpt-neo local attention
    # MoE (mixtral / qwen2_moe): layer i is an MoE block when
    # i % moe_every == moe_offset % moe_every (moe/layer.py)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1
    moe_offset: int = 0
    moe_intermediate_size: Optional[int] = None
    moe_shared_expert_size: int = 0
    moe_norm_topk: bool = True
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None
    moe_drop_tokens: bool = True
    moe_use_rts: bool = True
    moe_use_residual: bool = False
    moe_dropless: bool = False
    # execution
    dtype: Any = torch.bfloat16
    remat: bool = False                         # recompute each layer in the backward
    remat_policy: Optional[str] = None          # runtime/activation_checkpointing.POLICIES
    sequence_parallel: bool = False             # SP over 'sp' (not ported: raises)
    sp_impl: str = "ulysses"                    # ulysses | ring
    attn_impl: str = "auto"                     # auto | xla | flash (the CUDA kernels)
    # serving fused-decode attention pin: auto | einsum | pallas (the name
    # of the kernel path, as in the JAX package)
    decode_attn_impl: str = "auto"
    loss_impl: str = "auto"                     # auto | xla | fused (the CUDA kernels)
    embed_overlap: str = "auto"                 # auto | xla | ring (ops/collective_matmul.py)
    overlap_collective_matmul: bool = False     # tp rings (ops/collective_matmul.py)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def rotary_dim(self):
        d = int(self.head_dim * self.rotary_pct)
        return d - d % 2  # rope rotates pairs

    @property
    def qkv_bias(self):
        return (self.norm == "layernorm" if self.attn_qkv_bias is None
                else self.attn_qkv_bias)

    @property
    def out_bias(self):
        return (self.norm == "layernorm" if self.attn_out_bias is None
                else self.attn_out_bias)

    @property
    def ffn_bias(self):
        return self.norm == "layernorm" if self.mlp_bias is None else self.mlp_bias


def rope_table(seq_len: int, head_dim: int, theta: float, device="cpu"):
    """(cos, sin) ``[seq_len, head_dim // 2]`` float32. Built in numpy
    float64 exactly as the JAX package builds it, then rounded once to
    float32, so both packages rotate by the same table."""
    pos = np.arange(seq_len)
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    angles = np.outer(pos, freqs)
    return (torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(device))


def apply_rope(x, cos, sin, positions=None, interleaved: bool = False):
    """x: [B, S, H, D]. Two pairing conventions: half-split "rotate_half"
    (llama/neox — pairs are (i, i+rot/2)) and ``interleaved``
    "rotate_every_two" (gpt-j — pairs are (2i, 2i+1)). Partial rotary: when
    the table covers fewer dims than D, only the leading
    ``2 * cos.shape[-1]`` dims rotate. Arithmetic runs in the promoted type
    of ``x`` and the float32 table, as in the JAX function."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if positions is None:
        cos_p = cos[None, :x.shape[1], None, :]
        sin_p = sin[None, :x.shape[1], None, :]
    else:
        cos_p = cos[positions][:, :, None, :]
        sin_p = sin[positions][:, :, None, :]
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        r1 = x1 * cos_p - x2 * sin_p
        r2 = x2 * cos_p + x1 * sin_p
        out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = torch.chunk(x_rot, 2, dim=-1)
        out = torch.cat([x1 * cos_p - x2 * sin_p,
                         x2 * cos_p + x1 * sin_p], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out.to(x.dtype)


def apply_activation(name: str, x):
    """Non-gated MLP activation by config name (swiglu is gated and handled
    by the callers). ``gelu`` is the tanh approximation, as ``jax.nn.gelu``
    defaults to."""
    if name == "relu":                # opt
        return F.relu(x)
    if name == "quick_gelu":          # clip: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu_exact":          # mpt: erf gelu, not tanh
        return F.gelu(x, approximate="none")
    return F.gelu(x, approximate="tanh")


def merge_partial_attention(out1, m1, l1, out2, m2, l2):
    """Merge two normalized partial-attention results over disjoint KV sets
    (flash combine algebra). out_i: [..., D]; m_i/l_i: [...]; an empty set
    contributes ``m = -inf, l = 0``."""
    mx = torch.maximum(m1, m2)
    e1 = l1 * torch.exp(m1 - mx)
    e2 = l2 * torch.exp(m2 - mx)
    den = torch.clamp(e1 + e2, min=1e-30)
    num = (out1.float() * e1[..., None] + out2.float() * e2[..., None])
    return num / den[..., None]


# ---------------------------------------------------------------------------
# Shared functional numerics (the serving forward and the training forward)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rope_cs(device: str, seq_len: int, dim: int, theta: float):
    # serving builds it under inference_mode; training must be able to save
    # the same cached table for backward, so it is never an inference tensor
    with torch.inference_mode(False):
        return rope_table(seq_len, dim, theta, device=device)


def _rope_tables(cfg, device):
    if cfg.position != "rope":
        return None
    return _rope_cs(str(device), cfg.max_seq_len, cfg.rotary_dim,
                    float(cfg.rope_theta))


def _rms_norm(x, scale, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale
    return out if bias is None else out + bias


def _norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return _rms_norm(x, p["scale"], cfg.norm_eps)
    return _layer_norm(x, p["scale"], p.get("bias"), cfg.norm_eps)


def _dense(p, x):
    """flax DenseGeneral kernels ``[in, ...out]`` as one matmul over a 2-D
    view of the kernel, in x's dtype; optional bias. x: ``[..., in]``."""
    k = p["kernel"]
    out = (x @ k.reshape(k.shape[0], -1).to(x.dtype)).reshape(
        *x.shape[:-1], *k.shape[1:])
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def _dense_multi_in(p, x):
    """o_proj DenseGeneral with axis=(-2,-1): kernel [H, D, hidden];
    x: ``[..., H, D]``."""
    k = p["kernel"]
    out = x.reshape(*x.shape[:-2], -1) @ k.reshape(-1, k.shape[-1]).to(x.dtype)
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def _mlp(cfg, mp, y):
    if cfg.activation == "swiglu":
        hid = F.silu(_dense(mp["gate_proj"], y)) * _dense(mp["up_proj"], y)
    else:
        hid = apply_activation(cfg.activation, _dense(mp["up_proj"], y))
    return _dense(mp["down_proj"], hid)


def _dense_ffn(cfg, lp, z):
    return _mlp(cfg, lp["mlp"], z)


def _block_out(cfg, lp, x, y, attn_out, ffn=_dense_ffn):
    """Residual wiring after attention (sequential or parallel); ``ffn(cfg,
    lp, z)`` is the layer's MLP or MoE block on its input ``z``."""
    if cfg.parallel_residual:
        y_mlp = y if cfg.parallel_shared_norm else _norm(cfg, lp["mlp_norm"], x)
        return x + attn_out + ffn(cfg, lp, y_mlp)
    x = x + attn_out
    return x + ffn(cfg, lp, _norm(cfg, lp["mlp_norm"], x))


def _embed(cfg, params, tokens, positions):
    """Token (and learned position) embeddings in ``cfg.dtype``; tokens
    ``[...]``, positions broadcastable to them."""
    x = params["embed"]["embedding"].to(cfg.dtype)[tokens]
    if cfg.embed_norm:  # bloom word_embeddings_layernorm
        x = _norm(cfg, params["embed_norm"], x)
    if cfg.position == "learned":
        x = x + params["pos_embed"][positions + cfg.pos_offset].to(cfg.dtype)
    return x


def _lm_logits(cfg, params, h):
    """fp32 logits (the serving head; also the untied training head: the
    flax ``lm_head`` is a float32 Dense over ``h.astype(float32)``)."""
    h = h.float()
    if cfg.tie_embeddings:
        return h @ params["embed"]["embedding"].float().T
    logits = h @ params["lm_head"]["kernel"].float()
    if cfg.lm_head_bias:
        logits = logits + params["lm_head"]["bias"].float()
    return logits


def alibi_slopes(num_heads: int, bf16_round: bool = True) -> np.ndarray:
    """ALiBi per-head slopes (Press et al.; the HF falcon/bloom form,
    geometric in 2^(-8/n), extended for non-pow2). ``bf16_round``: falcon/
    bloom round the slopes through bfloat16; MPT keeps fp32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    n2 = 2 ** int(np.floor(np.log2(num_heads)))
    slopes = pow2_slopes(n2)
    if n2 != num_heads:
        extra = pow2_slopes(2 * n2)[0::2][: num_heads - n2]
        slopes = np.concatenate([slopes, extra])
    if not bf16_round:
        return slopes.astype(np.float32)
    return torch.from_numpy(slopes).to(torch.bfloat16).float().numpy()


_FLASH_FALLBACK_WARNED = set()


def _warn_flash_fallback(reason: str) -> None:
    if reason in _FLASH_FALLBACK_WARNED:
        return
    _FLASH_FALLBACK_WARNED.add(reason)
    from ..utils.logging import logger

    logger.warning(f"attn_impl=flash requested but {reason} is unsupported by "
                   "the flash kernel — using the plain attention for these call "
                   "sites (one-time notice)")


def attention_core(q, k, v, *, causal: bool = True, impl: str = "auto",
                   positions_q=None, positions_kv=None, alibi=None,
                   scale=None, window=None, alibi_post_scale=False):
    """[B, S, H, D] attention with unexpanded GQA k/v ``[B, S, Hk, D]``.

    ``flash`` runs the hand-written kernels (``ops/flash_attention.py``;
    their plain versions for CPU tensors); ``xla`` is the plain grouped
    einsum of the JAX package's XLA path (fp32 logits, softmax, probs in q's
    dtype); ``auto`` picks ``flash`` when the kernels are built for q (a
    tensor on the card, fp32 or bf16, head dim 64, 80, 96, 128 or 256) and
    there is no ALiBi bias or window. The JAX rule also asks for a sequence that is a
    multiple of 128, the TPU kernel's block; the CUDA kernels mask a ragged
    last tile, so any length takes them here. ``alibi``: per-head slopes
    [H]; ``scale``: logits multiplier (default 1/sqrt(d)); ``window``: key j
    visible iff q_pos - j < window."""
    if impl == "auto":
        from ..ops.flash_attention import kernel_takes

        impl = "flash" if kernel_takes(q) and alibi is None and window is None else "xla"
    if impl == "flash":
        if alibi is None and window is None:
            from ..ops.flash_attention import flash_attention

            return flash_attention(q, k, v, causal=causal, sm_scale=scale)
        _warn_flash_fallback("an ALiBi bias" if alibi is not None
                             else "a local attention window")
    elif impl != "xla":
        raise ValueError(f"attn_impl must be auto, xla or flash, got {impl!r}")
    b, sq, h, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    dev = q.device
    pq = positions_q if positions_q is not None else torch.arange(sq, device=dev)[:, None]
    pk = positions_kv if positions_kv is not None else torch.arange(skv, device=dev)[None, :]
    # falcon/bloom fold the 1/sqrt(d) scale into the slope; MPT adds it raw
    sl_factor = 1.0 if alibi_post_scale else scale
    if alibi is not None:
        alibi = sl_factor * torch.as_tensor(alibi, dtype=torch.float32, device=dev)
        dist = (pq - pk).float()                                  # [sq, skv]
    mask = None
    if causal:
        mask = pq >= pk
        if window is not None:
            mask = mask & (pq - pk < window)
    rep = h // hk
    # GQA without materializing repeated kv heads: q grouped per kv head
    qg = q.reshape(b, sq, hk, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    if alibi is not None:
        logits = logits - alibi.reshape(hk, rep)[None, :, :, None, None] * dist
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.to(q.dtype))
    return out.reshape(b, sq, h, d)


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else 0. The mask comes from a fresh
    generator seeded with ``seed`` on ``x``'s device, so a recompute that
    passes the same seed draws the same mask."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed & ((1 << 63) - 1))
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _attention(cfg, ap, y, rope_cs, alibi, window, seed=None, tp=None):
    """The training attention block: projections, rotary, core, o_proj, and
    dropout on its output when ``seed`` is given (JAX: ``nn.Dropout`` after
    ``o_proj``, the model's only dropout on this path). With ``tp`` (a
    :class:`_TPLayer` whose ``attn`` is set) the heads are this rank's."""
    if tp is not None and tp.attn:
        out = _tp_attention(cfg, ap, y, rope_cs, alibi, window, tp)
    else:
        q, k, v = _dense(ap["q_proj"], y), _dense(ap["k_proj"], y), _dense(ap["v_proj"], y)
        out = _dense_multi_in(ap["o_proj"], _attention_core(cfg, q, k, v, rope_cs, alibi,
                                                            window))
    if seed is not None and cfg.dropout > 0:
        out = dropout(out, cfg.dropout, seed)
    return out


def _attention_core(cfg, q, k, v, rope_cs, alibi, window):
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin, interleaved=cfg.rotary_interleaved)
        k = apply_rope(k, cos, sin, interleaved=cfg.rotary_interleaved)
    impl = cfg.attn_impl
    if impl == "auto":
        from ..ops.fastpath import fastpath

        impl = fastpath("attn_impl")
    return attention_core(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, impl=impl, alibi=alibi, scale=cfg.attn_scale,
                          window=window, alibi_post_scale=cfg.alibi_post_scale)


_PARALLEL = "not ported yet: ROADMAP.md Queue A item 8 (parallelism side paths: {})"


def check_parallel_fields(cfg: TransformerConfig) -> None:
    """Raise for the config fields whose paths are not ported: sequence
    parallelism (sp). The tensor-parallel fields (``vocab_parallel_loss``,
    ``embed_overlap``, ``overlap_collective_matmul``) run."""
    if cfg.sequence_parallel:
        raise NotImplementedError(f"sequence_parallel ({cfg.sp_impl}) is "
                                  + _PARALLEL.format("sp"))
    if cfg.embed_overlap not in ("auto", "xla", "ring"):
        raise ValueError(f"embed_overlap must be auto, xla or ring, got {cfg.embed_overlap!r}")


def _check_trainable(cfg: TransformerConfig) -> None:
    check_parallel_fields(cfg)


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron, explicit): the engine slices each leaf by
# the parameter specs (e.g. sharding/packs.py) and hands the loss the split
# dims once (make_loss_fn's bind_tp_layout); tp_layout turns them into the
# plan every forward runs.
# ---------------------------------------------------------------------------


class _TPLayer:
    """One layer's tensor-parallel plan: ``attn`` / ``mlp`` true when that
    block's leaves are in the Megatron layout (column-parallel heads or
    columns, row-parallel output); ``kv_rep`` when k/v are whole (kv heads
    that do not divide over tp, as the JAX rule leaves them); ``overlap``
    when the blocks run as rings (the knob on, the sequence chunking over
    tp)."""

    def __init__(self, size, rank, attn, mlp, kv_rep, overlap):
        self.size, self.rank = size, rank
        self.attn, self.mlp, self.kv_rep, self.overlap = attn, mlp, kv_rep, overlap


class TPLayout:
    """A :class:`TransformerLM`'s layout over tp > 1, built once from the
    split dim of every leaf (:func:`tp_layout`): ``layers`` per layer
    ``(attn, mlp, kv_rep)`` (see :class:`_TPLayer`); ``dims`` the split dims
    of the embedding, ``pos_embed`` and the head, which their own paths lay
    out; ``gathered`` (path: split dim) the split leaves that no Megatron
    block computes in their split (e.g. ``param_specs="auto"`` splits q / k
    / v on the head dim), gathered whole on every forward, their gradients
    this rank's slices. :func:`tp_layout` warns when that set is not
    empty."""

    def __init__(self, size, rank, layers, dims, gathered):
        self.size, self.rank = size, rank
        self.layers, self.dims, self.gathered = layers, dims, gathered

    def split(self, path: str) -> Optional[int]:
        """The dim the engine split ``path`` on (None: whole), gathered or
        not."""
        return self.dims.get(path, self.gathered.get(path))


def tp_layout(cfg: TransformerConfig, dims) -> TPLayout:
    """The layout of this rank's shards from ``dims``, each parameter path's
    split dim over tp (None: whole), at the live topology's tp size."""
    import warnings

    from .. import comm
    from ..parallel.topology import get_topology
    from .convert import param_shapes

    size = get_topology().tp_size
    full = param_shapes(cfg)
    if set(dims) != set(full):
        raise ValueError(f"tp layout: split dims for {sorted(set(dims) ^ set(full))} do "
                         "not match the model's parameters")

    def split_as_kernel(prefix, name):
        # a column bias splits with its kernel's output dim (or stays whole)
        bias, kernel = dims.get(prefix + name + "/bias"), dims[prefix + name + "/kernel"]
        return prefix + name + "/bias" not in dims or bias == (None if kernel is None
                                                              else kernel - 1)

    layers, computed = [], set()
    for i in range(cfg.num_layers):
        a = f"layer_{i}/attn/"
        qkv = [dims[a + n + "/kernel"] for n in ("q_proj", "k_proj", "v_proj")]
        kv_rep = qkv[1:] == [None, None]
        attn = (qkv[0] == 1 and (qkv[1:] == [1, 1] or kv_rep)
                and dims[a + "o_proj/kernel"] == 0 and dims.get(a + "o_proj/bias") is None
                and all(split_as_kernel(a, n) for n in ("q_proj", "k_proj", "v_proj")))
        m = f"layer_{i}/mlp/"
        cols = [n for n in ("gate_proj", "up_proj") if m + n + "/kernel" in dims]
        mlp = (bool(cols) and all(dims[m + n + "/kernel"] == 1 and split_as_kernel(m, n)
                                  for n in cols)
               and dims.get(m + "down_proj/kernel") == 0
               and dims.get(m + "down_proj/bias") is None)
        layers.append((attn, mlp, kv_rep))
        if attn:
            computed.update(k for k in dims if k.startswith(a))
        if mlp:
            computed.update(k for k in dims if k.startswith(m))
    # the embedding (split on vocab or hidden), the head (either dim; its
    # bias with a vocab split) and pos_embed split on hidden have paths of
    # their own
    computed.update({"embed/embedding", "lm_head/kernel"})
    if dims.get("pos_embed") == 1:
        computed.add("pos_embed")
    if dims.get("lm_head/kernel") == 1:
        computed.add("lm_head/bias")
    gathered = {k: d for k, d in sorted(dims.items()) if d is not None and k not in computed}
    if gathered:
        warnings.warn(f"tp {size}: the parameter specs split {list(gathered)} in a layout no "
                      "Megatron block computes; each is gathered whole on every forward "
                      "(the generic pack, sharding.generic_pack(), splits none so)",
                      stacklevel=3)
    own = {k: dims[k] for k in ("embed/embedding", "pos_embed", "lm_head/kernel",
                                "lm_head/bias") if k in dims and k not in gathered}
    return TPLayout(size, comm.axis_index("tp"), layers, own, gathered)


def _overlap_on(cfg) -> bool:
    from ..ops.collective_matmul import overlap_enabled

    return cfg.overlap_collective_matmul or overlap_enabled()


def _tp_plan(cfg, layout, params, seq_len):
    """``(params, plans)`` for a forward on this rank's shards under
    ``layout``: the leaves of ``layout.gathered`` gathered whole, per layer
    a :class:`_TPLayer`."""
    from ..parallel.tensor_parallel import gather_from_tp
    from .convert import _flatten, _nest

    overlap = _overlap_on(cfg) and seq_len % layout.size == 0
    plans = [_TPLayer(layout.size, layout.rank, attn, mlp, kv_rep, overlap)
             for attn, mlp, kv_rep in layout.layers]
    if not layout.gathered:
        return params, plans
    return _nest({k: gather_from_tp(v, layout.gathered[k]) if k in layout.gathered else v
                  for k, v in _flatten(params).items()}), plans


def _dense_nobias(p, x):
    k = p["kernel"]
    return (x @ k.reshape(k.shape[0], -1).to(x.dtype)).reshape(*x.shape[:-1], *k.shape[1:])


def _tp_attention(cfg, ap, y, rope_cs, alibi, window, tp):
    """Megatron attention on this rank's heads: column-parallel q / k / v
    (their input entering the tp region), the core on the local heads,
    row-parallel o_proj (its partial sums leaving it), o_proj's bias after
    the sum. Replicated k / v (indivisible kv heads) are computed whole and
    each q head takes its kv head. With ``tp.overlap`` (and k / v split)
    the projections run as the rings of ``ops/collective_matmul.py`` on
    sequence chunks."""
    from ..ops import collective_matmul as cm
    from ..parallel.tensor_parallel import (copy_to_tp, gather_from_tp, reduce_from_tp,
                                            scatter_to_tp)

    hl = ap["q_proj"]["kernel"].shape[1]
    if alibi is not None:
        alibi = np.asarray(alibi)[tp.rank * hl:(tp.rank + 1) * hl]
    if tp.overlap and not tp.kv_rep:
        x_seq = scatter_to_tp(y, 1)
        biases = ([ap[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")]
                  if "bias" in ap["q_proj"] else [])
        dt = y.dtype
        q, k, v = cm.fused_qkv_all_gather_matmul(
            x_seq, *(ap[n]["kernel"].to(dt) for n in ("q_proj", "k_proj", "v_proj")),
            [b.to(dt) for b in biases], cfg.head_dim, "tp")
        out = _attention_core(cfg, q, k, v, rope_cs, alibi, window)
        b_, s_ = out.shape[:2]
        wo = ap["o_proj"]["kernel"]
        o = cm.matmul_reduce_scatter(out.reshape(b_, s_, -1),
                                     wo.reshape(-1, wo.shape[-1]).to(dt), "tp")
        o = gather_from_tp(o, 1)
    else:
        y_in = copy_to_tp(y)
        q = _dense(ap["q_proj"], y_in)
        if tp.kv_rep:
            rep = cfg.num_heads // cfg.kv_heads
            idx = (tp.rank * hl + torch.arange(hl, device=y.device)) // rep
            k = copy_to_tp(_dense(ap["k_proj"], y)).index_select(2, idx)
            v = copy_to_tp(_dense(ap["v_proj"], y)).index_select(2, idx)
        else:
            k, v = _dense(ap["k_proj"], y_in), _dense(ap["v_proj"], y_in)
        out = _attention_core(cfg, q, k, v, rope_cs, alibi, window)
        wo = ap["o_proj"]["kernel"]
        o = reduce_from_tp(out.reshape(*out.shape[:-2], -1)
                           @ wo.reshape(-1, wo.shape[-1]).to(out.dtype))
    if "bias" in ap["o_proj"]:
        o = o + ap["o_proj"]["bias"].to(o.dtype)
    return o


def _tp_mlp(cfg, mp, y, tp):
    """Megatron MLP: column-parallel gate / up, row-parallel down (its bias
    after the sum); with ``tp.overlap`` as the two rings."""
    from ..ops import collective_matmul as cm
    from ..parallel.tensor_parallel import (copy_to_tp, gather_from_tp, reduce_from_tp,
                                            scatter_to_tp)

    gated = cfg.activation == "swiglu"
    cols = ("gate_proj", "up_proj") if gated else ("up_proj",)
    if tp.overlap:
        dt = y.dtype
        x_seq = scatter_to_tp(y, 1)
        hid = cm.all_gather_matmul(x_seq, torch.cat([mp[n]["kernel"].to(dt) for n in cols],
                                                    dim=-1), "tp")
        if "bias" in mp[cols[0]]:
            hid = hid + torch.cat([mp[n]["bias"] for n in cols]).to(hid.dtype)
        if gated:
            g, u = torch.chunk(hid, 2, dim=-1)
            hid = F.silu(g) * u
        else:
            hid = apply_activation(cfg.activation, hid)
        out = gather_from_tp(cm.matmul_reduce_scatter(hid, mp["down_proj"]["kernel"].to(dt),
                                                      "tp"), 1)
    else:
        y_in = copy_to_tp(y)
        if gated:
            hid = F.silu(_dense(mp["gate_proj"], y_in)) * _dense(mp["up_proj"], y_in)
        else:
            hid = apply_activation(cfg.activation, _dense(mp["up_proj"], y_in))
        out = reduce_from_tp(_dense_nobias(mp["down_proj"], hid))
    if "bias" in mp["down_proj"]:
        out = out + mp["down_proj"]["bias"].to(out.dtype)
    return out


def _embed_ring_on(cfg) -> bool:
    """``embed_overlap`` resolved (model field > fleet knob): the ring only
    when asked for (``auto`` in the JAX package asks the comm planner, whose
    training sites are ROADMAP.md Queue A item 9)."""
    impl = cfg.embed_overlap
    if impl == "auto":
        from ..ops.fastpath import fastpath

        impl = fastpath("embedding_overlap")
    return impl == "ring"


def _vocab_table(table, dim):
    """The embedding table as this rank's vocab shard ``[V/tp, E]`` (the
    ring layout), from a table split on hidden (an all-to-all) or on vocab."""
    from ..parallel.tensor_parallel import all_to_all_tp

    if dim == 0:
        return table
    return all_to_all_tp(table, 0, 1)


def _tp_embed(cfg, params, tokens, positions, dims):
    """Token (and learned position) embeddings from split tables: a table
    split on hidden gathers its rows' columns over tp; with the embedding
    ring (or a table split on vocab) the vocab shards circulate
    (``ring_embedding_gather``)."""
    from .. import comm
    from ..ops.collective_matmul import embedding_overlap_ready, ring_embedding_gather
    from ..parallel.tensor_parallel import gather_from_tp

    table = params["embed"]["embedding"].to(cfg.dtype)
    dim = dims.get("embed/embedding")
    size = comm.get_world_size("tp")
    if dim == 0 or (dim == 1 and _embed_ring_on(cfg)
                    and embedding_overlap_ready(size, cfg.vocab_size)):
        x = ring_embedding_gather(tokens, _vocab_table(table, dim), "tp")
    elif dim == 1:
        x = gather_from_tp(table[tokens], -1)
    else:
        x = table[tokens]
    if cfg.embed_norm:
        x = _norm(cfg, params["embed_norm"], x)
    if cfg.position == "learned":
        pos = params["pos_embed"][positions + cfg.pos_offset].to(cfg.dtype)
        x = x + (pos if dims.get("pos_embed") is None else gather_from_tp(pos, -1))
    return x


def _tp_tied_logits(cfg, params, x, dims):
    """The tied head over a split table: ``x`` split on hidden against the
    table's hidden shard and summed over tp, or (the embedding ring) the
    vocab shards circulating behind the column blocks."""
    from .. import comm
    from ..ops.collective_matmul import embedding_overlap_ready, ring_tied_lm_head
    from ..parallel.tensor_parallel import reduce_from_tp, scatter_to_tp

    table = params["embed"]["embedding"].to(cfg.dtype)
    dim = dims.get("embed/embedding")
    x = x.to(cfg.dtype)
    if dim is None:
        return x @ table.T
    if dim == 0 or (_embed_ring_on(cfg)
                    and embedding_overlap_ready(comm.get_world_size("tp"), cfg.vocab_size)):
        return ring_tied_lm_head(x, _vocab_table(table, dim), "tp")
    return reduce_from_tp(scatter_to_tp(x, -1) @ table.T)


def _tp_untied_logits(cfg, params, h, dims):
    """fp32 logits of an untied head: split on vocab, this rank's columns
    gathered over tp; split on hidden, this rank's hidden slice of ``h``
    against it, summed over tp."""
    from ..parallel.tensor_parallel import (copy_to_tp, gather_from_tp, reduce_from_tp,
                                            scatter_to_tp)

    head = params["lm_head"]
    dim = dims.get("lm_head/kernel")
    if dim is None:
        return _lm_logits(cfg, params, h)
    if dim == 0:
        logits = reduce_from_tp(scatter_to_tp(h.float(), -1) @ head["kernel"].float())
        return logits + head["bias"].float() if cfg.lm_head_bias else logits
    logits = copy_to_tp(h.float()) @ head["kernel"].float()
    if cfg.lm_head_bias:
        bias = head["bias"]
        logits = logits + (bias if dims.get("lm_head/bias") == 0
                           else scatter_to_tp(bias, 0)).float()
    return gather_from_tp(logits, -1)


def _layer(cfg, lp, x, rope_cs, alibi, window, seed=None, gating_seed=None, tp=None):
    """One decoder layer of the training forward: ``(out, aux)``, ``aux``
    the MoE block's scaled aux loss (None for a dense layer). ``seed`` is
    its dropout mask's, ``gating_seed`` its MoE gating's; ``tp`` its
    tensor-parallel plan (:class:`_TPLayer`, None at tp 1)."""
    aux = []

    def ffn(cfg, lp, z):
        if "moe" not in lp:
            if tp is not None and tp.mlp:
                return _tp_mlp(cfg, lp["mlp"], z, tp)
            return _dense_ffn(cfg, lp, z)
        out, a = moe_layer.moe_block(cfg, lp["moe"], z, seed=gating_seed)
        aux.append(a)
        return out

    y = _norm(cfg, lp["attn_norm"], x)
    out = _block_out(cfg, lp, x, y,
                     _attention(cfg, lp["attn"], y, rope_cs, alibi, window, seed, tp), ffn)
    return out, (aux[0] if aux else None)


def lm_forward(cfg: TransformerConfig, params, tokens, return_hidden: bool = False,
               dropout_seed: Optional[int] = None, gating_seed: Optional[int] = None,
               return_aux: bool = False, tp_layout: Optional[TPLayout] = None):
    """The causal LM forward on a flax-layout parameter tree: tokens
    ``[B, S]`` -> logits ``[B, S, V]`` (fp32 for an untied head; the tied
    head attends in ``cfg.dtype``, as flax ``Embed.attend`` does). With
    ``return_hidden`` it returns the final-norm hidden states ``[B, S, E]``
    in ``cfg.dtype`` instead (the fused loss consumes them), as a model
    without an LM head (``cfg.no_lm_head``: a CLIP-style text encoder)
    always does. With ``tp_layout`` (:func:`tp_layout`, at tp > 1)
    ``params`` are this rank's shards laid out by it: a layer whose q / k /
    v kernels are split on heads and o_proj on its input heads runs
    Megatron attention on this rank's heads (k / v may be whole where the
    kv heads do not divide over tp), one whose gate / up are split on
    columns and down on rows a Megatron MLP; ``overlap_collective_matmul``
    (or the runtime knob) runs them as the rings of
    ``ops/collective_matmul.py``. The layout's ``gathered`` leaves are
    gathered whole. An embedding split on hidden gathers its rows'
    columns, or with ``embed_overlap="ring"`` circulates as vocab shards;
    an untied head split on vocab gives this rank's logit columns, gathered
    over tp; the tied head, and an untied one split on hidden, sum the
    hidden shards' products. Without it every leaf is whole. With
    ``cfg.remat`` each layer is recomputed in the backward under
    ``cfg.remat_policy`` (JAX: ``nn.remat(Block, policy=...)``); with no
    policy, under what ``checkpointing.checkpoint`` would do, so a
    configured ``cpu_checkpointing`` keeps each layer's matrix products in
    pinned host memory. With ``dropout_seed`` and ``cfg.dropout > 0`` layer
    i drops out its attention output under the seed ``fold_in(dropout_seed,
    i)``, an argument of the layer, so its recompute draws the same mask;
    ``gating_seed`` seeds the MoE layers' gating noise the same way. With
    ``return_aux`` it returns ``(out, aux)``, ``aux`` the list of the MoE
    layers' scaled aux losses in layer order."""
    _check_trainable(cfg)
    tokens = tokens.long()
    dev = tokens.device
    plans, dims = None, {}
    if tp_layout is not None:
        params, plans = _tp_plan(cfg, tp_layout, params, tokens.shape[1])
        dims = tp_layout.dims
    positions = torch.arange(tokens.shape[1], device=dev)
    if plans is None:
        x = _embed(cfg, params, tokens, positions)
    else:
        x = _tp_embed(cfg, params, tokens, positions, dims)
    rope_cs = _rope_tables(cfg, dev)
    alibi = (alibi_slopes(cfg.num_heads, bf16_round=not cfg.alibi_post_scale)
             if cfg.position == "alibi" else None)
    layer = _layer
    if cfg.remat:
        from ..runtime.activation_checkpointing import layer_wrapper

        layer = layer_wrapper(_layer, cfg.remat_policy)
    auxes = []
    for i in range(cfg.num_layers):
        window = cfg.layer_windows[i] if cfg.layer_windows is not None else None
        seed = None if dropout_seed is None else fold_in(dropout_seed, i)
        gseed = None if gating_seed is None else fold_in(gating_seed, i)
        tp = None if plans is None else plans[i]
        x, aux = layer(cfg, params[f"layer_{i}"], x, rope_cs, alibi, window, seed, gseed, tp)
        if aux is not None:
            auxes.append(aux)
    x = _norm(cfg, params["final_norm"], x)
    if cfg.no_lm_head or return_hidden:
        out = x.to(cfg.dtype)
    elif cfg.tie_embeddings:
        out = (x.to(cfg.dtype) @ params["embed"]["embedding"].to(cfg.dtype).T
               if plans is None else _tp_tied_logits(cfg, params, x, dims))
    else:
        out = _lm_logits(cfg, params, x) if plans is None else _tp_untied_logits(
            cfg, params, x, dims)
    return (out, auxes) if return_aux else out


class TransformerLM(nn.Module):
    """Causal LM: ``forward(tokens [B, S]) -> logits [B, S, V]``.

    Its parameters sit in a ``ParameterDict`` keyed by their flax paths
    (``"layer_0/attn/q_proj/kernel"``, ...), so :func:`make_loss_fn` can run
    it on any flax-layout tree through ``torch.func.functional_call``.
    ``params`` (a nested tree, e.g. from ``init_params`` or
    ``params_from_jax``) is used as is, without a copy; without it the
    weights are drawn from ``seed`` on ``device``, which defaults to the
    card and raises without one."""

    def __init__(self, cfg: TransformerConfig, params=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        _check_trainable(cfg)
        from .convert import _flatten, init_params, param_shapes

        if params is None:
            params = init_params(cfg, seed=seed, device=device, dtype=torch.float32)
        flat = _flatten(params)
        want = param_shapes(cfg)
        if set(flat) != set(want):
            raise ValueError(f"parameter tree mismatch: missing "
                             f"{sorted(set(want) - set(flat))}, extra "
                             f"{sorted(set(flat) - set(want))}")
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: v if isinstance(v, nn.Parameter) else nn.Parameter(v)
             for k, v in flat.items()})

    def param_tree(self):
        """The module's parameters as the nested flax-layout tree."""
        from .convert import _nest

        return _nest(dict(self.params.items()))

    def forward(self, tokens, return_hidden: bool = False,
                dropout_seed: Optional[int] = None, gating_seed: Optional[int] = None,
                return_aux: bool = False, tp_layout: Optional[TPLayout] = None):
        return lm_forward(self.cfg, self.param_tree(), tokens, return_hidden, dropout_seed,
                          gating_seed, return_aux, tp_layout)


def causal_lm_loss(logits, tokens, loss_mask=None, z_loss: float = 0.0):
    """Next-token cross entropy; ignores the final position."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt_logit
    if z_loss > 0:
        nll = nll + z_loss * torch.square(logz)
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(nll.dtype)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def make_loss_fn(model: TransformerLM):
    """Engine-compatible ``loss = f(params, batch, rng=None)``: runs ``model``
    on the flax-layout tree ``params`` (``torch.func.functional_call``).
    ``batch`` is the token tensor ``[B, S]`` or a dict with ``tokens`` (and
    an optional ``loss_mask``). Each call chooses the loss once, on the
    tokens' device and ``cfg.dtype`` (``sequence.cross_entropy``'s
    ``_select_loss_impl``): when it comes out ``fused`` (``auto`` on the
    card, fp32 or bf16), the model returns its final hidden states and the
    fused kernels run on them and the head kernel, so the ``[B, S, V]``
    logits never exist; otherwise the model's dense logits go through
    ``causal_lm_loss``. A model without an LM head takes ``causal_lm_loss``
    over the hidden states it returns, as the JAX loss does (the token ids
    then index the hidden dims). ``rng`` is an integer seed (the engine draws one per
    micro-batch); with it and ``cfg.dropout > 0`` the model drops out, as
    the JAX loss does when given a key. A model with experts adds the mean
    of its MoE layers' aux losses; its gating stays deterministic, as the
    JAX loss passes no gating rng.

    Over a tp axis above 1 (the live topology) the engine slices the
    parameters and hands the split dims to ``loss_fn.bind_tp_layout(dims)``
    once (None at tp 1), which builds the model's :func:`tp_layout`; the
    model then runs this rank's shards Megatron-style (``lm_forward``).
    Without a bound layout every leaf is whole.
    With ``cfg.vocab_parallel_loss`` the loss runs on the hidden states and
    this rank's vocab shard of the head (``sequence.sharded_lm_loss``:
    the fused kernels with the cross-rank combine, or the vocab-parallel
    cross entropy), else on the dense logits gathered over tp."""
    from ..sequence.cross_entropy import _select_loss_impl, sharded_lm_loss
    from .convert import _flatten

    cfg = model.cfg
    if cfg.vocab_parallel_loss and cfg.no_lm_head:
        raise ValueError("vocab_parallel_loss needs an lm head; "
                         "no_lm_head=True models have no vocab projection")
    layout: Optional[TPLayout] = None

    def _tp():
        from ..parallel.topology import get_topology

        return get_topology().tp_size

    def _head_kernel_bias(params):
        """The head as ``[E, V]`` (and its bias), at tp > 1 this rank's
        vocab shard ``[E, V/tp]`` whatever the leaves' split: a table split
        on hidden exchanges its shards (an all-to-all), a whole leaf is
        sliced (its gradient gathered back)."""
        from ..parallel.tensor_parallel import all_to_all_tp, scatter_to_tp

        tp = _tp()
        split = layout.split if layout is not None else (lambda path: None)
        if cfg.tie_embeddings:
            table = params["embed"]["embedding"]
            if tp > 1:
                dim = split("embed/embedding")
                table = (all_to_all_tp(table, 0, 1) if dim == 1 else
                         table if dim == 0 else scatter_to_tp(table, 0))
            return table.T, None
        head = params["lm_head"]
        kernel, bias = head["kernel"], head.get("bias")
        if tp > 1:
            dim = split("lm_head/kernel")
            kernel = (kernel if dim == 1 else all_to_all_tp(kernel, 1, 0) if dim == 0
                      else scatter_to_tp(kernel, 1))
            if bias is not None and split("lm_head/bias") is None:
                bias = scatter_to_tp(bias, 0)
        return kernel, bias

    def _headless(device) -> bool:
        """True when the loss should consume hidden states + the head
        kernel (the ``[B, S, V]`` logits never materialized): the
        vocab-parallel knob, or (tp 1) the fused loss chosen (a biased head
        keeps the dense path, as in the JAX package). tp > 1 without
        ``vocab_parallel_loss`` keeps the dense logits, gathered over tp."""
        if cfg.no_lm_head:
            return False
        if cfg.vocab_parallel_loss:
            if _tp() > 1 and cfg.vocab_size % _tp():
                raise ValueError(
                    f"vocab_parallel_loss needs vocab_size ({cfg.vocab_size}) divisible "
                    f"by tp ({_tp()}); pad the vocab up to a multiple of tp (Megatron "
                    "pads for the same reason)")
            return True
        if _tp() > 1:
            return False
        return _select_loss_impl(cfg.loss_impl, cfg.vocab_size, device, cfg.dtype,
                                 cfg.lm_head_bias) == "fused"

    def _ce(out, params, tokens, mask, headless):
        if headless:
            kernel, bias = _head_kernel_bias(params)
            return sharded_lm_loss(out, kernel, tokens, loss_mask=mask, head_bias=bias,
                                   loss_impl=cfg.loss_impl)
        return causal_lm_loss(out, tokens, mask)

    def loss_fn(params, batch, rng=None):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        mask = batch.get("loss_mask") if isinstance(batch, dict) else None
        headless = _headless(tokens.device)
        flat = {f"params.{k}": v for k, v in _flatten(params).items()}
        kwargs = {"return_hidden": headless, "return_aux": True, "tp_layout": layout}
        if rng is not None and cfg.dropout > 0:
            kwargs["dropout_seed"] = int(rng)
        out, auxes = torch.func.functional_call(model, flat, (tokens,), kwargs)
        loss = _ce(out, params, tokens, mask, headless)
        return loss + sum(auxes) / len(auxes) if auxes else loss

    def bind_tp_layout(dims):
        """Lay out this rank's shards by ``dims`` (parameter path: split dim
        over tp, from the engine), or every leaf whole (None)."""
        nonlocal layout
        layout = None if dims is None else tp_layout(cfg, dims)

    # the engine hands the split dims here, and with no param_specs slices
    # by the generic pack for a loss that has this
    loss_fn.bind_tp_layout = bind_tp_layout
    return loss_fn


# ---------------------------------------------------------------------------
# Family presets
# ---------------------------------------------------------------------------


def gpt2_config(size: str = "small", **overrides) -> TransformerConfig:
    dims = {"small": (768, 12, 12), "medium": (1024, 24, 16), "large": (1280, 36, 20),
            "xl": (1600, 48, 25)}[size]
    d, l, h = dims
    base = dict(vocab_size=50257, hidden_size=d, intermediate_size=4 * d, num_layers=l,
                num_heads=h, max_seq_len=1024, norm="layernorm", activation="gelu",
                position="learned", tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


def mixtral_config(size: str = "tiny", **overrides) -> TransformerConfig:
    dims = {"tiny": (256, 4, 8, 8, 512, 4), "8x7b": (4096, 32, 32, 8, 14336, 8)}[size]
    d, l, h, hk, f, e = dims
    base = dict(vocab_size=32000, hidden_size=d, intermediate_size=f, num_layers=l,
                num_heads=h, num_kv_heads=hk, max_seq_len=4096, norm="rmsnorm",
                activation="swiglu", position="rope", num_experts=e, moe_top_k=2)
    base.update(overrides)
    return TransformerConfig(**base)


def llama_config(size: str = "7b", **overrides) -> TransformerConfig:
    dims = {"tiny": (256, 4, 8, 8, 688), "1b": (2048, 22, 32, 4, 5632),
            "7b": (4096, 32, 32, 32, 11008), "13b": (5120, 40, 40, 40, 13824)}[size]
    d, l, h, hk, f = dims
    base = dict(vocab_size=32000, hidden_size=d, intermediate_size=f, num_layers=l,
                num_heads=h, num_kv_heads=hk, max_seq_len=4096, norm="rmsnorm",
                activation="swiglu", position="rope")
    base.update(overrides)
    return TransformerConfig(**base)
