"""Transformer configuration and the shared numerics of the serving path.

Port of the serving-path pieces of ``deepspeed_tpu/models/transformer.py``:
the config (same field names, so a JAX config converts field by field), the
rotary table and its two pairings, the non-gated activations, the flash
combine of two partial attentions, and the family presets. The flax modules
and the training code are not part of the port's first slice; the serving
forward (``inference/v2/model.py``) runs on plain parameter dictionaries.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F


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
    attn_scale: Optional[float] = None          # gpt-neo trains UNSCALED (1.0)
    layer_windows: Optional[Any] = None         # gpt-neo local attention
    num_experts: int = 0                        # MoE (mixtral / qwen2_moe)
    # execution
    dtype: Any = torch.bfloat16
    # serving fused-decode attention pin: auto | einsum | pallas (the name
    # of the kernel path, as in the JAX package)
    decode_attn_impl: str = "auto"

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


def llama_config(size: str = "7b", **overrides) -> TransformerConfig:
    dims = {"tiny": (256, 4, 8, 8, 688), "1b": (2048, 22, 32, 4, 5632),
            "7b": (4096, 32, 32, 32, 11008), "13b": (5120, 40, 40, 40, 13824)}[size]
    d, l, h, hk, f = dims
    base = dict(vocab_size=32000, hidden_size=d, intermediate_size=f, num_layers=l,
                num_heads=h, num_kv_heads=hk, max_seq_len=4096, norm="rmsnorm",
                activation="swiglu", position="rope")
    base.update(overrides)
    return TransformerConfig(**base)
