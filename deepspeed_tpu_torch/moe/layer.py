"""The MoE block: a drop-in MLP replacement returning ``(out, aux_loss)``.

Port of ``deepspeed_tpu/moe/layer.py`` (``MoEBlock``). :func:`moe_block` is
the block as a function over its parameter dict (the flax layout under
``layer_{i}/moe``: ``router/kernel [D, E]``, ``expert_{gate,up}_proj
[E, D, F]``, ``expert_down_proj [E, F, D]``, their ``expert_*_bias`` with
``ffn_bias``, ``shared_{gate,up,down}_proj`` and ``shared_router`` for the
qwen2_moe shared expert, ``residual_*`` for PR-MoE); :class:`MoEBlock` is a
thin ``nn.Module`` over it. The JAX block's sharding hints mean nothing at
an ``ep`` axis of 1 and are not ported.

Gating randomness (Jitter on the router input, RSample noise, Random Token
Selection) comes from an explicit ``seed`` (or ``torch.Generator``);
without one gating is deterministic, as the JAX block is with no
``"gating"`` rng. A recompute that passes the same seed routes the same way.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .sharded_moe import (Rng, _sub_rng, _top_k, _uniform, compute_capacity,
                          dropless_moe, expert_ffn, load_balance_aux, moe_combine,
                          moe_dispatch, topk_gating)


def exp_counts(gates: torch.Tensor, k: int, used_token=None) -> torch.Tensor:
    """Pre-capacity assignments per expert ``[E]`` (int32): each token's
    top-k experts, padding tokens excluded (the JAX block sows these as
    ``moe_exp_counts``)."""
    e = gates.shape[-1]
    hot = F.one_hot(_top_k(gates, k)[1], e)                 # [G, S, k, E]
    if used_token is not None:
        hot = hot * used_token.long()[..., None, None]
    return hot.sum(dim=(0, 1, 2)).to(torch.int32)


def moe_block(cfg, p, x: torch.Tensor, used_token: Optional[torch.Tensor] = None,
              seed: Optional[Rng] = None, return_counts: bool = False):
    """The MoE block on ``x [G, S, D]`` with the parameters ``p``. Returns
    ``(out [G, S, D] in x's dtype, aux)``, the aux loss already scaled by
    ``cfg.moe_aux_loss_weight``, and the pre-drop ``exp_counts`` third with
    ``return_counts``. ``used_token [G, S]`` excludes padding tokens from
    dispatch and from the aux loss. ``moe_dropless`` takes the grouped-GEMM
    path (no capacity), else the capacity path (factor
    ``moe_capacity_factor``, or the no-drop bound ``k * S`` when
    ``moe_drop_tokens`` is off)."""
    g, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    swiglu = cfg.activation == "swiglu"
    noisy = cfg.moe_noisy_gate_policy
    dt = x.dtype

    # the router in float32, Jitter on its input
    x_router = x.float()
    if noisy == "Jitter" and seed is not None:
        x_router = x_router * _uniform(_sub_rng(seed, 0), x_router.shape, x.device,
                                       0.99, 1.01)
        seed = _sub_rng(seed, 1)
    logits = x_router @ p["router"]["kernel"].float()

    w_gate = p.get("expert_gate_proj") if swiglu else None
    w_up, w_down = p["expert_up_proj"], p["expert_down_proj"]
    b_up, b_down = p.get("expert_up_bias"), p.get("expert_down_bias")
    b_gate = p.get("expert_gate_bias") if swiglu else None

    def add_residual(y):
        """PR-MoE: a dense MLP beside the experts, blended per token by a
        learned 2-way softmax."""
        if not cfg.moe_use_residual:
            return y
        if swiglu:
            h_r = (F.silu(x @ p["residual_gate_proj"].to(dt))
                   * (x @ p["residual_up_proj"].to(dt)))
        else:
            h_r = F.gelu(x @ p["residual_up_proj"].to(dt), approximate="tanh")
        out_r = h_r @ p["residual_down_proj"].to(dt)
        coef = torch.softmax(x.float() @ p["residual_coefficient"].float(), dim=-1)
        coef = coef.to(y.dtype)
        return y * coef[..., 0:1] + out_r * coef[..., 1:2]

    def add_shared(y):
        """The qwen2_moe shared expert, always on, behind a sigmoid gate
        (after the residual blend)."""
        y = add_residual(y)
        if not cfg.moe_shared_expert_size:
            return y
        h_s = F.silu(x @ p["shared_gate_proj"].to(dt)) * (x @ p["shared_up_proj"].to(dt))
        out_s = h_s @ p["shared_down_proj"].to(dt)
        mod = torch.sigmoid(x.float() @ p["shared_router"].float()).to(dt)
        return y + out_s * mod

    gates = torch.softmax(logits, dim=-1)
    if cfg.moe_dropless:
        aux = load_balance_aux(gates, used_token)
        y = dropless_moe(x, gates, k, w_gate, w_up, w_down, activation=cfg.activation,
                         norm_topk=cfg.moe_norm_topk, b_up=b_up, b_down=b_down,
                         b_gate=b_gate)
        if used_token is not None:                  # padding contributes nothing
            y = y * used_token.to(y.dtype)[..., None]
    else:
        capacity = (compute_capacity(k, s, e, cfg.moe_capacity_factor)
                    if cfg.moe_drop_tokens else k * s)
        dispatch, combine, aux = topk_gating(
            logits, k, capacity, rng=seed,
            noisy_gate_policy=noisy if noisy == "RSample" else None,
            drop_tokens=cfg.moe_drop_tokens, norm_topk=cfg.moe_norm_topk,
            used_token=used_token, use_rts=cfg.moe_use_rts)
        out = expert_ffn(moe_dispatch(x, dispatch), w_up, w_down, w_gate=w_gate,
                         b_up=b_up, b_down=b_down, b_gate=b_gate,
                         activation=cfg.activation)
        y = moe_combine(out, combine)
    y = add_shared(y.to(dt)).to(dt)
    aux = aux * cfg.moe_aux_loss_weight
    if return_counts:
        return y, aux, exp_counts(gates, k, used_token)
    return y, aux


class MoEBlock(nn.Module):
    """:func:`moe_block` as a module: ``forward(x, used_token=None,
    seed=None, return_counts=False)``. ``params`` (the block's nested dict,
    e.g. ``init_params(cfg)["layer_0"]["moe"]``) is used as is; its leaves
    become the module's parameters under their ``"/"``-joined paths."""

    def __init__(self, cfg, params):
        super().__init__()
        from ..models.convert import _flatten

        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: v if isinstance(v, nn.Parameter) else nn.Parameter(v)
             for k, v in _flatten(params).items()})

    def forward(self, x, used_token=None, seed=None, return_counts=False):
        from ..models.convert import _nest

        return moe_block(self.cfg, _nest(dict(self.params.items())), x, used_token,
                         seed=seed, return_counts=return_counts)
