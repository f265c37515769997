"""MoE gating and dispatch math (GShard-style).

Port of ``deepspeed_tpu/moe/sharded_moe.py``: the same functions, names and
shapes. Tokens are ``[G, S, D]`` (G groups = batch), gates ``[G, S, E]``,
dispatch and combine ``[G, S, E, C]`` with a static capacity C.

The expert products stay PyTorch matrix products, as the JAX package
computes them outside any Pallas kernel: the capacity path's dispatch, FFN
and combine are ``torch.einsum`` (``jnp.einsum`` there), and the dropless
grouped GEMM (``jax.lax.ragged_dot`` there) is one matrix product per expert
over the expert-sorted rows, whose group sizes cross to the host once per
call.

Ties go to the lower expert index everywhere, as ``jnp.argmax`` and
``jax.lax.top_k`` give them: the top-k is k rounds of ``torch.argmax``
(which returns the first maximal index) rather than ``torch.topk``, whose
order of ties is not specified. The random draws (Random Token Selection,
RSample's Gumbel noise) come from torch generators, so they differ from
JAX's threefry draws; with no ``rng`` gating is deterministic in both.

Expert parallelism above 1 is not ported (ROADMAP.md Queue A item 8): the
port's topology builds no ``ep`` axis, so :func:`quantized_ep_ready` is
always False and :func:`quantized_ep_moe` raises.
"""

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.quant import fold_in

Rng = Union[int, torch.Generator]


def compute_capacity(k: int, tokens_per_group: int, num_experts: int,
                     capacity_factor: float, min_capacity: int = 4) -> int:
    cap = int(math.ceil(k * tokens_per_group * capacity_factor / num_experts))
    return max(cap, min_capacity)


def _sub_rng(rng: Rng, salt: int) -> Rng:
    """The rng of one draw site: a generator is shared by every site in
    call order; a seed gives each site its own, ``fold_in(seed, salt)``."""
    return rng if isinstance(rng, torch.Generator) else fold_in(int(rng), salt)


def _generator(rng: Rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng) & ((1 << 63) - 1))


def _uniform(rng: Rng, shape, device, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=_generator(rng, device), device=device)
    return u * (hi - lo) + lo


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in float32: an index outside ``[0, n)`` gives a
    row of zeros (``F.one_hot`` raises on one)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values and indices, largest
    first, ties to the lower index (k rounds of argmax)."""
    rem, vals, idxs = x.detach(), [], []
    for _ in range(k):
        idx = torch.argmax(rem, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, idx))
        idxs.append(idx)
        rem = rem.scatter(-1, idx, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def load_balance_aux(gates: torch.Tensor,
                     used_token: Optional[torch.Tensor] = None,
                     sel_gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GShard load-balance loss from the top-1 assignment:
    E * mean_g(sum_e(mean-prob_e * assigned-fraction_e)). ``used_token
    [G, S]`` excludes padding tokens from the assigned fraction;
    ``sel_gates`` are the (possibly noised) scores that drove the selection,
    while the mean probability stays on the clean ``gates``."""
    e = gates.shape[-1]
    top1 = torch.argmax(gates if sel_gates is None else sel_gates, dim=-1)
    me = torch.mean(gates, dim=1)                           # [G, E] mean prob
    hot = _one_hot(top1, e)
    if used_token is not None:
        hot = hot * used_token.float()[..., None]
    ce = torch.mean(hot, dim=1)
    return torch.mean(torch.sum(me * ce, dim=-1)) * e


def _rts_rank(mask: torch.Tensor, rng: Rng) -> torch.Tensor:
    """Random-Token-Selection rank ``[G, S, E]`` of each token within its
    expert (0 = first slot; unselected tokens rank last): the position the
    token takes in a random order of that expert's selected tokens, from a
    uniform draw (a double stable argsort over S)."""
    r = _uniform(rng, mask.shape, mask.device, 1e-6, 1.0) * mask
    order = torch.argsort(-r, dim=1, stable=True)           # tokens by priority
    return torch.argsort(order, dim=1, stable=True).float()


def topk_gating(logits: torch.Tensor, k: int, capacity: int,
                rng: Optional[Rng] = None,
                noisy_gate_policy: Optional[str] = None,
                drop_tokens: bool = True,
                norm_topk: bool = True,
                used_token: Optional[torch.Tensor] = None,
                use_rts: bool = False):
    """Top-k gating with capacity. Returns (dispatch ``[G, S, E, C]`` bool,
    combine ``[G, S, E, C]`` float32, aux loss).

    ``rng`` (a seed or a ``torch.Generator``) drives RSample's noise and
    Random Token Selection; without it both are off. RSample changes the
    selection only: the combine weights and the aux loss's mean probability
    stay on the clean softmax. A token's slot in an expert is its count
    among this round's tokens of that expert before it, plus the tokens
    committed to the expert in earlier rounds. ``drop_tokens=False`` keeps
    every selected, non-padding token (pass ``capacity >= k * S``).
    ``norm_topk`` divides by the sum of the kept gates."""
    g, s, e = logits.shape
    logits = logits.float()
    rng_noise = rng_rts = None
    if rng is not None:
        rng_noise, rng_rts = _sub_rng(rng, 0), _sub_rng(rng, 1)
    sel_logits = logits
    if noisy_gate_policy == "RSample" and rng_noise is not None:
        tiny = torch.finfo(torch.float32).tiny
        u = _uniform(rng_noise, logits.shape, logits.device, tiny, 1.0)
        sel_logits = logits - torch.log(-torch.log(u))      # + Gumbel noise
    gates = torch.softmax(logits, dim=-1)                   # [G, S, E] clean
    sel = gates if sel_logits is logits else torch.softmax(sel_logits, dim=-1)
    aux_loss = load_balance_aux(gates, used_token,
                                sel_gates=None if sel_logits is logits else sel)
    ut = None if used_token is None else used_token.float()

    dev = logits.device
    remaining = sel.detach()                                # drives the argmax only
    committed = torch.zeros((g, 1, e), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((g, s, e, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, s, e, capacity), dtype=torch.float32, device=dev)
    denom = torch.zeros((g, s), dtype=torch.float32, device=dev)
    for ki in range(k):
        idx = torch.argmax(remaining, dim=-1)               # [G, S]
        mask = _one_hot(idx, e)                             # [G, S, E]
        if ut is not None:                                  # padding takes no slot
            mask = mask * ut[..., None]
        gate_k = torch.sum(gates * mask, dim=-1)            # [G, S]
        if use_rts and rng_rts is not None and drop_tokens:
            rank = _rts_rank(mask, _sub_rng(rng_rts, ki))
            pos_in_expert = rank + committed
        else:
            pos_in_expert = torch.cumsum(mask, dim=1) - mask + committed
        pos = torch.sum(pos_in_expert * mask, dim=-1)       # [G, S]
        keep = pos < capacity
        if not drop_tokens:
            keep = torch.sum(mask, dim=-1) > 0              # selected, not padding
        pos_c = _one_hot(pos.long(), capacity)
        slot = mask[..., None] * pos_c[:, :, None, :] * keep[:, :, None, None]
        dispatch = dispatch | (slot > 0)
        combine = combine + slot * gate_k[:, :, None, None]
        denom = denom + gate_k * keep
        committed = committed + torch.sum(mask, dim=1, keepdim=True)
        remaining = remaining * (1.0 - mask)

    if norm_topk:
        combine = combine / torch.clamp(denom, min=1e-9)[:, :, None, None]
    return dispatch, combine, aux_loss


def moe_dispatch(x: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """tokens ``[G, S, D]`` x dispatch ``[G, S, E, C]`` -> expert inputs
    ``[E, G, C, D]`` (expert-major)."""
    return torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), x)


def _bias(b, dt):
    return b.to(dt)[:, None, None, :]


def expert_ffn(expert_in: torch.Tensor, w_up, w_down, *, w_gate=None,
               b_up=None, b_down=None, b_gate=None,
               activation: str = "swiglu") -> torch.Tensor:
    """Expert-major FFN on ``[E, G, C, D]`` inputs in their dtype: swiglu
    (``silu(x W_gate) * x W_up``) or, for any other activation, tanh gelu,
    as the JAX function computes it."""
    dt = expert_in.dtype
    u = torch.einsum("egcd,edf->egcf", expert_in, w_up.to(dt))
    if b_up is not None:
        u = u + _bias(b_up, dt)
    if activation == "swiglu":
        h = torch.einsum("egcd,edf->egcf", expert_in, w_gate.to(dt))
        if b_gate is not None:
            h = h + _bias(b_gate, dt)
        h = F.silu(h) * u
    else:
        h = F.gelu(u, approximate="tanh")
    out = torch.einsum("egcf,efd->egcd", h, w_down.to(dt))
    if b_down is not None:
        out = out + _bias(b_down, dt)
    return out


_EP = ("the explicit int8 expert-parallel exchange is not ported yet: ROADMAP.md "
       "Queue A item 8 (the port's topology builds no ep axis)")


def quantized_ep_ready(num_experts: int, num_groups: Optional[int] = None,
                       site_shape: Optional[Tuple[int, ...]] = None,
                       site_dtype=None) -> bool:
    """Whether the explicit int8 expert-parallel exchange applies: it needs
    an ``ep`` axis above 1, which the port's topology never builds, so this
    is False, as the JAX function is at ep 1."""
    from ..parallel.topology import get_topology

    return get_topology().ep_size > 1


def quantized_ep_moe(x, dispatch, combine, w_up, w_down, *, w_gate=None,
                     b_up=None, b_down=None, b_gate=None,
                     activation: str = "swiglu") -> torch.Tensor:
    """The capacity path with int8 all-to-alls over the ``ep`` axis."""
    raise NotImplementedError("quantized_ep_moe: " + _EP)


def moe_combine(expert_out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """expert outputs ``[E, G, C, D]`` x combine ``[G, S, E, C]`` -> tokens
    ``[G, S, D]``, in the experts' dtype."""
    return torch.einsum("egcd,gsec->gsd", expert_out, combine.to(expert_out.dtype))


def _ragged_dot(rows: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """``jax.lax.ragged_dot``: consecutive groups of ``rows`` (``sizes[e]``
    rows each) times their expert's matrix ``w[e]``; empty groups skipped."""
    parts = [chunk @ w[e] for e, chunk in enumerate(torch.split(rows, sizes))
             if chunk.shape[0]]
    return torch.cat(parts)


def dropless_moe(x: torch.Tensor, gates: torch.Tensor, k: int,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 activation: str = "swiglu",
                 norm_topk: bool = True,
                 b_up: torch.Tensor = None, b_down: torch.Tensor = None,
                 b_gate: torch.Tensor = None) -> torch.Tensor:
    """Dropless MoE: every token reaches its top-k experts (no capacity, no
    padded compute). The token copies are sorted by expert (stable), each
    expert's contiguous rows multiply its weights, and each token sums its
    k weighted outputs.

    x: ``[G, S, D]``; gates: ``[G, S, E]`` float32 router probabilities;
    w_gate / w_up: ``[E, D, F]``; w_down: ``[E, F, D]``. Returns
    ``[G, S, D]`` in x's dtype."""
    g, s, d = x.shape
    e = gates.shape[-1]
    n = g * s
    xf = x.reshape(n, d)
    top_w, top_e = _top_k(gates.reshape(n, e), k)           # [N, k]
    if norm_topk:
        top_w = top_w / torch.clamp(torch.sum(top_w, dim=-1, keepdim=True), min=1e-9)
    eid = top_e.reshape(-1)                                 # [N * k]
    wts = top_w.reshape(-1)
    order = torch.argsort(eid, stable=True)                 # expert-sorted copies
    tok_of = order // k                                     # source token per copy
    xs = xf[tok_of]                                         # [N * k, D]
    # rows per expert (a scatter-add: ``bincount`` on the card syncs to
    # size its output) and the one host sync, for the split sizes
    sizes = torch.zeros(e, dtype=eid.dtype, device=eid.device).index_add_(
        0, eid, torch.ones_like(eid)).tolist()
    eid_sorted = eid[order]

    dt = x.dtype
    up = _ragged_dot(xs, w_up.to(dt), sizes)
    if b_up is not None:
        up = up + b_up.to(dt)[eid_sorted]
    if activation == "swiglu":
        gt = _ragged_dot(xs, w_gate.to(dt), sizes)
        if b_gate is not None:
            gt = gt + b_gate.to(dt)[eid_sorted]
        h = F.silu(gt) * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = _ragged_dot(h, w_down.to(dt), sizes)              # [N * k, D]
    if b_down is not None:
        out = out + b_down.to(dt)[eid_sorted]
    out = out * wts[order][:, None].to(out.dtype)
    # back to (token, choice) order and summed over the k choices: a
    # deterministic sum where a scatter-add would race on the card
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return out[inv].reshape(n, k, d).sum(dim=1).reshape(g, s, d)
