"""Compressed collectives: the block-quantized int8 all-reduce.

Port of ``deepspeed_tpu/comm/compressed.py`` (lines 60-260 and 889-921):

* :func:`quantized_all_reduce` — the two-stage mean all-reduce: every rank
  block-quantizes its whole tensor, the int8 shards and their scales ride an
  all-to-all, each rank dequantizes and averages its shard in fp32, then
  requantizes the mean shard and the int8 shards all-gather back. Optional
  error feedback carries both stages' residuals into the next call.
* :func:`quantized_all_gather` / :func:`quantized_reduce_scatter` — the
  ZeRO++ qwZ / qgZ one-shots.

The quantizers are the hand-written kernels of ``ops/quant.py`` on the card.
Each call appends ONE ledger entry (``comm.log_compressed``) with the
logical bytes (what the exact collective would move) and the wire bytes
(int8 payloads and one fp32 scale per block), the JAX package's formulas.

Where the JAX function runs inside ``shard_map`` over a mesh axis, this one
runs in each process over ``axis`` (a group or axis names): the world size,
this rank's index and the exchanges come from the group. Stochastic
rounding (``int8_sr``) takes a ``torch.Generator`` for the JAX key; the
dither is decorrelated across ranks and stages by folding the rank and the
stage into the seed drawn from it, as the JAX function folds in
``axis_index`` and splits.

Not ported yet: ``hierarchical_quantized_all_reduce`` and
``quantized_all_to_all`` (ROADMAP.md Queue A item 8: ep, moe, ulysses), and
the collective-program planner hooks (item 9).
"""

import time
from typing import Optional

import torch

from ..ops.quant import (BLOCK, _dequantize, _quantize, draw_seed, fold_in, pad_parts,
                         shard_layout)
from . import comm

__all__ = [
    "quantized_all_reduce", "hierarchical_quantized_all_reduce", "quantized_all_to_all",
    "quantized_all_gather", "quantized_reduce_scatter", "configure_compression",
    "compression_mode", "compression_block", "compression_hierarchical",
    "allreduce_feedback_init", "run_collective_program", "feedback_state",
    "store_feedback", "clear_feedback",
]

_SITES = ("dp_gradients", "zero_weights", "zero_gradients", "moe", "ulysses")
_STATE = {"mode": "none", "block": BLOCK, "hierarchical": False,
          "sites": {s: True for s in _SITES}}


def configure_compression(mode: str = "none", *, block: Optional[int] = None,
                          hierarchical: Optional[bool] = None,
                          sites: Optional[dict] = None) -> None:
    """Set the process-wide compression state (``initialize`` maps
    ``config.compressed_collectives`` onto it). Each call sets the WHOLE
    state: omitted fields return to their defaults."""
    if mode not in ("none", "int8", "int8_sr"):
        raise ValueError(f"compressed_collectives mode must be none|int8|int8_sr, "
                         f"got {mode!r}")
    _STATE["mode"] = mode
    _STATE["block"] = BLOCK if block is None else int(block)
    _STATE["hierarchical"] = bool(hierarchical) if hierarchical is not None else False
    _STATE["sites"] = {s: True for s in _SITES}
    for k, v in (sites or {}).items():
        if k not in _STATE["sites"]:
            raise ValueError(f"unknown compressed-collective site {k!r}; known: {_SITES}")
        _STATE["sites"][k] = bool(v)


def compression_mode(site: Optional[str] = None) -> str:
    """The active mode, or ``"none"`` when ``site`` is toggled off."""
    mode = _STATE["mode"]
    if mode == "none" or site is None:
        return mode
    return mode if _STATE["sites"].get(site, False) else "none"


def compression_block() -> int:
    return _STATE["block"]


def compression_hierarchical() -> bool:
    return _STATE["hierarchical"]


def _not_ported(what: str, item: int, area: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue A item {item} "
                               f"({area})")


def _stage_seeds(generator: Optional[torch.Generator], axis):
    """(stage-1, stage-2) seeds for stochastic rounding: one seed drawn from
    ``generator`` (the same on every rank), this rank's index folded in,
    then one fold per stage."""
    if generator is None:
        raise ValueError("stochastic quantized_all_reduce needs a torch.Generator")
    base = fold_in(draw_seed(generator), comm.axis_index(axis))
    return fold_in(base, 1), fold_in(base, 2)


def _quantize_parts(parts: torch.Tensor, world: int, shard_p: int, block: int,
                    seed: Optional[int]):
    """``world`` padded shards of ``shard_p`` (``pad_parts``) -> int8
    ``[world * nb_per, block]`` and scales ``[world * nb_per]``."""
    return _quantize(parts, parts.numel(), world * shard_p // block, block, seed)


def _dequantize_parts(q: torch.Tensor, s: torch.Tensor, world: int) -> torch.Tensor:
    """Inverse of :func:`_quantize_parts`: -> fp32 ``[world, shard_p]``."""
    return _dequantize(q, s, q.numel()).view(world, -1)


def allreduce_feedback_init(shape, world: int, device="cuda"):
    """Zero ``ErrorFeedbackState`` for :func:`quantized_all_reduce` over a
    tensor of ``shape`` on a ``world``-rank axis: ``worker_error`` like the
    input, ``server_error`` this rank's stage-2 shard. Built on the card
    unless ``device="cpu"`` asks for the host (``resolve_device`` raises
    for the card where there is none)."""
    from ..accelerator.real_accelerator import resolve_device
    from ..compression.onebit import ErrorFeedbackState

    device = resolve_device(device)
    n = 1
    for d in shape:
        n *= d
    shard = -(-n // world)
    return ErrorFeedbackState(worker_error=torch.zeros(shape, device=device),
                              server_error=torch.zeros(shard, device=device))


# The residual registry (JAX ``comm/compressed.py:783-811``): host-side
# callers that cannot thread the error-feedback state through their own
# signatures register it under a stable key. The first fetch creates the
# zeros, every later fetch returns the last stored state, and
# store_feedback() commits the post-reduction residual.

_FEEDBACK_REGISTRY: dict = {}


def feedback_state(name: str, shape=None, world: Optional[int] = None, init=None):
    """The registered residual for ``name``, created on first use from
    ``init()`` (or :func:`allreduce_feedback_init` ``(shape, world)``, on
    the card: a caller on the host passes ``init``)."""
    if name not in _FEEDBACK_REGISTRY:
        if init is not None:
            _FEEDBACK_REGISTRY[name] = init()
        else:
            if shape is None or world is None:
                raise ValueError(f"feedback_state({name!r}): first use needs shape+world "
                                 "(or an init callable) to build the zero state")
            _FEEDBACK_REGISTRY[name] = allreduce_feedback_init(shape, world)
    return _FEEDBACK_REGISTRY[name]


def store_feedback(name: str, state) -> None:
    """Commit the post-reduction residual for ``name``; the next
    :func:`feedback_state` fetch returns it."""
    _FEEDBACK_REGISTRY[name] = state


def clear_feedback(name: Optional[str] = None) -> None:
    """Drop one registered residual (or all of them), so that a rollback
    does not re-inject a residual from an abandoned trajectory."""
    if name is None:
        _FEEDBACK_REGISTRY.clear()
    else:
        _FEEDBACK_REGISTRY.pop(name, None)


def quantized_all_reduce(x: torch.Tensor, axis=None, *, block: Optional[int] = None,
                         stochastic: bool = False,
                         generator: Optional[torch.Generator] = None,
                         feedback=None, link: Optional[str] = None):
    """Mean all-reduce over ``axis`` with int8 payloads on both hops.

    1. reduce-scatter: quantize the whole tensor once (as ``world`` shards,
       each padded to whole blocks), all-to-all the int8 shards and their
       scales, dequantize the ``world`` copies of this rank's shard and take
       their fp32 mean;
    2. all-gather: requantize the mean shard, all-gather the int8 shards and
       scales, dequantize to the full tensor.

    ``stochastic=True`` dithers both quantizations (``generator`` needed).
    ``feedback`` (:func:`allreduce_feedback_init`) carries both stages'
    residuals into the next call and makes the return ``(out,
    new_feedback)``. Returns fp32 in ``x``'s shape; at world size 1 that is
    ``x`` in fp32, and nothing is launched."""
    block = compression_block() if block is None else block
    world = comm.get_world_size(axis)
    shape = tuple(x.shape)
    n = x.numel()
    if world == 1:
        out = x.to(torch.float32)
        return (out, feedback) if feedback is not None else out
    t0 = time.perf_counter()
    shard, shard_p, b1 = shard_layout(n, world, block)
    seed1 = seed2 = None
    if stochastic:
        seed1, seed2 = _stage_seeds(generator, axis)

    comp = x.reshape(-1).to(torch.float32)
    if feedback is not None:
        comp = comp + feedback.worker_error.reshape(-1)
    parts = pad_parts(comp, world, shard, shard_p)

    # stage 1: quantize once, exchange shards, dequantize + mean
    q, s1 = _quantize_parts(parts, world, shard_p, b1, seed1)
    new_worker = None
    if feedback is not None:
        # the residual against what the receivers decode of this rank's part
        decoded = _dequantize_parts(q, s1, world)[:, :shard].reshape(-1)[:n]
        new_worker = (comp - decoded).reshape(shape)
    qt = comm.exchange(q, axis)
    st = comm.exchange(s1, axis)
    shard_mean = _dequantize_parts(qt, st, world)[:, :shard].mean(dim=0)

    # stage 2: requantize the mean shard, gather it back (shard_layout
    # guarantees shard_p % b1 == 0, so the stage reuses b1)
    s_comp = shard_mean
    if feedback is not None:
        s_comp = s_comp + feedback.server_error
    q2, s2 = _quantize(s_comp.contiguous(), shard, shard_p // b1, b1, seed2)
    new_server = None
    if feedback is not None:
        new_server = s_comp - _dequantize(q2, s2, shard)
    qg = comm.gather_stack(q2, axis).view(-1, b1)
    sg = comm.gather_stack(s2, axis).view(-1)
    out = _dequantize_parts(qg, sg, world)[:, :shard].reshape(-1)[:n].reshape(shape)

    nb1 = world * (shard_p // b1)
    nb2 = shard_p // b1
    wire = (world * shard_p + 4 * nb1) + (shard_p + 4 * nb2)
    comm.log_compressed("quantized_all_reduce", n * x.element_size(), wire,
                        time.perf_counter() - t0, link=link, axes=axis,
                        impl=("int8_ef" if feedback is not None
                              else "int8_sr" if stochastic else "int8"))
    if feedback is not None:
        return out, type(feedback)(worker_error=new_worker, server_error=new_server)
    return out


def hierarchical_quantized_all_reduce(x, inner_axis, outer_axis, **kwargs):
    raise _not_ported("hierarchical_quantized_all_reduce", 8,
                      "the expert axis split, ep > 1")


def quantized_all_to_all(x, axis, *args, **kwargs):
    raise _not_ported("quantized_all_to_all", 8, "moe and ulysses exchanges")


def run_collective_program(*args, **kwargs):
    raise _not_ported("run_collective_program", 9, "comm/planner/*")


def quantized_all_gather(x: torch.Tensor, axis=None, block: Optional[int] = None, *,
                         stochastic: bool = False, generator: Optional[torch.Generator] = None,
                         link: Optional[str] = None) -> torch.Tensor:
    """qwZ int8 all-gather: quantize the local tensor once, gather payloads
    and scales, dequantize on arrival. Returns ``[world, *x.shape]`` fp32."""
    from ..ops.quant import quantized_all_gather as _qag

    block = compression_block() if block is None else block
    n = x.numel()
    nb = -(-n // block)
    t0 = time.perf_counter()
    out = _qag(x, axis, block, stochastic=stochastic, generator=generator)
    comm.log_compressed("quantized_all_gather", n * x.element_size(), nb * block + 4 * nb,
                        time.perf_counter() - t0, link=link, axes=axis,
                        impl="int8_sr" if stochastic else "int8")
    return out


def quantized_reduce_scatter(x: torch.Tensor, axis=None, block: Optional[int] = None, *,
                             stochastic: bool = False,
                             generator: Optional[torch.Generator] = None,
                             link: Optional[str] = None) -> torch.Tensor:
    """qgZ int8 mean reduce-scatter: this rank's ``[ceil(n / world)]`` fp32
    shard of the mean."""
    from ..ops.quant import quantized_reduce_scatter as _qrs

    block = compression_block() if block is None else block
    world = comm.get_world_size(axis)
    n = x.numel()
    _, shard_p, b = shard_layout(n, world, block)
    nb = world * (shard_p // b)
    t0 = time.perf_counter()
    out = _qrs(x, axis, block, stochastic=stochastic, generator=generator)
    comm.log_compressed("quantized_reduce_scatter", n * x.element_size(),
                        world * shard_p + 4 * nb, time.perf_counter() - t0, link=link,
                        axes=axis, impl="int8_sr" if stochastic else "int8")
    return out
