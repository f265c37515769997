"""Dynamic loss scaling as functional state.

Port of ``deepspeed_tpu/runtime/loss_scaler.py`` (reference
``DynamicLossScaler``, ``runtime/fp16/loss_scaler.py:91``). The state is a
small tuple of host numbers; the engine reads the overflow flag on the host
once per fp16 step (the JAX package keeps it on the device with
``jnp.where``), so the update here is plain Python with the same rules.
"""

from typing import Iterable, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float          # current loss scale
    good_steps: int       # consecutive non-overflow steps
    hysteresis: int       # remaining tolerated overflows before backoff


def make_loss_scale_state(initial_scale_power: int = 16, static_scale: float = 0.0,
                          hysteresis: int = 2) -> LossScaleState:
    scale = static_scale if static_scale > 0 else 2.0 ** initial_scale_power
    return LossScaleState(scale=float(scale), good_steps=0, hysteresis=int(hysteresis))


def has_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global non-finite check over a list of gradients (reference
    ``CheckOverflow``, ``runtime/utils.py:181``): a 0-dim bool tensor on the
    gradients' device."""
    grads = list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    flags = [~torch.isfinite(g.float()).all() for g in grads]
    return torch.stack(flags).any()


def update_loss_scale(state: LossScaleState, overflow: bool, *,
                      dynamic: bool = True, scale_window: int = 1000,
                      scale_factor: float = 2.0, min_scale: float = 1.0,
                      max_hysteresis: int = 2,
                      consecutive_hysteresis: bool = False) -> LossScaleState:
    """One step of the reference's update_scale logic (loss_scaler.py:91)."""
    if not dynamic:
        return state
    overflow = bool(overflow)
    hys_exhausted = state.hysteresis <= 1
    scale, hys = state.scale, state.hysteresis
    if overflow and hys_exhausted:
        scale = max(state.scale / scale_factor, min_scale)
    if overflow and not hys_exhausted:
        hys = state.hysteresis - 1
    good = 0 if overflow else state.good_steps + 1
    grow = (not overflow) and good % scale_window == 0 and good > 0
    if grow:
        scale = scale * scale_factor
    # reference loss_scaler.py:194-201: consecutive_hysteresis replenishes on
    # every good step; otherwise hysteresis replenishes only at growth windows
    replenish = (not overflow) if consecutive_hysteresis else grow
    if replenish:
        hys = max_hysteresis
    return LossScaleState(scale=float(scale), good_steps=good, hysteresis=hys)
