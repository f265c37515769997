"""LR schedules (reference ``runtime/lr_schedules.py``).

Port of ``deepspeed_tpu/runtime/lr_schedules.py``: each builder returns a
pure function ``step -> lr`` of the optimizer step counter. The JAX package
evaluates them in float32 inside its compiled step; here they run on the
host, in numpy float32 with each intermediate rounded as the JAX function
rounds it, and return a Python float that is exactly the float32 value, so
both packages feed the optimizer the same learning rate.

Reference classes: ``LRRangeTest:273``, ``OneCycle:371``, ``WarmupLR:633``,
``WarmupDecayLR:723``, ``WarmupCosineLR:774``.
"""

import math
from typing import Callable, Optional

import numpy as np

Schedule = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

f32 = np.float32


def _clip(x, lo, hi):
    return f32(min(max(x, f32(lo)), f32(hi)))


def _log(x):
    """float32 log rounded once from double, as XLA's is; numpy's float32
    transcendentals can be an ulp off."""
    return f32(math.log(x))


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def sched(step):
        s = f32(max(f32(step) - f32(1), f32(0)))
        interval = f32(s / f32(lr_range_test_step_size))
        if lr_range_test_staircase:
            interval = f32(np.floor(interval))
        return float(f32(lr_range_test_min_lr) * f32(
            f32(1) + f32(interval * f32(lr_range_test_step_rate))))

    return sched


def one_cycle(cycle_min_lr: float = 1e-3, cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> Schedule:
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second
    lo, hi = f32(cycle_min_lr), f32(cycle_max_lr)
    span = f32(cycle_max_lr - cycle_min_lr)   # a Python difference, as in JAX

    def sched(step):
        s = f32(max(f32(step) - f32(1), f32(0)))
        up = _clip(f32(s / f32(cycle_first_step_size)), 0.0, 1.0)
        down = _clip(f32(f32(s - f32(cycle_first_step_size)) / f32(second)), 0.0, 1.0)
        if s <= f32(cycle_first_step_size):
            in_cycle = f32(lo + f32(span * up))
        else:
            in_cycle = f32(hi - f32(span * down))
        if decay_step_size > 0 and s > f32(total_cycle):
            decay_steps = f32(f32(max(f32(s - f32(total_cycle)), f32(0)))
                              / f32(decay_step_size))
            return float(f32(lo / f32(f32(1) + f32(decay_steps * f32(decay_lr_rate)))))
        return float(in_cycle)

    return sched


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Schedule:
    warmup_num_steps = max(2, warmup_num_steps)
    lo, hi = f32(warmup_min_lr), f32(warmup_max_lr)
    span = f32(warmup_max_lr - warmup_min_lr)

    def sched(step):
        if step >= warmup_num_steps:
            return float(hi)
        s = _clip(f32(step), 1.0, float(warmup_num_steps))
        if warmup_type == "log":
            gamma = f32(_log(s) / f32(math.log(warmup_num_steps)))
        else:
            gamma = f32(s / f32(warmup_num_steps))
        return float(f32(lo + f32(span * gamma)))

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps_ = max(2, warmup_num_steps)

    def sched(step):
        s = f32(step)
        if s < f32(warmup_num_steps_):
            return base(step)
        decay = _clip(f32(f32(f32(total_num_steps) - s)
                          / f32(max(1.0, total_num_steps - warmup_num_steps_))), 0.0, 1.0)
        return float(f32(f32(warmup_max_lr) * decay))

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.01,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "linear", base_lr: float = 1.0, **_) -> Schedule:
    warmup_num_steps_ = max(2, warmup_num_steps)

    def sched(step):
        s = f32(max(f32(step), f32(1)))
        if s < f32(warmup_num_steps_):
            if warmup_type == "log":
                gamma = f32(_log(_clip(s, 1.0, warmup_num_steps_))
                            / f32(math.log(warmup_num_steps_)))
            else:
                gamma = _clip(f32(s / f32(warmup_num_steps_)), 0.0, 1.0)
            ratio = f32(f32(warmup_min_ratio) + f32(f32(1.0 - warmup_min_ratio) * gamma))
        else:
            progress = _clip(f32(f32(s - f32(warmup_num_steps_))
                                 / f32(max(1.0, total_num_steps - warmup_num_steps_))), 0.0, 1.0)
            cos = f32(math.cos(f32(f32(np.pi) * progress)))
            ratio = f32(f32(cos_min_ratio) + f32(
                f32((1.0 - cos_min_ratio) * 0.5) * f32(f32(1) + cos)))
        return float(f32(f32(base_lr) * ratio))

    return sched


def build_lr_schedule(sched_type: Optional[str], params: dict, base_lr: float = 1e-3) -> Schedule:
    """Config ``scheduler`` section -> schedule callable. ``None`` -> constant
    base_lr (the optimizer's own lr)."""
    if sched_type is None:
        return lambda step: float(f32(base_lr))
    if sched_type == LR_RANGE_TEST:
        return lr_range_test(**params)
    if sched_type == ONE_CYCLE:
        return one_cycle(**params)
    if sched_type == WARMUP_LR:
        return warmup_lr(**params)
    if sched_type == WARMUP_DECAY_LR:
        return warmup_decay_lr(**params)
    if sched_type == WARMUP_COSINE_LR:
        return warmup_cosine_lr(**params)
    raise ValueError(f"Unknown scheduler type {sched_type}; valid: {VALID_LR_SCHEDULES}")
