"""Optimizers: the port of the Adam part of ``deepspeed_tpu/ops/optimizers.py``.

Keeps the optax shape of the JAX package — ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)`` — over parameter trees
(nested dicts of tensors, the flax layout). A transformation may also offer
``apply(grads, state, params) -> state``, which updates the parameters IN
PLACE; the engine prefers it for fp32 parameters. For ``fused_adam`` on
the card (the hand-written kernel of ``ops/csrc/fused_adam.cu``) ``apply``
is one kernel launch over every tensor that updates p, m and v in place
and never allocates the update ``u``.

Only the Adam family is ported in this slice; the other types raise
``NotImplementedError`` naming ROADMAP.md Queue A item 7.
"""

from typing import Any, Callable, NamedTuple, Optional, Union

import torch
from torch.utils import _pytree as pytree

ScalarOrSchedule = Union[float, Callable[[int], float]]

_NOT_PORTED = ("optimizer type {!r} is not ported yet (ops/optimizers.py: LAMB, "
               "Lion, Adagrad, SGD, 1-bit and muP optimizers; ROADMAP.md Queue A "
               "item 7, optimizers)")


def _lr_at(lr: ScalarOrSchedule, step: int) -> float:
    return lr(step) if callable(lr) else lr


class GradientTransformation(NamedTuple):
    """optax's ``GradientTransformation`` plus an optional in-place
    ``apply``."""
    init: Callable
    update: Callable
    apply: Optional[Callable] = None


class ScaleByAdamState(NamedTuple):
    step: int
    exp_avg: Any
    exp_avg_sq: Any


def fused_adam(lr: ScalarOrSchedule = 1e-3,
               betas=(0.9, 0.999),
               eps: float = 1e-8,
               weight_decay: float = 0.0,
               adam_w_mode: bool = True,
               bias_correction: bool = True,
               use_pallas: bool = False) -> GradientTransformation:
    """Adam/AdamW with the reference ``FusedAdam`` semantics
    (``deepspeed/ops/adam/fused_adam.py:18``): decoupled weight decay when
    ``adam_w_mode``, classic L2-into-grad otherwise. State and math are fp32
    whatever the parameters' dtype; the step counter is a host integer and
    both the LR and the bias correction see ``step + 1``.

    The device chooses the implementation: tensors on the card take the
    hand-written multi-tensor kernel (one launch per step), CPU tensors its
    plain version. ``use_pallas`` only picks which of the JAX package's two
    roundings of the bias correction to reproduce: its Pallas kernel's
    ``1 - exp(step * ln b)`` (True) or its plain update's ``1 - b ** step``
    (False). ``update`` updates m and v in place."""

    def init_fn(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return ScaleByAdamState(step=0, exp_avg=pytree.tree_map(zeros, params),
                                exp_avg_sq=pytree.tree_map(zeros, params))

    def run(grads, state, params, updates):
        from .fused_adam import multi_tensor_adam

        step = state.step + 1
        g = pytree.tree_leaves(grads)
        p = (pytree.tree_leaves(params) if params is not None else
             [torch.zeros_like(x, dtype=torch.float32) for x in g])
        multi_tensor_adam([x.float() for x in g], pytree.tree_leaves(state.exp_avg),
                          pytree.tree_leaves(state.exp_avg_sq), [x.float() for x in p],
                          lr=_lr_at(lr, step), betas=betas, eps=eps,
                          weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                          bias_correction=bias_correction, step=step, updates=updates,
                          pow_correction=not use_pallas)
        return state._replace(step=step)

    def update_fn(grads, state, params=None):
        g, spec = pytree.tree_flatten(grads)
        u = [torch.empty_like(x, dtype=torch.float32) for x in g]
        state = run(grads, state, params, u)
        return pytree.tree_unflatten(u, spec), state

    def apply_fn(grads, state, params):
        """In place: ``p += u`` (fp32 parameters), m and v updated."""
        if any(x.dtype != torch.float32 for x in pytree.tree_leaves(params)):
            raise ValueError("apply updates float32 parameters in place; use "
                             "update for parameters stored in another dtype")
        return run(grads, state, params, None)

    return GradientTransformation(init_fn, update_fn, apply_fn)


# ---------------------------------------------------------------------------
# Registry — the analogue of engine._configure_basic_optimizer (engine.py:1330)
# ---------------------------------------------------------------------------

def _normalize_params(params: dict) -> dict:
    p = dict(params)
    if "betas" in p:
        p["betas"] = tuple(p["betas"])
    p.pop("torch_adam", None)
    return p


def build_optimizer(name: str, params: Optional[dict] = None) -> GradientTransformation:
    """Map a config ``optimizer.type`` to a transformation. Accepts the
    reference's Adam names: Adam, AdamW, FusedAdam, CPUAdam (the host path is
    an engine concern; same math). Other types raise
    ``NotImplementedError``."""
    params = _normalize_params(params or {})
    lr = params.pop("lr", 1e-3)
    wd = params.pop("weight_decay", 0.0)
    name_l = name.lower().replace("_", "")
    if name_l in ("adam", "fusedadam", "cpuadam", "deepspeedcpuadam"):
        return fused_adam(lr=lr, weight_decay=wd,
                          adam_w_mode=params.pop("adam_w_mode", params.pop("adamw_mode", True)),
                          **{k: v for k, v in params.items() if k in ("betas", "eps", "bias_correction")})
    if name_l == "adamw":
        return fused_adam(lr=lr, weight_decay=wd, adam_w_mode=True,
                          **{k: v for k, v in params.items() if k in ("betas", "eps", "bias_correction")})
    if name_l in ("lamb", "fusedlamb", "lion", "fusedlion", "cpulion", "adagrad",
                  "cpuadagrad", "sgd", "onebitadam", "zerooneadam", "onebitlamb",
                  "muadam", "muadamw", "musgd"):
        raise NotImplementedError(_NOT_PORTED.format(name))
    raise ValueError(f"Unknown optimizer type: {name}")
