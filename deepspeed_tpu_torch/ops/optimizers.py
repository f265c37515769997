"""Optimizers: the port of ``deepspeed_tpu/ops/optimizers.py``.

Keeps the optax shape of the JAX package — ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)`` — over parameter trees
(nested dicts of tensors, the flax layout). A transformation may also offer
``apply(grads, state, params) -> state``, which updates the parameters IN
PLACE; the engine prefers it for fp32 parameters. For ``fused_adam`` on
the card (the hand-written kernel of ``ops/csrc/fused_adam.cu``) ``apply``
is one kernel launch over every tensor that updates p, m and v in place
and never allocates the update ``u``.

LAMB, Lion, Adagrad, SGD and the muP wrappers are plain PyTorch on the
tensors, as the JAX package's are plain ``jnp`` that XLA fuses (no Pallas
kernel). Their state is fp32 whatever the parameters' dtype, and their
moments are updated in place. The 1-bit names raise
``NotImplementedError``: their only working JAX path is the packed
transport of ROADMAP.md Queue A item 8.

Over ZeRO stages 1-3 the engine may give a transformation this rank's
fragment of each leaf (1-D) instead of the leaf. It then opens
:func:`sharded_leaves`, through which the rules that need more than the
elements read what a fragment cannot tell: LAMB sums its per-leaf squared
norms over the ranks (one collective a step), muP reads each leaf's full
shape by its path.
"""

import contextlib
import contextvars
import math
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

ScalarOrSchedule = Union[float, Callable[[int], float]]

_ONEBIT = ("optimizer type {!r} is not ported yet: the JAX package's 1-bit optimizers "
           "train only through onebit_train_step_factory over packed_allreduce "
           "(build_onebit_optimizer raises AttributeError there); ROADMAP.md Queue A "
           "item 8 (compression/onebit.py)")


class LeafShards(NamedTuple):
    """What a transformation over fragments needs: ``shapes`` maps each
    leaf's path (``"/"``-joined keys) to its full shape, ``reduce_sum``
    sums a 1-D fp32 tensor over the ranks that hold the other fragments."""
    shapes: Dict[str, tuple]
    reduce_sum: Callable[[torch.Tensor], torch.Tensor]


_SHARDS: contextvars.ContextVar = contextvars.ContextVar("optimizer_leaf_shards",
                                                         default=None)


@contextlib.contextmanager
def sharded_leaves(shapes: Dict[str, tuple], reduce_sum: Callable):
    """Within the block, the leaves given to a transformation are fragments
    of the leaves whose full shapes ``shapes`` holds (see
    :class:`LeafShards`)."""
    token = _SHARDS.set(LeafShards(shapes, reduce_sum))
    try:
        yield
    finally:
        _SHARDS.reset(token)


def path_name(path) -> str:
    """The ``"/"``-joined keys of a pytree key path (the JAX package's
    spelling of a leaf's name)."""
    return "/".join(str(getattr(e, "key", getattr(e, "name", e))) for e in path)


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


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def fused_lamb(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01) -> GradientTransformation:
    """LAMB (reference ``csrc/lamb/fused_lamb_cuda_kernel.cu``): the Adam
    direction plus ``weight_decay * p``, rescaled per tensor by the trust
    ratio ``clip(||p|| / ||adam_step||, min_coeff, max_coeff)`` (1 where
    either norm is 0). Both norms of every leaf are taken in one stacked
    vector, summed over the ranks under :func:`sharded_leaves` with one
    collective; the last step's ratios stay readable as
    ``update.last_trust`` (a device vector, one per leaf in tree order)."""
    b1, b2 = betas

    def init_fn(params):
        return ScaleByAdamState(step=0, exp_avg=pytree.tree_map(_zeros32, params),
                                exp_avg_sq=pytree.tree_map(_zeros32, params))

    def update_fn(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        g_l, spec = pytree.tree_flatten(grads)
        m_l, v_l = pytree.tree_leaves(state.exp_avg), pytree.tree_leaves(state.exp_avg_sq)
        p_l = pytree.tree_leaves(params)
        steps, squares = [], []
        for g, m, v, p in zip(g_l, m_l, v_l, p_l):
            g, p32 = g.float(), p.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            s = (m / bc1) / ((v / bc2).sqrt() + eps) + weight_decay * p32
            steps.append(s)
            squares += [p32.square().sum(), s.square().sum()]
        if steps:
            sq = torch.stack(squares)
            shards = _SHARDS.get()
            if shards is not None:
                sq = shards.reduce_sum(sq)
            w, u = sq.sqrt().view(-1, 2).unbind(1)
            trust = torch.where((w > 0) & (u > 0), (w / u).clamp(min_coeff, max_coeff),
                                torch.ones_like(w))
            update_fn.last_trust = trust
            for s, c in zip(steps, (-lr_t * trust).unbind()):
                s.mul_(c)
        return pytree.tree_unflatten(steps, spec), state._replace(step=step)

    update_fn.last_trust = None
    return GradientTransformation(init_fn, update_fn)


class ScaleByLionState(NamedTuple):
    step: int
    exp_avg: Any


def fused_lion(lr: ScalarOrSchedule = 1e-4, betas=(0.9, 0.99),
               weight_decay: float = 0.0) -> GradientTransformation:
    """Lion (reference ``csrc/lion/fused_lion_frontend.cpp``): ``-lr *
    (sign(b1 m + (1 - b1) g) + weight_decay * p)``, then the moment moves
    with ``b2``."""
    b1, b2 = betas

    def init_fn(params):
        return ScaleByLionState(step=0, exp_avg=pytree.tree_map(_zeros32, params))

    def update_fn(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        g_l, spec = pytree.tree_flatten(grads)
        out = []
        for g, m, p in zip(g_l, pytree.tree_leaves(state.exp_avg),
                           pytree.tree_leaves(params)):
            g = g.float()
            out.append(-lr_t * (torch.sign(b1 * m + (1 - b1) * g)
                                + weight_decay * p.float()))
            m.mul_(b2).add_(g, alpha=1 - b2)
        return pytree.tree_unflatten(out, spec), state._replace(step=step)

    return GradientTransformation(init_fn, update_fn)


class ScaleByAdagradState(NamedTuple):
    step: int
    sum_sq: Any


def adagrad(lr: ScalarOrSchedule = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0) -> GradientTransformation:
    """Adagrad (reference ``csrc/adagrad/cpu_adagrad.cpp``), weight decay
    added to the gradient."""

    def init_fn(params):
        return ScaleByAdagradState(step=0, sum_sq=pytree.tree_map(_zeros32, params))

    def update_fn(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        g_l, spec = pytree.tree_flatten(grads)
        out = []
        for g, s, p in zip(g_l, pytree.tree_leaves(state.sum_sq),
                           pytree.tree_leaves(params)):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            s.addcmul_(g, g)
            out.append(-lr_t * g / (s.sqrt() + eps))
        return pytree.tree_unflatten(out, spec), state._replace(step=step)

    return GradientTransformation(init_fn, update_fn)


class SGDState(NamedTuple):
    """optax's ``sgd`` state, flattened: the schedule's ``count`` (0 at the
    first update) and the momentum ``trace`` (``()`` without momentum)."""
    count: int
    trace: Any


def sgd(lr: ScalarOrSchedule = 1e-3, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> GradientTransformation:
    """The JAX package's ``sgd``: optax's ``add_decayed_weights`` (when
    ``weight_decay``), ``trace(momentum, nesterov)`` (when ``momentum``) and
    ``scale_by_learning_rate`` over a schedule that sees the count before
    its increment, 0 at the first update."""

    def init_fn(params):
        return SGDState(count=0, trace=pytree.tree_map(_zeros32, params) if momentum else ())

    def update_fn(grads, state, params=None):
        g_l, spec = pytree.tree_flatten(grads)
        p_l = pytree.tree_leaves(params) if weight_decay else [None] * len(g_l)
        t_l = pytree.tree_leaves(state.trace) if momentum else [None] * len(g_l)
        lr_t = _lr_at(lr, state.count)
        out = []
        for g, p, t in zip(g_l, p_l, t_l):
            u = g.float()
            if weight_decay:
                u = u + weight_decay * p.float()
            if momentum:
                t.copy_(u + momentum * t)
                u = u + momentum * t if nesterov else t
            out.append(-lr_t * u)
        return pytree.tree_unflatten(out, spec), state._replace(count=state.count + 1)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Registry — the analogue of engine._configure_basic_optimizer (engine.py:1330)
# ---------------------------------------------------------------------------

def _normalize_params(params: dict) -> dict:
    p = dict(params)
    if "betas" in p:
        p["betas"] = tuple(p["betas"])
    p.pop("torch_adam", None)
    return p


def _pick(params: dict, *keys) -> dict:
    return {k: v for k, v in params.items() if k in keys}


def build_optimizer(name: str, params: Optional[dict] = None) -> GradientTransformation:
    """Map a config ``optimizer.type`` to a transformation. Accepts the
    reference's names: Adam, AdamW, FusedAdam, CPUAdam (the host path is an
    engine concern; same math), Lamb, FusedLamb, Lion, Adagrad, SGD,
    MuAdam, MuAdamW, MuSGD. OneBitAdam, OneBitLamb and ZeroOneAdam raise
    ``NotImplementedError``; an unknown name raises ``ValueError``."""
    params = _normalize_params(params or {})
    lr = params.pop("lr", 1e-3)
    wd = params.pop("weight_decay", 0.0)
    name_l = name.lower().replace("_", "")
    if name_l in ("adam", "fusedadam", "cpuadam", "deepspeedcpuadam"):
        return fused_adam(lr=lr, weight_decay=wd,
                          adam_w_mode=params.pop("adam_w_mode", params.pop("adamw_mode", True)),
                          **_pick(params, "betas", "eps", "bias_correction"))
    if name_l == "adamw":
        return fused_adam(lr=lr, weight_decay=wd, adam_w_mode=True,
                          **_pick(params, "betas", "eps", "bias_correction"))
    if name_l in ("lamb", "fusedlamb"):
        return fused_lamb(lr=lr, weight_decay=wd,
                          **_pick(params, "betas", "eps", "max_coeff", "min_coeff"))
    if name_l in ("lion", "fusedlion", "cpulion"):
        return fused_lion(lr=lr, weight_decay=wd, **_pick(params, "betas"))
    if name_l in ("adagrad", "cpuadagrad"):
        return adagrad(lr=lr, weight_decay=wd, **_pick(params, "eps"))
    if name_l == "sgd":
        return sgd(lr=lr, weight_decay=wd, **_pick(params, "momentum", "nesterov"))
    if name_l in ("onebitadam", "zerooneadam", "onebitlamb"):
        raise NotImplementedError(_ONEBIT.format(name))
    if name_l in ("muadam", "muadamw", "musgd"):
        base = "sgd" if name_l == "musgd" else \
            ("adamw" if name_l == "muadamw" else "adam")
        return mu_optimizer(base, lr=lr, weight_decay=wd, **params)
    raise ValueError(f"Unknown optimizer type: {name}")


# the JAX package's AutoTP name vocabulary (module_inject/auto_tp.py): layers
# whose output is summed into the residual stream contract every dim but the
# last
_ROW_PATTERNS = (
    "o_proj", "out_proj", "down_proj", "dense_4h_to_h", "attention/dense",
    "attn/dense", "self_attention/dense", "fc2", "c_proj", "wo",
    "proj_out", "dense_out",
)
_INPUT_EMBED = ("embedding", "embed_tokens", "wte", "word_embeddings", "type_embed",
                "pos_embed")
_STACKED_EXPERT = ("expert_gate_proj", "expert_up_proj", "expert_down_proj",
                   "expert_gate_bias", "expert_up_bias", "expert_down_bias")


def _matches(patterns: Sequence[str], text: str) -> bool:
    """A pattern hits only at name-component boundaries ([/_.-] or an end);
    a '/' inside a pattern matches either separator."""
    return any(re.search(rf"(^|[/_.\-]){re.escape(p).replace('/', '[/.]')}([/_.\-]|$)",
                         text)
               for p in patterns)


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: a stateless stage of a chain."""


def mu_optimizer(base: str, lr: float = 1e-3, weight_decay: float = 0.0,
                 base_width: int = 1, **params) -> GradientTransformation:
    """μP optimizer wrappers (reference ``MuAdam`` / ``MuSGD`` of the ``mup``
    package): the base optimizer's update scaled per leaf from its full
    shape and path, as the JAX package's ``mu_optimizer`` scales it.

    * matrix-like leaves (ndim >= 2): the Adam family scales by
      ``base_width / fan_in``, fan_in being the contracted extent: every
      dim but the last for the row-parallel names (o_proj, down_proj, ...),
      the leading dim otherwise; SGD keeps its lr. Input embedding tables
      are unscaled; stacked expert leaves ``[E, ...]`` drop the expert dim
      first.
    * vectors (biases, norms): the Adam family keeps its lr, SGD scales by
      ``fan_out / base_width``.

    The state is ``(base state, EmptyState())``, optax's chain of the two."""
    adam_family = base in ("adam", "adamw")

    def scale_for(name: str, shape: tuple) -> float:
        if len(shape) >= 2:
            if _matches(_INPUT_EMBED, name):
                return 1.0
            if _matches(_STACKED_EXPERT, name):
                shape = shape[1:]
            if len(shape) < 2:
                return 1.0
            fan_in = math.prod(shape[:-1]) if _matches(_ROW_PATTERNS, name) else shape[0]
            return base_width / fan_in if adam_family else 1.0
        if len(shape) == 1 and not adam_family:
            return shape[0] / base_width
        return 1.0

    if adam_family:
        inner = fused_adam(lr=lr, weight_decay=weight_decay, adam_w_mode=(base == "adamw"),
                           **_pick(params, "betas", "eps", "bias_correction"))
    else:
        inner = sgd(lr=lr, weight_decay=weight_decay, **_pick(params, "momentum", "nesterov"))

    def init_fn(params_tree):
        return (inner.init(params_tree), EmptyState())

    def update_fn(grads, state, params_tree=None):
        updates, inner_state = inner.update(grads, state[0], params_tree)
        shards = _SHARDS.get()
        flat, spec = pytree.tree_flatten_with_path(updates)
        out = []
        for path, u in flat:
            name = path_name(path)
            shape = shards.shapes[name] if shards is not None else tuple(u.shape)
            s = scale_for(name.lower(), shape)
            out.append(u if s == 1.0 else u.mul_(s))
        return pytree.tree_unflatten(out, spec), (inner_state, state[1])

    return GradientTransformation(init_fn, update_fn)
