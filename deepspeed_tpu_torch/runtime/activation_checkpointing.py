"""Activation checkpointing API (reference ``deepspeed.checkpointing``).

Port of ``deepspeed_tpu/runtime/activation_checkpointing.py``. The JAX
package maps rematerialization onto ``jax.checkpoint`` and a
``jax.checkpoint_policies`` entry; here it is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:

* policy ``None`` or ``"nothing_saveable"``: nothing inside the wrapped
  function is kept; the backward re-runs it whole;
* ``"dots_saveable"``: the outputs of matrix products (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``) are kept and the rest recomputed,
  through ``create_selective_checkpoint_contexts``;
  ``"dots_with_no_batch_dims_saveable"`` keeps only the unbatched ones
  (``mm``, ``addmm``), as the JAX policy does;
* ``"everything_saveable"``: everything is kept (no recompute);
* ``cpu_checkpointing`` (reference ``checkpoint_in_cpu``) with no explicit
  policy: :func:`checkpoint` keeps what ``"dots_saveable"`` keeps, but in
  pinned host memory: each matrix product's output is copied to the host as
  the forward makes it (:func:`_pack_to_host`) and copied back to its
  device when the backward's recompute reaches that product
  (:func:`_unpack_to_device`), which returns the copy in place of running
  it. The JAX package offloads the unbatched dots to pinned host memory
  (``offload_dot_with_no_batch_dims("device", "pinned_host")``); the values
  are those of the policy without offload.

A selective policy sees dispatcher ops only. The port's hand-written
kernels launch from inside ``torch.autograd.Function``s through ``ctypes``,
so no policy sees them and they re-run under every policy but
``everything_saveable``; in JAX a ``pallas_call`` is not a dot either, so
``dots_saveable`` recomputes them there too. Any other policy name raises.

No RNG state is saved or restored around the recompute, and restoring
would not reach an explicit ``torch.Generator``: a wrapped function that
draws random numbers takes its seed as an argument, as the model's dropout
does (each layer's mask from a fresh generator seeded with a value fixed
before the forward), so the recompute draws what the forward drew.
"""

import collections
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as _torch_checkpoint,
                                    create_selective_checkpoint_contexts)

_config = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "policy": None,
}
_configured = False
_KEYS = ("partition_activations", "cpu_checkpointing",
         "contiguous_memory_optimization", "number_checkpoints",
         "synchronize_checkpoint_boundary", "profile", "policy")

_aten = torch.ops.aten
_UNBATCHED_DOTS = (_aten.mm.default, _aten.addmm.default)
_DOTS = _UNBATCHED_DOTS + (_aten.bmm.default, _aten.baddbmm.default)
_SAVED_OPS = {"dots_saveable": _DOTS, "dots_with_no_batch_dims_saveable": _UNBATCHED_DOTS}
POLICIES = (None, "nothing_saveable", "everything_saveable") + tuple(_SAVED_OPS)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              policy: Optional[str] = None):
    """Record the reference knob vocabulary and pick a remat policy (one of
    :data:`POLICIES`). The storage knobs are accepted for config
    compatibility and change nothing, except ``cpu_checkpointing``, which
    :func:`checkpoint` reads."""
    if deepspeed_config is not None:
        act = getattr(deepspeed_config, "activation_checkpointing", None)
        if isinstance(deepspeed_config, dict):
            act = deepspeed_config.get("activation_checkpointing")
        if act is not None and not isinstance(act, dict):
            act = {f: getattr(act, f) for f in _KEYS if hasattr(act, f)}
        if act:
            for key in _KEYS:
                if key in act and act[key] is not None:
                    _config[key] = act[key]
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile), ("policy", policy)):
        if val is not None:
            _config[key] = val
    global _configured
    _configured = True


def is_configured() -> bool:
    """Whether :func:`configure` has run (reference lazy-config idiom:
    ``if not is_configured(): configure(...)``)."""
    return _configured


def get_config() -> dict:
    return dict(_config)


def checkpoint(function: Callable, *args) -> Any:
    """Reference ``checkpointing.checkpoint(fn, *args)``: run ``fn`` now,
    recompute its intermediates in the backward pass under the configured
    policy. With ``cpu_checkpointing`` and no explicit policy, the matrix
    products' outputs are kept in pinned host memory and the rest is
    recomputed (the JAX package's offload of the saved dots)."""
    policy = _config.get("policy")
    if policy is None and _config.get("cpu_checkpointing"):
        return checkpoint_wrapper(function, "dots_saveable", offload=True)(*args)
    return checkpoint_wrapper(function, policy)(*args)


def layer_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """The recompute wrapper of a model's layer under ``policy``: with no
    policy, what :func:`checkpoint` would do with the configured knobs
    (``cpu_checkpointing``: the products kept in host memory; otherwise
    nothing kept)."""
    if policy is None and _config.get("policy") is None and _config.get("cpu_checkpointing"):
        return checkpoint_wrapper(function, "dots_saveable", offload=True)
    return checkpoint_wrapper(function, policy)


def model_parallel_reconfigure_tp_seed(seed) -> torch.Generator:
    """Reference ``model_parallel_reconfigure_tp_seed``. The JAX package
    returns a key the caller threads; the port returns a ``torch.Generator``
    for the caller to pass on, seeded with ``seed`` folded with this rank's
    tp index when the live topology has a tp axis above 1 (so the ranks'
    streams differ), else with ``seed``."""
    from ..parallel.topology import get_topology

    if get_topology().tp_size > 1:
        from .. import comm
        from ..ops.quant import fold_in

        seed = fold_in(int(seed), comm.axis_index("tp"))
    return torch.Generator().manual_seed(int(seed))


def _context_fn(policy: str):
    saved = _SAVED_OPS[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy_fn)


def _pack_to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a saved product (its strides kept): pinned and written
    asynchronously, in stream order, for a tensor on the card."""
    host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="cpu",
                               pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=t.is_cuda)
    return host


def _unpack_to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    return host.to(device, non_blocking=True)


class _SaveToHost(TorchDispatchMode):
    """The checkpointed forward: the output of each saved op goes to the
    host as it is made, in order, per op."""

    def __init__(self, ops, store):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.store[func].append((_pack_to_host(out), out.device))
        return out


class _ReplayFromHost(TorchDispatchMode):
    """The backward's recompute: a saved op returns its host copy, back on
    its device, instead of running; every other op runs again."""

    def __init__(self, ops, store):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            return _unpack_to_device(*self.store[func].popleft())
        return func(*args, **(kwargs or {}))


def _offload_context_fn(policy: str):
    ops = frozenset(_SAVED_OPS[policy])

    def contexts():
        store = collections.defaultdict(collections.deque)
        return _SaveToHost(ops, store), _ReplayFromHost(ops, store)

    return contexts


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None,
                       offload: bool = False) -> Callable:
    """Return a recompute-wrapped callable (decorator form) under ``policy``
    (one of :data:`POLICIES`); an unknown policy raises ``ValueError``.
    ``offload`` keeps what a selective policy keeps in host memory instead
    of on the device."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} is not supported by the port "
                         f"(supported: {', '.join(str(p) for p in POLICIES)})")
    if offload and policy not in _SAVED_OPS:
        raise ValueError(f"offload keeps the outputs a selective policy saves "
                         f"({', '.join(_SAVED_OPS)}), not under {policy!r}")
    if policy == "everything_saveable":
        return function
    kwargs = dict(use_reentrant=False, preserve_rng_state=False)
    if offload:
        kwargs["context_fn"] = _offload_context_fn(policy)
    elif policy in _SAVED_OPS:
        kwargs["context_fn"] = _context_fn(policy)

    def wrapped(*args):
        return _torch_checkpoint(function, *args, **kwargs)

    return wrapped
