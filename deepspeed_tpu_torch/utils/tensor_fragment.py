"""ZeRO parameter / gradient / optimizer-state access API: the port of
``deepspeed_tpu/utils/tensor_fragment.py`` (reference
``deepspeed/utils/tensor_fragment.py``: ``safe_get_full_fp32_param`` and
the rest, the surface RLHF and LoRA frameworks use to read and write
training state that ZeRO has partitioned).

Addressing is the JAX package's: a leaf is named by its **path** in the
parameter tree, ``"layer_0/attn/q_proj/kernel"`` (dots or slashes), integer
components indexing sequences; ``engine`` is the ``DeepSpeedTPUEngine``.
Values are torch tensors on the engine's device, always copies (never an
alias of live training state).

"Full" is the whole leaf at every stage and world size. Over several ranks
it is a collective where the state is partitioned (``runtime/zero/
partition.py``): the masters at ZeRO stage 3, the optimizer state and the
gradients at stages 1-3; every rank then calls the getter, as in the
reference. "Local" is this rank's part: the 1-D fragment of the flat
partition that the rank owns where the state is partitioned, else the whole
leaf (the JAX package's one chip's shard; the port has one device per rank,
so ``device_index`` is 0). A setter writes what every rank passes; the full
setters take the same value on every rank.

Under ZeRO-Offload's host-Adam tier (JAX ``tensor_fragment.py:115-143,
263-290``) the fp32 params and the optimizer state are the host optimizer's
masters and moments: the getters copy them to the engine's device, and
``safe_set_*_fp32_param`` writes the host master and its compute-dtype leaf
on the device.

Availability (as the reference): params and optimizer state are always
readable and writable; gradients exist only inside an imperative
``forward``/``backward`` accumulation window (``train_batch`` consumes its
gradients within the step), so ``safe_get_full_grad`` returns None outside
one. Inside a ``no_sync`` window, gradients not yet reduced across the ranks
raise. Gradients are read and written in true magnitude: the accumulator
holds loss-scale-multiplied, gas-summed gradients, and ``_grad_denom``
translates (JAX ``tensor_fragment.py:167-175``).
"""

from typing import Optional

import torch

from .logging import logger

__all__ = [
    "safe_get_full_fp32_param", "safe_set_full_fp32_param",
    "safe_get_full_grad", "safe_set_full_grad",
    "safe_get_full_optimizer_state", "safe_set_full_optimizer_state",
    "safe_get_local_fp32_param", "safe_get_local_grad",
    "safe_get_local_optimizer_state", "safe_set_local_fp32_param",
    "safe_set_local_grad", "safe_set_local_optimizer_state",
]


def _parts(path):
    if isinstance(path, (list, tuple)):
        return list(path)
    return [p for p in str(path).replace("/", ".").split(".") if p]


def _resolve(tree, path):
    node = tree
    for p in _parts(path):
        if hasattr(node, "_fields") and isinstance(p, str) and p in node._fields:
            node = getattr(node, p)
        elif isinstance(node, (list, tuple)):
            node = node[int(p)]
        elif isinstance(node, dict):
            if p not in node:
                raise KeyError(f"path component {p!r} not found; available: "
                               f"{sorted(node)[:12]}")
            node = node[p]
        else:
            node = getattr(node, p)
    return node


def _leaf(engine, path) -> int:
    """The index of the leaf ``path`` names, in tree order."""
    i = _resolve(engine._tree(range(len(engine._masters))), path)
    if not isinstance(i, int):
        raise KeyError(f"{path!r} names a subtree, not a parameter")
    return i


def _device(device_index: int) -> None:
    if device_index != 0:
        raise ValueError(f"device_index={device_index}: each rank of the port drives "
                         "one device (index 0)")


def _shape(engine, i: int):
    part = engine._zero
    return part.shapes[i] if part is not None else tuple(engine._masters[i].shape)


def _value(engine, value, shape, path) -> torch.Tensor:
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"shape mismatch at {path}: {tuple(value.shape)} vs "
                         f"{tuple(shape)}")
    return value.to(engine.device)


# -- params -----------------------------------------------------------------


def safe_get_full_fp32_param(engine, path) -> torch.Tensor:
    """Full fp32 master value of a (possibly ZeRO-sharded) parameter
    (reference ``tensor_fragment.py:214``)."""
    return engine._full_param(_leaf(engine, path)).float().clone()


def safe_set_full_fp32_param(engine, path, value) -> None:
    """Write a full fp32 master value (reference ``safe_set_full_fp32_param``);
    at stage 3 each rank keeps its fragment of it."""
    i = _leaf(engine, path)
    engine._set_full_param(i, _value(engine, value, _shape(engine, i), path))


def safe_get_local_fp32_param(engine, path, device_index: int = 0):
    _device(device_index)
    i = _leaf(engine, path)
    if engine._host_adam is not None:
        return engine._full_param(i).float().clone()
    return engine._masters[i].detach().float().clone()


def safe_set_local_fp32_param(engine, path, value, device_index: int = 0):
    _device(device_index)
    i = _leaf(engine, path)
    if engine._host_adam is not None:
        engine._set_full_param(i, _value(engine, value, _shape(engine, i), path))
        return
    dst = engine._masters[i]
    value = _value(engine, value, dst.shape, path)
    with torch.no_grad():
        dst.copy_(value)


# -- gradients --------------------------------------------------------------


def _grad_denom(engine) -> float:
    """The raw accumulator holds loss-scale-multiplied, gas-summed grads
    (``step`` divides by ``scale * gas`` before the optimizer); get/set
    translate so callers always see TRUE gradient magnitudes — the reference
    API contract."""
    scale = 1.0
    if engine.fp16:
        scale = float(engine.state.loss_scale.scale)
    return scale * engine.gas


def _grad_source(engine):
    """``(buffer, partitioned)``: where the accumulated gradients live — the
    shard accumulator (stages 1-3 over several ranks), the reduced flat
    accumulator (stage 0 over several ranks) or the masters' ``.grad``
    (None) — or None outside an imperative window."""
    if engine._compat_count == 0:
        return None
    if engine._pending_local:
        raise RuntimeError("the gradients of the micro-batches inside no_sync() are not "
                           "reduced across the ranks yet: read them after the next "
                           "micro-batch outside it")
    if engine._zero is not None:
        return engine._shard_grad, True
    return engine._compat_acc, False


def _raw_grad(engine, i: int, source, full: bool) -> torch.Tensor:
    buf, partitioned = source
    part = engine._zero
    if partitioned:
        return part.gather(buf, i) if full else part.fragment(buf, i)
    if buf is None:
        return engine._grads()[i]
    off = sum(p.numel() for p in engine._masters[:i])
    return buf[off:off + engine._masters[i].numel()].view_as(engine._masters[i])


def _no_grads(what: str) -> None:
    logger.warning(f"{what}: no accumulated gradients — train_batch consumes its "
                   "gradients within the step; use the forward()/backward()/step() "
                   "path to inspect them")


def safe_get_full_grad(engine, path) -> Optional[torch.Tensor]:
    """Accumulated gradient of a param in true (unscaled, gas-averaged)
    magnitude, or None outside an imperative accumulation window."""
    source = _grad_source(engine)
    if source is None:
        _no_grads("safe_get_full_grad")
        return None
    return _raw_grad(engine, _leaf(engine, path), source, True).float() / _grad_denom(engine)


def safe_set_full_grad(engine, path, value) -> None:
    """Write a TRUE-magnitude gradient; it is re-scaled into the raw
    accumulator so ``step()`` consumes exactly ``value``."""
    source = _grad_source(engine)
    if source is None:
        raise RuntimeError("safe_set_full_grad: no accumulated gradients to modify; call "
                           "forward()/backward() first (train_batch keeps no gradient "
                           "buffer between steps)")
    i = _leaf(engine, path)
    value = _value(engine, value, _shape(engine, i), path) * _grad_denom(engine)
    if source[1]:
        engine._zero.scatter(source[0], i, value)
    else:
        _raw_grad(engine, i, source, True).copy_(value)


def safe_get_local_grad(engine, path, device_index: int = 0):
    _device(device_index)
    source = _grad_source(engine)
    if source is None:
        _no_grads("safe_get_local_grad")
        return None
    raw = _raw_grad(engine, _leaf(engine, path), source, False)
    return raw.float() / _grad_denom(engine)


def safe_set_local_grad(engine, path, value, device_index: int = 0):
    _device(device_index)
    source = _grad_source(engine)
    if source is None:
        raise RuntimeError("safe_set_local_grad: no accumulated gradients")
    i = _leaf(engine, path)
    dst = _raw_grad(engine, i, source, False)
    dst.copy_(_value(engine, value, dst.shape, path) * _grad_denom(engine))


# -- optimizer state --------------------------------------------------------


def _find_optim_subtree(opt_state, key: str):
    """The moment tree named ``key`` (reference state keys: exp_avg /
    exp_avg_sq; ``ScaleByAdamState`` uses the same names, Lion exp_avg,
    Adagrad sum_sq, SGD trace): params-congruent at stage 0 and, leaf by
    leaf, at stages 1-3 (this rank's fragments), else the one-leaf list of
    this rank's flat shard."""
    found = []

    def walk(node):
        if hasattr(node, "_fields"):
            if key in node._fields:
                found.append(getattr(node, key))
            for f in node._fields:
                walk(getattr(node, f))
        elif isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
        elif isinstance(node, dict):
            for item in node.values():
                walk(item)

    walk(opt_state)
    return found[0] if found else None


def _moment(engine, key: str):
    if engine._host_adam is not None:
        _, m, v = engine._host_adam.leaves()
        if key not in ("exp_avg", "exp_avg_sq"):
            raise ValueError(f"unknown optimizer state key {key!r} (the host Adam keeps "
                             "exp_avg and exp_avg_sq)")
        return m if key == "exp_avg" else v
    sub = _find_optim_subtree(engine.state.opt_state, key)
    if sub is None:
        raise ValueError(f"optimizer state has no {key!r} tree (optimizer: "
                         f"{engine.config.optimizer.type})")
    return sub


def _moment_leaf(engine, sub, i: int, path, full: bool) -> torch.Tensor:
    """The moment of leaf i: at stages 1-3 gathered (``full``) or this
    rank's fragment, else the tensor itself. A frozen leaf has none."""
    if engine._host_adam is not None:
        return sub[i].to(engine.device)
    if engine._frozen[i]:
        raise ValueError(f"{path!r} is frozen (frozen_params): it has no optimizer state")
    if engine._zero is None:
        return _resolve(sub, path)
    if engine._leafwise:
        frag = _resolve(sub, path)
        # the storage tier keeps the state in host memory; gather on the device
        return engine._zero.gather_fragment(frag.to(engine.device), i) if full else frag
    shard = sub[0]
    if full:
        return engine._zero.gather(shard.to(engine.device), i)
    return engine._zero.fragment(shard, i)


def safe_get_full_optimizer_state(engine, path, optim_state_key: str):
    """Full value of one optimizer-state tensor, e.g. ``exp_avg`` /
    ``exp_avg_sq`` (reference ``tensor_fragment.py:245``)."""
    sub = _moment(engine, optim_state_key)
    return _moment_leaf(engine, sub, _leaf(engine, path), path, True).to(engine.device,
                                                                           copy=True)


def safe_get_local_optimizer_state(engine, path, optim_state_key: str,
                                   device_index: int = 0):
    _device(device_index)
    sub = _moment(engine, optim_state_key)
    return _moment_leaf(engine, sub, _leaf(engine, path), path, False).to(engine.device,
                                                                            copy=True)


def safe_set_full_optimizer_state(engine, path, value, optim_state_key: str):
    """Write a full optimizer-state value in place (the fused Adam kernel
    keeps its table on the tensors' pointers)."""
    sub = _moment(engine, optim_state_key)
    i = _leaf(engine, path)
    value = _value(engine, value, _shape(engine, i), path)
    if engine._host_adam is not None:
        sub[i].copy_(value)
    elif engine._zero is not None:
        a, b = engine._zero.span(i)
        _moment_leaf(engine, sub, i, path, False).copy_(value.reshape(-1)[a:b])
    else:
        _moment_leaf(engine, sub, i, path, False).copy_(value)


def safe_set_local_optimizer_state(engine, path, value, optim_state_key: str,
                                   device_index: int = 0):
    _device(device_index)
    sub = _moment(engine, optim_state_key)
    i = _leaf(engine, path)
    dst = sub[i] if engine._host_adam is not None else _moment_leaf(engine, sub, i, path,
                                                                     False)
    dst.copy_(_value(engine, value, dst.shape, path))
