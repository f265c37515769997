"""AutoTP v2: an HF-shaped checkpoint -> a tensor-parallel engine.

Port of ``deepspeed_tpu/sharding/autotp.py``::

    engine, *_ = autotp_initialize(state_dict, hf_config, config=ds_config)

1. ``inference/hf.py::params_from_hf`` normalizes the checkpoint into the
   canonical tree and a ``TransformerConfig``.
2. A :class:`~.rules.RuleSet` decides every leaf's spec (:func:`resolve_rules`:
   a rule set, a pack name, ``"derive"`` or the structural family pack).
3. ``initialize`` takes the whole host tree with the matched spec tree as
   ``param_specs``; the engine slices each leaf to this rank's shard on the
   host (``module_inject/auto_tp.shard_checkpoint_leaf``), so the whole
   model never reaches the device. :func:`shard_checkpoint_tree` is the
   same slicing as a converter: any rank's shard of a full tree (e.g. the
   JAX package's parameters as numpy).

The JAX package also registers the collectives the sharded tree implies
with the comm planner (``register_param_collectives``); the planner's
training sites are ROADMAP.md Queue A item 9, so the port's function
returns no decisions while the planner is off and raises naming the item
while it is on.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .packs import get_pack, pack_for_config
from .rules import RuleSet, ShardingRuleError, spec_tree_axis_sizes


def resolve_rules(rules, cfg=None, params=None) -> RuleSet:
    """Normalize the ``rules=`` argument: a RuleSet passes through, a pack
    name looks up the built-in, ``"derive"`` runs the AutoTP bridge over
    ``params``, and ``None`` picks the family pack structurally from
    ``cfg`` (``generic`` when there is no config to inspect)."""
    if isinstance(rules, RuleSet):
        return rules
    if isinstance(rules, str):
        if rules == "derive":
            if params is None:
                raise ShardingRuleError(
                    "rules='derive' needs the param tree to run AutoTP "
                    "inference over")
            from .derive import derive_rules

            return derive_rules(params)
        return get_pack(rules)
    if rules is None:
        return pack_for_config(cfg) if cfg is not None else get_pack("generic")
    raise TypeError(
        f"rules must be a RuleSet, a pack name, 'derive', or None; "
        f"got {type(rules).__name__}")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _cast_tree(params, dtype):
    """``params`` as host tensors of the numpy ``dtype``."""
    from ..module_inject.auto_tp import flatten_with_paths, unflatten

    _, leaves, treedef = flatten_with_paths(params)
    return unflatten(treedef, [torch.from_numpy(np.ascontiguousarray(_host(v).astype(dtype)))
                               for v in leaves])


def shard_checkpoint_tree(params, specs, *, mesh=None, axis: str = "tp",
                          axis_index: Optional[int] = None,
                          axis_size: Optional[int] = None,
                          dtype=None):
    """Load-time sharding: each leaf sliced to one rank's shard along
    ``axis`` on the host (``module_inject/auto_tp.shard_checkpoint_leaf``).

    * ``axis_index=i``: the host numpy tree of rank ``i``'s slices, ``axis_size``
      ranks (or the size of ``axis`` in ``mesh``, a port ``Topology``).
    * ``axis_index=None``: this process's shard under ``mesh`` (default:
      the live topology), as float tensors on the host — the per-process
      form of the JAX package's global placement.

    ``params`` holds numpy arrays or tensors (e.g. the JAX package's full
    tree from ``jax.device_get``); ``specs`` is a spec tree of the same
    structure (``RuleSet.match``)."""
    from ..module_inject.auto_tp import (flatten_with_paths, shard_checkpoint_leaf,
                                         spec_leaves, unflatten)

    flat_specs = spec_leaves(specs)
    _, leaves, treedef = flatten_with_paths(params)
    if len(flat_specs) != len(leaves):
        raise ShardingRuleError(
            f"spec tree has {len(flat_specs)} leaves, params has "
            f"{len(leaves)} — match() the same tree you load")
    as_tensors = axis_index is None
    if axis_index is None:
        from .. import comm
        from ..parallel.topology import get_topology

        topo = mesh if mesh is not None else get_topology()
        axis_index = comm.axis_index(axis) if topo.axis_size(axis) > 1 else 0
        size = topo.axis_size(axis)
    else:
        size = int(axis_size if axis_size is not None
                   else mesh.axis_size(axis) if mesh is not None else 1)
    out = []
    for leaf, spec in zip(leaves, flat_specs):
        val = _host(leaf)
        if dtype is not None:
            val = val.astype(dtype)
        val = shard_checkpoint_leaf(val, tuple(spec), axis, int(axis_index), size)
        out.append(torch.from_numpy(np.ascontiguousarray(val)) if as_tensors else val)
    return unflatten(treedef, out)


def register_param_collectives(params, specs, topo, consumer: str = "autotp",
                               zero_stage: int = 0) -> Dict[str, Any]:
    """The JAX package pre-resolves the collective sites a sharded tree
    implies with the comm planner. No planner in this process: no
    decisions (``{}``). The planner's training sites are not ported: with a
    planner on this raises naming ROADMAP.md Queue A item 9."""
    from ..comm.planner import planner_active

    if not planner_active():
        return {}
    raise NotImplementedError(
        "register_param_collectives with an active planner: the planner's training "
        "sites are not ported yet: ROADMAP.md Queue A item 9 (comm/planner training "
        "sites)")


def autotp_initialize(model_or_state_dict, hf_config=None, *,
                      apply_fn=None, rules=None, config=None, topology=None,
                      optimizer=None, lr_scheduler=None, training_data=None,
                      dtype=None, strict: bool = False,
                      **kwargs) -> Tuple[Any, ...]:
    """Checkpoint in, tensor-parallel engine out.

    * ``autotp_initialize(state_dict_or_model, hf_config, ...)``: the
      checkpoint goes through ``params_from_hf`` and the engine trains the
      normalized ``TransformerLM``.
    * ``autotp_initialize(params, apply_fn=fn, ...)``: a normalized tree
      and the caller's loss ``fn(params, batch[, rng])``, which must read
      its shards' layout itself.

    The full tree stays on the host (cast to ``dtype`` where given) and
    the engine slices it to this rank's shard by the matched specs before
    anything reaches the device. Keywords the JAX function passes to
    ``initialize`` pass through (``device``, ``frozen_params``)."""
    from .. import comm
    from ..inference.hf import params_from_hf
    from ..models.transformer import TransformerLM, make_loss_fn
    from ..parallel.topology import Topology, TopologySpec, set_topology
    from ..runtime.config import load_config
    from ..runtime.engine import initialize

    device = kwargs.pop("device", "cuda")
    if apply_fn is not None:
        cfg_model, params = None, model_or_state_dict
    else:
        cfg_model, params = params_from_hf(model_or_state_dict, hf_config, device="cpu")
    ds_cfg = load_config(config)
    comm.init_distributed()
    if topology is None:
        topology = Topology(TopologySpec(
            tp=ds_cfg.tensor_parallel.tp_size if ds_cfg.tensor_parallel.enabled else 1))
    set_topology(topology)
    ruleset = resolve_rules(rules, cfg=cfg_model, params=params)
    axis_sizes = spec_tree_axis_sizes(topology)
    ruleset.validate(axis_sizes)
    specs = ruleset.match(params, axis_sizes=axis_sizes, strict=strict)
    if dtype is not None:
        params = _cast_tree(params, dtype)
    register_param_collectives(params, specs, topology,
                               zero_stage=ds_cfg.zero_optimization.stage)
    loss_fn = (apply_fn if apply_fn is not None
               else make_loss_fn(TransformerLM(cfg_model, params, device="cpu")))
    return initialize(model=loss_fn, model_parameters=params, optimizer=optimizer,
                      lr_scheduler=lr_scheduler, training_data=training_data,
                      config=config, topology=topology, param_specs=specs,
                      device=device, **kwargs)
