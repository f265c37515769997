"""ZeRO memory-need estimators: the port of
``deepspeed_tpu/runtime/zero/memory_estimators.py``.

Reference API parity: ``estimate_zero2_model_states_mem_needs_all_live``
(``runtime/zero/stage_1_and_2.py``) and the zero3 variant
(``stage3.py``), the sizing helpers users call before picking a stage.
Model state per rank, bf16 compute + fp32 master + Adam m and v:

* stage 0: 2P (weights) + 4P master + 8P optimizer + 4P gradients
* stage 1: optimizer and master sharded over dp
* stage 2: + fp32 gradients sharded
* stage 3: + weights sharded
"""

import math
from typing import Dict

import torch
from torch.utils import _pytree as pytree


def _param_count(params_or_count) -> int:
    if isinstance(params_or_count, int):
        return params_or_count
    if isinstance(params_or_count, torch.nn.Module):
        return sum(p.numel() for p in params_or_count.parameters())
    return sum(math.prod(leaf.shape) for leaf in pytree.tree_leaves(params_or_count)
               if hasattr(leaf, "shape"))


def estimate_zero_model_states_mem_needs(params_or_count, zero_stage: int,
                                         dp_size: int,
                                         compute_bytes: int = 2) -> Dict[str, float]:
    """Model-state bytes per rank for a stage and dp size (activations
    excluded). ``params_or_count`` is a parameter count, a tree of tensors
    or an ``nn.Module``."""
    p = _param_count(params_or_count)
    d = max(1, dp_size)
    weights = compute_bytes * p
    master = 4 * p
    optim = 8 * p   # adam m+v fp32
    grads = 4 * p
    if zero_stage >= 1:
        master, optim = master / d, optim / d
    if zero_stage >= 2:
        grads = grads / d
    if zero_stage >= 3:
        weights = weights / d
    total = weights + master + optim + grads
    return {"params": p, "weights_bytes": weights, "master_bytes": master,
            "optimizer_bytes": optim, "grad_bytes": grads,
            "total_bytes": total, "total_gb": total / 1024**3}


def estimate_zero2_model_states_mem_needs_all_live(model_params, num_gpus_per_node=1,
                                                   num_nodes=1):
    """Reference-named helper (``stage_1_and_2.py``)."""
    return estimate_zero_model_states_mem_needs(
        model_params, 2, num_gpus_per_node * num_nodes)


def estimate_zero3_model_states_mem_needs_all_live(model_params, num_gpus_per_node=1,
                                                   num_nodes=1):
    """Reference-named helper (``stage3.py``)."""
    return estimate_zero_model_states_mem_needs(
        model_params, 3, num_gpus_per_node * num_nodes)
