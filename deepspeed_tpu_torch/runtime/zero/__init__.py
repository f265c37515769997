"""``deepspeed.zero`` surface (reference ``deepspeed/runtime/zero/__init__.py``),
ported from ``deepspeed_tpu/runtime/zero/__init__.py``: partitioning rules,
memory estimators, tiling and the NVMe swapper of ZeRO-Offload
(``swapper.AsyncTensorSwapper``); the ZeRO++ pieces raise
``NotImplementedError`` naming their ROADMAP.md item.

The reference's ``zero.Init`` context manager intercepts ``torch.nn``
module construction to shard parameters as they are made. The JAX package,
and this port with it, take an **init closure** instead: pass
``model_parameters=zero.Init(lambda: init_params(cfg, ...))`` (or the bare
lambda) to ``initialize`` and the engine keeps each leaf only as this
rank's ZeRO-3 shard (``runtime/engine.py``). Unlike the JAX package, which
materializes every leaf directly into its shard, the closure here builds
its whole tree first (on the host, if the closure puts it there) and the
engine then copies out this rank's part and drops the tree.
"""

import contextlib

from .memory_estimators import (estimate_zero2_model_states_mem_needs_all_live,
                                estimate_zero3_model_states_mem_needs_all_live,
                                estimate_zero_model_states_mem_needs)
from .sharding import ZeroShardingRules, shard_param_spec
from .swapper import AsyncTensorSwapper
from .tiling import TiledLinear, tiled_matmul

__all__ = ["Init", "ZeroShardingRules", "shard_param_spec",
           "estimate_zero_model_states_mem_needs",
           "estimate_zero2_model_states_mem_needs_all_live",
           "estimate_zero3_model_states_mem_needs_all_live",
           "AsyncTensorSwapper", "TiledLinear", "tiled_matmul",
           "ZeroPPState", "hierarchical_all_gather", "hpz_remat_policy",
           "zeropp_train_step_factory"]


def _not_ported(what: str, item: int, area: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue A item "
                               f"{item} ({area})")


class ZeroPPState:
    """The ZeRO++ train state (JAX ``runtime/zero/zeropp.py``): not ported."""

    def __init__(self, step, shards, opt_state):
        raise _not_ported("zero.ZeroPPState", 8, "runtime/zero/zeropp.py (ZeRO++)")


def hierarchical_all_gather(x, inner_axis: str, outer_axis: str, tiled: bool = True):
    raise _not_ported("zero.hierarchical_all_gather", 8, "runtime/zero/zeropp.py (ZeRO++)")


def hpz_remat_policy():
    raise _not_ported("zero.hpz_remat_policy", 8, "runtime/zero/zeropp.py (ZeRO++)")


def zeropp_train_step_factory(loss_fn, tx, mesh, dp_axis: str = "dp",
                              quantized_weights=None, quantized_gradients=None,
                              compute_dtype=None, quant_block: int = 2048, remat=None,
                              overlap_collective_matmul=None, stochastic_rounding=None):
    raise _not_ported("zero.zeropp_train_step_factory", 8,
                      "runtime/zero/zeropp.py (ZeRO++)")


class Init(contextlib.AbstractContextManager):
    """Adapter for the reference ``with deepspeed.zero.Init(): model = M()``
    idiom. Construction cannot be intercepted here either, so this wraps the
    init CLOSURE instead::

        params = zero.Init(lambda: init_params(cfg, seed=0, device="cpu"))
        engine, *_ = deepspeed_tpu_torch.initialize(model=loss_fn,
                                                    model_parameters=params, ...)

    ``initialize`` recognizes the wrapper (it is itself the zero-arg
    closure) and, at ZeRO stage 3 over several ranks, keeps only this
    rank's shard of every leaf. Entering it as a context manager raises with
    this guidance, because silently building the model unsharded would
    defeat the point."""

    def __init__(self, init_closure=None, config_dict_or_path=None, **_ignored):
        if init_closure is not None and not callable(init_closure):
            raise TypeError("zero.Init takes a zero-arg init closure, e.g. "
                            "zero.Init(lambda: init_params(cfg, device='cpu'))")
        self._closure = init_closure

    def __call__(self):
        if self._closure is None:
            raise ValueError("zero.Init was built without an init closure")
        return self._closure()

    def __enter__(self):
        raise RuntimeError(
            "there is no construction hook to intercept: instead of "
            "`with zero.Init(): model = M()`, pass the init closure — "
            "model_parameters=zero.Init(lambda: init_params(cfg, device='cpu')) "
            "or the bare lambda — to deepspeed_tpu_torch.initialize; at ZeRO "
            "stage 3 each rank then keeps only its shard of every leaf")

    def __exit__(self, *exc):
        return False
