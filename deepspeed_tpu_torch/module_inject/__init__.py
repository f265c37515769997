"""Tensor-parallel specs by name (the part of the JAX package's
``module_inject`` that the state-dict factory uses)."""

from .auto_tp import (AutoTPResult, flatten_with_paths, infer_tp_roles,
                      shard_checkpoint_leaf, sharded_dim, tp_parser, unflatten)

__all__ = ["tp_parser", "infer_tp_roles", "shard_checkpoint_leaf", "AutoTPResult",
           "flatten_with_paths", "unflatten", "sharded_dim"]
