"""Checkpointing of the port: save/load of the training state
(``engine.py``, with ``zero_to_fp32``), its inspector
(``deepspeed_checkpoint.py``), the tp merge and split of raw checkpoint
shards (``state_dict_factory.py``: ``SDLoaderFactory``, the Megatron layout
table, both fused-QKV layouts) and the conversion of raw shards to a
universal checkpoint (``ds_to_universal.py``, run as ``python -m
deepspeed_tpu_torch.checkpoint.ds_to_universal``; its ``load_universal``
reads one back)."""

from .deepspeed_checkpoint import DeepSpeedCheckpoint
from .engine import (CheckpointEngine, TorchCheckpointEngine,
                     get_fp32_state_dict_from_zero_checkpoint, load_checkpoint,
                     save_checkpoint, zero_to_fp32)
from .state_dict_factory import (SDLoader, SDLoaderFactory, megatron_specs, merge_qkv,
                                 merge_state_dicts, save_shard_npz, split_qkv,
                                 split_state_dict)

__all__ = ["CheckpointEngine", "TorchCheckpointEngine", "DeepSpeedCheckpoint", "save_checkpoint", "load_checkpoint", "zero_to_fp32",
           "get_fp32_state_dict_from_zero_checkpoint", "SDLoaderFactory", "SDLoader",
           "merge_state_dicts", "split_state_dict", "merge_qkv", "split_qkv",
           "megatron_specs", "save_shard_npz"]
