"""Checkpointing of the port: save/load of the training state
(``engine.py``) and its inspector (``deepspeed_checkpoint.py``). The JAX
package's ``state_dict_factory`` (Megatron split and merge over tp) comes
with the parallelism side paths, ROADMAP.md Queue A item 8."""

from .deepspeed_checkpoint import DeepSpeedCheckpoint
from .engine import (CheckpointEngine, TorchCheckpointEngine,
                     get_fp32_state_dict_from_zero_checkpoint, load_checkpoint,
                     save_checkpoint, zero_to_fp32)

__all__ = ["CheckpointEngine", "TorchCheckpointEngine", "DeepSpeedCheckpoint", "save_checkpoint", "load_checkpoint", "zero_to_fp32",
           "get_fp32_state_dict_from_zero_checkpoint"]
