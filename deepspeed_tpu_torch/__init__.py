"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its layout and public names module by module. Three paths are ported:

* serving — ``serving.LLMServer`` -> ``inference.v2.InferenceEngineV2`` ->
  the ragged model forward, with the two paged-attention kernels
  hand-written for Hopper (``ops/csrc/paged_attention.cu``);
* training on one card — ``initialize(model=make_loss_fn(model),
  model_parameters=params, config=...)`` -> ``engine.train_batch(batch)``,
  with the flash-attention forward and backward kernels
  (``ops/csrc/flash_attention.cu``) and the fused Adam kernel
  (``ops/csrc/fused_adam.cu``); the LM loss takes the fused loss kernels
  (``ops/csrc/fused_loss.cu``) on the card, layers may be recomputed in the
  backward (``checkpointing``, ``remat``), and the engine saves and resumes
  its whole state (``checkpoint``);
* data-parallel training over ``torch.distributed`` — the same entry points
  at world size > 1 (``comm.init_distributed``), ZeRO stage 0, the
  gradients mean-reduced exactly or by the int8 all-reduce of
  ``comm.compressed`` with the block-quant kernels (``ops/csrc/quant.cu``).

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
plain PyTorch versions of the kernels run only when the caller passes
``device="cpu"``.
"""

from . import comm
from .comm import init_distributed
from .runtime import activation_checkpointing as checkpointing
from .runtime.config import DeepSpeedTPUConfig, load_config
from .runtime.engine import DeepSpeedTPUEngine, TrainState, initialize

# reference name for the engine class (deepspeed/__init__.py:24)
DeepSpeedEngine = DeepSpeedTPUEngine

__version__ = "0.1.0"

__all__ = ["DeepSpeedEngine", "DeepSpeedTPUConfig", "DeepSpeedTPUEngine",
           "TrainState", "checkpointing", "comm", "init_distributed", "initialize",
           "load_config"]
