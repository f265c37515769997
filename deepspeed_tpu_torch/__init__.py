"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its layout and public names module by module. Two paths are ported:

* serving — ``serving.LLMServer`` -> ``inference.v2.InferenceEngineV2`` ->
  the ragged model forward, with the two paged-attention kernels
  hand-written for Hopper (``ops/csrc/paged_attention.cu``);
* training on one card — ``initialize(model=make_loss_fn(model),
  model_parameters=params, config=...)`` -> ``engine.train_batch(batch)``,
  with the flash-attention forward and backward kernels
  (``ops/csrc/flash_attention.cu``) and the fused Adam kernel
  (``ops/csrc/fused_adam.cu``).

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
plain PyTorch versions of the kernels run only when the caller passes
``device="cpu"``.
"""

from .runtime.config import DeepSpeedTPUConfig, load_config
from .runtime.engine import DeepSpeedTPUEngine, TrainState, initialize

# reference name for the engine class (deepspeed/__init__.py:24)
DeepSpeedEngine = DeepSpeedTPUEngine

__version__ = "0.1.0"

__all__ = ["DeepSpeedEngine", "DeepSpeedTPUConfig", "DeepSpeedTPUEngine",
           "TrainState", "initialize", "load_config"]
