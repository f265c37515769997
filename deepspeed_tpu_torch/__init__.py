"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its layout and public names module by module. Three paths are ported:

* serving — ``serving.LLMServer`` -> ``inference.v2.InferenceEngineV2`` ->
  the ragged model forward, with the two paged-attention kernels
  hand-written for Hopper (``ops/csrc/paged_attention_sm90.cu`` in bf16,
  ``ops/csrc/paged_attention.cu`` in fp32);
* training on one card — ``initialize(model=make_loss_fn(model),
  model_parameters=params, config=...)`` -> ``engine.train_batch(batch)``,
  with the flash-attention forward and backward kernels
  (``ops/csrc/flash_attention_sm90.cu`` in bf16, ``ops/csrc/flash_attention.cu``
  in fp32) and the fused Adam kernel
  (``ops/csrc/fused_adam.cu``); the LM loss takes the fused loss kernels
  (``ops/csrc/fused_loss.cu``) on the card, layers may be recomputed in the
  backward (``checkpointing``, ``remat``), and the engine saves and resumes
  its whole state (``checkpoint``);
* data-parallel training over ``torch.distributed`` — the same entry points
  at world size > 1 (``comm.init_distributed``): at ZeRO stage 0 the
  gradients mean-reduced exactly or by the int8 all-reduce of
  ``comm.compressed`` with the block-quant kernels (``ops/csrc/quant.cu``);
  at stages 1-3 the optimizer state, then the gradients, then the
  parameters partitioned over the ranks (``zero``), read and written leaf
  by leaf through ``utils.tensor_fragment``;
* ZeRO-Offload — the optimizer's masters and moments on the host
  (``ops/csrc/host/cpu_adam.cpp``) or its state in pinned host memory;
* the engine's remainder — every optimizer type of the JAX registry but
  the 1-bit ones (``ops.optimizers``: LAMB, Lion, Adagrad, SGD, muP, plain
  PyTorch beside the fused Adam kernel) at ZeRO stages 0-3, model dropout
  seeded per micro-batch by the engine, ``frozen_params``, an optimizer
  factory, and ``runtime.dataloader.PrefetchLoader``.

* tensor parallelism — ``tensor_parallel.tp_size`` > 1: each leaf sliced
  to its rank by a rule pack (``sharding``), the model laid out Megatron-
  style (``parallel.tensor_parallel``), the vocab-parallel fused loss, the
  ring collective matmuls (``ops.collective_matmul``) over ``comm.ppermute``,
  ZeRO 0-1 over the dp group, the TP decode projections.

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
plain PyTorch versions of the kernels run only when the caller passes
``device="cpu"``.
"""

from . import comm, sharding
from .comm import init_distributed
from .runtime import activation_checkpointing as checkpointing
from .runtime import zero
from .runtime.config import DeepSpeedTPUConfig, load_config
from .runtime.engine import DeepSpeedTPUEngine, TrainState, initialize
from .version import __version__

# reference name for the engine class (deepspeed/__init__.py:24)
DeepSpeedEngine = DeepSpeedTPUEngine

# AutoTP: an HF-shaped checkpoint -> a tensor-parallel engine (sharding/autotp.py)
autotp_initialize = sharding.autotp_initialize


def add_config_arguments(parser):
    """Attach the DeepSpeed command-line group (reference
    ``deepspeed/__init__.py:268``): the ``--deepspeed`` flag and
    ``--deepspeed_config <json>``, so reference training scripts parse
    unchanged."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    return parser


__all__ = ["DeepSpeedEngine", "DeepSpeedTPUConfig", "DeepSpeedTPUEngine",
           "TrainState", "add_config_arguments", "autotp_initialize", "checkpointing",
           "comm", "sharding",
           "init_distributed", "initialize", "load_config", "version", "zero"]
