"""Kernels of the port: each TPU (Pallas) kernel of ``deepspeed_tpu/ops``
as a kernel hand-written for Hopper, beside its plain PyTorch version.

``paged_attention`` — the two paged-attention kernels of the serving path
(``csrc/paged_attention.cu``); ``flash_attention`` — the flash forward and
its two backward kernels of the training path (``csrc/flash_attention.cu``);
``fused_adam`` — the multi-tensor Adam update (``csrc/fused_adam.cu``);
``fused_loss`` — the LM head fused into the cross entropy, forward and
backward (``csrc/fused_loss.cu``); ``quant`` — block int8 quantize
(nearest and stochastic rounding) and dequantize of the compressed
gradient all-reduce (``csrc/quant.cu``). All are CUDA C++ built by
``_build``.
"""

from .fused_loss import fused_loss_ready, fused_vocab_nll
from .quant import (BLOCK, dequantize_int8, dequantize_rows, pack_signs,
                    quantize_int8, quantize_rows, quantized_all_gather,
                    quantized_reduce_scatter, shard_layout, unpack_signs)

__all__ = ["fused_vocab_nll", "fused_loss_ready", "BLOCK", "dequantize_int8",
           "dequantize_rows", "pack_signs", "quantize_int8", "quantize_rows",
           "quantized_all_gather", "quantized_reduce_scatter", "shard_layout",
           "unpack_signs"]
