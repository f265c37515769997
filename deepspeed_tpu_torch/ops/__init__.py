"""Kernels of the port: each TPU (Pallas) kernel of ``deepspeed_tpu/ops``
as a kernel hand-written for Hopper, beside its plain PyTorch version.

``paged_attention`` — the two paged-attention kernels of the serving path
(``csrc/paged_attention.cu``); ``flash_attention`` — the flash forward and
its two backward kernels of the training path (``csrc/flash_attention.cu``);
``fused_adam`` — the multi-tensor Adam update (``csrc/fused_adam.cu``). All
are CUDA C++ built by ``_build``.
"""
