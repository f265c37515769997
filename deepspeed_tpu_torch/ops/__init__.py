"""Kernels of the port: each TPU (Pallas) kernel of ``deepspeed_tpu/ops``
as a kernel hand-written for Hopper, beside its plain PyTorch version.

``paged_attention`` — the two paged-attention kernels of the serving path
(CUDA C++ in ``csrc/paged_attention.cu``, built by ``_build``).
"""
