"""CUDA accelerator (the port's runtime; reference ``cuda_accelerator.py``,
JAX package ``accelerator/tpu_accelerator.py``)."""

from typing import Dict

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):
    _name = "cuda"

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def device_name(self, device_index: int = 0) -> str:
        return torch.cuda.get_device_name(device_index)

    def communication_backend_name(self) -> str:
        return "nccl"

    def synchronize(self, device_index: int = 0) -> None:
        torch.cuda.synchronize(device_index)

    def memory_stats(self, device_index: int = 0) -> Dict[str, int]:
        return dict(torch.cuda.memory_stats(device_index))

    def max_memory_allocated(self, device_index: int = 0) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index: int = 0) -> None:
        torch.cuda.reset_peak_memory_stats(device_index)
