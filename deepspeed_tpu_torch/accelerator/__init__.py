from .abstract_accelerator import DeepSpeedAccelerator
from .cuda_accelerator import CUDA_Accelerator
from .real_accelerator import (get_accelerator, resolve_device, set_accelerator,
                               set_accelerator_by_name)

__all__ = ["DeepSpeedAccelerator", "CUDA_Accelerator", "get_accelerator",
           "resolve_device", "set_accelerator", "set_accelerator_by_name"]
