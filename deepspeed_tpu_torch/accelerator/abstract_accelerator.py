"""Hardware abstraction layer.

Port of ``deepspeed_tpu/accelerator/abstract_accelerator.py`` (reference
``accelerator/abstract_accelerator.py:10`` ``DeepSpeedAccelerator``): the
interface vocabulary the engines and scripts use for device handles,
synchronization and memory statistics, here over ``torch.device``.
"""

import abc
from typing import Dict


class DeepSpeedAccelerator(abc.ABC):
    """Interface every accelerator implements."""

    _name: str = "abstract"

    # --- device APIs ---------------------------------------------------
    @abc.abstractmethod
    def is_available(self) -> bool:
        ...

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    @abc.abstractmethod
    def device_name(self, device_index: int = 0) -> str:
        """The hardware's own name for the device (``"NVIDIA H100 80GB
        HBM3"``), not the framework's device string."""

    # --- communication -------------------------------------------------
    @abc.abstractmethod
    def communication_backend_name(self) -> str:
        """The ``torch.distributed`` backend of this device's collectives."""

    # --- synchronization -----------------------------------------------
    @abc.abstractmethod
    def synchronize(self, device_index: int = 0) -> None:
        """Block until all work queued on the device has completed."""

    # --- memory --------------------------------------------------------
    @abc.abstractmethod
    def memory_stats(self, device_index: int = 0) -> Dict[str, int]:
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index: int = 0) -> int:
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index: int = 0) -> None:
        ...
