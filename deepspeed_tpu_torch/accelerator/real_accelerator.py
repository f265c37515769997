"""Runtime accelerator selection and device resolution.

Port of ``deepspeed_tpu/accelerator/real_accelerator.py``. The port has one
accelerator, CUDA; :func:`resolve_device` is the one check every entry point
makes on its ``device`` argument, so a default ``"cuda"`` on a machine
without a card raises instead of carrying on on the CPU.
"""

from typing import Optional

import torch

from .abstract_accelerator import DeepSpeedAccelerator
from .cuda_accelerator import CUDA_Accelerator

_accelerator: Optional[DeepSpeedAccelerator] = None


def get_accelerator() -> DeepSpeedAccelerator:
    """The process-wide accelerator (reference ``get_accelerator()``)."""
    global _accelerator
    if _accelerator is None:
        _accelerator = CUDA_Accelerator()
    return _accelerator


def set_accelerator(accel: DeepSpeedAccelerator) -> None:
    """Install ``accel`` process-wide."""
    global _accelerator
    _accelerator = accel


def set_accelerator_by_name(name: str) -> DeepSpeedAccelerator:
    """Build the named accelerator (the port has one: ``"cuda"``) and
    install it process-wide."""
    if name.lower() != "cuda":
        raise ValueError(f"unknown accelerator {name!r}: the port has 'cuda' only (the CPU "
                         "runs the plain versions when an entry point gets device='cpu')")
    set_accelerator(CUDA_Accelerator())
    return get_accelerator()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present. Only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not get_accelerator().is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
