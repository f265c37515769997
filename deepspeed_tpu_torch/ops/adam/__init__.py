"""The host Adam of ZeRO-Offload (the JAX package's ``ops/adam``)."""

from .cpu_adam import (CPUAdamBuilder, DeepSpeedCPUAdam, cpu_adam_reference, launch_counts,
                       reset_launch_counts)

__all__ = ["CPUAdamBuilder", "DeepSpeedCPUAdam", "cpu_adam_reference", "launch_counts",
           "reset_launch_counts"]
