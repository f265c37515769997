"""The host Adam of ZeRO-Offload (the JAX package's ``ops/adam``)."""

from .cpu_adam import (ROUTES, CPUAdamBuilder, DeepSpeedCPUAdam, best_route, bf16_reference,
                       call_counts, cpu_adam_reference, launch_counts, reset_launch_counts,
                       route_counts, supported_routes)

__all__ = ["CPUAdamBuilder", "DeepSpeedCPUAdam", "ROUTES", "best_route", "bf16_reference",
           "call_counts", "cpu_adam_reference", "launch_counts", "reset_launch_counts",
           "route_counts", "supported_routes"]
