"""Fleet tier of the port: elastic multi-replica serving.

Port of ``deepspeed_tpu/fleet/``. The serving package gives one process N
routed replicas; this package makes that a *fleet*: real replica
lifecycle with a warm-join contract (:mod:`lifecycle` — SPAWNING →
WARMING → JOINED → DRAINING → DEAD, cached comm plans and autotune winners
applied so a joining replica runs zero probes), the control supervisor's
scale actuator with flap-guarded scale-in and reap-on-failure
(:mod:`manager`), per-tenant SLA classes weighting admission and shed
order (:mod:`tenancy`), and a subprocess-backed replica speaking the same
protocol (:mod:`subproc`).
"""

from .lifecycle import (DEAD, DRAINING, JOINED, SPAWNING, STATES, WARMING,
                        ReplicaHandle, ReplicaSpawnError, WarmReport,
                        serving_space_signature)
from .manager import FleetAtCapacity, FleetManager
from .subproc import SubprocessReplica
from .tenancy import DEFAULT_CLASSES, SLAClass, TenancyMap

__all__ = [
    "SPAWNING", "WARMING", "JOINED", "DRAINING", "DEAD", "STATES",
    "ReplicaHandle", "ReplicaSpawnError", "WarmReport",
    "serving_space_signature",
    "FleetManager", "FleetAtCapacity",
    "SubprocessReplica",
    "SLAClass", "TenancyMap", "DEFAULT_CLASSES",
]
