"""Fleet tier of the port: per-tenant SLA classes (:mod:`tenancy`).

Port of ``deepspeed_tpu/fleet/``. The replica lifecycle
(``lifecycle.py``), the scale actuator (``manager.py``) and the
subprocess replica (``subproc.py``) are not ported yet: looking one of
their names up here raises ``NotImplementedError`` naming ROADMAP.md Queue
A item 6.
"""

from .tenancy import DEFAULT_CLASSES, SLAClass, TenancyMap

_NOT_PORTED = {
    **dict.fromkeys(("SPAWNING", "WARMING", "JOINED", "DRAINING", "DEAD",
                     "STATES", "ReplicaHandle", "ReplicaSpawnError",
                     "WarmReport", "serving_space_signature"),
                    "fleet/lifecycle.py"),
    **dict.fromkeys(("FleetManager", "FleetAtCapacity"), "fleet/manager.py"),
    "SubprocessReplica": "fleet/subproc.py",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md Queue A item 6 "
            f"({_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["SLAClass", "TenancyMap", "DEFAULT_CLASSES"]
