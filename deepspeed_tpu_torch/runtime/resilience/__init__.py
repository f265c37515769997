"""Resilience subsystem of the port: fault schedules and replica health.

Port of ``deepspeed_tpu/runtime/resilience/``, the parts the serving fleet
runs:

- :mod:`faults` — deterministic training-fault plans (``FaultPlan``), the
  nested half of a chaos schedule;
- :mod:`chaos` — seeded, one-shot-audited fault schedules across
  transport (object-store errors, torn beacons), serving (replica kill,
  KV exhaustion, slow prefill, dropped token delivery) and control (stale
  health rows, flapping straggler verdicts), consulted by injection sites
  through a process-global that is None — and cost-free — by default;
- :mod:`heartbeat` — per-host beacons in a shared dir or bucket; readers
  derive dead-host and straggler verdicts. The beacon files are the JAX
  package's, byte for byte.

The training engine's tier (snapshots, sentinel, preemption watcher,
supervisor, watchdog, integrity) is not ported yet: looking one of its
names up here raises ``NotImplementedError`` naming ROADMAP.md Queue A
item 9.
"""

from .chaos import (FAULT_CLASSES, ChaosEvent, ChaosInjectedError,
                    ChaosSchedule, chaos_active, configure_chaos, get_chaos)
from .faults import FaultPlan, InjectedCrash
from .heartbeat import (FileHeartbeatTransport, HealthTable, HeartbeatWriter,
                        HostHealth, ObjectStoreHeartbeatTransport)

_NOT_PORTED = {
    "SnapshotManager": "snapshot.py", "Sentinel": "sentinel.py",
    "SentinelEvent": "sentinel.py", "SentinelHalt": "sentinel.py",
    "PreemptionWatcher": "preempt.py", "ResilienceManager": "supervisor.py",
    "resolve_restore": "supervisor.py", "PREEMPT_EXIT_CODE": "supervisor.py",
    "StepWatchdog": "watchdog.py", "WATCHDOG_EXIT_CODE": "watchdog.py",
    "IntegrityMonitor": "integrity.py", "FingerprintStore": "integrity.py",
    "make_fingerprint_fn": "integrity.py", "fingerprint_hex": "integrity.py",
    "flip_bit": "integrity.py",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md Queue A item 9 "
            f"(runtime/resilience/{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FaultPlan", "InjectedCrash", "HeartbeatWriter", "HealthTable",
           "HostHealth", "FileHeartbeatTransport",
           "ObjectStoreHeartbeatTransport", "ChaosSchedule", "ChaosEvent",
           "ChaosInjectedError", "FAULT_CLASSES", "configure_chaos",
           "get_chaos", "chaos_active"]
