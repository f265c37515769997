"""Control ledger: every automated decision, recorded where post-mortems look.

Port of ``deepspeed_tpu/control/ledger.py``, host logic unchanged.

The control plane's contract with the operator is *explainability*: a knob
that moves by itself MUST leave a record of what moved it, or the fleet
becomes undebuggable. Each supervisor action (and each autotuner
application) appends one :class:`ControlAction` here, and the entry fans
out to every observability surface the repo already has:

- the bounded in-memory ring rides every telemetry **flight dump**
  (``TelemetryManager.flight_dump`` attaches ``snapshot()`` under the
  ``control`` key), so the post-mortem doctor prints
  "supervisor action" lines beside its verdicts;
- ``dstpu_control_actions_total{action=...}`` in the Prometheus
  **registry** (when the telemetry spine is live);
- ``Control/<action>`` **monitor events** through the existing
  ``Monitor.write_events`` fan-out (TensorBoard / W&B / CSV / JSONL).

Stdlib-only; the registry/monitor hooks are injected callables so the
ledger works (and is unit-testable) without either subsystem.
"""

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class ControlAction:
    """One automated decision. ``outcome`` records what actually happened
    (``ok`` / ``skipped:<why>`` / ``failed:<why>``) — a rule that fired but
    found nothing to actuate is still a ledger entry, because the operator
    debugging a flapping signal needs to see the no-ops too."""
    seq: int
    step: int
    wall_time: float
    action: str            # e.g. straggler_replan, raise_remat, serving_shed
    rule: str              # guard rule that fired (usually == action)
    signal: str            # the observed signal, human-readable
    reason: str            # why the rule decided to act
    params: Dict[str, Any] = field(default_factory=dict)
    outcome: str = "ok"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


class ControlLedger:
    def __init__(self, *, max_entries: int = 256,
                 clock: Callable[[], float] = time.time):
        self._ring: "deque[ControlAction]" = deque(
            maxlen=max(1, int(max_entries)))
        self._lock = threading.Lock()
        self.clock = clock
        self._seq = 0
        self.total = 0
        # injected sinks: set by ControlSupervisor wiring
        self._counter = None          # telemetry Counter (inc(action=...))
        self._emit: Optional[Callable[[List], None]] = None  # monitor events

    # -- wiring ---------------------------------------------------------
    def bind_counter(self, counter) -> None:
        """A ``dstpu_control_actions_total`` Counter (telemetry registry)."""
        self._counter = counter

    def bind_monitor(self, emit: Callable[[List], None]) -> None:
        """``Monitor.write_events``-compatible callable for Control/* events."""
        self._emit = emit

    # -- recording ------------------------------------------------------
    def record(self, action: str, *, step: int, rule: Optional[str] = None,
               signal: str = "", reason: str = "",
               params: Optional[Dict[str, Any]] = None,
               outcome: str = "ok") -> ControlAction:
        with self._lock:
            self._seq += 1
            entry = ControlAction(seq=self._seq, step=int(step),
                                  wall_time=float(self.clock()),
                                  action=str(action), rule=rule or str(action),
                                  signal=signal, reason=reason,
                                  params=dict(params or {}), outcome=outcome)
            self._ring.append(entry)
            self.total += 1
        if self._counter is not None:
            try:
                self._counter.inc(action=entry.action)
            except Exception:
                pass  # swallow-ok: metrics must never abort the action they describe
        if self._emit is not None:
            try:
                self._emit([(f"Control/{entry.action}", 1.0, entry.step)])
            except Exception:
                pass  # swallow-ok: monitor sinks must never abort the action they describe
        return entry

    # -- reading --------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e.to_dict() for e in self._ring]

    def entries(self) -> List[ControlAction]:
        with self._lock:
            return list(self._ring)

    def actions(self, action: Optional[str] = None) -> List[ControlAction]:
        with self._lock:
            return [e for e in self._ring
                    if action is None or e.action == action]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def describe_action(entry: Dict[str, Any]) -> str:
    """One human line per ledger entry — shared by the doctor's
    "supervisor action" report lines and the supervisor's own logging, so
    the post-mortem reads exactly like the live log did."""
    bits = [f"step {entry.get('step')}: {entry.get('action')}"]
    if entry.get("reason"):
        bits.append(f"— {entry['reason']}")
    params = entry.get("params") or {}
    if params:
        kv = ", ".join(f"{k}={v}" for k, v in sorted(params.items()))
        bits.append(f"({kv})")
    outcome = entry.get("outcome")
    if outcome and outcome != "ok":
        bits.append(f"[{outcome}]")
    return " ".join(bits)
