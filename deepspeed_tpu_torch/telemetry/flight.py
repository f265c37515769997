"""Crash flight recorder: the last N steps' spans + metrics, dumped on death.

Port of ``deepspeed_tpu/telemetry/flight.py``, host logic unchanged.

The resilience watchdog turned a hung collective into a restartable exit-83 failure
with an all-thread stack dump — but a hangdump says where the *interpreter*
was, not what the *step* was doing: "blocked in synchronize" is every
hang ever. The flight recorder closes that gap: a fixed-size ring buffer of
per-step records (drained from the span tracer at each step end, plus the
step's host metrics), written to ``<dir>/flightdump-<rank>.json`` from the
three paths where a post-mortem matters —

- **watchdog expiry** (via :attr:`StepWatchdog.pre_dump`, before the
  hangdump and the ``os._exit(83)``): the dump's ``open_spans`` name the
  phase that never finished;
- **sentinel rollback**: what the run was doing in the steps leading into
  the divergence the sentinel tripped on;
- **preemption drain**: the final record of a run that is about to vanish.

Stdlib-only (the watchdog's monitor thread must be able to dump while the
device runtime is wedged); writes are temp + ``os.replace`` + fsync so a reader never sees
a torn dump even when ``os._exit`` follows immediately.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .spans import SpanTracer


def flightdump_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"flightdump-{rank}.json")


class FlightRecorder:
    """Ring buffer of per-step telemetry, dumpable from any thread."""

    def __init__(self, tracer: SpanTracer, directory: str, *,
                 steps: int = 32, rank: int = 0,
                 clock=time.time, collectives=None):
        self.tracer = tracer
        self.dir = directory
        self.rank = int(rank)
        self.clock = clock
        # optional CollectiveRecorder (telemetry/collective.py): its launch
        # ring rides every dump, and each step entry is stamped with the
        # latest seq so the doctor can attribute seq ranges to steps
        self.collectives = collectives
        self._ring: "deque" = deque(maxlen=max(1, int(steps)))
        self._lock = threading.Lock()
        self.dumps = 0

    # -- recording -------------------------------------------------------
    def record_step(self, step: int, *, step_time_s: Optional[float] = None,
                    metrics: Optional[Dict[str, Any]] = None,
                    mem: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Fold the tracer's closed spans since the last call into one ring
        entry. Called at step end (engine) — off the device-sync path.
        Returns the appended entry so the hot path never has to copy the
        whole ring to read the window it just recorded."""
        entry = {"step": int(step), "wall_time": float(self.clock()),
                 "spans": self.tracer.drain()}
        if step_time_s is not None:
            entry["step_time_s"] = float(step_time_s)
        if metrics:
            entry["metrics"] = {k: v for k, v in metrics.items()
                                if isinstance(v, (int, float, bool))}
        if mem:  # device-memory gauges (bytes in use / peak / limit)
            entry["mem"] = dict(mem)
        if self.collectives is not None:
            entry["collective_seq"] = self.collectives.last_seq()
        with self._lock:
            self._ring.append(entry)
        return entry

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # -- post-mortem -----------------------------------------------------
    def last_phase(self, open_spans: Optional[List[dict]] = None,
                   inflight: Optional[List[dict]] = None) -> Optional[str]:
        """The phase the run was last inside: the innermost OPEN span when
        one exists (a hang — that phase never finished), else the last
        closed span of the current window, else of the last ring entry."""
        open_spans = (self.tracer.open_spans() if open_spans is None
                      else open_spans)
        if open_spans:
            return max(open_spans, key=lambda s: (s["depth"], s["t0_ns"]))["name"]
        inflight = (self.tracer.snapshot() if inflight is None else inflight)
        if inflight:
            return inflight[-1]["name"]
        steps = self.steps()
        if steps and steps[-1]["spans"]:
            return steps[-1]["spans"][-1]["name"]
        return None

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write ``flightdump-<rank>.json`` and return its path.

        Captures the ring, the current (not-yet-folded) window's closed
        spans, and every open span with its live age — so a watchdog dump of
        a wedged step shows exactly which phase is still running. The newest
        dump wins the filename; ``reason``/``sequence`` disambiguate."""
        open_spans = self.tracer.open_spans()
        inflight = self.tracer.snapshot()  # non-destructive: rollback keeps tracing
        self.dumps += 1
        doc = {
            "reason": reason,
            "rank": self.rank,
            "pid": os.getpid(),
            "sequence": self.dumps,
            "wall_time": float(self.clock()),
            "last_phase": self.last_phase(open_spans, inflight),
            "open_spans": open_spans,
            "inflight_spans": inflight,
            "steps": self.steps(),
        }
        if self.collectives is not None:
            # the collective launch stream: what the doctor aligns across
            # ranks to find the first divergent seq
            doc["collectives"] = self.collectives.snapshot()
        try:
            # transport-retry log (utils/retry.py): the doctor shows "this
            # host retried the bucket 14x before the dead verdict". Lazy +
            # ImportError-only guard: standalone file-path loads have no
            # package context (dump proceeds without the retry trail), but
            # any OTHER failure must surface — a silently-dropped retries
            # key is exactly the invisible evidence loss lint rule R4
            # exists to prevent
            from ..utils.retry import retry_log_snapshot
        except ImportError:
            pass
        else:
            retries = retry_log_snapshot()
            if retries:
                doc["retries"] = retries
        if extra:
            doc.update(extra)
        os.makedirs(self.dir, exist_ok=True)
        path = flightdump_path(self.dir, self.rank)
        # local copy of utils/fs.py's temp+fsync+replace recipe: importing
        # the utils package pulls torch-bound modules via its __init__, and
        # this module must stay loadable (and dumpable) standalone
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic even against an os._exit after
        except BaseException:
            try:  # a failed dump (disk full) must not litter tmp files
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path
