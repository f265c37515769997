"""Collective flight recorder: the per-rank stream of collective launches.

Port of ``deepspeed_tpu/telemetry/collective.py``, host logic unchanged.

The fleet's most common unexplained failure is a *collective desync*: one
rank enters a different collective (extra barrier, mismatched shape,
reordered reduce) and every other rank blocks forever in the one it
expected — the watchdog fires exit-83 on all of them, and the hangdumps
all say the same useless thing ("blocked in a collective"). NCCL ships a
flight recorder for exactly this, but only for its own launches, so the
evidence must be collected where the runtime *issues* collectives: the
``comm.comm`` / ``comm.compressed`` wrappers.

:class:`CollectiveRecorder` is a bounded ring of launch records, one per
collective the wrappers see:

``{seq, op, axes, shape, dtype, impl, link, phase, step, t_ns, eager}``

- ``seq`` is a process-monotonic sequence number — the alignment key the
  doctor (the post-mortem doctor) uses to find the first
  launch where two ranks' streams diverge;
- ``phase`` is the innermost open span of the calling thread (the
  ``comm/...``/``compute/...`` taxonomy), so a divergent launch names the
  step phase that issued it;
- ``impl``/``link`` carry the resolved fast path (planner decision:
  ``int8``, ``program`` phase ops, ring variants) and the hop class.

Recording happens at **launch time** on the host — the port's
collectives run eagerly, so the record is exact, and nothing here touches device
state (no sync, no allocation on the traced path). Like the span tracer,
the module-level :func:`record_launch` is a single attribute check when
recording is off, and the traced program is bit-identical either way.

Stdlib-only: the flight recorder dumps this ring from the watchdog's
monitor thread while the device runtime is wedged.
"""

import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from .spans import get_tracer

DEFAULT_RING = 512


class CollectiveRecorder:
    """Bounded ring of collective-launch records, dumpable from any thread.

    Concurrency story (same as :class:`~.spans.SpanTracer`): appends are
    GIL-atomic deque operations, and :meth:`snapshot` retries around the
    rare mutation-during-copy ``RuntimeError`` — no lock on the record
    path, which runs inside every traced collective."""

    def __init__(self, enabled: bool = False, max_records: int = DEFAULT_RING):
        self.enabled = bool(enabled)
        self.max_records = int(max_records)
        self._ring: "deque" = deque(maxlen=max(1, self.max_records))
        self._seq = itertools.count()

    # -- producing (the wrapper hot path: one attribute check when off) --
    def record(self, op: str, *, shape: Optional[Sequence[int]] = None,
               dtype: Optional[str] = None,
               axes: Optional[Sequence[str]] = None,
               impl: Optional[str] = None, link: Optional[str] = None,
               eager: bool = False,
               detail: Optional[str] = None) -> Optional[int]:
        """Append one launch record; returns its ``seq`` (None when off).

        ``detail`` disambiguates launches the (op, axes, shape) signature
        cannot — e.g. a barrier's name: two ranks both at "a barrier" may
        still be at *different* barriers, which is precisely a desync.
        """
        if not self.enabled:
            return None
        tr = get_tracer()
        phase = None
        stack = getattr(tr._tls, "stack", None)
        if stack:  # innermost open span of THIS thread: the issuing phase
            phase = stack[-1].name
        rec: Dict[str, Any] = {
            "seq": next(self._seq),
            "op": op,
            "t_ns": time.perf_counter_ns(),
        }
        if shape is not None:
            rec["shape"] = [int(d) for d in shape]
        if dtype is not None:
            rec["dtype"] = str(dtype)
        if axes is not None:
            rec["axes"] = [str(a) for a in axes]
        if impl is not None:
            rec["impl"] = impl
        if link is not None:
            rec["link"] = link
        if phase is not None:
            rec["phase"] = phase
        if tr._step is not None:
            rec["step"] = tr._step
        if eager:
            rec["eager"] = True
        if detail is not None:
            rec["detail"] = detail
        self._ring.append(rec)  # deque append is atomic under the GIL
        return rec["seq"]

    # -- consuming --------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring, oldest first — best-effort against concurrent appends
        (the watchdog dumps while the main thread may still be tracing)."""
        for _ in range(8):
            try:
                return [dict(r) for r in self._ring]
            except RuntimeError:
                continue
        return []

    def last_seq(self) -> int:
        """Highest sequence number issued so far (-1 before any record) —
        the flight ring stamps each step entry with it so the doctor can
        attribute seq ranges to steps."""
        try:
            return self._ring[-1]["seq"] if self._ring else -1
        except IndexError:
            return -1

    def clear(self) -> None:
        self._ring.clear()


# ---------------------------------------------------------------------------
# Fleet-global recorder (the get_tracer pattern): the comm wrappers record
# through one process-wide instance flipped by the telemetry config.
# ---------------------------------------------------------------------------

_RECORDER = CollectiveRecorder(enabled=False)


def get_collective_recorder() -> CollectiveRecorder:
    return _RECORDER


def configure_collective_recorder(enabled: Optional[bool] = None,
                                  max_records: Optional[int] = None
                                  ) -> CollectiveRecorder:
    rec = _RECORDER
    if max_records is not None and int(max_records) != rec.max_records:
        rec.max_records = int(max_records)
        rec._ring = deque(rec._ring, maxlen=max(1, rec.max_records))
    if enabled is not None:
        rec.enabled = bool(enabled)
    return rec


def record_launch(op: str, **kw) -> Optional[int]:
    """The wrapper entry point: one attribute check when recording is off
    (the default), a ring append when a TelemetryManager enabled it."""
    rec = _RECORDER
    if not rec.enabled:
        return None
    return rec.record(op, **kw)
