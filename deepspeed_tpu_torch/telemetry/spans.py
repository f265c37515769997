"""Step-phase span tracer: a shared host-side timeline for the whole stack.

Port of ``deepspeed_tpu/telemetry/spans.py``, host logic unchanged.

The stack already has five observability islands — monitor backends, the
comms ledger, serving percentile histograms, ``torch.profiler`` captures, and
the watchdog's hangdumps — but none of them answer "what was the step DOING
at t?". Spans do: ``with span("compute/dispatch"): ...`` records a named,
nested, monotonic-stamped interval into a bounded buffer that the flight
recorder (:mod:`.flight`), the metrics registry (:mod:`.registry`), and a
Chrome-trace/Perfetto export all read from.

Design constraints, in order:

- **Off means off.** The module-level :func:`span` is the only thing hot
  paths touch; with the fleet tracer disabled it returns a shared no-op
  context manager — one attribute check, no allocation, and the traced
  program is bit-identical (spans never touch math).
- **No per-span device sync.** A span measures HOST time (launches,
  queueing, python glue). Device work is attributed once per *window*: the
  engine drains the dispatch queue inside a ``compute/drain`` span every
  ``drain_interval_steps`` steps (see ``TelemetryConfig``), so the timeline
  shows true step cost without serializing the async pipeline every step.
- **Stdlib-only.** The watchdog dumps spans from its monitor thread while
  the process is wedged; this module must import (and dump) without torch.

Open spans are tracked so a crash dump can name the phase that never
finished — the whole point of a flight recorder.
"""

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; becomes a record on ``__exit__``."""

    __slots__ = ("tracer", "name", "attrs", "sid", "t0_ns", "depth", "tid",
                 "step")

    def __init__(self, tracer: "SpanTracer", name: str, attrs):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = None

    def __enter__(self):
        tr = self.tracer
        tls = tr._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self.depth = len(stack)
        self.tid = threading.get_ident()
        self.step = tr._step
        self.sid = next(tr._ids)
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        tr._open[self.sid] = self  # publish AFTER t0_ns: a concurrent dump
        return self                # must never see a half-built span

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self.t0_ns
        tr = self.tracer
        tr._open.pop(self.sid, None)
        stack = tr._tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # mis-nested exit (generator-held span): repair
            stack.remove(self)
        tr._spans.append((self.name, self.t0_ns, dur_ns, self.depth,
                          self.tid, self.step, self.attrs))
        return False


class SpanTracer:
    """Bounded span buffer with thread-local nesting.

    Closed spans land in a ``deque(maxlen=max_spans)`` (append is atomic
    under the GIL — the serving thread and the engine can both trace);
    open spans live in a dict so :meth:`open_spans` can name a hung phase
    from another thread.
    """

    def __init__(self, enabled: bool = False, max_spans: int = 8192):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self._spans: "deque" = deque(maxlen=self.max_spans)
        self._open: Dict[int, _Span] = {}
        self._tls = threading.local()
        self._ids = itertools.count()
        self._step: Optional[int] = None

    # -- producing -------------------------------------------------------
    def span(self, name: str, **attrs):
        """A context manager recording one nested interval. Prefer the
        module-level :func:`span` on hot paths — it short-circuits to a
        shared no-op when the fleet tracer is off."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def set_step(self, step: Optional[int]) -> None:
        """Stamp subsequently-opened spans with the engine step (cheap: one
        attribute write; spans copy it at open)."""
        self._step = None if step is None else int(step)

    # -- consuming -------------------------------------------------------
    @staticmethod
    def _concurrent_copy(container):
        """Copy a deque/dict-values view that other threads keep mutating
        (the GIL makes each mutation atomic but iteration can still raise
        RuntimeError mid-copy). The dump paths — watchdog expiry while a
        serving thread traces on — must get a best-effort copy, never an
        exception."""
        for _ in range(8):
            try:
                return list(container)
            except RuntimeError:
                continue
        return []

    @staticmethod
    def _as_dict(rec) -> Dict[str, Any]:
        name, t0, dur, depth, tid, step, attrs = rec
        d = {"name": name, "t0_ns": t0, "dur_ns": dur, "depth": depth,
             "tid": tid, "step": step}
        if attrs:
            d["attrs"] = attrs
        return d

    def snapshot(self) -> List[Dict[str, Any]]:
        """Closed spans, oldest first, without consuming them."""
        return [self._as_dict(r) for r in self._concurrent_copy(self._spans)]

    def drain(self) -> List[Dict[str, Any]]:
        """Pop every closed span (the flight recorder's per-step window)."""
        out = []
        while True:
            try:
                out.append(self._as_dict(self._spans.popleft()))
            except IndexError:
                return out

    def open_spans(self) -> List[Dict[str, Any]]:
        """Currently-open spans (any thread), outermost first — the spans a
        hang dump reports with ``dur_ns=None`` and their live age instead."""
        now = time.perf_counter_ns()
        out = []
        for sp in sorted(self._concurrent_copy(self._open.values()),
                         key=lambda s: s.t0_ns):
            out.append({"name": sp.name, "t0_ns": sp.t0_ns,
                        "age_ns": now - sp.t0_ns, "dur_ns": None,
                        "depth": sp.depth, "tid": sp.tid, "step": sp.step,
                        **({"attrs": sp.attrs} if sp.attrs else {})})
        return out

    def clear(self) -> None:
        self._spans.clear()


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export: the span timeline opens in the same UI as
# profiling/trace.py's device captures (chrome://tracing, ui.perfetto.dev),
# so host phases and device op timelines sit side by side.
# ---------------------------------------------------------------------------


def chrome_trace(spans: List[Dict[str, Any]],
                 open_spans: Optional[List[Dict[str, Any]]] = None,
                 rank: Optional[int] = None) -> dict:
    """Span dicts -> a Chrome trace-event JSON object (``ph: "X"`` complete
    events, microsecond units). Open spans export with their live age as the
    duration and an ``open: true`` arg.

    With ``rank`` given, events are stamped ``pid=rank`` and
    ``process_name``/``process_sort_index`` metadata events are emitted, so
    per-rank exports concatenate into ONE Perfetto timeline (one process
    lane per rank, in rank order) — ``the post-mortem doctor
    --merge-trace`` does exactly that."""
    pid = os.getpid() if rank is None else int(rank)
    events = []
    if rank is not None:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {int(rank)}"}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": int(rank)}})
    for s in spans:
        args = dict(s.get("attrs") or {})
        if s.get("step") is not None:
            args["step"] = s["step"]
        events.append({"name": s["name"], "ph": "X", "pid": pid,
                       "tid": s.get("tid", 0), "ts": s["t0_ns"] / 1e3,
                       "dur": (s.get("dur_ns") or 0) / 1e3,
                       **({"args": args} if args else {})})
    for s in (open_spans or []):
        args = dict(s.get("attrs") or {})
        args["open"] = True
        if s.get("step") is not None:
            args["step"] = s["step"]
        events.append({"name": s["name"], "ph": "X", "pid": pid,
                       "tid": s.get("tid", 0), "ts": s["t0_ns"] / 1e3,
                       "dur": (s.get("age_ns") or 0) / 1e3, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome(path: str, spans: List[Dict[str, Any]],
                  open_spans: Optional[List[Dict[str, Any]]] = None,
                  rank: Optional[int] = None) -> str:
    """Write a Chrome-trace JSON file; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(chrome_trace(spans, open_spans, rank=rank), f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# ---------------------------------------------------------------------------
# Fleet-global tracer (the configure_compression / get_comms_logger pattern):
# call sites trace through one process-wide tracer flipped by the telemetry
# config; nothing allocates while it is off.
# ---------------------------------------------------------------------------

_TRACER = SpanTracer(enabled=False)


def get_tracer() -> SpanTracer:
    return _TRACER


def configure_tracer(enabled: Optional[bool] = None,
                     max_spans: Optional[int] = None) -> SpanTracer:
    tr = _TRACER
    if max_spans is not None and int(max_spans) != tr.max_spans:
        tr.max_spans = int(max_spans)
        tr._spans = deque(tr._spans, maxlen=tr.max_spans)
    if enabled is not None:
        tr.enabled = bool(enabled)
    return tr


def span(name: str, **attrs):
    """The hot-path entry point: a nested span when the fleet tracer is on,
    a shared no-op context manager when it is off."""
    tr = _TRACER
    if not tr.enabled:
        return _NULL_SPAN
    return _Span(tr, name, attrs or None)
