"""Pull-based metrics registry with Prometheus text exposition.

Port of ``deepspeed_tpu/telemetry/registry.py``, host logic unchanged.

The stack's metric producers each grew their own sink: the comms ledger
prints a table, ServingMetrics keeps exact-percentile histograms, the
resilience tier emits ``Resilience/*`` monitor events, and step timings
live in a private list on the engine. This registry is the one place they
all land: counters / gauges / histograms registered by name (+ labels),
plus pull-time *collectors* (callables producing samples at scrape time —
how the comms ledger and serving metrics expose their existing state
without double bookkeeping).

Two read surfaces:

- :meth:`MetricsRegistry.exposition` — Prometheus text format 0.0.4,
  served by :class:`MetricsServer` at ``GET /metrics`` (with ``/healthz``
  backed by the heartbeat health table when one is wired), so the
  fleet's existing scrape infrastructure reads training and serving
  metrics the same way;
- :meth:`MetricsRegistry.monitor_events` — the ``Monitor.write_events``
  event-tuple bridge, so the JSONL/TensorBoard/W&B sinks that already
  exist keep working unchanged.

Stdlib-only; every mutate path is lock-guarded (the serving thread, the
engine, and the scrape handler are three different threads).
"""

import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# histogram default buckets (seconds — step phases span µs..minutes)
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0,
                   120.0, 600.0)

LabelDict = Dict[str, str]
# one exposition family: (name, type, help, [(suffix, labels, value), ...])
Sample = Tuple[str, str, str, List[Tuple[str, Optional[LabelDict], float]]]


def _label_key(labels: Optional[LabelDict]):
    return tuple(sorted(labels.items())) if labels else ()


def _fmt_labels(labels: Optional[LabelDict]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        v = str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class _Metric:
    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.type = mtype
        self.help = help_text
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, "counter", help_text)
        self._values: Dict[tuple, float] = {}
        self._labels: Dict[tuple, Optional[LabelDict]] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount
            self._labels.setdefault(key, labels or None)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> Sample:
        with self._lock:
            rows = [("", self._labels[k], v) for k, v in self._values.items()]
        return (self.name, "counter", self.help, rows or [("", None, 0.0)])


class Gauge(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, "gauge", help_text)
        self._values: Dict[tuple, float] = {}
        self._labels: Dict[tuple, Optional[LabelDict]] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = float(value)
            self._labels.setdefault(key, labels or None)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Pull-time gauge: ``fn()`` is called at scrape."""
        self._fn = fn

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(labels))

    def samples(self) -> Sample:
        if self._fn is not None:
            try:
                return (self.name, "gauge", self.help,
                        [("", None, float(self._fn()))])
            except Exception:
                return (self.name, "gauge", self.help, [])
        with self._lock:
            rows = [("", self._labels[k], v) for k, v in self._values.items()]
        return (self.name, "gauge", self.help, rows or [("", None, 0.0)])


class Histogram(_Metric):
    """Prometheus-convention histogram: cumulative ``_bucket{le=..}`` counts
    plus ``_sum`` and ``_count`` per label set."""

    def __init__(self, name, help_text="", buckets: Sequence[float] = None):
        super().__init__(name, "histogram", help_text)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts: Dict[tuple, List[int]] = {}
        self._sum: Dict[tuple, float] = {}
        self._n: Dict[tuple, int] = {}
        self._labels: Dict[tuple, Optional[LabelDict]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sum[key] = 0.0
                self._n[key] = 0
                self._labels[key] = labels or None
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sum[key] += float(value)
            self._n[key] += 1

    def count(self, **labels) -> int:
        return self._n.get(_label_key(labels), 0)

    def samples(self) -> Sample:
        rows: List[Tuple[str, Optional[LabelDict], float]] = []
        with self._lock:
            for key, counts in self._counts.items():
                base = self._labels[key] or {}
                for b, c in zip(self.buckets, counts):
                    rows.append(("_bucket", {**base, "le": f"{b:g}"}, c))
                rows.append(("_bucket", {**base, "le": "+Inf"}, self._n[key]))
                rows.append(("_sum", base or None, self._sum[key]))
                rows.append(("_count", base or None, self._n[key]))
        return (self.name, "histogram", self.help, rows)


class MetricsRegistry:
    """Name -> metric families, plus pull-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: Dict[str, Callable[[], List[Sample]]] = {}

    # -- registration ----------------------------------------------------
    def _get(self, name: str, cls, help_text: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_text, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.type}")
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(name, Counter, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(name, Gauge, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = None) -> Histogram:
        return self._get(name, Histogram, help_text, buckets=buckets)

    def register_collector(self, key: str,
                           fn: Callable[[], List[Sample]]) -> None:
        """Register (or replace — ``key`` dedupes re-registration) a
        pull-time sample producer: how existing stateful sources (comms
        ledger totals, ServingMetrics) expose without double bookkeeping."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    # -- reading ---------------------------------------------------------
    def collect(self) -> List[Sample]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.values())
        out = [m.samples() for m in metrics]
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # a broken bridge must not kill the scrape
                continue
        return out

    def exposition(self) -> str:
        """Prometheus text format 0.0.4.

        Families are merged by name before rendering: several collectors
        can emit the same family (one serving collector per replica), and
        the text format requires ALL of a metric's samples under a single
        ``# TYPE`` line — repeated family blocks are a parse error to
        promtool/OpenMetrics scrapers."""
        merged: Dict[str, List] = {}
        for name, mtype, help_text, rows in self.collect():
            fam = merged.setdefault(name, [mtype, help_text, []])
            fam[2].extend(rows)
            if not fam[1] and help_text:
                fam[1] = help_text
        lines: List[str] = []
        for name, (mtype, help_text, rows) in merged.items():
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for suffix, labels, value in rows:
                # repr = shortest round-trip float: '%g' would clip large
                # counters to 6 significant digits and make small increments
                # between scrapes render identically (rate() reads zero)
                v = repr(value) if isinstance(value, float) else str(value)
                lines.append(f"{name}{suffix}{_fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"

    def monitor_events(self, step: int, prefix: str = "Telemetry"
                       ) -> List[Tuple[str, Any, int]]:
        """``Monitor.write_events``-compatible tuples (the existing-sinks
        bridge): one event per plain sample; histograms emit ``_sum`` and
        ``_count`` only (per-bucket series would flood a scalar sink)."""
        events = []
        for name, mtype, _help, rows in self.collect():
            for suffix, labels, value in rows:
                if suffix == "_bucket":
                    continue
                tag = "/".join([prefix, name + suffix]
                               + [f"{k}={v}" for k, v in
                                  sorted((labels or {}).items())])
                events.append((tag, value, step))
        return events


# ---------------------------------------------------------------------------
# HTTP surface: /metrics (exposition) + /healthz (heartbeat verdicts)
# ---------------------------------------------------------------------------


class MetricsServer:
    """Tiny stdlib HTTP endpoint serving the registry and the fleet health
    table — the pull half of the telemetry spine. ``health_fn`` (optional)
    returns a JSON-able dict; when it reports dead hosts the /healthz status
    code flips to 503 so a plain HTTP check doubles as a fleet probe."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry
        self.host = host
        self.port = int(port)
        self.health_fn = health_fn
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port
        (``port=0`` picks a free one — tests)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib contract)
                if self.path.split("?")[0] == "/metrics":
                    body = server.registry.exposition().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                    code = 200
                elif self.path.split("?")[0] in ("/healthz", "/health"):
                    doc = {"status": "ok"}
                    code = 200
                    if server.health_fn is not None:
                        try:
                            verdicts = server.health_fn() or {}
                            doc.update(verdicts)
                            if verdicts.get("dead"):
                                doc["status"] = "degraded"
                                code = 503
                        except Exception as e:
                            doc = {"status": "error", "error": str(e)[:200]}
                            code = 500
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                else:
                    body, ctype, code = b"not found\n", "text/plain", 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stdout
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dstpu-metrics-server",
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Fleet-global registry (the get_comms_logger pattern): producers register
# into one process-wide registry; the scrape surface reads it.
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Replace the fleet registry with a fresh one (tests; a long-lived
    process keeps its registry for the lifetime of the run)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY
