"""Unified telemetry spine.

Port of ``deepspeed_tpu/telemetry/__init__.py``, host logic unchanged.

Four pieces behind one default-off ``telemetry:`` config block:

- :mod:`spans` — low-overhead step-phase span tracer with thread-local
  nesting and Chrome-trace/Perfetto export;
- :mod:`collective` — collective flight recorder: a bounded ring of every
  collective launch (seq/op/axes/shape/dtype/impl/phase) recorded in the
  comm wrappers at launch time — the stream
  the post-mortem doctor aligns across ranks to name a desync;
- :mod:`flight` — crash flight recorder: the last N steps' spans + metrics
  (+ the collective ring) ring-buffered and dumped to
  ``flightdump-<rank>.json`` from the watchdog expiry path, sentinel
  rollback, the preemption drain, and the engine's crash hook;
- :mod:`registry` — pull-based counters/gauges/histograms with Prometheus
  text exposition (``/metrics`` + ``/healthz``) and a monitor-event bridge
  so the existing JSONL/TensorBoard sinks keep working;
- :mod:`manager` — the serving wiring (the training engine's waits for
  ROADMAP.md Queue A item 9).

``spans``/``flight``/``registry`` are stdlib-only: the watchdog dumps from
its monitor thread while the process is wedged, and drill scripts import them
standalone.
"""

from .collective import (CollectiveRecorder, configure_collective_recorder,
                         get_collective_recorder, record_launch)
from .flight import FlightRecorder, flightdump_path
from .manager import TelemetryManager, register_serving_metrics, telemetry_active
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       MetricsServer, get_registry, reset_registry)
from .spans import (SpanTracer, chrome_trace, configure_tracer, export_chrome,
                    get_tracer, span)

__all__ = [
    "span", "SpanTracer", "get_tracer", "configure_tracer",
    "chrome_trace", "export_chrome",
    "CollectiveRecorder", "get_collective_recorder",
    "configure_collective_recorder", "record_launch",
    "FlightRecorder", "flightdump_path",
    "MetricsRegistry", "MetricsServer", "Counter", "Gauge", "Histogram",
    "get_registry", "reset_registry",
    "TelemetryManager", "telemetry_active", "register_serving_metrics",
]
