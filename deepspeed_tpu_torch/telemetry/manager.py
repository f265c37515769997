"""TelemetryManager: one object wiring the spine into a running engine.

Port of ``deepspeed_tpu/telemetry/manager.py``, host logic unchanged; the
device-memory sampler reads ``torch.cuda.memory_stats`` for every visible
card. The training engine does not build one yet (ROADMAP.md Queue A item
9): a serving process constructs it itself, and every ``LLMServer`` built
while it is live registers its metrics.

Owns the configured :class:`~.spans.SpanTracer`, the
:class:`~.flight.FlightRecorder`, the fleet
:class:`~.registry.MetricsRegistry` (+ optional
:class:`~.registry.MetricsServer`), and the bridges between them and the
pre-existing observability islands:

- comms ledger totals -> ``dstpu_comm_*`` pull-time samples;
- ServingMetrics -> ``dstpu_serving_*`` samples (registered by every
  ``LLMServer`` built while telemetry is active);
- resilience events -> ``dstpu_resilience_events_total{event=...}``;
- drained step spans -> ``dstpu_step_phase_seconds{phase=...}`` histograms
  and the flight ring.

Constructed ONLY when ``config.telemetry.enabled`` — the default-off tree
never imports this module, and nothing here touches the traced program
(spans and counters read, they never compute), so stepping stays
bit-identical either way.
"""

import os
from collections import deque
from typing import Any, Dict, List, Optional

from .collective import configure_collective_recorder, get_collective_recorder
from .flight import FlightRecorder
from .registry import MetricsRegistry, MetricsServer, Sample, get_registry
from .spans import configure_tracer, export_chrome, get_tracer

_ACTIVE = False
# the manager currently owning the process-global tracer/_ACTIVE flag: a
# newer manager takes ownership, and only the owner's close() tears the
# globals down (closing a superseded manager must not mute its successor)
_OWNER = None


def telemetry_active() -> bool:
    """Whether a TelemetryManager is live in this process — the cheap check
    late joiners (LLMServer) use to decide whether to register bridges."""
    return _ACTIVE


class TelemetryManager:
    def __init__(self, cfg, *, rank: int = 0,
                 default_dir: Optional[str] = None):
        global _ACTIVE
        self.cfg = cfg
        self.rank = int(rank)
        self.tracer = configure_tracer(enabled=cfg.spans,
                                       max_spans=cfg.max_spans)
        self.registry: MetricsRegistry = get_registry()
        flight_dir = cfg.flight_dir or default_dir or "."
        # collective flight recorder: launches recorded in the comm wrappers
        # land here; the ring rides every flight dump
        ring = int(getattr(cfg, "collective_ring", 0) or 0)
        self.collectives = configure_collective_recorder(
            enabled=ring > 0, max_records=ring or None)
        self.flight: Optional[FlightRecorder] = None
        if cfg.flight_steps > 0:
            self.flight = FlightRecorder(
                self.tracer, flight_dir, steps=cfg.flight_steps,
                rank=self.rank,
                collectives=self.collectives if ring > 0 else None)
        self.server: Optional[MetricsServer] = None
        self._health_fn = None
        # device-memory gauges: a sampler closure installed by attach_engine
        # (the manager itself never imports torch); None = off or unavailable
        self._mem_fn = None
        self._mem_gauges = None
        self._ledger = None
        # newest per-step memory sample (the control plane's mem-pressure
        # signal reads this — one step stale by design, never a fresh sync)
        self.last_mem: Optional[Dict[str, Any]] = None
        # set by ControlSupervisor.attach_engine: the control ledger rides
        # every flight dump so the doctor can explain automated decisions
        self._control = None
        self.phase_hist = self.registry.histogram(
            "dstpu_step_phase_seconds",
            "host-side duration of each step phase span")
        self.step_counter = self.registry.counter(
            "dstpu_steps_total", "engine steps completed")
        self.res_counter = self.registry.counter(
            "dstpu_resilience_events_total",
            "resilience events (snapshot/rollback/degraded/preempt_drain)")
        self._trace_dir = cfg.trace_dir
        # with no flight ring, drained step spans would be lost to the
        # trace_dir export — keep them in a bounded side buffer instead
        self._trace_spans: Optional[deque] = (
            deque(maxlen=cfg.max_spans)
            if cfg.trace_dir and self.flight is None else None)
        self._closed = False
        _ACTIVE = True
        global _OWNER
        _OWNER = self
        if cfg.prometheus_port is not None:
            self.start_server(cfg.prometheus_port)
        # the engine has no shutdown hook, so the trace_dir export and the
        # server teardown ride process exit; close() is idempotent, so an
        # explicit engine.telemetry.close() beforehand is also fine
        import atexit

        atexit.register(self.close)

    # -- engine hooks ----------------------------------------------------
    def drain_due(self, step: int) -> bool:
        """Whether this step should drain the device inside its
        ``compute/drain`` span (the once-per-window device attribution that
        replaces a per-span sync)."""
        n = self.cfg.drain_interval_steps
        return bool(n and n > 0 and step % n == 0)

    def on_step_end(self, step: int, *, step_time_s: Optional[float] = None,
                    metrics: Optional[Dict[str, Any]] = None) -> None:
        """Fold the step's spans into the phase histograms and the flight
        ring. Only host-resident values are recorded — this hook never
        forces a device sync (``memory_stats`` reads the allocator's
        host-side counters)."""
        self.step_counter.inc()
        mem = self.sample_memory()
        self.last_mem = mem
        if self.flight is not None:
            # record_step drains the tracer; feed the histogram from the
            # recorded window so both views see the same spans
            window = self.flight.record_step(step, step_time_s=step_time_s,
                                             metrics=metrics,
                                             mem=mem)["spans"]
        else:
            window = self.tracer.drain()
            if self._trace_spans is not None:
                self._trace_spans.extend(window)
        for s in window:
            self.phase_hist.observe(s["dur_ns"] / 1e9, phase=s["name"])

    def sample_memory(self) -> Optional[Dict[str, Any]]:
        """One host-side read of the device allocator gauges: the flight
        ring gets the fleet-aggregate summary, the registry gets per-device
        ``dstpu_mem_*`` series. Returns None when unavailable (CPU) — the
        sampler self-disables after the first empty read."""
        if self._mem_fn is None:
            return None
        try:
            stats = self._mem_fn()
        except Exception:
            return None  # transient read failure: skip this step, keep
        if not stats:     # sampling (a multi-day job must not lose its HBM
            # history to one flaky read); only a backend that SUCCESSFULLY
            # reports nothing (CPU) disables the sampler for good
            self._mem_fn = None
            return None
        if self._mem_gauges is None:
            self._mem_gauges = {
                "in_use": self.registry.gauge(
                    "dstpu_mem_bytes_in_use", "device HBM bytes in use"),
                "peak": self.registry.gauge(
                    "dstpu_mem_peak_bytes_in_use",
                    "peak device HBM bytes in use"),
                "limit": self.registry.gauge(
                    "dstpu_mem_bytes_limit", "device HBM byte limit"),
            }
        in_use = peak = 0
        limit = None
        for idx, s in stats:
            bi = int(s.get("bytes_in_use", 0))
            pk = int(s.get("peak_bytes_in_use", bi))
            lm = s.get("bytes_limit")
            self._mem_gauges["in_use"].set(bi, device=str(idx))
            self._mem_gauges["peak"].set(pk, device=str(idx))
            if lm is not None:
                self._mem_gauges["limit"].set(int(lm), device=str(idx))
                limit = int(lm) if limit is None else min(limit, int(lm))
            in_use = max(in_use, bi)
            peak = max(peak, pk)
        mem = {"bytes_in_use": in_use, "peak_bytes_in_use": peak}
        if limit is not None:
            mem["bytes_limit"] = limit
        return mem

    def record_memory_analysis(self, label: str,
                               info: Dict[str, Any]) -> None:
        """Surface one executable's compile-time memory breakdown (engine
        ``memory_analysis()``) as ``dstpu_mem_exec_bytes{exec=,kind=}``
        gauges; the comms ledger's plan table carries the same row."""
        g = self.registry.gauge(
            "dstpu_mem_exec_bytes",
            "compile-time executable memory breakdown (memory_analysis)")
        for kind in ("argument", "output", "temp", "generated_code"):
            v = info.get(f"{kind}_size_in_bytes")
            if v is not None:
                g.set(float(v), exec=label, kind=kind)

    def count(self, event: str, amount: float = 1.0) -> None:
        self.res_counter.inc(amount, event=event)

    # -- wiring ----------------------------------------------------------
    def attach_engine(self, engine) -> None:
        """Post-construction wiring: the comms-ledger bridge, the device
        memory sampler, the resilience tier (flight dumps on watchdog
        expiry / rollback / drain), and the health surface for /healthz."""
        from ..comm import get_comms_logger

        ledger = self._ledger = get_comms_logger()
        self.registry.register_collector(
            "comms_ledger", lambda: comms_ledger_samples(ledger))
        if getattr(self.cfg, "memory", False):
            self._mem_fn = device_memory_sampler()
        rz = getattr(engine, "resilience", None)
        if rz is not None:
            self.attach_resilience(rz)

    def attach_control(self, supervisor) -> None:
        """Control-plane wiring: the decision ledger rides every flight
        dump (the doctor's ``supervisor action`` lines read it back)."""
        self._control = supervisor

    def attach_resilience(self, manager) -> None:
        manager._telemetry = self
        self._resilience = manager
        if self.flight is not None and manager.watchdog is not None:
            # route through flight_dump (not flight.dump) so the plan table
            # rides the watchdog post-mortem too — but with sample_mem off:
            # the watchdog fires while the runtime is WEDGED, and a
            # device.memory_stats() call from the monitor thread could
            # block on the same stuck client and stall the exit-83 kill
            manager.watchdog.pre_dump = (
                lambda: self.flight_dump(
                    "watchdog",
                    {"fired_step": manager.watchdog.fired_step},
                    sample_mem=False))
        if manager.health is not None:
            # stash the health source so a server started LATER (manual
            # start_server after init) still serves real /healthz verdicts
            self._health_fn = manager.health.verdicts
            if self.server is not None:
                self.server.health_fn = self._health_fn

    def flight_dump(self, reason: str,
                    extra: Optional[Dict[str, Any]] = None, *,
                    sample_mem: bool = True) -> Optional[str]:
        """Exception-guarded: a failed dump (full disk, tracer churn) must
        never abort the recovery action — rollback, drain — it documents;
        the watchdog path has the same guard around ``pre_dump``.
        ``sample_mem=False`` skips the live device-memory read — the
        watchdog dump runs while the runtime is wedged and must stay on
        the stdlib-only path (the ring's per-step ``mem`` history is
        already in the dump)."""
        if self.flight is None:
            return None
        try:
            extra = dict(extra or {})
            # per-mesh facts ride every post-mortem: the resolved plan
            # table (planner decisions + executable memory) lets the doctor
            # check SPMD plan consistency across ranks
            if (self._ledger is not None
                    and getattr(self._ledger, "plan_records", None)):
                extra.setdefault("plan", dict(self._ledger.plan_records))
            if (self._ledger is not None
                    and getattr(self._ledger, "memory_records", None)):
                extra.setdefault("exec_memory",
                                 dict(self._ledger.memory_records))
            if self._control is not None and len(self._control.ledger):
                # the control ledger: which knobs the supervisor moved and
                # why — the doctor prints these beside its verdicts
                extra.setdefault("control", self._control.ledger.snapshot())
            mon = getattr(getattr(self, "_resilience", None),
                          "integrity", None)
            if mon is not None:
                # per-rank fingerprint history: the doctor cross-votes
                # these across dumps to NAME the corrupt rank
                extra.setdefault("integrity", mon.snapshot())
            mem = self.sample_memory() if sample_mem else None
            if mem:
                extra.setdefault("mem", mem)
            return self.flight.dump(reason, extra)
        except Exception as e:
            from ..utils.logging import logger

            logger.error(f"telemetry: flight dump ({reason}) failed: {e!r}")
            return None

    def crash_dump(self, exc: BaseException) -> Optional[str]:
        """The crash hook: an unhandled train-loop exception loses the
        flight ring unless someone dumps it — the engine calls this before
        re-raising. The dump meta carries the exception type and a bounded
        traceback summary so the doctor can class the failure without the
        stderr log."""
        import traceback

        tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
        return self.flight_dump("crash", {
            "exception": type(exc).__name__,
            "message": str(exc)[:500],
            "traceback": "".join(tb)[-4000:],
        })

    @property
    def prometheus_port(self) -> Optional[int]:
        """The ACTUAL bound /metrics port (differs from the configured one
        under ``prometheus_port: 0`` — ephemeral bind), or None."""
        return self.server.port if self.server is not None else None

    def start_server(self, port: int, host: str = "127.0.0.1") -> int:
        """Serve /metrics (+/healthz) — the Prometheus surface beside the
        heartbeat files the fleet already publishes. ``port=0`` binds an
        ephemeral port (two engines on one host stop colliding); the bound
        port is logged and readable via :attr:`prometheus_port`. Bind
        failures are logged, not raised: a fixed port shared across ranks
        (or held by a stale process) must not take down engine bring-up —
        telemetry never breaks the main path. Returns the bound port, or
        -1 on failure."""
        from ..utils.logging import logger

        if self.server is not None:
            return self.server.port
        try:
            server = MetricsServer(self.registry, port=port, host=host,
                                   health_fn=self._health_fn)
            bound = server.start()
        except OSError as e:
            logger.warning(f"telemetry: metrics server failed to bind "
                           f"{host}:{port} ({e}); /metrics disabled on "
                           f"rank {self.rank}")
            return -1
        self.server = server
        logger.info(f"telemetry: rank {self.rank} serving /metrics on "
                    f"http://{host}:{bound}/metrics"
                    + (" (ephemeral)" if int(port) == 0 else ""))
        return bound

    # -- export / teardown ----------------------------------------------
    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Chrome-trace JSON of everything still held: the flight ring's
        per-step spans, the current unfolded window, and open spans. Slots
        beside ``profiling/trace.py`` device captures in Perfetto."""
        if path is None:
            if not self._trace_dir:
                return None
            path = os.path.join(self._trace_dir,
                                f"spans-{self.rank}.trace.json")
        spans: List[dict] = []
        if self.flight is not None:
            for entry in self.flight.steps():
                spans.extend(entry["spans"])
        elif self._trace_spans is not None:
            spans.extend(self._trace_spans)
        spans.extend(self.tracer.snapshot())
        return export_chrome(path, spans, self.tracer.open_spans(),
                             rank=self.rank)

    def close(self) -> None:
        global _ACTIVE
        if self._closed:
            return
        self._closed = True
        import atexit

        try:  # drop the atexit pin so a closed manager can be collected
            atexit.unregister(self.close)
        except Exception:
            pass
        if self._trace_dir:
            try:
                self.export_trace()
            except Exception:
                pass
        if self.server is not None:
            self.server.stop()
            self.server = None
        # off means off again: a later telemetry-free engine in the same
        # process must not keep filling the fleet tracer's buffer — but only
        # the OWNING manager may flip the globals (closing a superseded
        # manager while its successor is live must not mute the successor)
        global _OWNER
        if _OWNER is self:
            configure_tracer(enabled=False)
            configure_collective_recorder(enabled=False)
            _ACTIVE = False
            _OWNER = None


# ---------------------------------------------------------------------------
# bridges: existing stateful sources -> pull-time registry samples
# ---------------------------------------------------------------------------


def device_memory_sampler():
    """A closure reading every visible card's allocator gauges
    (``torch.cuda.memory_stats`` — host-side counters, no device sync)
    under the JAX ``memory_stats()`` keys: ``bytes_in_use`` from
    ``allocated_bytes.all.current``, ``peak_bytes_in_use`` from
    ``allocated_bytes.all.peak``, ``bytes_limit`` from the card's
    ``total_memory``. Returns ``[(device_index, stats_dict), ...]``, empty
    where no card is visible (CPU), which disables the sampler."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    limits = [torch.cuda.get_device_properties(i).total_memory
              for i in range(n)]

    def sample():
        out = []
        for i in range(n):
            try:
                s = torch.cuda.memory_stats(i)
            except Exception:
                s = None
            if s:
                cur = int(s.get("allocated_bytes.all.current", 0))
                out.append((i, {
                    "bytes_in_use": cur,
                    "peak_bytes_in_use": int(
                        s.get("allocated_bytes.all.peak", cur)),
                    "bytes_limit": int(limits[i])}))
        return out

    return sample


def comms_ledger_samples(ledger) -> List[Sample]:
    """CommsLogger totals as ``dstpu_comm_*`` counter families (scrape-time
    read of the ledger the collectives already maintain)."""
    rows_b, rows_w, rows_c, rows_l = [], [], [], []
    for op, t in sorted(ledger.totals().items()):
        lab = {"op": op}
        rows_b.append(("", lab, float(t["bytes"])))
        rows_w.append(("", lab, float(t["wire_bytes"])))
        rows_c.append(("", lab, float(t["count"])))
        rows_l.append(("", lab, t["total_latency_ms"] / 1e3))
    hop_rows = [("", {"link": link}, float(nbytes))
                for link, nbytes in sorted(ledger.hop_totals().items())]
    return [
        ("dstpu_comm_logical_bytes_total", "counter",
         "logical payload bytes per collective op", rows_b),
        ("dstpu_comm_wire_bytes_total", "counter",
         "on-wire bytes per collective op (compression-aware)", rows_w),
        ("dstpu_comm_ops_total", "counter",
         "collective invocations per op", rows_c),
        ("dstpu_comm_latency_seconds_total", "counter",
         "accumulated eager-collective latency per op", rows_l),
        ("dstpu_comm_hop_bytes_total", "counter",
         "wire bytes per link class (ici/dcn/host)", hop_rows),
    ]


def serving_metrics_samples(metrics, labels: Dict[str, str]) -> List[Sample]:
    """ServingMetrics as ``dstpu_serving_*`` families: counters straight off
    the tallies, latency percentiles as gauges (the serving tier keeps
    exact percentiles — re-bucketing them would lose the tail)."""
    lab = dict(labels)
    counters = [
        ("dstpu_serving_requests_total", "submitted"),
        ("dstpu_serving_completed_total", "completed"),
        ("dstpu_serving_cancelled_total", "cancelled"),
        ("dstpu_serving_failed_total", "failed"),
        ("dstpu_serving_rejected_total", "rejected"),
        ("dstpu_serving_preemptions_total", "preemptions"),
        ("dstpu_serving_requeues_total", "requeues"),
        ("dstpu_serving_sla_violations_total", "sla_violations"),
        ("dstpu_serving_canary_probes_total", "canary_probes"),
        ("dstpu_serving_canary_fail_total", "canary_fails"),
        ("dstpu_serving_tokens_out_total", "tokens_out"),
        # prefix KV cache / speculative decoding (mirrored off the
        # engine's ReuseStats by the server loop)
        ("dstpu_serving_prefix_lookups_total", "prefix_lookups"),
        ("dstpu_serving_prefix_hits_total", "prefix_hits"),
        ("dstpu_serving_prefix_tokens_reused_total", "prefix_tokens_reused"),
        ("dstpu_serving_prefix_blocks_shared_total", "prefix_blocks_shared"),
        ("dstpu_serving_cow_forks_total", "cow_forks"),
        ("dstpu_serving_spec_drafted_total", "spec_drafted"),
        ("dstpu_serving_spec_accepted_total", "spec_accepted"),
    ]
    out: List[Sample] = [
        (name, "counter", f"serving {attr}",
         [("", lab, float(getattr(metrics, attr)))])
        for name, attr in counters]
    gauge_rows: List[Sample] = []
    for hname, h in (("ttft", metrics.ttft), ("tpot", metrics.tpot),
                     ("e2e", metrics.e2e), ("queue_wait", metrics.queue_wait)):
        for p in (50, 99):
            v = h.percentile(p)
            if v is not None:
                gauge_rows.append(
                    (f"dstpu_serving_{hname}_p{p}_seconds", "gauge",
                     f"exact p{p} of {hname}", [("", lab, float(v))]))
    occ = metrics.kv_occupancy()
    if occ is not None:
        gauge_rows.append(("dstpu_serving_kv_occupancy", "gauge",
                           "KV pool occupancy fraction", [("", lab, occ)]))
    gauge_rows.append(("dstpu_serving_queue_depth", "gauge",
                       "requests queued (ingress + scheduler)",
                       [("", lab, float(metrics.queue_depth))]))
    gauge_rows.append(("dstpu_serving_inflight", "gauge",
                       "sequences in the engine",
                       [("", lab, float(metrics.inflight))]))
    hr = metrics.prefix_hit_rate() if hasattr(metrics,
                                              "prefix_hit_rate") else None
    if hr is not None:
        gauge_rows.append(("dstpu_serving_prefix_hit_rate", "gauge",
                           "fraction of admissions matching cached prefix",
                           [("", lab, float(hr))]))
    ar = (metrics.spec_acceptance_rate()
          if hasattr(metrics, "spec_acceptance_rate") else None)
    if ar is not None:
        gauge_rows.append(("dstpu_serving_spec_acceptance_rate", "gauge",
                           "fraction of drafted tokens accepted by verify",
                           [("", lab, float(ar))]))
    # per-tenant SLA-class slices (fleet/tenancy.py): the SAME family
    # names with a tenant label added, so dstpu_serving_*{tenant="acme"}
    # sits next to the untenanted fleet total. Cardinality is bounded by
    # tenants actually seen — no row exists until a tenant submits.
    tenant_counters = [
        ("dstpu_serving_requests_total", "submitted"),
        ("dstpu_serving_completed_total", "completed"),
        ("dstpu_serving_cancelled_total", "cancelled"),
        ("dstpu_serving_failed_total", "failed"),
        ("dstpu_serving_rejected_total", "rejected"),
        ("dstpu_serving_sla_violations_total", "sla_violations"),
        ("dstpu_serving_tokens_out_total", "tokens_out"),
    ]
    tenant_rows: List[Sample] = []
    for tname, ts in sorted(getattr(metrics, "tenants", {}).items()):
        tlab = {**lab, "tenant": str(tname)}
        for name, attr in tenant_counters:
            tenant_rows.append((name, "counter", f"serving {attr}",
                                [("", tlab, float(getattr(ts, attr)))]))
        for hname, h in (("ttft", ts.ttft), ("e2e", ts.e2e)):
            for p in (50, 99):
                v = h.percentile(p)
                if v is not None:
                    tenant_rows.append(
                        (f"dstpu_serving_{hname}_p{p}_seconds", "gauge",
                         f"exact p{p} of {hname}", [("", tlab, float(v))]))
    return out + gauge_rows + tenant_rows


def register_serving_metrics(metrics, replica_id: int = 0) -> None:
    """Register one server's ServingMetrics into the fleet registry (keyed
    by replica — a rebuilt server replaces its predecessor's collector)."""
    lab = {"replica": str(int(replica_id))}
    get_registry().register_collector(
        f"serving-{int(replica_id)}",
        lambda: serving_metrics_samples(metrics, lab))
