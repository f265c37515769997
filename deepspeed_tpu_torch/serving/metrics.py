"""Serving metrics: latency histograms, throughput, occupancy gauges.

The numbers a serving tier is judged by (blogs/deepspeed-fastgen: TTFT /
per-token latency / effective throughput): time-to-first-token, time per
output token, end-to-end latency — each a percentile histogram — plus queue
depth, KV-pool occupancy, and tokens/s. ``monitor_events`` emits them as
``Serving/*`` events through the same ``Monitor.write_events`` contract the
ledger→monitor bridge uses, so they land in TensorBoard / W&B / CSV /
JSONL next to the training metrics.

Port of ``deepspeed_tpu/serving/metrics.py``; ``tokens_per_sec_per_chip``
counts the visible cards (1 where there is none).
"""

import bisect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .request import (FINISH_CANCELLED, FINISH_EOS, FINISH_FAILED,
                      FINISH_LENGTH, ServedResponse)

Event = Tuple[str, Any, int]


class LatencyHistogram:
    """Exact percentiles over a bounded, sorted sample set.

    Inserts keep the list sorted (bisect — samples arrive one request at a
    time, so O(n) inserts beat re-sorting on every percentile query). At
    ``cap`` samples the histogram decimates to every other sample: long
    soaks keep bounded memory while percentiles stay representative."""

    def __init__(self, cap: int = 65536):
        self.cap = int(cap)
        self._xs: List[float] = []
        self.count = 0          # total recorded (survives decimation)
        self.total = 0.0

    def record(self, value: float) -> None:
        bisect.insort(self._xs, float(value))
        self.count += 1
        self.total += float(value)
        if len(self._xs) >= self.cap:
            # every other sample, but the maximum must survive every
            # decimation — the upper tail is exactly what p99 exists to
            # surface (plain [::2] drops the current max each round and
            # biases the reported tail low in long soaks)
            tail = self._xs[-1]
            self._xs = self._xs[::2]
            if self._xs[-1] != tail:
                self._xs.append(tail)

    def percentile(self, p: float) -> Optional[float]:
        if not self._xs:
            return None
        idx = min(len(self._xs) - 1, int(round((p / 100.0) * (len(self._xs) - 1))))
        return self._xs[idx]

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50)

    @property
    def p99(self) -> Optional[float]:
        return self.percentile(99)

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def snapshot_ms(self) -> Dict[str, Optional[float]]:
        ms = lambda v: None if v is None else round(v * 1e3, 3)
        return {"p50_ms": ms(self.p50), "p99_ms": ms(self.p99),
                "mean_ms": ms(self.mean), "count": self.count}


class TenantStats:
    """Per-tenant slice of the serving counters (fleet/tenancy.py SLA
    classes). Deliberately lean — counters plus TTFT/e2e histograms —
    because one row exists per tenant label and telemetry cardinality
    is bounded by the tenants actually seen, not a config."""

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0
        self.rejected = 0
        self.sla_violations = 0
        self.sla_tracked = 0
        self.tokens_out = 0
        self.ttft = LatencyHistogram(cap=8192)
        self.e2e = LatencyHistogram(cap=8192)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted, "completed": self.completed,
            "cancelled": self.cancelled, "failed": self.failed,
            "rejected": self.rejected,
            "sla_violations": self.sla_violations,
            "sla_tracked": self.sla_tracked,
            "tokens_out": self.tokens_out,
            "ttft": self.ttft.snapshot_ms(),
            "e2e": self.e2e.snapshot_ms(),
        }


class ServingMetrics:
    """Aggregated serving-tier metrics for one server (or one router)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.start_time = clock()
        self.ttft = LatencyHistogram()
        self.tpot = LatencyHistogram()
        self.e2e = LatencyHistogram()
        self.queue_wait = LatencyHistogram()   # arrival -> admission
        # counters
        self.submitted = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0
        self.rejected = 0          # bounded-ingress overload rejections
        self.preemptions = 0
        self.requeues = 0          # replica-loss / drain requeues
        self.sla_violations = 0
        self.sla_tracked = 0
        # integrity canary: periodic self-submitted seeded
        # greedy probes whose token hash must match a known-good value —
        # a fail means this replica decodes WRONG BITS while looking alive
        self.canary_probes = 0
        self.canary_fails = 0
        self.tokens_out = 0
        self.prompt_tokens = 0
        # last-sampled gauges
        self.queue_depth = 0
        self.inflight = 0
        self.kv_free_blocks = 0
        self.kv_total_blocks = 0
        # prefix-cache / speculative-decode counters, mirrored from the
        # engine's cumulative ReuseStats each loop (sample_reuse) — the
        # engine is the source of truth, these are its last-seen values
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefix_blocks_shared = 0
        self.cow_forks = 0
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # implementation stamp: which attention kernels served this replica
        # (engine_v2 resolution) — the sv/pd ladder rungs and post-hoc
        # readers must know which decode path produced a latency row
        self.attn_impl: Optional[str] = None
        self.decode_attn_impl: Optional[str] = None
        # per-tenant slices, lazily created on first sighting of a tenant
        # name (requests with tenant=None aggregate only into the fleet
        # totals above — no phantom "None" tenant row)
        self.tenants: Dict[str, TenantStats] = {}

    def tenant(self, name: str) -> TenantStats:
        """The (lazily created) per-tenant slice for ``name``."""
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts

    def _tenant_of(self, obj) -> Optional[TenantStats]:
        """Per-tenant slice for a ServedResponse OR a bare Request (the
        door-shed reject path has no response yet); None when untenanted."""
        if obj is None:
            return None
        req = getattr(obj, "request", obj)
        name = getattr(req, "tenant", None)
        return None if name is None else self.tenant(name)

    def stamp_impls(self, attn_impl: Optional[str] = None,
                    decode_attn_impl: Optional[str] = None) -> None:
        """Record the engine's resolved packed-step / fused-decode attention
        implementations (``LLMServer`` stamps these at construction)."""
        if attn_impl:
            self.attn_impl = str(attn_impl)
        if decode_attn_impl:
            self.decode_attn_impl = str(decode_attn_impl)

    # ------------------------------------------------------------------
    def on_submit(self, resp: ServedResponse) -> None:
        self.submitted += 1
        ts = self._tenant_of(resp)
        if ts is not None:
            ts.submitted += 1

    def on_reject(self, resp=None) -> None:
        """An overload/shed rejection. ``resp`` (optional, back-compat: a
        ServedResponse or the bare Request) attributes the rejection to
        its tenant's slice."""
        self.rejected += 1
        ts = self._tenant_of(resp)
        if ts is not None:
            ts.rejected += 1

    def on_finish(self, resp: ServedResponse) -> None:
        ts = self._tenant_of(resp)
        if resp.finish_reason == FINISH_CANCELLED:
            self.cancelled += 1
            if ts is not None:
                ts.cancelled += 1
            return
        if resp.finish_reason == FINISH_FAILED:
            self.failed += 1
            if ts is not None:
                ts.failed += 1
            return
        if resp.finish_reason in (FINISH_EOS, FINISH_LENGTH):
            self.completed += 1
            self.tokens_out += len(resp.tokens)
            self.prompt_tokens += len(resp.request.prompt)
            if resp.ttft_s is not None:
                self.ttft.record(resp.ttft_s)
            if resp.tpot_s is not None:
                self.tpot.record(resp.tpot_s)
            if resp.e2e_s is not None:
                self.e2e.record(resp.e2e_s)
            if resp.admitted_time is not None:
                self.queue_wait.record(resp.admitted_time - resp.arrival_time)
            v = resp.sla_violated()
            if v is not None:
                self.sla_tracked += 1
                self.sla_violations += int(v)
            if ts is not None:
                ts.completed += 1
                ts.tokens_out += len(resp.tokens)
                if resp.ttft_s is not None:
                    ts.ttft.record(resp.ttft_s)
                if resp.e2e_s is not None:
                    ts.e2e.record(resp.e2e_s)
                if v is not None:
                    ts.sla_tracked += 1
                    ts.sla_violations += int(v)

    def sample(self, *, queue_depth: int, inflight: int,
               kv_free_blocks: int, kv_total_blocks: int) -> None:
        self.queue_depth = int(queue_depth)
        self.inflight = int(inflight)
        self.kv_free_blocks = int(kv_free_blocks)
        self.kv_total_blocks = int(kv_total_blocks)

    def sample_reuse(self, reuse) -> None:
        """Mirror the engine's cumulative prefix-cache / speculative-decode
        counters (``engine_v2.ReuseStats`` or any object with the same
        attribute names)."""
        for name in ("prefix_lookups", "prefix_hits", "prefix_tokens_reused",
                     "prefix_blocks_shared", "cow_forks", "spec_steps",
                     "spec_drafted", "spec_accepted"):
            setattr(self, name, int(getattr(reuse, name, 0)))

    def prefix_hit_rate(self) -> Optional[float]:
        """Fraction of admissions that mapped at least one cached block
        (None until the first lookup, i.e. prefix cache off or no traffic)."""
        if not self.prefix_lookups:
            return None
        return self.prefix_hits / self.prefix_lookups

    def spec_acceptance_rate(self) -> Optional[float]:
        """Fraction of drafted tokens the verify pass accepted (None until
        the first draft)."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted

    # ------------------------------------------------------------------
    @property
    def elapsed_s(self) -> float:
        return max(1e-9, self.clock() - self.start_time)

    def tokens_per_sec(self) -> float:
        return self.tokens_out / self.elapsed_s

    def tokens_per_sec_per_chip(self, n_chips: Optional[int] = None) -> float:
        if n_chips is None:
            import torch

            n_chips = (max(1, torch.cuda.device_count())
                       if torch.cuda.is_available() else 1)
        return self.tokens_per_sec() / n_chips

    def kv_occupancy(self) -> Optional[float]:
        if not self.kv_total_blocks:
            return None
        return 1.0 - self.kv_free_blocks / self.kv_total_blocks

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        occ = self.kv_occupancy()
        return {
            "ttft": self.ttft.snapshot_ms(),
            "tpot": self.tpot.snapshot_ms(),
            "e2e": self.e2e.snapshot_ms(),
            "queue_wait": self.queue_wait.snapshot_ms(),
            "submitted": self.submitted, "completed": self.completed,
            "cancelled": self.cancelled, "failed": self.failed,
            "rejected": self.rejected, "preemptions": self.preemptions,
            "requeues": self.requeues,
            "sla_violations": self.sla_violations,
            "sla_tracked": self.sla_tracked,
            "canary_probes": self.canary_probes,
            "canary_fails": self.canary_fails,
            "tokens_out": self.tokens_out,
            "prompt_tokens": self.prompt_tokens,
            "tokens_per_sec": round(self.tokens_per_sec(), 2),
            "queue_depth": self.queue_depth, "inflight": self.inflight,
            "kv_occupancy": None if occ is None else round(occ, 4),
            "elapsed_s": round(self.elapsed_s, 3),
            "attn_impl": self.attn_impl,
            "decode_attn_impl": self.decode_attn_impl,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (None if (hr := self.prefix_hit_rate()) is None
                                else round(hr, 4)),
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "prefix_blocks_shared": self.prefix_blocks_shared,
            "cow_forks": self.cow_forks,
            "spec_steps": self.spec_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": (None
                                     if (ar := self.spec_acceptance_rate())
                                     is None else round(ar, 4)),
            "tenants": {name: ts.snapshot()
                        for name, ts in sorted(self.tenants.items())},
        }

    def monitor_events(self, step: int, prefix: str = "Serving") -> List[Event]:
        """``Monitor.write_events``-compatible ``Serving/*`` events (the
        ledger→monitor bridge contract, ``utils/comms_logging.py``)."""
        events: List[Event] = []

        def put(name, value):
            if value is not None:
                events.append((f"{prefix}/{name}", value, step))

        for hname, h in (("ttft", self.ttft), ("tpot", self.tpot),
                         ("e2e", self.e2e), ("queue_wait", self.queue_wait)):
            put(f"{hname}_p50_ms", None if h.p50 is None else h.p50 * 1e3)
            put(f"{hname}_p99_ms", None if h.p99 is None else h.p99 * 1e3)
        put("tokens_per_sec", self.tokens_per_sec())
        put("queue_depth", self.queue_depth)
        put("inflight", self.inflight)
        put("kv_occupancy", self.kv_occupancy())
        put("completed", self.completed)
        put("preemptions", self.preemptions)
        put("requeues", self.requeues)
        put("rejected", self.rejected)
        put("sla_violations", self.sla_violations)
        put("canary_probes", self.canary_probes)
        put("canary_fails", self.canary_fails)
        put("prefix_hit_rate", self.prefix_hit_rate())
        put("prefix_tokens_reused", self.prefix_tokens_reused)
        put("prefix_blocks_shared", self.prefix_blocks_shared)
        put("cow_forks", self.cow_forks)
        put("spec_acceptance_rate", self.spec_acceptance_rate())
        for name, ts in sorted(self.tenants.items()):
            put(f"tenant/{name}/completed", ts.completed)
            put(f"tenant/{name}/rejected", ts.rejected)
            put(f"tenant/{name}/sla_violations", ts.sla_violations)
        return events
