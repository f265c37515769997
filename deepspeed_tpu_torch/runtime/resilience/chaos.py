"""Full-stack chaos engine: deterministic fault schedules across

Port of ``deepspeed_tpu/runtime/resilience/chaos.py``, host logic unchanged.
transport / serving / control.

:class:`~.faults.FaultPlan` proved the pattern for the *training* loop —
every failure mode a scheduled, repeatable, one-shot-audited event — but
its injection surface stops at loss/grad metrics and snapshot hooks. The
serving tier, the non-collective transports (heartbeat beacons over the
object store, the plan cache, the snapshot manifest commit), and the
control plane's health signals had no drill harness at all: their failure
handling was only exercised by real failures. :class:`ChaosSchedule`
generalizes the plan to the whole stack:

transport layer
    ``transport_put_error`` / ``transport_get_error`` — transient
    object-store PUT/GET failures (retried by ``utils/retry.py``);
    ``torn_beacon`` — a beacon body truncated mid-PUT (readers must treat
    it as absent); ``plan_cache_error`` — transient plan-cache read
    errors; ``snapshot_io_error`` — transient snapshot-commit I/O errors.

serving layer
    ``replica_kill`` — a replica dies at serving step N (engine thread
    stops, beacon goes stale; the router's dead-replica takeover must
    resume its work); ``kv_exhaustion`` — the admission pool reads dry for
    a few cycles; ``slow_prefill`` — a stalled/slow prefill step;
    ``drop_token`` — a sampled token's stream delivery is lost (the
    delivered-token dedup cursor must re-deliver it exactly once);
    ``replica_spawn_fail`` — a fleet scale-out's replica bring-up fails
    before the server exists (the FleetManager must reap the half-spawned
    handle, never leak a WARMING router entry); ``replica_slow_warm`` — a
    joining replica's warm-up stalls ``param`` seconds (the router's warm
    gate must keep traffic off it the whole time).

control layer
    ``stale_health`` — a health-table refresh returns the previous rows
    (stale data the flap guard must ride out); ``flap_straggler`` — a
    rank's straggler verdict flaps on alternate reads.

Each :class:`ChaosEvent` arms at the ``at``-th call of its injection site
and fires ``count`` consecutive times, exactly once per event — the
``fired`` audit trail records what actually happened (and rides
``chaos-schedule.json`` so the post-mortem doctor can name
every injected fault in its post-mortem). Schedules are seeded:
:meth:`ChaosSchedule.generate` derives the ``at`` indices from a
``random.Random(seed)``, so the same seed replays the same chaos.

Training-layer injections (NaN loss, grad spikes, preemption, torn
snapshot writes, hangs, stragglers, beacon loss) ride along unchanged as a
nested :class:`~.faults.FaultPlan` (``ChaosSchedule.training``), which the
``ResilienceManager`` adopts when the ``chaos:`` block carries one.

Injection sites consult the process-global schedule through
:func:`get_chaos`; with no ``chaos:`` block configured the global is None
and every hook is a single attribute test — the stack is bitwise identical
to a tree without the subsystem.

Stdlib-only (no torch import): drill scripts and the stdlib transports
(``heartbeat.py``) import this without touching a backend.
"""

import json
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .faults import FaultPlan

try:
    from ...utils.logging import logger
except ImportError:  # loaded standalone (file-path import in drill scripts)
    import logging

    logger = logging.getLogger("deepspeed_tpu_torch.chaos")

#: fault class -> layer (the taxonomy the docs/doctor report by)
FAULT_CLASSES: Dict[str, str] = {
    "transport_put_error": "transport",
    "transport_get_error": "transport",
    "torn_beacon": "transport",
    "plan_cache_error": "transport",
    "snapshot_io_error": "transport",
    "replica_kill": "serving",
    "kv_exhaustion": "serving",
    "slow_prefill": "serving",
    "drop_token": "serving",
    "replica_spawn_fail": "serving",
    "replica_slow_warm": "serving",
    "stale_health": "control",
    "flap_straggler": "control",
    # silent-data-corruption drills: ride the nested training FaultPlan
    # (sdc_transient_at_steps / sdc_sticky_from_step), not poll() sites —
    # registered here so the taxonomy, manifest validation, and the
    # doctor's named-fault evidence cover them like every other class
    "sdc_bitflip_transient": "training",
    "sdc_bitflip_sticky": "training",
}

#: per-class defaults for seeded generation: (count, param)
_GENERATE_DEFAULTS: Dict[str, Any] = {
    "transport_put_error": (2, 0.0),
    "transport_get_error": (2, 0.0),
    "torn_beacon": (1, 0.0),
    "plan_cache_error": (2, 0.0),
    "snapshot_io_error": (2, 0.0),
    "replica_kill": (1, 0.0),
    "kv_exhaustion": (3, 0.0),
    "slow_prefill": (1, 0.05),
    "drop_token": (1, 0.0),
    "replica_spawn_fail": (1, 0.0),
    "replica_slow_warm": (1, 0.05),
    "stale_health": (1, 0.0),
    "flap_straggler": (4, 0.0),
}

MANIFEST_NAME = "chaos-schedule.json"


class ChaosInjectedError(OSError):
    """A scheduled transient transport error (never raised outside chaos
    schedules). An OSError so the retry classification treats it exactly
    like the real failure it stands in for."""


@dataclass
class ChaosEvent:
    """One scheduled fault: arms at the ``at``-th call of a matching
    injection site, then fires ``count`` consecutive times."""
    kind: str
    site: str = ""        # "" matches every site consulting this kind
    at: int = 0           # 0-based index of the arming call
    count: int = 1        # consecutive firings once armed
    param: float = 0.0    # class-specific magnitude (sleep seconds, rank..)
    # runtime state (not part of the schedule identity)
    armed: bool = field(default=False, compare=False)
    remaining: int = field(default=0, compare=False)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "site": self.site, "at": self.at,
                "count": self.count, "param": self.param}


class ChaosSchedule:
    """Seeded, one-shot-audited fault schedule across the whole stack."""

    def __init__(self, events: List[ChaosEvent], *, seed: int = 0,
                 training: Optional[FaultPlan] = None):
        for ev in events:
            if ev.kind not in FAULT_CLASSES:
                raise ValueError(
                    f"unknown chaos fault class {ev.kind!r}; "
                    f"choose from {sorted(FAULT_CLASSES)}")
        self.seed = int(seed)
        self.events = list(events)
        self.training = training
        self.fired: List[dict] = []   # (kind/site/at/layer/param) audit trail
        self._calls: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._by_kind: Dict[str, List[ChaosEvent]] = {}
        for ev in self.events:
            self._by_kind.setdefault(ev.kind, []).append(ev)

    # -- construction ----------------------------------------------------
    @classmethod
    def generate(cls, seed: int, classes: List[str], *, horizon: int = 64,
                 events_per_class: int = 1,
                 sites: Optional[Dict[str, str]] = None,
                 training: Optional[FaultPlan] = None) -> "ChaosSchedule":
        """Seeded schedule: for each listed fault class, draw
        ``events_per_class`` arming indices uniformly over ``[0, horizon)``
        from ``random.Random(seed)``. Same seed => same schedule."""
        rng = random.Random(int(seed))
        events: List[ChaosEvent] = []
        for kind in classes:
            if kind not in FAULT_CLASSES:
                raise ValueError(f"unknown chaos fault class {kind!r}")
            count, param = _GENERATE_DEFAULTS.get(kind, (1, 0.0))
            for _ in range(max(1, int(events_per_class))):
                events.append(ChaosEvent(
                    kind=kind, site=(sites or {}).get(kind, ""),
                    at=rng.randrange(max(1, int(horizon))),
                    count=count, param=param))
        return cls(events, seed=seed, training=training)

    @classmethod
    def from_config(cls, cfg) -> "ChaosSchedule":
        """Build from a ``chaos:`` config block (``runtime/config.py``
        ChaosConfig): explicit ``events`` dicts first, then the seeded
        ``classes`` auto-generation, plus the nested training FaultPlan."""
        events = []
        for e in (getattr(cfg, "events", None) or []):
            if not isinstance(e, dict) or "kind" not in e:
                raise ValueError(
                    f"chaos.events entries are dicts with a 'kind' key "
                    f"(one of {sorted(FAULT_CLASSES)}); got {e!r}")
            events.append(ChaosEvent(kind=e["kind"], site=e.get("site", ""),
                                     at=int(e.get("at", 0)),
                                     count=int(e.get("count", 1)),
                                     param=float(e.get("param", 0.0))))
        training = None
        tr = getattr(cfg, "training", None)
        if tr is not None and getattr(tr, "enabled", False):
            training = FaultPlan.from_config(tr)
        classes = list(getattr(cfg, "classes", None) or [])
        if classes:
            gen = cls.generate(getattr(cfg, "seed", 0), classes,
                               horizon=getattr(cfg, "horizon", 64),
                               events_per_class=getattr(
                                   cfg, "events_per_class", 1))
            events.extend(gen.events)
        return cls(events, seed=getattr(cfg, "seed", 0), training=training)

    # -- the injection-site API ------------------------------------------
    def poll(self, kind: str, site: str) -> Optional[ChaosEvent]:
        """One consult from an injection site: increments the (kind, site)
        call counter, arms any matching event whose ``at`` index this call
        reaches (audited ONCE into ``fired``), and returns the event while
        it still has firings left — else None."""
        with self._lock:
            key = (kind, site)
            idx = self._calls.get(key, 0)
            self._calls[key] = idx + 1
            matching = [ev for ev in self._by_kind.get(kind, ())
                        if not ev.site or ev.site == site]
            # arm FIRST, for every matching event: an event whose `at`
            # index lands inside an earlier event's firing window must
            # still arm this call — the call counter never revisits an
            # index, so skipping the arming here would silently drop the
            # injection (and undercount the audited schedule)
            for ev in matching:
                if not ev.armed and idx == ev.at:
                    ev.armed = True
                    ev.remaining = max(1, ev.count)
                    self.fired.append({
                        "kind": kind, "site": site, "at": idx,
                        "count": ev.count, "param": ev.param,
                        "layer": FAULT_CLASSES[kind]})
                    logger.warning(f"chaos: {kind}@{site} armed at call "
                                   f"{idx} (x{ev.count})")
            for ev in matching:
                if ev.armed and ev.remaining > 0:
                    ev.remaining -= 1
                    return ev
        return None

    def fire(self, kind: str, site: str) -> bool:
        """One-shot boolean consult (serving/control sites)."""
        return self.poll(kind, site) is not None

    def value(self, kind: str, site: str) -> Optional[float]:
        """Like :meth:`fire` but returns the event's ``param`` (sleep
        seconds, target rank, ...) when it fires."""
        ev = self.poll(kind, site)
        return None if ev is None else ev.param

    def maybe_raise(self, kind: str, site: str) -> None:
        """Transport sites: raise a transient :class:`ChaosInjectedError`
        while the matching event fires (the retry loop absorbs it)."""
        ev = self.poll(kind, site)
        if ev is not None:
            raise ChaosInjectedError(f"chaos[{kind}@{site}]")

    def mangle_bytes(self, kind: str, site: str, data: bytes) -> bytes:
        """Torn-write sites: truncate the payload mid-body while the
        matching event fires (a reader must see garbage, never half-new)."""
        ev = self.poll(kind, site)
        if ev is None:
            return data
        return data[:max(1, len(data) // 2)]

    # -- audit / manifest ------------------------------------------------
    def all_fired(self) -> List[dict]:
        """The full audit trail including the nested training plan's
        ``fired`` entries (as ``site="training"`` rows)."""
        out = list(self.fired)
        if self.training is not None:
            out += [{"kind": kind, "site": "training", "at": step,
                     "layer": "training"}
                    for step, kind in self.training.fired]
        return out

    def classes_fired(self) -> List[str]:
        return sorted({e["kind"] for e in self.all_fired()})

    def to_manifest(self) -> dict:
        return {"version": 1, "seed": self.seed,
                "events": [ev.to_dict() for ev in self.events],
                "fired": self.all_fired()}

    def dump(self, directory: str) -> str:
        """Write ``chaos-schedule.json`` beside the fleet's other crash
        artifacts so the doctor's post-mortem can name every injected
        fault. Returns the path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, MANIFEST_NAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_manifest(), f, indent=1)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# process-global schedule: injection sites consult this; None = chaos off
# and every hook is a single attribute test (bitwise off-identity)
# ---------------------------------------------------------------------------

_CHAOS: Optional[ChaosSchedule] = None
_FROM_CONFIG = False   # provenance: installed by an engine's chaos: block?


def configure_chaos(schedule: Optional[ChaosSchedule]
                    ) -> Optional[ChaosSchedule]:
    """Install (or clear, with None) the process-wide chaos schedule.
    Schedules installed this way (benches, tests) are MANUAL: an engine
    built from a chaos-FREE config leaves them alone (the caller owns the
    lifecycle), while an engine whose config carries its own enabled
    ``chaos:`` block installs that schedule instead — an explicit config
    always wins over an ambient manual install."""
    global _CHAOS, _FROM_CONFIG
    _CHAOS = schedule
    _FROM_CONFIG = False
    return schedule


def _training_identity(plan: Optional[FaultPlan]):
    """The *schedule* identity of a training FaultPlan (runtime state —
    ``fired``/``_spent`` — excluded): what two configs must agree on for
    their chaos blocks to count as the same drill."""
    if plan is None:
        return None
    return (plan.nan_loss_at_steps, plan.grad_spike_at_steps,
            plan.spike_magnitude, plan.preempt_at_step,
            plan.torn_write_at_steps, plan.crash_before_commit_at_steps,
            plan.hang_at_step, plan.slow_rank, plan.slow_step_s,
            plan.heartbeat_loss_at_steps, plan.sdc_transient_at_steps,
            plan.sdc_sticky_from_step, plan.sdc_rank, plan.sdc_bit)


def install_chaos_from_config(cfg) -> ChaosSchedule:
    """Engine-init install path for the ``chaos:`` config block. Building
    several engines from the SAME drill config (the autotuner's probe
    engines, a restart in-process) must not reset the one-shot audit
    trail and re-arm already-fired events — when a config-installed
    schedule with the same seed+events+training plan is already live, it
    is kept (counters and ``fired`` intact) instead of being rebuilt. A
    config that differs in ANY schedule dimension (including only the
    nested training block) replaces the live schedule."""
    global _CHAOS, _FROM_CONFIG
    new = ChaosSchedule.from_config(cfg)
    cur = _CHAOS
    if (_FROM_CONFIG and cur is not None and cur.seed == new.seed
            and [e.to_dict() for e in cur.events]
            == [e.to_dict() for e in new.events]
            and _training_identity(cur.training)
            == _training_identity(new.training)):
        return cur
    _CHAOS = new
    _FROM_CONFIG = True
    return new


def clear_config_chaos() -> None:
    """Engine-init path for configs WITHOUT a chaos block: clears a
    previously config-installed schedule (the off-identity contract is
    per-config), but never touches a manually-installed one — a bench
    mid-drill may legitimately build chaos-free reference engines."""
    global _CHAOS, _FROM_CONFIG
    if _FROM_CONFIG:
        _CHAOS = None
        _FROM_CONFIG = False


def get_chaos() -> Optional[ChaosSchedule]:
    return _CHAOS


def chaos_active() -> bool:
    return _CHAOS is not None
