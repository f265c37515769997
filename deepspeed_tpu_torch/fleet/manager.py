"""FleetManager: the supervisor's actual elastic-scaling actuator.

Port of ``deepspeed_tpu/fleet/manager.py``, whole (host logic only: the
replicas it spawns are the port's ``LLMServer``s or subprocess proxies).

PR 12's control plane can *decide* ``serving_scale`` — ``rule_sla``
fires its registered ``scale_fn`` — but until now nothing in the tree
could actually spawn, warm, join, or drain a replica. The manager is
that actuator:

scale-out (SLA pressure)
    ``manager.scale_out`` IS the ``scale_fn``: attach it via
    ``supervisor.attach_server(server, scale_fn=manager.scale_out)``.
    It walks a fresh :class:`~.lifecycle.ReplicaHandle` through
    spawn → warm → join, so by the time the router can dispatch to the
    new replica its programs are compiled and the cached per-mesh
    winners applied (zero probes — see lifecycle.py). The ledger entry
    ``replica_join`` carries the full :class:`~.lifecycle.WarmReport`.

reap on failure
    if bring-up fails ANYWHERE (the ``replica_spawn_fail`` drill, an
    engine OOM mid-warm, a factory bug), the manager reaps: halts
    whatever half-exists, removes any router registration, marks the
    handle DEAD, records ``replica_reap`` — and re-raises, so
    ``rule_sla``'s existing fallback (record ``failed:<type>``, shed)
    still runs. A failed scale-out never leaks a WARMING entry in the
    router and never strands an engine thread.

scale-in (sustained under-utilization)
    ``manager.poll()`` (call it from the serving poll loop) watches the
    fleet's mean outstanding-per-replica; when it sits below
    ``scale_in_low_watermark`` with more than ``min_replicas`` joined,
    the ``fleet_scale_in`` rule fires through the SAME
    :class:`~deepspeed_tpu_torch.control.guard.FlapGuard` hysteresis/cooldown/
    budget as every other control action, and the LEAST-loaded replica
    drains gracefully (``serving_scale_in`` in the ledger).

Every transition is a ControlLedger entry, so fleet history rides the
registry, the monitor bridge, flight dumps, and the doctor's
supervisor-action evidence for free.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger
from .lifecycle import DEAD, JOINED, ReplicaHandle


class FleetAtCapacity(RuntimeError):
    """scale_out at max_replicas — rule_sla's fallback (shedding) applies."""


class FleetManager:
    def __init__(self, factory: Callable[[int], Any], *,
                 router=None, supervisor=None, ledger=None, guard=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_in_low_watermark: float = 0.5,
                 drain_timeout_s: float = 60.0,
                 autotune_cache_dir: Optional[str] = None,
                 warm_kwargs: Optional[Dict[str, Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.factory = factory
        self.router = router
        self.supervisor = supervisor
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_in_low_watermark = float(scale_in_low_watermark)
        self.drain_timeout_s = drain_timeout_s
        self.autotune_cache_dir = autotune_cache_dir
        self.warm_kwargs = dict(warm_kwargs or {})
        self.clock = clock
        self.handles: Dict[int, ReplicaHandle] = {}
        self._next_rid = 0
        # scale operations are serialized: two SLA ticks firing scale_out
        # concurrently must not both spawn (the guard's cooldown usually
        # prevents it, but the manager must be safe without it)
        self._scale_lock = threading.Lock()
        if ledger is not None:
            self.ledger = ledger
        elif supervisor is not None:
            self.ledger = supervisor.ledger
        else:
            from ..control.ledger import ControlLedger

            self.ledger = ControlLedger()
        if guard is not None:
            self.guard = guard
        elif supervisor is not None:
            self.guard = supervisor.guard
        else:
            from ..control.guard import FlapGuard

            self.guard = FlapGuard(clock=clock)

    # -- bring-up -----------------------------------------------------------
    def _new_handle(self) -> ReplicaHandle:
        rid = self._next_rid
        self._next_rid += 1
        return ReplicaHandle(rid, self.factory,
                             autotune_cache_dir=self.autotune_cache_dir,
                             clock=self.clock, **self.warm_kwargs)

    def start(self, n: int, *, transport=None, dead_after_s: float = 10.0,
              router_kwargs: Optional[Dict[str, Any]] = None):
        """Bring up the initial fleet: spawn+warm ``n`` replicas, build the
        router over them, record their JOINED handles. Returns the router
        (also stored on the manager)."""
        from ..serving.replica import ReplicaRouter

        if self.router is not None:
            raise RuntimeError("fleet already started")
        handles = []
        for _ in range(max(1, int(n))):
            h = self._new_handle()
            try:
                h.spawn()
                h.warm()
            except BaseException:
                self.handles[h.replica_id] = h
                self._reap(h, during="start")
                for prev in handles:    # a failed day-one bring-up is fatal;
                    prev.kill()         # don't leak the siblings' threads
                raise
            handles.append(h)
        kw = dict(router_kwargs or {})
        if transport is not None:
            kw.setdefault("transport", transport)
            kw.setdefault("dead_after_s", dead_after_s)
        self.router = ReplicaRouter([h.server for h in handles],
                                    **kw).start()
        for h in handles:
            # constructor-registered: flip the handle to JOINED directly
            h._set_state(JOINED)
            self.handles[h.replica_id] = h
            self.ledger.record(
                "replica_join", step=0, rule="fleet_start",
                signal=f"initial fleet bring-up ({n} replica(s))",
                reason=f"replica {h.replica_id} warmed and joined",
                params=h.report.to_params())
        return self.router

    # -- scale-out (the supervisor's scale_fn) ------------------------------
    def scale_out(self, sup=None) -> int:
        """Spawn → warm → join one replica; returns its id (rule_sla's
        ledger entry stringifies it as ``added``). Raises on failure AFTER
        reaping, so the SLA rule's shed fallback still engages."""
        with self._scale_lock:
            if self.router is None:
                raise RuntimeError("fleet not started (no router)")
            joined = self._joined()
            if len(joined) >= self.max_replicas:
                raise FleetAtCapacity(
                    f"fleet already at max_replicas={self.max_replicas}")
            handle = self._new_handle()
            self.handles[handle.replica_id] = handle
            step = self._step()
            try:
                report = handle.bring_up(self.router)
            except BaseException as e:
                self._reap(handle, during="scale_out", error=e)
                raise
            how = ("cached winners, zero probes"
                   if report.zero_probe_join() else "probed winners")
            self.ledger.record(
                "replica_join", step=step, rule="fleet_scale_out",
                signal=f"fleet {len(joined)} -> {len(joined) + 1} replica(s)",
                reason=f"replica {handle.replica_id} warmed and joined "
                       f"({how})",
                params=report.to_params())
            logger.info(f"fleet: scaled out to replica {handle.replica_id} "
                        f"(zero_probe={report.zero_probe_join()})")
            return handle.replica_id

    def _reap(self, handle: ReplicaHandle, *, during: str,
              error: Optional[BaseException] = None) -> None:
        """Satellite-6 contract: a failed bring-up leaves NOTHING behind —
        no WARMING entry in the router, no orphan engine thread, no handle
        stuck mid-state. Always records ``replica_reap``."""
        rid = handle.replica_id
        if self.router is not None and rid in getattr(self.router,
                                                      "replicas", {}):
            try:
                self.router.remove_replica(rid)   # also halts the server
            except RuntimeError:
                # it carries tracked work (join succeeded, failure came
                # later): drain instead of stranding its clients
                self.router.drain_replica(rid, self.drain_timeout_s)
        handle.kill()
        self.ledger.record(
            "replica_reap", step=self._step(), rule=f"fleet_{during}",
            signal=f"replica {rid} bring-up failed during {during}",
            reason=f"reaped half-spawned replica {rid}: "
                   f"{type(error).__name__ if error else 'error'}"
                   f"{f': {error}' if error else ''}",
            outcome=f"failed:{type(error).__name__}" if error else "ok")
        logger.warning(f"fleet: reaped replica {rid} after failed {during}")

    # -- scale-in -----------------------------------------------------------
    def poll(self, step: Optional[int] = None) -> Optional[int]:
        """One under-utilization observation; drains the least-loaded
        replica when the ``fleet_scale_in`` rule fires (flap-guarded).
        Returns the drained replica id, or None. Call this from the same
        loop that calls ``router.check()``."""
        if self.router is None:
            return None
        self._reconcile_dead()
        joined = self._joined()
        can_shrink = len(joined) > self.min_replicas
        load = (sum(h.server.outstanding for h in joined) / len(joined)
                if joined else 0.0)
        asserted = can_shrink and load < self.scale_in_low_watermark
        if not self.guard.should_fire("fleet_scale_in", asserted):
            return None
        victim = min(joined, key=lambda h: (h.server.outstanding,
                                            h.replica_id))
        return self.scale_in(victim.replica_id, step=step,
                             signal=f"mean outstanding {load:.2f} < "
                                    f"{self.scale_in_low_watermark:g} across "
                                    f"{len(joined)} replica(s)")

    def scale_in(self, rid: Optional[int] = None, *, step: Optional[int] = None,
                 signal: str = "operator request") -> Optional[int]:
        """Drain one JOINED replica (least-loaded when ``rid`` is None)."""
        with self._scale_lock:
            joined = self._joined()
            if not joined:
                return None
            if rid is None:
                handle = min(joined, key=lambda h: (h.server.outstanding,
                                                    h.replica_id))
            else:
                handle = self.handles[rid]
                if handle.state != JOINED:
                    raise RuntimeError(f"replica {rid} is {handle.state}, "
                                       f"not {JOINED}")
            ok = handle.drain(self.router, self.drain_timeout_s)
            self.ledger.record(
                "serving_scale_in", step=step if step is not None
                else self._step(),
                rule="fleet_scale_in", signal=signal,
                reason=f"drained least-loaded replica {handle.replica_id}",
                params={"replica": str(handle.replica_id),
                        "drained_clean": str(bool(ok))},
                outcome="ok" if ok else "failed:drain-timeout")
            logger.info(f"fleet: scaled in replica {handle.replica_id} "
                        f"(clean={ok})")
            return handle.replica_id

    def _reconcile_dead(self) -> None:
        """Fold router-declared deaths (chaos kill, process loss) back into
        handle state. The router's takeover already requeued the victim's
        work; without this the dead replica would still look JOINED to
        scale-in and could be picked as the least-loaded drain victim."""
        dead = getattr(self.router, "dead_ids", lambda: [])()
        for rid in dead:
            h = self.handles.get(rid)
            if h is None or h.state == DEAD:
                continue
            h.kill()
            self.ledger.record(
                "replica_reap", step=self._step(), rule="fleet_reconcile",
                signal=f"router declared replica {rid} dead",
                reason=f"replica {rid} died outside the fleet's control; "
                       f"handle reconciled (work already requeued)")
            logger.warning(f"fleet: reconciled dead replica {rid}")
            # the death changed the topology: an sla_pressure rule that
            # latched in the OLD fleet (e.g. a scale-out rejected at
            # capacity) must not block the first scale-out of the new,
            # smaller one — re-arm it (cooldown and budget still apply)
            if self.supervisor is not None and \
                    getattr(self.supervisor, "guard", None) is not None:
                self.supervisor.guard.rearm("sla_pressure")

    # -- views --------------------------------------------------------------
    def _joined(self) -> List[ReplicaHandle]:
        return [h for h in self.handles.values() if h.state == JOINED]

    def _step(self) -> int:
        """Best-effort fleet step stamp for ledger entries: the max serving
        step across joined replicas (fleet time moves with its engines)."""
        steps = [getattr(h.server, "_steps", 0) for h in self._joined()
                 if h.server is not None]
        return max(steps, default=0)

    def describe(self) -> Dict[str, Any]:
        return {"replicas": {rid: h.describe()
                             for rid, h in sorted(self.handles.items())},
                "joined": [h.replica_id for h in self._joined()],
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}

    def close(self) -> None:
        """Halt everything (tests / bench teardown; production exits drain)."""
        for h in self.handles.values():
            if h.state not in (DEAD,):
                h.kill()
        if self.router is not None:
            self.router.close()
