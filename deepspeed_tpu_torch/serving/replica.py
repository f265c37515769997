"""Multi-replica routing with heartbeat-derived health.

Port of ``deepspeed_tpu/serving/replica.py``, host logic unchanged.

A serving fleet is N independent :class:`~.server.LLMServer` replicas (one
engine each — model replicas, not shards); the router in front of them:

* **dispatches** each request to the least-loaded replica that is alive
  (``HealthTable`` verdict over the replicas' heartbeat beacons) and
  not draining;
* **requeues** on failure: the router tracks every in-flight assignment
  itself, so when a replica's beacon goes stale (``dead_after_s``) its
  unfinished requests are resubmitted to the survivors with the SAME
  response handles — the client's ``wait()`` never learns which replica
  served it. Requeues *resume*: the generated prefix up to the response's
  last checkpoint survives, the survivor runs one prefill over
  prompt+generated, and the delivered-token cursor keeps stream callbacks
  exactly-once. The SLA clock keeps running, ``preemptions`` counts the
  restart, and a per-request requeue budget (``Request.max_restarts``)
  turns the Nth restart into ``FINISH_FAILED`` instead of an infinite
  bounce between dying replicas;
* **drains** gracefully: ``drain_replica`` stops dispatch to one replica
  and lets its in-flight work finish (maintenance), ``drain()`` does the
  fleet.

Transport is the resilience tier's pluggable beacon protocol
(``runtime/resilience/heartbeat.py`` ``FileHeartbeatTransport``): in one
process it is a tmpdir, on a real fleet a shared bucket — the router only
reads verdicts, never the replicas' memory, so the same logic serves both.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from ..runtime.resilience.heartbeat import HealthTable, HeartbeatWriter
from ..utils.logging import logger
from .request import (FINISH_EOS, FINISH_FAILED, FINISH_LENGTH, Request,
                      ServedResponse)
from .server import LLMServer, ServerClosed, ServerOverloaded


class ReplicaRouter:
    def __init__(self, replicas: List[LLMServer], *, transport=None,
                 dead_after_s: float = 10.0,
                 clock: Callable[[], float] = time.time,
                 response_clock: Callable[[], float] = time.monotonic):
        if not replicas:
            raise ValueError("need at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas: Dict[int, LLMServer] = {r.replica_id: r
                                               for r in replicas}
        self.clock = clock              # wall time, for beacon ages only
        # timestamps stamped ONTO responses must share the servers' clock
        # domain (LLMServer defaults to time.monotonic) — mixing wall time
        # into arrival/finish stamps would corrupt e2e_s / sla_violated()
        self.response_clock = response_clock
        self.health: Optional[HealthTable] = None
        if transport is not None:
            self.health = HealthTable(transport, dead_after_s=dead_after_s,
                                      clock=clock)
            for r in replicas:
                if r.heartbeat is None:
                    r.heartbeat = HeartbeatWriter(transport, r.replica_id,
                                                  clock=clock)
        self._lock = threading.Lock()
        # router-side assignment book: uid is replica-local, so key by the
        # response object itself
        self._assigned: Dict[int, Dict[int, ServedResponse]] = \
            {rid: {} for rid in self.replicas}
        self._draining: set = set()
        self._dead: set = set()
        # warm gate: replicas joined via add_replica whose engine has not
        # yet compiled a step. A WARMING replica is registered (heartbeat,
        # health, takeover all cover it) but receives NO dispatch until it
        # reports warm — its first step may build kernels for tens of
        # seconds long, and routing a storm into it would park real
        # requests behind that build. Constructor-passed replicas are
        # bootstrap capacity and are not gated (there is no older replica
        # to prefer — day-one behavior is unchanged).
        self._warming: set = set()
        self._closed = False
        self.requeues = 0

    # ------------------------------------------------------------------
    def start(self) -> "ReplicaRouter":
        for r in self.replicas.values():
            r.start()
        return self

    def alive_ids(self) -> List[int]:
        """Replica ids currently eligible for dispatch."""
        # copy under the lock: check()/_take_over()/drain_replica() mutate
        # these sets from an operator thread while client submits read them
        with self._lock:
            # lazy warm-gate promotion: the engine thread flips
            # server.warmed after its first completed step; the next
            # routing decision (here) observes it — no callback plumbing
            # through the engine loop
            for rid in list(self._warming):
                srv = self.replicas.get(rid)
                if srv is None or getattr(srv, "warmed", True):
                    self._warming.discard(rid)
            dead = set(self._dead)
            draining = set(self._draining)
            warming = set(self._warming)
        if self.health is not None:
            beacons = {row.rank: row for row in self.health.read()}
            for rid in self.replicas:
                row = beacons.get(rid)
                # no beacon yet = still warming up, give benefit of the doubt
                if row is not None and not row.alive:
                    dead.add(rid)
        return [rid for rid in self.replicas
                if rid not in dead and rid not in draining
                and rid not in warming
                and self.replicas[rid].error is None]

    def _pick(self, exclude=()) -> LLMServer:
        alive = [rid for rid in self.alive_ids() if rid not in exclude]
        if not alive:
            raise ServerClosed("no live replica available")
        # a replica's own `outstanding` already counts every unfinished
        # request it holds — router-dispatched AND direct submits alike; the
        # assignment book is requeue tracking, adding it would double-weight
        # router traffic
        rid = min(alive, key=lambda i: (self.replicas[i].outstanding, i))
        return self.replicas[rid]

    # ------------------------------------------------------------------
    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None) -> ServedResponse:
        """Dispatch to the least-loaded live replica. Raises
        :class:`ServerOverloaded` only when EVERY live replica sheds."""
        last_err: Optional[Exception] = None
        tried: set = set()              # a shed replica is out for THIS call:
        for _ in range(len(self.replicas)):  # retrying it would starve peers
            try:
                server = self._pick(exclude=tried)
            except ServerClosed as e:
                last_err = last_err or e
                break
            try:
                resp = server.submit(request, block=block, timeout=timeout)
            except (ServerOverloaded, ServerClosed) as e:
                last_err = e
                tried.add(server.replica_id)
                if isinstance(e, ServerClosed):
                    # conclusively not accepting (halted/closed outside the
                    # router): take it over NOW — merely excluding it would
                    # leave its in-flight work unrequeued until (never, if
                    # its beacon stays fresh) check() notices
                    self._take_over(server.replica_id)
                continue
            self._track(server.replica_id, resp)
            return resp
        raise last_err if last_err is not None else ServerClosed("no replica")

    def _track(self, rid: int, resp: ServedResponse) -> None:
        with self._lock:
            closed = self._closed
            dead = rid in self._dead
            if not closed and not dead:
                self._assigned[rid][id(resp)] = resp
        if closed:
            # a submit that passed the replica's admission check while
            # close() was snapshotting the book: nothing will ever serve
            # it and it missed the close-time failure sweep. Fail it HERE
            # so the client's wait(timeout=None) cannot hang on a closed
            # router — unless the owning engine thread is still running
            # (close()'s timed join can be outrun by a submit that landed
            # in ingress), in which case failing would race _on_token on
            # the same handle: defer to the book like close() does for
            # wedged replicas, and a second close() sweeps it.
            srv = self.replicas.get(rid)
            if (srv is not None and srv._thread is not None
                    and srv._thread.is_alive()):
                with self._lock:
                    self._assigned.setdefault(rid, {})[id(resp)] = resp
                # the untrack hook still applies: if the outrunning engine
                # thread finishes this response normally, the book entry
                # must not linger and inflate `outstanding` forever
                resp.on_finish = lambda r, rid=rid: self._untrack(rid, r)
                if resp.done:
                    self._untrack(rid, resp)
                return
            if not resp.done:
                resp._on_finish(FINISH_FAILED, self.response_clock())
                if srv is not None:
                    srv.metrics.on_finish(resp)
            return
        if dead:
            # submit raced _take_over: the replica was declared dead (its
            # book already swept) between _pick and this call, so nothing
            # will ever serve, requeue, or fail this handle from the
            # takeover path — recover it exactly like takeover would
            logger.warning(f"serving: submit raced the takeover of dead "
                           f"replica {rid}; redirecting its request")
            self._requeue_or_fail(resp, rid)
            return
        resp.on_finish = lambda r, rid=rid: self._untrack(rid, r)
        if resp.done:     # finished before the hook landed: untrack now
            self._untrack(rid, resp)

    def _untrack(self, rid: int, resp: ServedResponse) -> None:
        with self._lock:
            self._assigned[rid].pop(id(resp), None)

    # ------------------------------------------------------------------
    def check(self) -> List[int]:
        """Poll replica health; requeue every unfinished request of a newly
        dead replica onto the survivors. Returns the replica ids declared
        dead by this call. Call periodically (or after a suspicious
        latency) — the router has no background thread of its own."""
        if self.health is None:
            return []
        newly_dead = []
        rows = {row.rank: row for row in self.health.read()}
        with self._lock:
            already_dead = set(self._dead)
        for rid in list(self.replicas):
            if rid in already_dead:
                continue
            row = rows.get(rid)
            if row is not None and not row.alive:
                newly_dead.append(rid)
        return [rid for rid in newly_dead if self._take_over(rid)]

    def _take_over(self, rid: int) -> bool:
        server = self.replicas[rid]
        server.halt()
        if server._thread is not None and server._thread.is_alive():
            # live-but-wedged (e.g. stuck in a long kernel build): requeueing now
            # would race its engine thread mutating the same response
            # handles. Defer — a later check() (or submit failure) retries.
            logger.warning(f"serving: replica {rid} looks dead but its "
                           f"engine thread is still running; deferring "
                           f"takeover")
            return False
        with self._lock:
            self._dead.add(rid)
            tracked = list(self._assigned[rid].values())
            self._assigned[rid].clear()
        logger.warning(f"serving: replica {rid} declared dead; "
                       f"requeueing its work")
        # the authoritative set is the router's own book; stealing from the
        # halted server only resets engine-side state for handles we track
        # (a truly lost process leaves nothing to steal — the book suffices)
        try:
            server.steal_unfinished()
        except Exception:
            pass  # swallow-ok: best-effort engine-state reset on a dead replica; the book is authoritative
        for resp in tracked:
            self._requeue_or_fail(resp, rid)
        return True

    def _requeue_or_fail(self, resp: ServedResponse, rid: int) -> None:
        """Move one unfinished response off dead replica ``rid``: charge
        the requeue budget, resume-requeue onto a survivor, or fail the
        handle. Shared by the takeover loop and the submit-vs-takeover
        race recovery in ``_track``."""
        if resp.done:
            return
        server = self.replicas[rid]
        req = resp.request
        reason = resp.derived_finish_reason()
        if reason == FINISH_EOS or len(resp.tokens) >= req.max_new_tokens:
            # the dead replica had already generated everything — only the
            # finish bookkeeping died with it. Complete the handle here:
            # resubmitting would overrun max_new_tokens by the resume
            # clamp (and, at exactly max_seq_len, wedge the head of the
            # survivor's queue on an unschedulable +1-token prefill).
            resp._on_finish(reason, self.response_clock())
            server.metrics.on_finish(resp)
            return
        resp.requeues += 1
        self.requeues += 1
        # per-request retry budget, checked BEFORE any state reset: the
        # Nth replica-loss requeue fails the handle instead of bouncing
        # it between dying replicas forever, and a budget-failed
        # response keeps its full token list consistent with what was
        # already streamed (truncating to the checkpoint first would
        # desync tokens from the delivered stream)
        if resp.requeues > resp.request.max_restarts:
            logger.warning(
                f"serving: request uid={resp.uid} exceeded its requeue "
                f"budget ({resp.request.max_restarts}); failing it")
            resp._on_finish(FINISH_FAILED, self.response_clock())
            server.metrics.on_finish(resp)
            return
        # resume=True: the generated prefix up to the response's last
        # checkpoint survives — the survivor runs ONE prefill over
        # prompt+generated and continues, instead of replaying and
        # re-delivering the whole request (the delivered-token cursor
        # keeps stream callbacks exactly-once either way)
        full_tokens = list(resp.tokens)     # restored if the resubmit fails
        resp._on_requeue(resume=True)   # the one place restarts are counted
        # a resubmit failure (no live replica, a survivor shedding or
        # closing between _pick and submit, or a survivor whose ingress
        # stays full past the bounded timeout — an unbounded blocking put
        # here could wedge check() forever on an undetected-dead peer)
        # must fail THIS response, never abort the caller's loop
        try:
            target = self._pick()
            target.submit(resp.request, block=True, timeout=5.0,
                          _response=resp)
        except (ServerClosed, ServerOverloaded) as e:
            logger.warning(f"serving: could not requeue a request from "
                           f"dead replica {rid}: {e!r}")
            # un-truncate before failing: a failed handle must keep its
            # token list consistent with what was already streamed (the
            # checkpoint truncation only ever serves a successful resume)
            resp.tokens[:] = full_tokens
            resp._on_finish(FINISH_FAILED, self.response_clock())
            # every other finish path reports to a ServingMetrics; use
            # the dead replica's (which admitted it) so failed counters
            # still reconcile with submissions
            server.metrics.on_finish(resp)
            return
        self._track(target.replica_id, resp)

    # ------------------------------------------------------------------
    def add_replica(self, server: LLMServer, *,
                    ready: Optional[bool] = None) -> None:
        """Scale-out: register (and start) a new replica — the control
        plane's ``serving_scale`` actuator (``control/policy.py
        rule_sla``) reaches this through its ``scale_fn`` (now normally
        the fleet tier's :class:`~..fleet.manager.FleetManager`). The new
        replica joins the heartbeat transport when the router has one, so
        health verdicts cover it immediately.

        Warm gate: ``ready`` says whether the replica may take traffic
        NOW. ``None`` (default) reads the server's own ``warmed`` flag —
        an ``LLMServer`` is warm after its first completed engine step, a
        fleet-warmed replica (fleet/lifecycle.py) joins pre-warmed, and
        an object without the flag is assumed ready (pre-gate servers).
        A not-ready replica is registered but excluded from dispatch
        until ``server.warmed`` flips (observed lazily by
        :meth:`alive_ids`) or :meth:`mark_ready` is called."""
        rid = int(server.replica_id)
        ready = (bool(getattr(server, "warmed", True)) if ready is None
                 else bool(ready))
        with self._lock:
            if rid in self.replicas:
                raise ValueError(f"replica id {rid} already registered")
            self.replicas[rid] = server
            self._assigned[rid] = {}
            self._dead.discard(rid)
            self._draining.discard(rid)
            if not ready:
                self._warming.add(rid)
        if self.health is not None and server.heartbeat is None:
            server.heartbeat = HeartbeatWriter(self.health.transport, rid,
                                               clock=self.clock)
        server.start()
        logger.info(f"serving: replica {rid} added to the router "
                    f"({len(self.replicas)} total"
                    f"{', warming' if not ready else ''})")

    def mark_ready(self, rid: int) -> None:
        """Promote a WARMING replica to dispatchable (the lifecycle's
        explicit join step; ``alive_ids`` also promotes lazily once the
        server's own ``warmed`` flag flips)."""
        with self._lock:
            self._warming.discard(rid)

    def remove_replica(self, rid: int) -> LLMServer:
        """Unregister a replica that never carried work — the
        FleetManager's reap path for a scale-out that failed mid-warm. A
        replica with tracked in-flight assignments must go through
        ``drain_replica`` or the dead-takeover instead: silently dropping
        its book would strand those clients forever."""
        with self._lock:
            server = self.replicas.get(rid)
            if server is None:
                raise KeyError(f"replica id {rid} not registered")
            if self._assigned.get(rid):
                raise RuntimeError(
                    f"replica {rid} has {len(self._assigned[rid])} tracked "
                    f"request(s); drain it instead of removing it")
            del self.replicas[rid]
            self._assigned.pop(rid, None)
            self._warming.discard(rid)
            self._draining.discard(rid)
            self._dead.discard(rid)
        server.halt()
        logger.info(f"serving: replica {rid} removed from the router "
                    f"({len(self.replicas)} total)")
        return server

    def dead_ids(self) -> List[int]:
        """Replica ids this router has declared dead (takeover complete,
        their in-flight work already requeued). The FleetManager reads
        this to reconcile its handle states after a chaos kill / process
        loss it did not itself initiate."""
        with self._lock:
            return sorted(self._dead)

    def drain_replica(self, rid: int, timeout: Optional[float] = None) -> bool:
        """Graceful maintenance drain: stop dispatching to ``rid``, let its
        in-flight requests finish, then stop its engine thread."""
        with self._lock:
            self._draining.add(rid)
        return self.replicas[rid].drain(timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            dead = set(self._dead)
        ok = True
        for rid in list(self.replicas):
            if rid in dead:
                continue
            ok = self.drain_replica(rid, timeout) and ok
        return ok

    def close(self) -> None:
        """Abrupt fleet shutdown. Every replica halts WITHOUT finishing its
        in-flight work, and every unfinished handle still in the assignment
        book is failed (``FINISH_FAILED``) — once the router stops
        checking, nothing will ever finish those responses, and a client
        blocked in ``wait(timeout=None)`` would otherwise hang forever.

        ``halt()``'s thread join is TIMED: a replica wedged past it (a long
        kernel build mid-step — the same case ``_take_over`` defers for)
        still has a live engine thread mutating its handles, so failing
        them here would race ``_on_token``/``_on_finish``. Those handles
        stay in the book instead; call ``close()`` again once the wedge
        clears (or let the finishing thread resolve them)."""
        with self._lock:
            self._closed = True     # _track now fails late-racing submits
            self._draining.update(self.replicas)
            tracked = [r for book in self._assigned.values()
                       for r in book.values()]
            for book in self._assigned.values():
                book.clear()
        for server in self.replicas.values():
            server.halt()
        stopped = {rid: not (s._thread is not None and s._thread.is_alive())
                   for rid, s in self.replicas.items()}
        # second sweep: a submit racing this close() may have re-booked a
        # handle (via _track's closed-branch deferral) AFTER the snapshot
        # above but BEFORE its replica's halt() join finished — once that
        # thread is stopped, nothing but this sweep will ever fail it
        with self._lock:
            for rid in list(self._assigned):
                if stopped.get(rid, True):
                    tracked.extend(self._assigned[rid].values())
                    self._assigned[rid].clear()
        now = self.response_clock()
        for resp in tracked:
            if resp.done:
                continue
            rid = resp.replica_id
            if not stopped.get(rid, True):
                logger.warning(
                    f"serving: replica {rid} engine thread outlived halt(); "
                    f"deferring failure of its in-flight handles (call "
                    f"close() again once it stops)")
                with self._lock:
                    self._assigned.setdefault(rid, {})[id(resp)] = resp
                continue
            resp._on_finish(FINISH_FAILED, now)
            srv = self.replicas.get(rid)
            if srv is not None:
                srv.metrics.on_finish(resp)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._assigned.values())
