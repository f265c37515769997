"""LLMServer: a live serving front end over ``InferenceEngineV2``.

Port of ``deepspeed_tpu/serving/server.py``. Reference: FastGen's
``MIIAsyncPipeline`` (mii/batching/ragged_batching.py) — a background
thread owns the ragged engine and steps it continuously while clients
submit/await requests from any thread. Same shape here:

* **ingress** — a bounded ``queue.Queue``; a full queue rejects with
  :class:`ServerOverloaded` (load shedding at the door instead of unbounded
  latency inside), the admission policy itself lives in
  :class:`~.scheduler.ContinuousBatchScheduler`;
* **engine thread** — drains ingress, admits per policy, runs
  ``engine.step()`` (SplitFuse packed prefill+decode) or, in steady decode,
  ``engine.spec_decode_batch()`` / ``engine.decode_batch(chunk)``, streams
  sampled tokens into each request's :class:`~.request.ServedResponse`;
  every phase is a span (``serve/ingress|admit|prefill|decode|mixed|step|
  deliver``), and the loop hosts the chaos sites, the control tick and the
  integrity canary;
* **drain** — ``drain()`` stops admission of NEW requests and returns once
  every in-flight sequence has finished (the graceful half of the replica
  lifecycle; the abrupt half is the router's dead-replica takeover);
* **health** — an optional ``HeartbeatWriter`` publishes this
  replica's beacon each ``heartbeat_interval_s`` so a
  :class:`~.replica.ReplicaRouter` (or any fleet observer) can derive
  liveness without touching the serving thread.

Engine-affinity rule: every engine/scheduler touch happens on the engine
thread; client threads only enqueue, cancel (a flag), and wait on events.
"""

import itertools
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..runtime.resilience.chaos import get_chaos
from ..telemetry.spans import get_tracer, span
from ..utils.logging import logger
from .metrics import ServingMetrics
from .request import (FINISH_CANCELLED, FINISH_EOS, FINISH_FAILED,
                      FINISH_LENGTH, Request, ServedResponse)
from .scheduler import ContinuousBatchScheduler


class ServerClosed(RuntimeError):
    """Submit after close()/drain() started."""


class ServerOverloaded(RuntimeError):
    """Bounded ingress queue is full — shed load upstream."""


class LLMServer:
    def __init__(self, engine, *, policy: str = "fcfs", preempt: bool = True,
                 max_queue: int = 256, idle_s: float = 0.001,
                 metrics: Optional[ServingMetrics] = None,
                 monitor=None, metrics_interval_steps: int = 50,
                 replica_id: int = 0,
                 heartbeat=None, heartbeat_interval_s: float = 2.0,
                 default_deadline_s: Optional[float] = None,
                 fused_decode_chunk: int = 0,
                 resume_checkpoint_tokens: Optional[int] = None,
                 tenancy=None,
                 canary_interval_steps: int = 0,
                 canary_prompt: Optional[Sequence[int]] = None,
                 canary_max_tokens: int = 8,
                 canary_expect: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.replica_id = int(replica_id)
        self.clock = clock
        self.idle_s = float(idle_s)
        self.default_deadline_s = default_deadline_s
        # multi-tenancy (fleet/tenancy.py TenancyMap, duck-typed so the
        # serving tier never imports the fleet package): weights the
        # deadline scheduler's admission order and the control-plane shed
        # door per tenant, and stamps class-default deadlines. None =
        # tenancy off, every path identical to the single-tenant server.
        self.tenancy = tenancy
        # warm gate (fleet/lifecycle.py contract): False until this
        # replica has completed one engine step (or a fleet warm-up set it
        # explicitly). ReplicaRouter.add_replica reads it to keep traffic
        # off a WARMING replica whose first step may still be building
        # kernels for tens of seconds.
        self.warmed = False
        # resumable requests: every N generated tokens a response
        # checkpoints its generation state, so a replica-loss requeue
        # resumes from the last checkpoint (one prefill over
        # prompt+generated) instead of replaying the whole request.
        # 0 = requeues replay from scratch (the pre-resume behavior);
        # None = the request-tier default.
        from .request import DEFAULT_RESUME_CHECKPOINT_TOKENS

        self.resume_checkpoint_tokens = int(
            DEFAULT_RESUME_CHECKPOINT_TOKENS
            if resume_checkpoint_tokens is None
            else resume_checkpoint_tokens)
        # fused multi-token decode (engine.decode_batch — the paged
        # flash-decode path): when > 1 and every live sequence is in
        # steady decode with nothing waiting to prefill, one engine step
        # runs a whole chunk of decode iterations in one call instead of
        # chunk packed single-token steps. Tokens then stream in
        # chunk-sized bursts — the latency granularity the fused path
        # trades for per-token dispatch overhead. 0 = off (every step is a
        # packed SplitFuse step, the pre-chunk behavior).
        self.fused_decode_chunk = int(fused_decode_chunk)
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.metrics.stamp_impls(getattr(engine, "attn_impl", None),
                                 getattr(engine, "decode_attn_impl", None))
        self.monitor = monitor              # Monitor.write_events provider
        self.metrics_interval_steps = int(metrics_interval_steps)
        self.scheduler = ContinuousBatchScheduler(engine, policy,
                                                  preempt=preempt,
                                                  metrics=self.metrics,
                                                  tenancy=tenancy,
                                                  clock=clock)
        self._ingress: "queue.Queue[ServedResponse]" = queue.Queue(max_queue)
        self._uid = itertools.count()
        # serializes the accepting/draining flags against submit's admission
        # check, and _submitting counts submits between that check and their
        # enqueue landing — so a submit that passed the check can never land
        # its put AFTER the draining loop observed an empty ingress and
        # exited (a stranded request would hang its client forever). The
        # enqueue itself happens OUTSIDE the lock: a blocking put under it
        # would deadlock against the crash handler's ingress sweep.
        self._flags = threading.Lock()
        self._submitting = 0
        self._accepting = True
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._beat_thread: Optional[threading.Thread] = None
        self._beat_stop = threading.Event()
        self._steps = 0
        self._last_emit_step = 0
        self._last_step_time: Optional[float] = None
        # control plane (deepspeed_tpu/control/): a ControlSupervisor
        # attached via attach_server ticks every control_interval_steps
        # serving steps; control_max_queue is its shedding actuator — a
        # tightened admission watermark below the ingress queue's bound
        # (None = full admission). Requeues bypass it: already-admitted
        # work must land.
        self.control = None
        self.control_interval_steps = 25
        self.control_max_queue: Optional[int] = None
        self._last_control_step = 0
        # integrity canary (the serving-side SDC probe): every
        # canary_interval_steps engine steps the server self-submits a
        # fixed prompt under greedy decode and hashes the tokens. A hash
        # that stops matching means this replica computes WRONG BITS while
        # passing every liveness check — the canary fails the engine
        # thread so the router's existing dead-replica takeover (error !=
        # None -> excluded from alive_ids, work requeued) quarantines it.
        # canary_expect pins the known-good hash; None learns it from the
        # first probe (valid only if the replica is healthy at warm-up).
        # Determinism requires greedy decode — with sampling on, the very
        # first mismatch would kill a healthy replica.
        self.canary_interval_steps = int(canary_interval_steps)
        self._canary_prompt = np.asarray(
            list(canary_prompt) if canary_prompt is not None
            else [3, 1, 4, 1, 5], np.int32)
        self.canary_max_tokens = int(canary_max_tokens)
        self.canary_expect = canary_expect
        self._canary_inflight: Optional[ServedResponse] = None
        self._last_canary_step = 0
        self.heartbeat = heartbeat          # resilience.HeartbeatWriter
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.suppress_heartbeat = False     # FaultPlan-style drill hook
        self.error: Optional[BaseException] = None
        # telemetry spine: when a TelemetryManager is live in this process,
        # this replica's ServingMetrics become dstpu_serving_* scrape
        # samples (keyed by replica — a rebuilt server replaces its entry;
        # stop paths unregister so a dead replica stops exporting)
        self._telemetry_registered = False
        try:
            from ..telemetry import register_serving_metrics, telemetry_active
            if telemetry_active():
                register_serving_metrics(self.metrics, self.replica_id)
                self._telemetry_registered = True
        except Exception:
            pass  # swallow-ok: telemetry must never block serving bring-up

    def _unregister_telemetry(self) -> None:
        """Drop this replica's scrape collector (idempotent): a halted or
        drained server must not keep exporting frozen dstpu_serving_*
        series that look like a live replica."""
        if not self._telemetry_registered:
            return
        self._telemetry_registered = False
        try:
            from ..telemetry import get_registry

            get_registry().unregister_collector(
                f"serving-{int(self.replica_id)}")
        except Exception:
            pass  # swallow-ok: scrape-surface teardown is best-effort on a dying replica

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, model, params, config, *, monitor=None,
                    replica_id: Optional[int] = None,
                    device="cuda") -> "LLMServer":
        """Build an engine + server from a ``serving:`` config block
        (``runtime/config.py`` ServingConfig, a dict of its fields, or a
        whole ds_config dict/``DeepSpeedTPUConfig``). ``serving.engine``
        carries ``RaggedInferenceEngineConfig`` overrides. ``model`` is a
        ``TransformerConfig`` (or a ``TransformerLM``, whose config is
        taken); the engine lives on ``device``."""
        from ..inference.v2 import (InferenceEngineV2,
                                    RaggedInferenceEngineConfig)
        from ..runtime.config import DeepSpeedTPUConfig, ServingConfig

        if isinstance(config, DeepSpeedTPUConfig):
            sv = config.serving
        elif isinstance(config, ServingConfig):
            sv = config
        else:
            import dataclasses
            d = dict(config or {})
            if "serving" in d:
                raw = d["serving"]
            else:
                # a bare dict of ServingConfig fields is taken as-is; any
                # other dict is a full ds_config without a serving block —
                # defaults, not a ConfigError on its training keys
                fields = {f.name for f in dataclasses.fields(ServingConfig)}
                raw = d if set(d) <= fields else {}
            if isinstance(raw, str):  # the "serving": "<policy>" shorthand
                raw = {"enabled": True, "policy": raw}
            sv = ServingConfig.from_dict(raw)
        engine = InferenceEngineV2(
            getattr(model, "cfg", model), params,
            RaggedInferenceEngineConfig(**dict(sv.engine)), device=device)
        rid = sv.replica_id if replica_id is None else int(replica_id)
        heartbeat = None
        if sv.heartbeat_dir:
            from ..runtime.resilience.heartbeat import (FileHeartbeatTransport,
                                                        HeartbeatWriter)

            heartbeat = HeartbeatWriter(FileHeartbeatTransport(sv.heartbeat_dir),
                                        rank=rid)
        tenancy = None
        if getattr(sv, "tenancy", None) is not None:
            from ..fleet.tenancy import TenancyMap

            tenancy = TenancyMap.from_config(sv.tenancy)
        return cls(engine, policy=sv.policy, preempt=sv.preempt,
                   max_queue=sv.max_queue, idle_s=sv.idle_s,
                   monitor=monitor,
                   metrics_interval_steps=sv.metrics_interval_steps,
                   replica_id=rid, heartbeat=heartbeat,
                   heartbeat_interval_s=sv.heartbeat_interval_s,
                   default_deadline_s=sv.default_deadline_s,
                   fused_decode_chunk=getattr(sv, "fused_decode_chunk", 0),
                   resume_checkpoint_tokens=getattr(
                       sv, "resume_checkpoint_tokens", None),
                   tenancy=tenancy,
                   canary_interval_steps=getattr(
                       sv, "canary_interval_steps", 0),
                   canary_prompt=getattr(sv, "canary_prompt", None),
                   canary_max_tokens=getattr(sv, "canary_max_tokens", 8),
                   canary_expect=getattr(sv, "canary_expect", None))

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def start(self) -> "LLMServer":
        # under _flags: start() is called from every submit(), and two
        # first-submits racing the None check would each spawn a _loop
        # thread — two threads stepping one single-threaded engine.
        # A halted server (accepting off, NOT draining) stays down: a
        # submit that raced past the admission check before halt() landed
        # must not revive the engine thread the router just stopped —
        # its stranded request is the router's (close()/_track) to fail.
        with self._flags:
            revivable = self._accepting or self._draining
            if revivable and (self._thread is None
                              or not self._thread.is_alive()):
                self._running = True
                self._thread = threading.Thread(
                    target=self._loop, name=f"llm-server-{self.replica_id}",
                    daemon=True)
                self._thread.start()
            if revivable:
                self._start_beater()
        return self

    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None,
               _response: Optional[ServedResponse] = None) -> ServedResponse:
        """Enqueue a request; returns its live response handle.

        ``block=False`` (the default) makes a full ingress queue an
        immediate :class:`ServerOverloaded` — open-loop clients must shed
        load, not stack it. ``_response`` re-enqueues an existing handle
        (router requeue path): the response keeps its arrival time/SLA clock
        but gets a fresh engine uid on this replica."""
        if _response is None and self.control_max_queue is not None:
            # control-plane shedding: sustained SLA violations tightened
            # admission below the ingress bound — reject at the door like
            # an overload, so upstream backpressure works unchanged. With
            # tenancy, the door is per-class: a low-weight tenant's
            # watermark is a fraction of the base, so bronze sheds first
            # while gold keeps landing under the same supervisor actuator.
            wm = self.control_max_queue
            if self.tenancy is not None:
                wm = self.tenancy.shed_watermark(
                    wm, getattr(request, "tenant", None))
            if self._ingress.qsize() >= wm:
                self.metrics.on_reject(request)
                raise ServerOverloaded(
                    f"control plane shed: admission tightened to "
                    f"{wm} queued request(s)"
                    + (f" for tenant {request.tenant!r}"
                       if self.tenancy is not None and request.tenant else ""))
        with self._flags:
            if not (self._accepting and not self._draining):
                raise ServerClosed(f"server replica={self.replica_id} is not "
                                   "accepting requests")
            if request.deadline_s is None and self.tenancy is not None:
                request.deadline_s = self.tenancy.default_deadline_s(
                    getattr(request, "tenant", None))
            if request.deadline_s is None and self.default_deadline_s is not None:
                request.deadline_s = self.default_deadline_s
            uid = next(self._uid)
            if _response is None:
                resp = ServedResponse(request, uid, self.clock())
                resp.ckpt_every = self.resume_checkpoint_tokens
            else:
                resp = _response
                resp.uid = uid
                self.metrics.requeues += 1   # replica-loss / drain restart
            resp.replica_id = self.replica_id
            self._submitting += 1
        try:
            self._ingress.put(resp, block=block, timeout=timeout)
        except queue.Full:
            self.metrics.on_reject(request)
            raise ServerOverloaded(
                f"ingress queue full ({self._ingress.maxsize}); "
                f"request rejected") from None
        finally:
            with self._flags:
                self._submitting -= 1
        self.metrics.on_submit(resp)
        self.start()
        return resp

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience wrapper: submit all, wait, return tokens."""
        resps = [self.submit(Request(p, max_new_tokens=max_new_tokens,
                                     eos_token_id=eos_token_id), block=True)
                 for p in prompts]
        return [r.result(timeout) for r in resps]

    def cancel(self, resp: ServedResponse) -> None:
        resp.cancel()

    @property
    def queue_depth(self) -> int:
        return self._ingress.qsize() + self.scheduler.queue_depth

    @property
    def inflight_count(self) -> int:
        return len(self.scheduler.inflight)

    @property
    def outstanding(self) -> int:
        """Requests accepted but not yet finished (load, for routing)."""
        return self.queue_depth + self.inflight_count

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting new requests, finish every in-flight one, then
        stop the engine thread. Returns True when everything completed."""
        with self._flags:
            self._accepting = False
            self._draining = True
        self.start()                       # a never-started server still drains
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._thread.is_alive():
            self._thread.join(0.05)
            if deadline is not None and time.monotonic() > deadline:
                return False
        return self.error is None

    def close(self) -> None:
        """Cancel everything outstanding and stop."""
        with self._flags:
            self._accepting = False
        # flag scheduler-held AND still-ingress-queued requests: once
        # _accepting is off nothing new lands, so a mutex-held snapshot of
        # the queue covers everything the drain loop will ever see (the
        # engine thread finishes them as cancelled instead of serving them)
        with self._ingress.mutex:
            queued = list(self._ingress.queue)
        for resp in (list(self.scheduler.inflight.values())
                     + list(self.scheduler.pending) + queued):
            resp.cancel()
        with self._flags:
            self._draining = True
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(5.0)
        self._unregister_telemetry()   # covers a never-started server too

    # -- fleet hooks --------------------------------------------------------
    def halt(self) -> None:
        """Abrupt stop WITHOUT finishing in-flight work — the dead-replica
        drill (process loss leaves exactly this state behind, beacon
        included: a real process loss kills the beater thread too)."""
        with self._flags:
            self._accepting = False
            self._running = False
        self._beat_stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(5.0)
        self._unregister_telemetry()

    def steal_unfinished(self) -> List[ServedResponse]:
        """Take every unfinished request off this (halted or draining-idle)
        server for requeue elsewhere. Only call once the engine thread is
        stopped — the router's takeover of a dead replica."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("steal_unfinished on a live server "
                               "(halt() or drain() it first)")
        out = self.scheduler.evict_all()
        while True:
            try:
                out.append(self._ingress.get_nowait())
            except queue.Empty:
                break
        return [r for r in out if not r.done]

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        try:
            while self._running:
                now = self.clock()
                with span("serve/ingress"):
                    self._drain_ingress()
                    self._process_cancellations(now)
                with span("serve/admit"):
                    self.scheduler.admit(now)
                progressed = False
                if self.engine.has_work():
                    chaos = get_chaos()
                    if chaos is not None and self._chaos_step(chaos):
                        return      # injected replica kill: simulated
                                    # process loss (finally stops the beat)
                    # phase-named step span: a hang dump should say whether
                    # the engine wedged packing prefill chunks or in steady
                    # decode. The prefill scan only runs while tracing.
                    if get_tracer().enabled:
                        seqs = list(self.engine.state_manager.all())
                        n_pre = sum(1 for s in seqs if s.in_prefill)
                        name = ("serve/decode" if n_pre == 0
                                else "serve/prefill" if n_pre == len(seqs)
                                else "serve/mixed")
                    else:
                        name = "serve/step"
                    mode = ("spec" if self._spec_decode_ready()
                            else "fused" if self._fusable_decode()
                            else "step")
                    t0 = self.clock()
                    with span(name):
                        if mode == "spec":
                            multi = self.engine.spec_decode_batch()
                        elif mode == "fused":
                            multi = self.engine.decode_batch(
                                self.fused_decode_chunk)
                        else:
                            out = self.engine.step()
                    self._last_step_time = self.clock() - t0
                    self._steps += 1
                    # first completed step = the engine's programs exist;
                    # the router's warm gate may now route traffic here
                    self.warmed = True
                    with span("serve/deliver"):
                        if mode == "step":
                            self._deliver(out)
                        else:
                            self._deliver_multi(multi)
                    progressed = (bool(multi) if mode != "step"
                                  else (self.engine.last_num_scheduled > 0
                                        or bool(out)))
                self._sample_gauges()
                self._maybe_emit()
                self._maybe_control_tick()
                self._maybe_canary()
                if self._draining and not self.scheduler.has_work():
                    # under the flags lock, with no submit between its
                    # admission check and its enqueue (_submitting == 0),
                    # an empty ingress is conclusive
                    with self._flags:
                        if self._submitting == 0 and self._ingress.empty():
                            self._running = False
                            break
                if not progressed:
                    time.sleep(self.idle_s)
        except BaseException as e:  # noqa: BLE001 - fail requests, not silently
            self.error = e
            logger.error(f"serving: replica {self.replica_id} engine thread "
                         f"died: {e!r}")
            now = self.clock()
            with self._flags:
                self._accepting = False   # no NEW submit passes the check...
            while True:                   # ...and in-progress ones must land
                self._drain_ingress()     # (consuming frees any blocked put)
                with self._flags:
                    if self._submitting == 0 and self._ingress.empty():
                        break
                time.sleep(0.001)
            for resp in self.scheduler.evict_all():   # not-yet-pulled requests
                resp._on_finish(FINISH_FAILED, now)   # fail too, not strand
                self.metrics.on_finish(resp)          # their client
        finally:
            self._running = False
            self._beat_stop.set()   # stopped serving = stop advertising
            self._unregister_telemetry()

    def _chaos_step(self, chaos) -> bool:
        """Serving-layer chaos consult, once per engine step (the ``at``
        index of serving events counts steps on this replica). Returns True
        when the replica was just killed: the loop must return — a
        simulated process loss leaves the scheduler/engine state in place
        (nothing finishes, nothing is failed), the beat stops via the
        loop's finally, and the router's dead-replica takeover is the only
        thing that can recover the in-flight work, exactly as with a real
        process death."""
        site = f"replica{self.replica_id}"
        if chaos.fire("replica_kill", site):
            logger.warning(f"chaos: killing replica {self.replica_id} at "
                           f"serving step {self._steps}")
            with self._flags:
                self._accepting = False
                self._running = False
            return True
        stall = chaos.value("slow_prefill", site)
        if stall:
            # slow/stalled prefill: the step sits still while queued work
            # ages — deadline scheduling and the router's health view must
            # absorb it, not misread it as death
            time.sleep(float(stall))
        return False

    def _drain_ingress(self) -> None:
        while True:
            try:
                resp = self._ingress.get_nowait()
            except queue.Empty:
                return
            self.scheduler.add(resp)

    def _process_cancellations(self, now: float) -> None:
        for resp in [r for r in self.scheduler.pending if r.cancelled]:
            self.scheduler.cancel_queued(resp.uid)
            resp._on_finish(FINISH_CANCELLED, now)
            self.metrics.on_finish(resp)
        for resp in [r for r in self.scheduler.inflight.values()
                     if r.cancelled]:
            self.engine.flush(resp.uid)   # frees KV blocks mid-generation
            self.scheduler.complete(resp.uid)
            resp._on_finish(FINISH_CANCELLED, now)
            self.metrics.on_finish(resp)

    def _fusable_decode(self) -> bool:
        """True when this step can run the fused multi-token decode
        (``engine.decode_batch`` — the paged flash-decode path)
        instead of a packed single-token step: opt-in
        (``fused_decode_chunk > 1``), every live sequence in steady decode
        with a first sampled token, the batch fits one call, and
        nothing is waiting to prefill. The bare ``pending`` gate is a
        deliberate admission-latency bias: a queued request isn't
        admissible RIGHT NOW (admit just ran), but a completion mid-chunk
        could free its capacity, and fusing would delay that admission by
        up to chunk steps — so a saturated queue keeps packed per-token
        steps (SplitFuse admission wins) and fusing serves the
        steady-decode / launch-latency-dominated regime it targets."""
        if self.fused_decode_chunk <= 1 or self.scheduler.pending:
            return False
        if not hasattr(self.engine, "decode_batch"):
            return False
        seqs = [s for s in self.engine.state_manager.all() if not s.done]
        if not (bool(seqs)
                and len(seqs) <= self.engine.config.max_ragged_sequence_count
                and all((not s.in_prefill) and s.generated for s in seqs)):
            return False
        # only fuse FULL chunks: decode_batch clamps its chunk to the
        # smallest remaining budget — tail tokens (< chunk remaining) run
        # as packed steps instead
        return min(s.max_new_tokens - len(s.generated)
                   for s in seqs) >= self.fused_decode_chunk

    def _spec_decode_ready(self) -> bool:
        """True when this step should run n-gram speculative decode
        (``engine.spec_decode_batch``): opt-in via the engine's
        ``spec_decode_k`` knob (greedy-only by construction), every live
        sequence in steady decode with a first sampled token, the batch
        fits one call, and nothing is queued — the same bare
        ``pending`` admission-latency bias as the fused path (see
        :meth:`_fusable_decode`). Unlike fusing there is no full-chunk
        gate: the verify step takes any accept count. When both are
        eligible speculation wins — accepted drafts make it strictly denser
        per step."""
        cfg = getattr(self.engine, "config", None)
        if (cfg is None or getattr(cfg, "spec_decode_k", 0) < 1
                or not getattr(cfg, "greedy", False)
                or not hasattr(self.engine, "spec_decode_batch")
                or self.scheduler.pending):
            return False
        seqs = [s for s in self.engine.state_manager.all() if not s.done]
        return (bool(seqs)
                and len(seqs) <= cfg.max_ragged_sequence_count
                and all((not s.in_prefill) and s.generated for s in seqs))

    def _finish_if_done(self, uid: int, resp, now: float) -> None:
        seq = self.engine.state_manager.get(uid)
        if seq is not None and seq.done:
            reason = resp.derived_finish_reason()
            self.engine.flush(uid)
            self.scheduler.complete(uid)
            resp._on_finish(reason, now)
            self.metrics.on_finish(resp)

    def _deliver(self, out: Dict[int, int]) -> None:
        now = self.clock()
        chaos = get_chaos()
        for uid, tok in out.items():
            resp = self.scheduler.inflight.get(uid)
            if resp is None:
                continue                   # flushed by a cancel this loop
            # drop_token drill: the token lands in the response (generation
            # state is engine truth) but its stream delivery is lost — the
            # delivered-token cursor must re-deliver it exactly once with
            # the next delivery (or at finish), never duplicate it
            drop = (chaos is not None
                    and chaos.fire("drop_token",
                                   f"replica{self.replica_id}"))
            resp._on_token(tok, now, deliver=not drop)
            self._finish_if_done(uid, resp, now)

    def _deliver_multi(self, out) -> None:
        """Fused-chunk delivery: ``decode_batch`` hands back a token BURST
        per uid (already EOS/length-trimmed host-side); the tokens stream
        into the response in order, sharing one wall-clock stamp — the
        latency granularity the fused path trades for launch overhead."""
        now = self.clock()
        chaos = get_chaos()
        for uid, toks in (out or {}).items():
            resp = self.scheduler.inflight.get(uid)
            if resp is None:
                continue                   # flushed by a cancel this loop
            for tok in toks:
                drop = (chaos is not None
                        and chaos.fire("drop_token",
                                       f"replica{self.replica_id}"))
                resp._on_token(tok, now, deliver=not drop)
            self._finish_if_done(uid, resp, now)

    def _sample_gauges(self) -> None:
        m = self.metrics
        m.preemptions = self.scheduler.preemptions
        m.sample(queue_depth=self.queue_depth,
                 inflight=self.inflight_count,
                 kv_free_blocks=self.engine.kv.free_blocks,
                 kv_total_blocks=self.engine.kv.num_blocks)
        reuse = getattr(self.engine, "reuse", None)
        if reuse is not None:
            m.sample_reuse(reuse)

    def _start_beater(self) -> None:
        if self.heartbeat is None:
            return
        if self._beat_thread is not None and self._beat_thread.is_alive():
            return
        self._beat_stop.clear()
        self._beat_thread = threading.Thread(
            target=self._beat_loop,
            name=f"llm-server-{self.replica_id}-beat", daemon=True)
        self._beat_thread.start()

    def _beat_loop(self) -> None:
        """Process-liveness beacon on its OWN thread. The engine loop can sit
        inside a single step for tens of seconds (first kernel build, a long
        packed prefill) — a loop-driven beat would starve past the router's
        ``dead_after_s`` and a merely-warming-up replica would be declared
        dead and its whole backlog requeued. Step/step-time ride along for
        straggler observation; liveness itself only asserts the process."""
        while not self._beat_stop.is_set():
            if not self.suppress_heartbeat:
                try:
                    self.heartbeat.beat(step=self._steps,
                                        step_time_s=self._last_step_time)
                except Exception as e:  # a full disk must not kill serving
                    logger.warning(f"serving: heartbeat write failed: {e!r}")
            self._beat_stop.wait(self.heartbeat_interval_s)

    def _maybe_control_tick(self) -> None:
        """Hand the supervisor one look at this replica's metrics every
        ``control_interval_steps`` engine steps (engine-thread context, so
        the SLA rule's shed/unshed actuation races nothing)."""
        if self.control is None or self.control_interval_steps <= 0:
            return
        if (self._steps and self._steps != self._last_control_step
                and self._steps % self.control_interval_steps == 0):
            self._last_control_step = self._steps
            try:
                self.control.on_serving_tick(self)
            except Exception as e:  # control must never stall serving
                logger.warning(f"serving: control tick failed: {e!r}")

    def _maybe_canary(self) -> None:
        """Integrity canary, engine-thread only: reap a finished probe
        (hash-compare, fail the replica on mismatch) and launch the next
        one when due. The probe bypasses ingress/shedding — it goes
        straight to the scheduler: a canary a busy door rejects is no
        canary, and an already-admitted request must land anyway."""
        if self.canary_interval_steps <= 0:
            return
        c = self._canary_inflight
        if c is not None and c.done:
            self._canary_inflight = None
            self._check_canary(c)        # raises on mismatch -> loop fails
            c = None
        if (c is not None or not self._steps or self._draining
                or self._steps == self._last_canary_step
                or self._steps % self.canary_interval_steps):
            return
        self._last_canary_step = self._steps
        req = Request(np.asarray(self._canary_prompt, np.int32),
                      max_new_tokens=self.canary_max_tokens)
        resp = ServedResponse(req, next(self._uid), self.clock())
        resp.replica_id = self.replica_id
        resp.is_canary = True            # post-mortem / metrics marker
        self.metrics.canary_probes += 1
        self.metrics.on_submit(resp)     # probes count as served traffic
        self.scheduler.add(resp)
        self._canary_inflight = resp

    def _check_canary(self, resp: ServedResponse) -> None:
        """Compare a finished probe's token hash with the expectation.
        First probe with no configured expectation LEARNS it (trust on
        first use — the replica just warmed and served it). A mismatch
        raises: the engine loop's failure path marks ``self.error``, fails
        outstanding requests, and the router takeover does the rest."""
        import hashlib

        if resp.finish_reason in (FINISH_CANCELLED, FINISH_FAILED):
            return                        # shutdown races are not verdicts
        got = hashlib.sha1(
            np.asarray(resp.tokens, np.int64).tobytes()).hexdigest()[:16]
        if self.canary_expect is None:
            self.canary_expect = got
            logger.info(f"serving: replica {self.replica_id} canary "
                        f"expectation learned: {got}")
            return
        if got != self.canary_expect:
            # the registered serving collector exports this as
            # dstpu_serving_canary_fail_total{replica=...} on next scrape
            self.metrics.canary_fails += 1
            raise RuntimeError(
                f"integrity canary failed on replica {self.replica_id}: "
                f"token hash {got} != expected {self.canary_expect} "
                f"(step {self._steps}) — replica output is corrupt")

    def _maybe_emit(self) -> None:
        if self.monitor is None or self.metrics_interval_steps <= 0:
            return
        if (self._steps and self._steps != self._last_emit_step
                and self._steps % self.metrics_interval_steps == 0):
            self._last_emit_step = self._steps
            try:
                self.monitor.write_events(
                    self.metrics.monitor_events(self._steps))
            except Exception as e:  # monitoring must never stall serving
                logger.warning(f"serving: monitor write failed: {e!r}")
