"""LLMServer: a live serving front end over ``InferenceEngineV2``.

Port of ``deepspeed_tpu/serving/server.py`` (reference FastGen
``MIIAsyncPipeline``): a background thread owns the ragged engine and steps
it continuously while clients submit/await requests from any thread.

* **ingress** — a bounded ``queue.Queue``; a full queue rejects with
  :class:`ServerOverloaded`; the admission policy lives in
  :class:`~.scheduler.ContinuousBatchScheduler`;
* **engine thread** — drains ingress, admits per policy, runs
  ``engine.step()`` (SplitFuse packed prefill+decode) or, in steady decode,
  ``engine.decode_batch(fused_decode_chunk)``, and streams sampled tokens
  into each request's :class:`~.request.ServedResponse`;
* **drain** — ``drain()`` stops admission of NEW requests and returns once
  every in-flight sequence has finished.

Left out of this slice (ROADMAP.md): chaos drills, telemetry spans, control
ticks, the integrity canary, heartbeats, tenancy, speculative decoding and
the fleet/router hooks.

Engine-affinity rule: every engine/scheduler touch happens on the engine
thread; client threads only enqueue, cancel (a flag), and wait on events.
"""

import itertools
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .metrics import ServingMetrics
from .request import (FINISH_CANCELLED, FINISH_FAILED, Request,
                      ServedResponse)
from .scheduler import ContinuousBatchScheduler

logger = logging.getLogger(__name__)


class ServerClosed(RuntimeError):
    """Submit after close()/drain() started."""


class ServerOverloaded(RuntimeError):
    """Bounded ingress queue is full — shed load upstream."""


class LLMServer:
    def __init__(self, engine, *, policy: str = "fcfs", preempt: bool = True,
                 max_queue: int = 256, idle_s: float = 0.001,
                 metrics: Optional[ServingMetrics] = None,
                 default_deadline_s: Optional[float] = None,
                 fused_decode_chunk: int = 0,
                 resume_checkpoint_tokens: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.clock = clock
        self.idle_s = float(idle_s)
        self.default_deadline_s = default_deadline_s
        from .request import DEFAULT_RESUME_CHECKPOINT_TOKENS

        self.resume_checkpoint_tokens = int(
            DEFAULT_RESUME_CHECKPOINT_TOKENS
            if resume_checkpoint_tokens is None
            else resume_checkpoint_tokens)
        # fused multi-token decode (engine.decode_batch, the paged
        # flash-decode path): when > 1 and every live sequence is in steady
        # decode with nothing waiting to prefill, one engine step runs a
        # whole chunk of decode iterations; tokens then stream in
        # chunk-sized bursts. 0 = off (every step is a packed SplitFuse step).
        self.fused_decode_chunk = int(fused_decode_chunk)
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.metrics.stamp_impls(getattr(engine, "attn_impl", None),
                                 getattr(engine, "decode_attn_impl", None))
        self.scheduler = ContinuousBatchScheduler(engine, policy,
                                                  preempt=preempt,
                                                  metrics=self.metrics,
                                                  clock=clock)
        self._ingress: "queue.Queue[ServedResponse]" = queue.Queue(max_queue)
        self._uid = itertools.count()
        # serializes the accepting/draining flags against submit's admission
        # check; _submitting counts submits between that check and their
        # enqueue, so a submit that passed the check can never land its put
        # AFTER the draining loop observed an empty ingress and exited. The
        # enqueue itself happens OUTSIDE the lock (a blocking put under it
        # would deadlock against the crash handler's ingress sweep).
        self._flags = threading.Lock()
        self._submitting = 0
        self._accepting = True
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def start(self) -> "LLMServer":
        # under _flags: two first-submits racing the None check would each
        # spawn a _loop thread — two threads stepping one engine
        with self._flags:
            revivable = self._accepting or self._draining
            if revivable and (self._thread is None
                              or not self._thread.is_alive()):
                self._running = True
                self._thread = threading.Thread(
                    target=self._loop, name="llm-server", daemon=True)
                self._thread.start()
        return self

    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None) -> ServedResponse:
        """Enqueue a request; returns its live response handle.
        ``block=False`` (the default) makes a full ingress queue an
        immediate :class:`ServerOverloaded`."""
        with self._flags:
            if not (self._accepting and not self._draining):
                raise ServerClosed("server is not accepting requests")
            if request.deadline_s is None and self.default_deadline_s is not None:
                request.deadline_s = self.default_deadline_s
            resp = ServedResponse(request, next(self._uid), self.clock())
            resp.ckpt_every = self.resume_checkpoint_tokens
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
        # once _accepting is off nothing new lands, so a mutex-held snapshot
        # of the queue covers everything the drain loop will ever see
        with self._ingress.mutex:
            queued = list(self._ingress.queue)
        for resp in (list(self.scheduler.inflight.values())
                     + list(self.scheduler.pending) + queued):
            resp.cancel()
        with self._flags:
            self._draining = True
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(5.0)

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        try:
            while self._running:
                now = self.clock()
                self._drain_ingress()
                self._process_cancellations(now)
                self.scheduler.admit(now)
                progressed = False
                if self.engine.has_work():
                    if self._fusable_decode():
                        multi = self.engine.decode_batch(self.fused_decode_chunk)
                        self._deliver_multi(multi)
                        progressed = bool(multi)
                    else:
                        out = self.engine.step()
                        self._deliver(out)
                        progressed = (self.engine.last_num_scheduled > 0
                                      or bool(out))
                self._sample_gauges()
                if self._draining and not self.scheduler.has_work():
                    # with no submit between its admission check and its
                    # enqueue (_submitting == 0), an empty ingress is final
                    with self._flags:
                        if self._submitting == 0 and self._ingress.empty():
                            self._running = False
                            break
                if not progressed:
                    time.sleep(self.idle_s)
        except BaseException as e:  # noqa: BLE001 - fail requests, not silently
            self.error = e
            logger.exception("serving: engine thread died")
            now = self.clock()
            with self._flags:
                self._accepting = False   # no NEW submit passes the check...
            while True:                   # ...and in-progress ones must land
                self._drain_ingress()
                with self._flags:
                    if self._submitting == 0 and self._ingress.empty():
                        break
                time.sleep(0.001)
            for resp in self.scheduler.evict_all():
                resp._on_finish(FINISH_FAILED, now)
                self.metrics.on_finish(resp)
            if not isinstance(e, Exception):
                raise
        finally:
            self._running = False

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
        """True when this step can run the fused multi-token decode instead
        of a packed single-token step: opt-in (``fused_decode_chunk > 1``),
        nothing queued (a completion mid-chunk could free capacity for it),
        every live sequence in steady decode, the batch fits one call, and
        each has a full chunk of budget left (tail tokens run as packed
        steps)."""
        if self.fused_decode_chunk <= 1 or self.scheduler.pending:
            return False
        seqs = [s for s in self.engine.state_manager.all() if not s.done]
        if not (bool(seqs)
                and len(seqs) <= self.engine.config.max_ragged_sequence_count
                and all((not s.in_prefill) and s.generated for s in seqs)):
            return False
        return min(s.max_new_tokens - len(s.generated)
                   for s in seqs) >= self.fused_decode_chunk

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
        for uid, tok in out.items():
            resp = self.scheduler.inflight.get(uid)
            if resp is None:
                continue                   # flushed by a cancel this loop
            resp._on_token(tok, now)
            self._finish_if_done(uid, resp, now)

    def _deliver_multi(self, out) -> None:
        """Fused-chunk delivery: a token burst per uid (already
        EOS/length-trimmed), streamed in order with one wall-clock stamp."""
        now = self.clock()
        for uid, toks in (out or {}).items():
            resp = self.scheduler.inflight.get(uid)
            if resp is None:
                continue
            for tok in toks:
                resp._on_token(tok, now)
            self._finish_if_done(uid, resp, now)

    def _sample_gauges(self) -> None:
        m = self.metrics
        m.preemptions = self.scheduler.preemptions
        m.sample(queue_depth=self.queue_depth,
                 inflight=self.inflight_count,
                 kv_free_blocks=self.engine.kv.free_blocks,
                 kv_total_blocks=self.engine.kv.num_blocks)
        m.sample_reuse(self.engine.reuse)
