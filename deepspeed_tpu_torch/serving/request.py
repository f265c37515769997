"""Request / response lifecycle for the serving tier.

Reference shape: the FastGen ``MIIAsyncPipeline``'s request objects
(mii/batching/data_classes.py — uid, prompt tokens, generation knobs,
streaming queue) recast for the ragged engine: a :class:`Request` is what a
client submits, a :class:`ServedResponse` is the live handle it gets back —
a thread-safe future carrying streamed tokens, latency timestamps (arrival /
admission / first token / finish), the finish reason, and cancellation.

SLA vocabulary: ``priority`` (higher = more important) and ``deadline_s``
(end-to-end latency budget from arrival) drive the scheduler's admission
order; neither changes the engine's per-step work.

Port of ``deepspeed_tpu/serving/request.py``.
"""

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

FINISH_EOS = "eos"            # sampled the eos token
FINISH_LENGTH = "length"      # hit max_new_tokens
FINISH_CANCELLED = "cancelled"
FINISH_FAILED = "failed"      # unschedulable (exceeds model/pool limits)

#: default generation-state checkpoint cadence (tokens) — the one source
#: of truth for ServedResponse/LLMServer; ServingConfig documents the same
#: value declaratively in runtime/config.py
DEFAULT_RESUME_CHECKPOINT_TOKENS = 16


@dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array."""
    prompt: np.ndarray
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    priority: int = 0                  # higher preempts lower (policy=priority)
    deadline_s: Optional[float] = None  # e2e SLA budget from arrival
    # per-token streaming callback(token_id, response) — called from the
    # engine thread, must be cheap and never raise. Delivery is
    # exactly-once per token index, across replica-loss restarts included
    # (the response's delivered-token cursor dedups replays).
    stream: Optional[Callable[[int, "ServedResponse"], None]] = None
    request_id: Optional[str] = None   # client-side correlation id
    # multi-tenancy: which tenant submitted this request. Resolved to an
    # SLA class (weight / default deadline / shed watermark) by the
    # server's TenancyMap (fleet/tenancy.py); None = the default class.
    # The tenant rides the Request object itself, so replica-loss
    # requeues across the fleet preserve tenant identity for free.
    tenant: Optional[str] = None
    # replica-loss requeue budget: after this many router requeues the next
    # one fails the handle (FINISH_FAILED) instead of bouncing it between
    # dying replicas forever; scheduler preemptions don't count
    max_restarts: int = 3

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class ServedResponse:
    """Thread-safe handle for an in-flight request.

    The engine thread appends tokens and stamps the lifecycle times; any
    thread may ``wait()``/``result()`` or ``cancel()``. Times come from the
    server's injectable clock (monotonic seconds)."""

    def __init__(self, request: Request, uid: int, arrival_time: float):
        self.request = request
        self.uid = uid
        self.arrival_time = arrival_time
        self.admitted_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.preemptions = 0           # times restarted (preempt / replica loss)
        self.requeues = 0              # replica-loss restarts only (budgeted)
        self.replica_id: Optional[int] = None
        self.is_canary = False         # the server's integrity probe
        self.tokens: List[int] = []
        # resumable generation: every ckpt_every tokens the response
        # checkpoints its generation state (token count + sampling state);
        # a replica-loss requeue then resumes from the last checkpoint via
        # one prefill over prompt+generated instead of a full replay.
        # 0 disables checkpointing (requeues replay from scratch).
        self.ckpt_every = DEFAULT_RESUME_CHECKPOINT_TOKENS
        self._ckpt_len = 0
        # delivered-token cursor: tokens[0:_delivered] have had their stream
        # callback fired — the exactly-once fence across dropped deliveries
        # and resume/replay re-generation
        self._delivered = 0
        self._done = threading.Event()
        self._cancel = threading.Event()
        # router hook (replica.py): called exactly once when the response
        # finishes, from the finishing server's engine thread
        self.on_finish: Optional[Callable[["ServedResponse"], None]] = None

    # -- engine-thread side -------------------------------------------------
    def _on_admit(self, now: float) -> None:
        self.admitted_time = now

    def _on_token(self, token: int, now: float, deliver: bool = True) -> None:
        if self.first_token_time is None:
            self.first_token_time = now
        self.tokens.append(int(token))
        if self.ckpt_every and len(self.tokens) % self.ckpt_every == 0:
            self._checkpoint()
        if deliver:
            self._flush_stream()

    def _checkpoint(self) -> None:
        """Record the generation state a resume restarts from. Under
        greedy decode the generated prefix IS the sampling state, so the
        checkpoint is just its length; a stochastic sampler would have to
        checkpoint its RNG state here too, or resume would regenerate a
        different span than what was already streamed."""
        self._ckpt_len = len(self.tokens)

    def _flush_stream(self) -> None:
        """Fire the stream callback for every not-yet-delivered token —
        exactly once per token index: a delivery dropped earlier (or tokens
        re-generated after a resume) is skipped or re-delivered by cursor
        position, never duplicated."""
        cb = self.request.stream
        if cb is None:
            self._delivered = max(self._delivered, len(self.tokens))
            return
        while self._delivered < len(self.tokens):
            tok = self.tokens[self._delivered]
            self._delivered += 1
            try:
                cb(tok, self)
            except Exception:  # swallow-ok: a client callback must never kill the server
                pass

    def _on_finish(self, reason: str, now: float) -> None:
        self._flush_stream()   # land any dropped/pending deliveries first
        self.finish_reason = reason
        self.finish_time = now
        self._done.set()
        cb = self.on_finish
        if cb is not None:
            cb(self)

    def _on_requeue(self, resume: bool = False) -> None:
        """Reset generation state for a restart on another replica (or
        after a preemption). With ``resume`` and a live checkpoint, the
        generated prefix up to the last checkpoint survives — the restart
        is one prefill over prompt+generated on the new replica — and the
        delivered-token cursor keeps stream callbacks exactly-once across
        the re-generated span. Without it, the prompt replays from
        scratch. Either way arrival time and the SLA clock keep running."""
        if resume and self._ckpt_len:
            del self.tokens[self._ckpt_len:]
        else:
            self.tokens = []
            self._ckpt_len = 0
            self.first_token_time = None
        self.admitted_time = None
        self.preemptions += 1

    def derived_finish_reason(self) -> str:
        """EOS vs length, derived from the generated tokens — the ONE
        definition shared by the engine's finish path
        (``server._finish_if_done``) and the router's dead-replica
        completion (``replica._requeue_or_fail``)."""
        req = self.request
        if (req.eos_token_id is not None and self.tokens
                and self.tokens[-1] == req.eos_token_id):
            return FINISH_EOS
        return FINISH_LENGTH

    # -- engine-side resume views -------------------------------------------
    def engine_prompt(self) -> np.ndarray:
        """What the next admission prefills: the prompt plus any resumed
        generated prefix (equal to the raw prompt for a fresh request)."""
        if not self.tokens:
            return self.request.prompt
        return np.concatenate([self.request.prompt,
                               np.asarray(self.tokens, np.int32)])

    def remaining_new_tokens(self) -> int:
        """Budget left after the resumed prefix (total footprint stays
        ``len(prompt) + max_new_tokens`` — admission math is unchanged)."""
        return max(1, self.request.max_new_tokens - len(self.tokens))

    # -- client side --------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> None:
        """Request cancellation; the owning server honors it at its next
        loop iteration (queued requests never run, running ones flush)."""
        self._cancel.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until finished; returns the generated tokens. Raises
        ``TimeoutError`` on timeout and ``RuntimeError`` if cancelled or
        failed — a failed request must not read as a zero-token success."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request uid={self.uid} still running")
        if self.finish_reason == FINISH_CANCELLED:
            raise RuntimeError(f"request uid={self.uid} was cancelled")
        if self.finish_reason == FINISH_FAILED:
            raise RuntimeError(f"request uid={self.uid} failed "
                               "(unschedulable or its replica died)")
        return np.asarray(self.tokens, np.int32)

    # -- latency views (seconds; None until the event happened) -------------
    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if (self.finish_time is None or self.first_token_time is None
                or len(self.tokens) < 2):
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.tokens) - 1))

    @property
    def deadline_time(self) -> Optional[float]:
        d = self.request.deadline_s
        return None if d is None else self.arrival_time + d

    def sla_violated(self) -> Optional[bool]:
        """Whether the finished request missed its deadline (None while
        running or when no deadline was set)."""
        dt = self.deadline_time
        if dt is None or self.finish_time is None:
            return None
        return self.finish_time > dt

    def __repr__(self):  # pragma: no cover - debugging aid
        state = (self.finish_reason if self.done
                 else ("admitted" if self.admitted_time else "queued"))
        return (f"ServedResponse(uid={self.uid}, {state}, "
                f"tokens={len(self.tokens)})")
