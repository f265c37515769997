"""Continuous-batching admission scheduler.

Port of ``deepspeed_tpu/serving/scheduler.py`` (tenant weighting and chaos
drills wait, ROADMAP.md). Reference: the FastGen
``RaggedBatchBase.schedule_requests`` loop
(mii/batching/ragged_batching.py) — which requests join the engine's ragged
batch next. The engine itself (``inference/v2/engine_v2.py``) already packs
prompt chunks + decode tokens per step (Dynamic SplitFuse); this layer
decides *admission*: which queued requests get a KV-block reservation at
all, in what order, and who gets thrown back when the pool runs dry.

Policies
--------
``fcfs``      arrival order (head-of-line blocking preserves fairness).
``priority``  higher ``Request.priority`` first; lower-priority *prefill*
              sequences are preempted-and-requeued when the pool runs dry.
``deadline``  earliest SLA deadline first (EDF); a later-deadline prefill
              can be preempted for a tighter one.

Backpressure is exact, not heuristic: admission goes through the engine's
``can_schedule`` (worst-case block commitment over the WHOLE pool including
``_outstanding_blocks``), so an admitted request can always run to its
``max_new_tokens`` without deadlocking the pool.

Single-threaded by design: every method runs on the owning server's engine
thread (``server.py``); cross-thread traffic arrives via the server's
ingress queue.
"""

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from .request import (FINISH_CANCELLED, FINISH_FAILED, ServedResponse)

logger = logging.getLogger(__name__)

POLICIES = ("fcfs", "priority", "deadline")


class ContinuousBatchScheduler:
    def __init__(self, engine, policy: str = "fcfs", *, preempt: bool = True,
                 max_inflight: Optional[int] = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"choose from {POLICIES}")
        self.engine = engine
        self.policy = policy
        self.metrics = metrics       # ServingMetrics.on_finish sink (optional)
        self.preempt = bool(preempt) and policy != "fcfs"
        # cap concurrently-admitted sequences at the engine's ragged slot
        # count: admitting more only moves queueing INSIDE the engine, where
        # this policy can no longer order it
        self.max_inflight = (engine.config.max_ragged_sequence_count
                            if max_inflight is None else int(max_inflight))
        self.clock = clock
        self.pending: List[ServedResponse] = []
        self.inflight: Dict[int, ServedResponse] = {}
        self.preemptions = 0
        self.failed = 0

    # ------------------------------------------------------------------
    def add(self, resp: ServedResponse) -> None:
        self.pending.append(resp)

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    def has_work(self) -> bool:
        return bool(self.pending or self.inflight)

    # ------------------------------------------------------------------
    def _key(self, resp: ServedResponse) -> Tuple:
        """Sort key: smaller = admitted sooner. The (arrival, uid) tail keeps
        every policy a stable FCFS tie-break."""
        if self.policy == "priority":
            return (-resp.request.priority, resp.arrival_time, resp.uid)
        if self.policy == "deadline":
            d = resp.deadline_time
            return (d if d is not None else float("inf"),
                    resp.arrival_time, resp.uid)
        return (resp.arrival_time, resp.uid)

    def _outranks(self, cand: ServedResponse, other: ServedResponse) -> bool:
        """Whether ``cand`` may preempt ``other`` (strictly, so equal-rank
        requests never thrash each other)."""
        if self.policy == "priority":
            return cand.request.priority > other.request.priority
        if self.policy == "deadline":
            cd, od = cand.deadline_time, other.deadline_time
            return cd is not None and (od is None or cd < od)
        return False

    def _finish(self, resp: ServedResponse, reason: str, now: float) -> None:
        resp._on_finish(reason, now)
        if self.metrics is not None:
            self.metrics.on_finish(resp)

    def _blocks_worst(self, resp: ServedResponse) -> int:
        """Worst-case KV-block footprint of a request run to max_new_tokens
        (what admission commits, and what a preempting flush gives back)."""
        req = resp.request
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.engine.config.kv_block_size)

    def _permanent(self, resp: ServedResponse) -> bool:
        """can_schedule refusals that no amount of waiting fixes — computed
        from the engine's own limits (not its message text): the sequence
        exceeds the model context, the per-sequence block-table width, or the
        whole allocatable pool (``num_blocks - 1``; block 0 is the trash
        block), which even an EMPTY engine could never satisfy — without the
        last check such a request would wedge the head of the queue forever."""
        req = resp.request
        if len(req.prompt) + req.max_new_tokens > self.engine.cfg.max_seq_len:
            return True
        return self._blocks_worst(resp) > min(
            self.engine.config.max_blocks_per_seq,
            self.engine.kv.num_blocks - 1)

    # ------------------------------------------------------------------
    def _eligible_victims(self, cand: ServedResponse) -> List[ServedResponse]:
        """In-flight sequences STILL IN PREFILL that ``cand`` outranks. Only
        prefills are preemptable: restarting one re-runs prompt chunks, while
        evicting a decoding sequence would discard sampled tokens the client
        may already have streamed."""
        victims = []
        for resp in self.inflight.values():
            seq = self.engine.state_manager.get(resp.uid)
            if seq is None or seq.done or not seq.in_prefill:
                continue
            if self._outranks(cand, resp):
                victims.append(resp)
        return victims

    def _pick_victim(self, cand: ServedResponse) -> Optional[ServedResponse]:
        victims = self._eligible_victims(cand)
        return max(victims, key=self._key) if victims else None

    def _victim_gain(self, resp: ServedResponse) -> int:
        """Uncommitted blocks a flush of ``resp`` actually returns. The
        un-commitment part (worst-case promise minus already-held pages) is
        always reclaimed; of the held pages, only those this sequence is
        the LAST owner of go back to the pool — a page shared with another
        live sequence (prefix-cache hit) survives the flush, so counting it
        would overstate the gain and trigger pointless evictions."""
        refs = getattr(self.engine.kv, "refs", None)
        seq = self.engine.state_manager.get(resp.uid)
        if refs is None or seq is None:
            return self._blocks_worst(resp)
        held = list(seq.blocks)
        return (self._blocks_worst(resp) - len(held)
                + sum(1 for p in held if refs.get(p, 0) <= 1))

    def _preemption_covers(self, cand: ServedResponse) -> bool:
        """Only start evicting when the evictable prefills can actually free
        enough: a victim's flush returns its un-committed worst-case promise
        plus the held pages it solely owns (``_victim_gain`` — shared
        prefix-cache pages don't free), so the sum over eligible victims
        bounds the gain. Without this check a too-large candidate would
        throw away every outranked prefill's progress and still not be
        admitted."""
        deficit = (self._blocks_worst(cand)
                   - self.engine.uncommitted_free_blocks)
        if deficit <= 0:
            return True       # schedulable modulo races; can_schedule decides
        return sum(self._victim_gain(v)
                   for v in self._eligible_victims(cand)) >= deficit

    def _preempt(self, victim: ServedResponse) -> None:
        self.engine.flush(victim.uid)     # frees its KV blocks + tracking
        del self.inflight[victim.uid]
        # resume=True: an ordinary prefill victim has no generated tokens
        # (identical to a scratch restart), but a RESUMED sequence still
        # re-prefilling its prompt+generated prefix keeps its checkpoint
        # instead of losing already-delivered tokens to a second replay
        victim._on_requeue(resume=True)
        self.pending.append(victim)
        self.preemptions += 1
        logger.info(f"serving: preempted uid={victim.uid} "
                    f"(priority={victim.request.priority}) to free KV blocks")

    # ------------------------------------------------------------------
    def admit(self, now: Optional[float] = None) -> List[ServedResponse]:
        """Admit as many queued requests as capacity allows, in policy
        order. Head-of-line blocking is intentional: when the best-ranked
        request doesn't fit (even after preemption), nothing behind it is
        admitted either — skipping ahead would starve large requests."""
        now = self.clock() if now is None else now
        admitted: List[ServedResponse] = []
        # one sort per admit() call: pops keep the order, and the only
        # in-loop append (a preempted victim rejoining pending) re-sorts
        # below — a per-iteration sort of a deep backlog would otherwise run
        # at the server loop's full idle frequency
        self.pending.sort(key=self._key)
        while self.pending and len(self.inflight) < self.max_inflight:
            resp = self.pending[0]
            if resp.cancelled:
                self.pending.pop(0)
                self._finish(resp, FINISH_CANCELLED, now)
                continue
            req = resp.request
            # resume-aware shape: a requeued response prefills over
            # prompt+generated with the remaining budget — the worst-case
            # total (prompt + max_new) is unchanged, so _blocks_worst /
            # _permanent stay in the request's own terms
            eff_prompt = resp.engine_prompt()
            eff_new = resp.remaining_new_tokens()
            ok, why = self.engine.can_schedule(len(eff_prompt), eff_new)
            if not ok and self._permanent(resp):
                self.pending.pop(0)
                self.failed += 1
                logger.warning(f"serving: rejecting uid={resp.uid}: {why}")
                self._finish(resp, FINISH_FAILED, now)
                continue
            if not ok and self.preempt and self._preemption_covers(resp):
                preempted = False
                while not ok:
                    victim = self._pick_victim(resp)
                    if victim is None:
                        break
                    self._preempt(victim)
                    preempted = True
                    ok, why = self.engine.can_schedule(len(eff_prompt),
                                                       eff_new)
                if preempted:
                    # victims rejoined pending; resp stays at the head (it
                    # strictly outranks every victim) but the victims must
                    # order against the rest of the queue
                    self.pending.sort(key=self._key)
            if not ok:
                break
            self.pending.pop(0)
            self.engine.put([resp.uid], [eff_prompt],
                            max_new_tokens=eff_new,
                            eos_token_id=req.eos_token_id)
            resp._on_admit(now)
            self.inflight[resp.uid] = resp
            admitted.append(resp)
        return admitted

    # ------------------------------------------------------------------
    def complete(self, uid: int) -> Optional[ServedResponse]:
        return self.inflight.pop(uid, None)

    def cancel_queued(self, uid: int) -> Optional[ServedResponse]:
        for i, resp in enumerate(self.pending):
            if resp.uid == uid:
                return self.pending.pop(i)
        return None

    def evict_all(self) -> List[ServedResponse]:
        """Flush every in-flight sequence and return ALL unfinished
        responses (queued + in-flight) — the server's crash path. Engine-side state is
        released here; the RESPONSE state is not touched."""
        out: List[ServedResponse] = []
        for resp in list(self.inflight.values()):
            self.engine.flush(resp.uid)
            out.append(resp)
        self.inflight.clear()
        out.extend(self.pending)
        self.pending = []
        return out
