"""Replica lifecycle: SPAWNING → WARMING → JOINED → DRAINING → DEAD.

Port of ``deepspeed_tpu/fleet/lifecycle.py``, whole: the host logic is the
JAX package's; the engine it warms is the port's (its paged kernels build
at their first launch, so the warm generation is what pays the build and
the probes before the replica takes traffic).

Reference shape: DeepSpeed-MII's deployment tier brings replicas up
*behind* the load balancer — a replica takes traffic only after its
engine exists and its programs are compiled. This module is that
contract for the serving tier: a :class:`ReplicaHandle` walks one
replica through the state machine, and the router's warm gate
(``ReplicaRouter.add_replica(ready=...)``) guarantees no dispatch ever
lands on a replica that has not finished WARMING.

The warm step is where the repo's two caches pay off (the fleet half of
the ROADMAP north star):

comm-plan cache
    a :class:`~deepspeed_tpu_torch.comm.planner.CollectivePlanner` configured
    in this process loaded its per-``MeshFingerprint`` plan at
    construction; the warm report records how many decisions came from
    cache vs. were searched, and the microbench ``probe_stats`` delta
    across the warm proves no new probe programs were built.

autotune winner cache
    the serving knob the fleet actually tunes per mesh —
    ``fused_decode_chunk`` — goes through the Autotuner-v2
    :class:`~deepspeed_tpu_torch.control.winners.WinnerCache`: the FIRST
    replica on a mesh probes the candidate chunks once (timed decode
    bursts on its own warm engine, before it joins) and stores the
    winner; every LATER replica applies the recorded winner with ZERO
    probes. ``WarmReport.zero_probe_join()`` is the assertion the fs
    bench rung and the warm-join test check.

A handle is deliberately supervisor-agnostic: :class:`FleetManager`
(manager.py) owns policy (when to scale), ledger entries, and reaping;
the handle owns mechanism (how one replica moves between states).
"""

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..runtime.resilience.chaos import get_chaos
from ..utils.logging import logger

# -- states -----------------------------------------------------------------
SPAWNING = "SPAWNING"   # handle created; engine/server being constructed
WARMING = "WARMING"     # server exists; compiling + applying cached winners
JOINED = "JOINED"       # registered with the router, taking traffic
DRAINING = "DRAINING"   # dispatch stopped, in-flight work finishing
DEAD = "DEAD"           # gone (drained, reaped, or killed)

STATES = (SPAWNING, WARMING, JOINED, DRAINING, DEAD)

#: legal transitions; DEAD is reachable from everywhere (reap/kill)
_TRANSITIONS = {
    SPAWNING: (WARMING, DEAD),
    WARMING: (JOINED, DEAD),
    JOINED: (DRAINING, DEAD),
    DRAINING: (DEAD,),
    DEAD: (),
}

#: the serving search space the fleet tunes per mesh (Autotuner-v2
#: vocabulary: dimension -> candidate names; the winner's overrides carry
#: the resolved chunk). One dimension today — the fused-decode chunk —
#: because it is the one serving knob with a real per-mesh answer.
SERVING_SPACE_DIMS: Dict[str, List[str]] = {
    "fused_decode_chunk": ["fd0", "fd8"],
}
SERVING_SPACE_METRIC = "serving_decode_tok_s"
_CHUNK_OF = {"fd0": 0, "fd8": 8}


class ReplicaSpawnError(RuntimeError):
    """Replica bring-up failed before the server existed (host allocation,
    process launch, or the ``replica_spawn_fail`` chaos drill)."""


def serving_space_signature() -> str:
    from ..control.winners import space_signature

    return space_signature(SERVING_SPACE_DIMS, SERVING_SPACE_METRIC)


@dataclass
class WarmReport:
    """What one replica's warm-up actually did — the evidence the
    zero-probe join contract is judged by (ledger params, bench asserts)."""
    replica_id: int = -1
    warm_s: float = 0.0
    warm_tokens: int = 0
    # comm-plan cache: decisions present on the planner after warm, and
    # how many of them were loaded from the per-mesh plan cache
    plan_decisions: int = 0
    plan_from_cache: int = 0
    # microbench probe programs BUILT during this warm (cache-hit lookups
    # don't count) — 0 is the zero-probe contract for the plan side
    probes_built: int = 0
    # autotune winner cache: did the serving winner come from cache, and
    # how many timed probe runs did THIS replica execute (0 on a hit)
    autotune_from_cache: bool = False
    autotune_probes: int = 0
    winner_name: Optional[str] = None
    fused_decode_chunk: Optional[int] = None

    def zero_probe_join(self) -> bool:
        """True when this replica joined without running a single probe:
        no microbench programs built, no autotune candidates timed."""
        return self.probes_built == 0 and self.autotune_probes == 0

    def to_params(self) -> Dict[str, str]:
        """Ledger-friendly (str->str) rendering for ControlLedger params."""
        return {
            "replica": str(self.replica_id),
            "warm_s": f"{self.warm_s:.3f}",
            "warm_tokens": str(self.warm_tokens),
            "plan_decisions": str(self.plan_decisions),
            "plan_from_cache": str(self.plan_from_cache),
            "probes_built": str(self.probes_built),
            "autotune_from_cache": str(self.autotune_from_cache),
            "autotune_probes": str(self.autotune_probes),
            "winner": str(self.winner_name),
            "fused_decode_chunk": str(self.fused_decode_chunk),
            "zero_probe": str(self.zero_probe_join()),
        }


class ReplicaHandle:
    """One replica's walk through the lifecycle state machine.

    ``factory(replica_id)`` builds the replica's ``LLMServer`` (the
    in-process path; a subprocess-backed server that speaks the same
    protocol — see :mod:`.subproc` — drops in unchanged, which is what
    keeps the state machine honest about real deployments). The handle
    never starts the server itself: joining the router does, so a replica
    that fails to warm never has an engine thread to leak."""

    def __init__(self, replica_id: int, factory: Callable[[int], Any], *,
                 warm_prompt_tokens: int = 8, warm_new_tokens: int = 8,
                 probe_new_tokens: int = 8,
                 autotune_cache_dir: Optional[str] = None,
                 use_winner_cache: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.replica_id = int(replica_id)
        self.factory = factory
        self.warm_prompt_tokens = int(warm_prompt_tokens)
        self.warm_new_tokens = int(warm_new_tokens)
        self.probe_new_tokens = int(probe_new_tokens)
        self.autotune_cache_dir = autotune_cache_dir
        self.use_winner_cache = bool(use_winner_cache)
        self.clock = clock
        self.server: Optional[Any] = None
        self.report = WarmReport(replica_id=self.replica_id)
        self.state = SPAWNING
        self.transitions: List[Tuple[str, float]] = [(SPAWNING, clock())]

    # -- state machine ------------------------------------------------------
    def _set_state(self, new: str) -> None:
        if new not in _TRANSITIONS[self.state] and new != self.state:
            raise RuntimeError(f"replica {self.replica_id}: illegal "
                               f"transition {self.state} -> {new}")
        if new != self.state:
            self.state = new
            self.transitions.append((new, self.clock()))
            logger.info(f"fleet: replica {self.replica_id} -> {new}")

    @property
    def site(self) -> str:
        """Chaos site name — the same ``replicaN`` vocabulary the serving
        drills (``replica_kill``/``slow_prefill``) use."""
        return f"replica{self.replica_id}"

    # -- SPAWNING -----------------------------------------------------------
    def spawn(self) -> Any:
        """Build the server (engine construction included). The
        ``replica_spawn_fail`` drill fires HERE — before the server exists
        — modeling a host/process allocation failure; the caller
        (FleetManager) must reap the handle, and the router must never
        have seen this replica."""
        assert self.state == SPAWNING, f"spawn() in state {self.state}"
        chaos = get_chaos()
        if chaos is not None and chaos.fire("replica_spawn_fail", self.site):
            self._set_state(DEAD)
            raise ReplicaSpawnError(
                f"chaos: replica {self.replica_id} spawn failed")
        try:
            self.server = self.factory(self.replica_id)
        except BaseException:
            self._set_state(DEAD)
            raise
        if getattr(self.server, "replica_id", self.replica_id) != self.replica_id:
            srv_rid = self.server.replica_id
            self._set_state(DEAD)
            raise ReplicaSpawnError(
                f"factory built replica_id={srv_rid}, "
                f"handle is {self.replica_id}")
        self._set_state(WARMING)
        return self.server

    # -- WARMING ------------------------------------------------------------
    def warm(self) -> WarmReport:
        """Compile the engine's programs and apply the cached per-mesh
        winners, so the JOIN is probe-free and the first real request
        never pays a compile. Runs on the caller's thread against the
        not-yet-started server's engine (single-threaded by construction:
        the engine thread only exists after join)."""
        assert self.state == WARMING, f"warm() in state {self.state}"
        chaos = get_chaos()
        if chaos is not None:
            stall = chaos.value("replica_slow_warm", self.site)
            if stall:
                # slow-warm drill: bring-up stalls (a cold cache fill, a
                # slow compile) — the warm gate must keep traffic off this
                # replica for the whole stall, not just until add_replica
                logger.warning(f"chaos: replica {self.replica_id} warm "
                               f"stalled {float(stall):.3f}s")
                time.sleep(float(stall))
        t0 = self.clock()
        try:
            from ..comm.planner.microbench import probe_stats

            probes_before = probe_stats().get("built", 0)
        except Exception:
            probes_before = None
        self._apply_winner()
        self._warm_generate()
        try:
            from ..comm.planner.microbench import probe_stats

            if probes_before is not None:
                self.report.probes_built = (probe_stats().get("built", 0)
                                            - probes_before)
        except Exception:
            pass
        self._record_plan_stats()
        self.report.warm_s = self.clock() - t0
        # the server is warm by fiat of this completed warm-up — the
        # router's gate (and its lazy promotion) reads this flag
        self.server.warmed = True
        return self.report

    def _warm_prompt(self) -> np.ndarray:
        """Deterministic tiny prompt inside any model's vocab (token ids
        1..N — 0 is conventionally a pad/special id)."""
        return (np.arange(self.warm_prompt_tokens, dtype=np.int32) % 32) + 1

    def _warm_generate(self) -> None:
        """One short generation through the server's own engine: compiles
        the packed SplitFuse step and — when a fused chunk was resolved —
        the fused decode path, exactly the programs real traffic runs."""
        engine = getattr(self.server, "engine", None)
        if engine is None or not hasattr(engine, "generate"):
            return      # protocol server (e.g. subprocess proxy): the
                        # remote side warms itself before reporting warm
        out = engine.generate([self._warm_prompt()],
                              max_new_tokens=self.warm_new_tokens)
        self.report.warm_tokens += sum(len(t) for t in out)
        chunk = getattr(self.server, "fused_decode_chunk", 0)
        if chunk and chunk > 1 and hasattr(engine, "decode_batch"):
            # compile the fused path at its real chunk size too
            self.report.warm_tokens += self._run_decode(engine, chunk,
                                                        self.warm_new_tokens)

    def _run_decode(self, engine, chunk: int, new_tokens: int) -> int:
        """Prefill one probe sequence, then decode ``new_tokens`` via the
        requested path (fused chunks when ``chunk > 1``, packed
        single-token steps otherwise). Returns tokens generated."""
        uid = 1_000_000 + self.replica_id
        engine.put([uid], [self._warm_prompt()], max_new_tokens=new_tokens)
        while any(s.in_prefill for s in engine.state_manager.all()
                  if not s.done):
            engine.step()
            if engine.last_num_scheduled == 0:
                break
        produced = 0
        while True:
            seq = engine.state_manager.get(uid)
            if seq is None or seq.done or produced >= new_tokens:
                break
            if chunk > 1 and hasattr(engine, "decode_batch"):
                out = engine.decode_batch(min(chunk, new_tokens - produced))
                produced += sum(len(t) for t in (out or {}).values())
                if not out:
                    break
            else:
                out = engine.step()
                produced += len(out or {})
                if engine.last_num_scheduled == 0 and not out:
                    break
        engine.flush(uid)
        return produced

    def _apply_winner(self) -> None:
        """Autotuner-v2 winner application: a cache hit applies the
        recorded ``fused_decode_chunk`` with zero probes; a miss (first
        replica on this mesh) times each candidate once on THIS replica's
        warm engine and stores the winner for the rest of the fleet."""
        if not self.use_winner_cache:
            return
        engine = getattr(self.server, "engine", None)
        if engine is None or not hasattr(self.server, "fused_decode_chunk"):
            return
        try:
            from ..comm.planner.topo import MeshFingerprint
            from ..control.winners import WinnerCache

            fp = MeshFingerprint.capture()
            cache = WinnerCache(self.autotune_cache_dir)
            sig = serving_space_signature()
            hit = cache.lookup(fp, sig)
        except Exception as e:
            logger.warning(f"fleet: winner cache unavailable "
                           f"({e!r}); keeping configured knobs")
            return
        if hit is not None:
            chunk = hit.get("overrides", {}).get("fused_decode_chunk")
            if chunk is not None:
                self.server.fused_decode_chunk = int(chunk)
                self.report.fused_decode_chunk = int(chunk)
            self.report.winner_name = hit.get("winner")
            self.report.autotune_from_cache = True
            logger.info(f"fleet: replica {self.replica_id} applied cached "
                        f"serving winner {hit.get('winner')!r} "
                        f"(fused_decode_chunk={chunk}) — zero probes")
            return
        # miss: probe once, on the warm engine, BEFORE taking traffic
        timings: Dict[str, float] = {}
        for name in SERVING_SPACE_DIMS["fused_decode_chunk"]:
            chunk = _CHUNK_OF[name]
            self._run_decode(engine, chunk, self.probe_new_tokens)  # compile
            t0 = self.clock()
            produced = self._run_decode(engine, chunk, self.probe_new_tokens)
            dt = max(1e-9, self.clock() - t0)
            timings[name] = produced / dt
            self.report.autotune_probes += 1
        winner = max(timings, key=lambda k: timings[k])
        chunk = _CHUNK_OF[winner]
        self.server.fused_decode_chunk = chunk
        self.report.winner_name = winner
        self.report.fused_decode_chunk = chunk
        try:
            cache.store(fp, sig, {
                "winner": winner,
                "overrides": {"fused_decode_chunk": chunk},
                "timings_tok_s": {k: round(v, 2) for k, v in timings.items()},
                "probes_run": self.report.autotune_probes,
                "metric": SERVING_SPACE_METRIC,
            })
        except OSError:
            pass  # read-only FS: winner still applies in-memory
        logger.info(f"fleet: replica {self.replica_id} probed serving "
                    f"winner {winner!r} ({timings}) and cached it")

    def _record_plan_stats(self) -> None:
        try:
            from ..comm.planner import get_planner, planner_active

            if planner_active():
                pl = get_planner()
                decisions = set(getattr(pl.plan, "decisions", {}) or {})
                self.report.plan_decisions = len(decisions)
                self.report.plan_from_cache = len(
                    decisions & set(getattr(pl, "_from_cache", ())))
        except Exception:
            pass  # no planner in this process: plan stats stay zero

    # -- JOINED -------------------------------------------------------------
    def join(self, router) -> None:
        """Register with the router. The server is warm, so the router's
        gate admits it immediately (``ready`` inferred from ``warmed``) —
        this is the FIRST moment traffic can reach the replica."""
        assert self.state == WARMING, f"join() in state {self.state}"
        router.add_replica(self.server)
        self._set_state(JOINED)

    def bring_up(self, router) -> WarmReport:
        """spawn → warm → join, the full scale-out arc."""
        self.spawn()
        self.warm()
        self.join(router)
        return self.report

    # -- DRAINING / DEAD ----------------------------------------------------
    def drain(self, router=None, timeout: Optional[float] = None) -> bool:
        """Graceful exit: stop dispatch, finish in-flight work, stop."""
        self._set_state(DRAINING)
        if router is not None:
            ok = router.drain_replica(self.replica_id, timeout)
        else:
            ok = self.server.drain(timeout) if self.server is not None else True
        self._set_state(DEAD)
        return ok

    def kill(self) -> None:
        """Abrupt stop (reap path, chaos cleanup): halt whatever exists."""
        if self.server is not None:
            try:
                self.server.halt()
            except Exception:
                pass  # swallow-ok: reaping a half-built server must not throw over its corpse
        if self.state != DEAD:
            self.state = DEAD          # kill is legal from every state
            self.transitions.append((DEAD, self.clock()))

    def describe(self) -> Dict[str, Any]:
        return {"replica": self.replica_id, "state": self.state,
                "transitions": [(s, round(t, 3)) for s, t in self.transitions],
                "warm": self.report.to_params()}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"ReplicaHandle(replica={self.replica_id}, state={self.state})"
