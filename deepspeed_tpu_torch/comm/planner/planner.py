"""The collective planner: per-site implementation selection, cached.

Port of ``deepspeed_tpu/comm/planner/planner.py``, whole. Multi-process
agreement (``_agree``) runs over ``torch.distributed`` through the port's
``comm.broadcast_host_data``. The sites the port resolves today are the
serving engine's ``decode_attn`` (``inference/v2/engine_v2.py``); the
training engine's sites need the ring and program executors (ROADMAP.md
Queue A item 8) and stay refused by the engine.

Resolution order for ``resolve(site)``:

1. **knob** — a raw config knob the user explicitly set always wins
   (``compressed_collectives.mode != none``, ``overlap_collective_matmul``);
   the planner never overrides an explicit choice.
2. **memo / cache** — a decision already made this run, or loaded from the
   on-disk plan for this mesh fingerprint (``planner/cache.py``).
3. **off** — today's defaults, bit-identical to the pre-planner tree (the
   wiring short-circuits before even calling resolve in this mode; resolve
   still answers for direct callers).
4. **static** — the alpha-beta cost model's argmin (``planner/topo.py``).
5. **measure** — cost-model pruning, then microbenchmarks pick the winner
   (``planner/microbench.py``); written through to the disk cache. A
   candidate whose probe fails loses, except on the card, where a failed
   ``decode_attn`` probe raises ``ProbeError``.

Every resolution is recorded once in the comms ledger
(``CommsLogger.record_plan``) so ``comm.log_summary()`` prints the plan
table next to the traffic table.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .cache import PlanCache
from .compiler import (DEFAULT_BEAM_WIDTH, SEARCH_SPACE, compile_programs,
                       legacy_menu_programs, program_capable)
from .ir import (GRADIENT_CONSUMERS, CollectiveSite, FusedCompute, PhaseStep,
                 Plan, PlanDecision, make_phase, make_site, program_summary)
from .microbench import ProbeError, benchmark_site
from .topo import CostModel, MeshFingerprint

MODES = ("off", "static", "measure")


def synthesize_programs(site: CollectiveSite, cost: CostModel,
                        block: int = 2048) -> List[Tuple[PhaseStep, ...]]:
    """Compat shim: PR 8's five hand-written hierarchical candidates,
    exactly as before. Real synthesis moved to ``planner/compiler.py`` —
    :func:`compile_programs` searches the full program space (axis
    groupings x algorithm shapes x wire dtypes x chunking) and the
    planner's ``_candidates`` uses that beam; this function remains for
    callers and tests that want the legacy fixed menu."""
    return legacy_menu_programs(site, cost, block=block)


class CollectivePlanner:
    def __init__(self, mode: str = "off", *,
                 knobs: Optional[Dict[str, Any]] = None,
                 cache_dir: Optional[str] = None,
                 use_cache: bool = True,
                 margin: float = 3.0,
                 measure_reps: int = 4,
                 measure_max_elems: int = 1 << 16,
                 block: int = 2048,
                 dcn_axes: Optional[Sequence[str]] = None,
                 beam_width: Optional[int] = None,
                 overlap_credit: Optional[float] = None,
                 topology=None):
        if mode not in MODES:
            raise ValueError(f"comm_planner mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self.knobs = dict(knobs or {})
        self.margin = float(margin)
        self.measure_reps = int(measure_reps)
        self.measure_max_elems = int(measure_max_elems)
        self.block = int(block)
        self.beam_width = int(beam_width) if beam_width else DEFAULT_BEAM_WIDTH
        self.overlap_credit = (None if overlap_credit is None
                               else float(overlap_credit))
        self.fingerprint = MeshFingerprint.capture(topology)
        forced = ()
        if dcn_axes:
            # operator-forced DCN axes (``comm_planner.dcn_axes``): rehearse
            # a multi-slice plan on a single-slice (or CPU) dev box. The
            # override is part of the fingerprint, so forced plans never
            # collide with this mesh's organic plan cache entry. Axes that
            # name no fleet mesh axis are KEPT (they mark foreign-mesh
            # sites — the zeropp factory's own ``dp`` axis resolves with an
            # explicit ``axis_size`` and its link class comes from exactly
            # this membership test) but called out, since a typo here
            # switches costing to fleet (accelerator) rates
            known = {n for n, s in self.fingerprint.axis_sizes if s > 1}
            forced = tuple(dict.fromkeys(str(a) for a in dcn_axes))
            foreign = [a for a in forced if a not in known]
            if foreign:
                from ...utils.logging import logger

                logger.warning(
                    f"comm_planner.dcn_axes: {foreign} match no multi-rank "
                    f"fleet mesh axis (known: {sorted(known)}) — kept as "
                    f"foreign-mesh DCN axes (zeropp-style sites with their "
                    f"own mesh); no cross-slice PROGRAM will be "
                    f"synthesized for them, and a typo here prices plans "
                    f"at fleet rates")
            if forced:
                self.fingerprint = dataclasses.replace(
                    self.fingerprint,
                    dcn_axes=tuple(sorted(set(self.fingerprint.dcn_axes)
                                          | set(forced))))
        # fleet costing only when an override actually took: a typo'd
        # dcn_axes must not silently switch quantization to the card's rates
        self._assume_fleet = bool(forced)
        self.cost = CostModel(self.fingerprint, block=self.block,
                              assume_fleet=self._assume_fleet,
                              overlap_credit=self.overlap_credit)
        # the winner cache is keyed by (fingerprint, SEARCH_SPACE): widening
        # the compiler's grammar in a later version is a clean cache miss —
        # a winner searched over a narrower space must not be replayed
        self.cache = (PlanCache(cache_dir, space_version=SEARCH_SPACE)
                      if use_cache else None)
        self._search_notes: Dict[str, str] = {}
        self.plan = Plan(fingerprint=self.fingerprint.digest())
        self._from_cache = set()
        if self.cache is not None and mode != "off":
            cached = self.cache.load(self.fingerprint)
            if cached is not None:
                self.plan.decisions.update(cached.decisions)
                self._from_cache = set(cached.decisions)
        self._recorded = set()
        self._agreed = set()  # sigs already broadcast-synced across hosts

    # ------------------------------------------------------------------
    def resolve(self, site: CollectiveSite) -> PlanDecision:
        sig = site.signature()
        knob = self._knob_decision(site)
        if knob is not None:
            # an explicit raw knob is answered directly and NEVER stored:
            # a knob choice is the user's, not a tuned plan — it must not
            # leak into the cache a later knob-less run would load
            self._record(site, knob)
            return knob
        decision = self.plan.decisions.get(sig)
        if decision is not None and sig in self._from_cache:
            decision = dataclasses.replace(decision, source="cache")
        if decision is None:
            if self.mode == "off":
                decision = self._default_decision(site)
            elif self.mode == "static":
                decision = self._static_decision(site)
            else:
                decision = self._measure(site)
        if sig not in self._agreed:
            # multi-host: every process MUST run the same implementation or
            # the SPMD programs issue mismatched collectives and deadlock —
            # measured timings (and per-host caches) can disagree, so rank
            # 0's decision is broadcast. Every host resolves the same sites
            # in the same order (same program construction), and knob
            # decisions come from the shared config, so the broadcasts
            # align; memoized re-resolutions never re-broadcast.
            decision = self._agree(decision)
            self._agreed.add(sig)
        self.plan.decisions[sig] = decision
        if self.cache is not None and self.mode != "off" \
                and sig not in self._from_cache:
            # write-through: one file per mesh fingerprint, merge-on-store
            try:
                self.cache.store(self.fingerprint, self.plan)
            except OSError:
                pass  # read-only FS: plan still lives in memory
        self._record(site, decision)
        return decision

    def replan_around(self, slow_axes: Sequence[str], *,
                      penalty: float = 4.0,
                      consumers: Sequence[str] = GRADIENT_CONSUMERS) -> bool:
        """Control-plane re-plan: demote the named mesh axes to DCN-class
        links (a straggler's link IS a slow cross-host link, whatever the
        nominal topology says), penalize them by the observed slowdown,
        and forget every decision for ``consumers`` so the next resolve
        re-synthesizes against the demoted fingerprint — hierarchical
        programs whose full-width phases EXCLUDE the slow axes become
        eligible (and, with the penalty, win).

        The fingerprint mutation re-keys the plan/cache identity exactly
        like the ``comm_planner.dcn_axes`` override does, so a replanned
        decision can never pollute this mesh's organic cache entry — and a
        restart that performs the same demotion resolves the same cached
        replanned plan. Returns False (no state touched) when none of the
        axes name a multi-rank mesh axis or the planner is off.

        ``consumers`` defaults to every gradient consumer (dp-grad AND
        zeropp) so a ZeRO++ factory rebuilt after the demotion re-resolves
        against the demoted links too — keeping only one consumer would
        re-persist the other's stale fast-link decisions under the new
        fingerprint."""
        if self.mode == "off":
            return False
        known = {n for n, s in self.fingerprint.axis_sizes if s > 1}
        slow = tuple(a for a in slow_axes if a in known)
        if not slow:
            return False
        self.fingerprint = dataclasses.replace(
            self.fingerprint,
            dcn_axes=tuple(sorted(set(self.fingerprint.dcn_axes)
                                  | set(slow))))
        penalties = dict(self.cost.link_penalties)
        for a in slow:
            penalties[a] = max(penalties.get(a, 1.0), float(penalty))
        # fleet costing: the demoted link is priced as the slow cross-host
        # hop it behaves as; quant at accelerator rates, as with dcn_axes
        self._assume_fleet = True
        self.cost = CostModel(self.fingerprint, block=self.block,
                              assume_fleet=True, link_penalties=penalties,
                              overlap_credit=self.overlap_credit)
        drop = {sig for sig in self.plan.decisions
                if sig.split(":", 1)[0] in set(consumers)}
        self.plan = Plan(
            fingerprint=self.fingerprint.digest(),
            decisions={sig: d for sig, d in self.plan.decisions.items()
                       if sig not in drop})
        self._from_cache -= drop
        self._agreed -= drop
        self._recorded -= drop
        if self.cache is not None:
            # a PREVIOUS run already measured under this demoted identity:
            # load its decisions (current in-memory ones win) so a restart
            # that repeats the demotion reuses them instead of re-running
            # microbenchmarks mid-training
            cached = self.cache.load(self.fingerprint)
            if cached is not None:
                for sig, d in cached.decisions.items():
                    if sig not in self.plan.decisions:
                        self.plan.decisions[sig] = d
                        self._from_cache.add(sig)
        return True

    def _agree(self, decision: PlanDecision) -> PlanDecision:
        """Rank 0's decision, on every process (no-op single-process)."""
        from ..comm import broadcast_host_data, get_world_size

        if get_world_size() <= 1:
            return decision

        return PlanDecision.from_dict(broadcast_host_data(decision.to_dict(),
                                                          src=0))

    # ------------------------------------------------------------------
    def _knob_decision(self, site: CollectiveSite) -> Optional[PlanDecision]:
        """Explicitly-set raw knobs win over any planning."""
        if site.op == "decode_attn":
            # the serving decode kernel choice: no raw training knob maps
            # to it (the engine's own attn_backend pins are applied BEFORE
            # the planner is consulted), and the compression knob must not
            # hijack it into an "xla" decision that isn't on its menu
            return None
        if site.op == "gather_matmul":
            if self.knobs.get("overlap"):
                return PlanDecision(impl="fused_matmul", source="knob")
            return None
        comp = self.knobs.get("compression")
        if comp is None:
            return None
        site_key = {"dp-grad": "dp_gradients", "ulysses": "ulysses",
                    "moe-a2a": "moe"}.get(site.consumer)
        if site.consumer == "zeropp":
            site_key = ("zero_gradients" if site.op == "reduce_scatter"
                        else "zero_weights")
        if site_key is None or not comp.get("sites", {}).get(site_key, True):
            return PlanDecision(impl="xla", source="knob")
        mode = comp["mode"]
        if site.consumer not in GRADIENT_CONSUMERS:
            mode = "int8"  # activation exchanges never dither
        if site.consumer == "dp-grad" and comp.get("hierarchical"):
            # same gate as the engine wiring: both split levels must be real
            p_in, p_out = self.cost._split_axes(site)
            if p_in > 1 and p_out > 1:
                return PlanDecision(impl="hierarchical",
                                    block=comp.get("block"), source="knob")
        return PlanDecision(impl=mode, block=comp.get("block"), source="knob")

    def _default_decision(self, site: CollectiveSite) -> PlanDecision:
        """Planner off, no knob: what the tree does today."""
        if site.op == "decode_attn":
            return PlanDecision(impl="einsum", source="default")
        if site.consumer == "zeropp":
            # zeropp_train_step_factory's legacy default is quantized ON
            return PlanDecision(impl="int8", block=self.block,
                                source="default")
        return PlanDecision(impl="xla", source="default")

    def _candidates(self, site: CollectiveSite):
        """Cost-ranked, margin-pruned ``(impl, est_s, program)`` candidates:
        the single-impl menu (``CostModel.prune``) PLUS the compiled program
        beam (``compiler.compile_programs`` — groupings x shapes x wires x
        chunking, slot-pruned), priced on the same alpha-beta scale. Stable
        sort keeps emission order on ties, with singles listed first so a
        program that merely MATCHES a flat impl can never displace it.

        Program candidates only survive at sites whose wiring can execute
        a program decision (``compiler.PROGRAM_CAPABLE`` — today the
        engine's dp-grad reduction). Elsewhere the beam is still compiled
        and the outcome recorded (``program_search`` in the plan table),
        but handing "program" to a wiring that dispatches on impl flags
        would silently run the exact path under a quantized-plan label —
        the planner keeps the best executable impl instead."""
        cands = [(impl, est, None)
                 for impl, est in self.cost.prune(site, margin=self.margin)]
        beam = compile_programs(site, self.cost, block=self.block,
                                beam_width=self.beam_width)
        note = None
        if beam and program_capable(site):
            cands.extend(("program", est, prog) for prog, est in beam)
            note = f"beam:{len(beam)}"
        elif beam:
            note = ("skipped:foreign-axis" if site.axis_size is not None
                    else "skipped:wiring")
        elif site.axis_size is not None:
            note = "skipped:foreign-axis"
        if note is not None:
            self._search_notes[site.signature()] = note
        cands.sort(key=lambda t: t[1])
        best = cands[0][1]
        cut = best * self.margin if best > 0 else float("inf")
        return [c for c in cands if c[1] <= cut] or cands[:1]

    def _static_decision(self, site: CollectiveSite) -> PlanDecision:
        """Static-mode decision: argmin over single impls AND programs."""
        impl, est, prog = self._candidates(site)[0]
        return self._finish(site, impl, est_s=est, source="cost-model",
                            program=prog)

    def _measure(self, site: CollectiveSite) -> PlanDecision:
        survivors = self._candidates(site)
        if len(survivors) == 1:
            impl, est, prog = survivors[0]
            return self._finish(site, impl, est_s=est, source="cost-model",
                                program=prog)
        timed, errs = [], []
        for impl, _, prog in survivors:
            try:
                t = benchmark_site(site, impl, block=self.block,
                                   program=prog,
                                   reps=self.measure_reps,
                                   max_elems=self.measure_max_elems)
            except ProbeError:
                raise  # a kernel that fails on the card is a fault
            except Exception as e:  # a candidate that fails to build loses
                name = impl if prog is None else program_summary(prog)
                errs.append(f"{name}: {type(e).__name__}: {e}")
                continue
            timed.append((impl, t, prog))
        if not timed:
            # degrade loudly, not silently: the user asked for measurement
            from ...utils.logging import logger

            logger.warning(
                f"comm_planner: no candidate probe ran for "
                f"{site.signature()} — falling back to the cost model "
                f"({'; '.join(errs)[:300]})")
            impl, est, prog = survivors[0]
            return self._finish(site, impl, est_s=est, source="cost-model",
                                program=prog)
        impl, t, prog = min(timed, key=lambda kv: kv[1])
        return self._finish(site, impl, est_s=t, source="measured",
                            program=prog)

    def calibrate_overlap_credit(self, site: CollectiveSite, *,
                                 reps: Optional[int] = None
                                 ) -> Optional[float]:
        """Measure the fused-matmul overlap credit instead of trusting the
        0.55 default: time a fused-hierarchical program against its
        sequenced twin (same phases, ``via="xla"``, no compute binding)
        through the real executor, set ``CostModel.overlap_credit`` to the
        observed hidden fraction ``(t_seq - t_fused) / t_seq`` (clamped to
        [0.05, 0.95] — no transfer hides completely, and a noisy negative
        sample must not zero the credit), and return it. Returns None —
        cost model untouched — when the site admits no fused program or a
        probe fails; subsequent ``resolve`` calls price candidates with the
        calibrated credit."""
        fused = next((p for p in legacy_menu_programs(site, self.cost,
                                                      block=self.block)
                      if any(s.via == "fused_matmul" for s in p)), None)
        if fused is None:
            return None
        seq = tuple(dataclasses.replace(s, via="xla", compute=None)
                    if s.via == "fused_matmul" else s for s in fused)
        reps = int(reps or self.measure_reps)
        try:
            t_fused = benchmark_site(site, "program", block=self.block,
                                     program=fused, reps=reps,
                                     max_elems=self.measure_max_elems)
            t_seq = benchmark_site(site, "program", block=self.block,
                                   program=seq, reps=reps,
                                   max_elems=self.measure_max_elems)
        except Exception:
            return None
        if not (t_seq > 0.0 and t_fused > 0.0):
            return None
        credit = min(0.95, max(0.05, (t_seq - t_fused) / t_seq))
        self.overlap_credit = credit
        self.cost = CostModel(self.fingerprint, block=self.block,
                              assume_fleet=self._assume_fleet,
                              link_penalties=self.cost.link_penalties,
                              overlap_credit=credit)
        return credit

    def _finish(self, site: CollectiveSite, impl: str, *, est_s: float,
                source: str, program=None) -> PlanDecision:
        block = self.block if impl in ("int8", "int8_sr", "hierarchical",
                                       "program") else None
        if impl == "fused_matmul" and site.op in ("all_gather",
                                                  "reduce_scatter"):
            # the fused gather/scatter rings carry an int8 wire (the TP
            # gather_matmul fused impl stays exact and blockless)
            block = self.block
        return PlanDecision(impl=impl, block=block, source=source,
                            est_us=round(est_s * 1e6, 3),
                            program=program)

    def _record(self, site: CollectiveSite, decision: PlanDecision) -> None:
        sig = site.signature()
        if sig in self._recorded:
            return
        self._recorded.add(sig)
        from ..comm import get_comms_logger

        info = {
            "consumer": site.consumer, "op": site.op,
            "shape": "x".join(str(d) for d in site.shape) or "scalar",
            "axes": ",".join(site.axes), "impl": decision.impl,
            "block": decision.block, "source": decision.source,
            "est_us": decision.est_us, "mode": self.mode,
        }
        note = self._search_notes.get(sig)
        if note is not None:
            # what the program compiler did here: "beam:N" (N candidates
            # competed) or an explicit skip — "skipped:foreign-axis" /
            # "skipped:wiring" (programs compiled but the site's wiring
            # can't execute a program decision; silent degradation is the
            # one thing this column exists to rule out)
            info["program_search"] = note
        if decision.program is not None:
            info["program"] = program_summary(decision.program)
            # the structured per-phase dicts ride beside the summary so
            # the graph auditor expands a program decision per hop (a
            # fused/ring phase emits p-1 collective-permutes, not the
            # phase's nominal fused collective) without re-parsing the
            # summary string
            info["program_phases"] = [s.to_dict()
                                      for s in decision.program]
        get_comms_logger().record_plan(sig, info)


# ---------------------------------------------------------------------------
# Fleet-wide planner instance (the configure_compression pattern):
# initialize() maps config.comm_planner onto this; the wiring reads it.
# ---------------------------------------------------------------------------

_PLANNER: Optional[CollectivePlanner] = None


def configure_planner(mode: str = "off", **kwargs) -> CollectivePlanner:
    global _PLANNER
    _PLANNER = CollectivePlanner(mode, **kwargs)
    return _PLANNER


def reset_planner() -> None:
    global _PLANNER
    _PLANNER = None


def get_planner() -> CollectivePlanner:
    global _PLANNER
    if _PLANNER is None:
        _PLANNER = CollectivePlanner("off")
    return _PLANNER


def planner_active() -> bool:
    """True when a planner with mode static|measure is configured — the
    wiring's gate: inactive means every site keeps today's exact behavior
    (``comm_planner: off`` is bit-identical to the pre-planner tree)."""
    return _PLANNER is not None and _PLANNER.mode != "off"


def resolve_site(**kwargs) -> PlanDecision:
    """Build a site from keyword parts and resolve it against the fleet
    planner — the one-liner the five wirings call."""
    return get_planner().resolve(make_site(**kwargs))


def configure_from_config(config, topology=None) -> CollectivePlanner:
    """Map the runtime config onto the fleet planner: the ``comm_planner``
    block picks the mode/cache knobs, and the explicitly-set raw fast-path
    knobs (``compressed_collectives``, ``overlap_collective_matmul``) are
    snapshotted so they keep winning at their sites."""
    pl = config.comm_planner
    knobs: Dict[str, Any] = {}
    cc = config.compressed_collectives
    if cc.mode != "none":
        knobs["compression"] = {"mode": cc.mode, "block": cc.block,
                                "hierarchical": cc.hierarchical,
                                "sites": cc.site_map()}
    if config.tensor_parallel.overlap_collective_matmul:
        knobs["overlap"] = True
    return configure_planner(pl.mode, knobs=knobs, cache_dir=pl.cache_dir,
                             use_cache=pl.use_cache, margin=pl.margin,
                             measure_reps=pl.measure_reps,
                             measure_max_elems=pl.measure_max_elems,
                             block=cc.block, dcn_axes=pl.dcn_axes,
                             beam_width=pl.beam_width,
                             overlap_credit=pl.overlap_credit,
                             topology=topology)
