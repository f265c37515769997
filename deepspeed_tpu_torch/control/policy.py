"""The supervisor's rule book: live signal -> guarded knob action.

Port of ``deepspeed_tpu/control/policy.py``, host logic unchanged. The
port has no comm planner and no training-engine wiring (ROADMAP.md Queue A
item 9), so the straggler, memory, rollback and integrity rules find no
engine to act on; ``rule_sla`` drives the serving tier.

Each rule reads one signal the fleet already publishes, runs it through the
:class:`~.guard.FlapGuard` (hysteresis + cooldown + budget), and — when the
guard lets it fire — moves exactly one knob through an actuator the stack
already has, recording a :class:`~.ledger.ControlAction` either way. The
table:

======================  ==========================  =========================
signal                  condition                   action (escalation)
======================  ==========================  =========================
HealthTable straggler   any live peer > k x the     re-plan the DP-grad
verdict                 leave-one-out median        collective around the
                                                    slow host's link
                                                    (planner re-synthesis)
dstpu_mem gauges        bytes_in_use >=             raise remat one rung;
                        watermark x bytes_limit     when exhausted, halve
                                                    micro-batch (2x GAS)
ServingMetrics SLA      violation rate >= r over    scale out via scale_fn
counters                >= n tracked finishes       when registered, else
                                                    shed (halve admission);
                                                    restore on recovery
sentinel rollbacks      >= n rollbacks within       enter the existing
                        the window                  degraded mode (exact
                                                    collectives)
======================  ==========================  =========================

Rules only ever *narrow* behavior toward safer/cheaper configurations
mid-run (exact collectives, more remat, less admission); re-escalation is
the operator's (``clear_degraded``) or a restart's job — an automatic
re-escalation would re-enter the very condition that triggered the rule.
"""

from typing import List, Tuple

# (rule, signal, condition knob, action, cooldown knob) — the docs table's
# machine-readable twin; tests assert the rule names the supervisor fires
# stay in sync with this book.
POLICY_TABLE: List[Tuple[str, str, str, str]] = [
    ("straggler_replan", "HealthTable straggler verdict",
     "any straggler row", "replan dp-grad around the slow link"),
    ("mem_pressure", "dstpu_mem_bytes_in_use / bytes_limit",
     "ratio >= supervisor.mem_watermark",
     "raise_remat, then halve_micro_batch"),
    ("sla_pressure", "ServingMetrics sla_violations / sla_tracked",
     ">= supervisor.sla_violation_rate over >= sla_min_tracked",
     "serving_scale (scale_fn) else serving_shed"),
    ("rollback_degrade", "sentinel rollbacks",
     ">= supervisor.rollback_threshold within rollback_window_s",
     "enter_degraded (exact collectives)"),
    ("integrity", "cross-rank fingerprint divergence (integrity tier)",
     "any unactioned divergence verdict",
     "integrity_rollback (newest VERIFIED snapshot); sticky minority -> "
     "sdc_quarantine (replan around the corrupt host)"),
]

RULE_NAMES = tuple(r[0] for r in POLICY_TABLE)


# ---------------------------------------------------------------------------
# training-side rules (sup = ControlSupervisor)
# ---------------------------------------------------------------------------


def rule_straggler(sup, step: int) -> None:
    """Straggler verdict -> re-invoke planner synthesis around the slow
    host's link. The HealthTable verdict is derived from the SHARED beacon
    table, so every controller observes the same signal at the same steps
    and the re-resolved decision still rides the planner's rank-0
    broadcast — the fleet re-plans together, not rank by rank.

    Static feasibility is checked BEFORE the guard: an engine that can
    never re-plan (planner off, ZeRO>0's declarative reductions, a
    single-axis dp span) gets one explanatory ledger note and never
    charges the global action budget with guaranteed no-ops."""
    stragglers = sup.straggler_rows()
    if not stragglers:
        # the steady-state path: one clear observation for the latch,
        # nothing else computed (feasibility probes cost planner/topo
        # lookups that do not belong on the per-step hot path)
        sup.guard.should_fire("straggler_replan", False)
        return
    axes = sup.slow_link_axes()
    if not axes or not sup.can_replan():
        if stragglers:
            ranks = sorted(r for r, _ in stragglers)
            sig = f"straggler rank(s) {ranks}"
            if not axes:
                sup.note_infeasible(
                    "straggler_replan", "straggler_replan", step=step,
                    signal=sig,
                    reason="no re-routable mesh axis (single-axis dp "
                           "span: every peer shares the link)",
                    outcome="skipped:no-slow-axes")
            else:
                sup.note_infeasible(
                    "straggler_replan", "straggler_replan", step=step,
                    signal=sig,
                    reason="planner off, or this engine has no "
                           "re-plannable DP-grad site (ZeRO>0 / "
                           "model-parallel reductions are declarative)",
                    outcome="skipped:no-replannable-site")
        return
    if not sup.guard.should_fire("straggler_replan", bool(stragglers)):
        return
    ranks = sorted(r for r, _ in stragglers)
    ratio = max(x for _, x in stragglers)
    sig = (f"straggler rank(s) {ranks} at {ratio:.1f}x the "
           f"leave-one-out peer median")
    penalty = max(float(sup.cfg.supervisor.straggler_penalty), ratio)
    summary = sup.engine.replan_dp_grad(axes, penalty=penalty)
    if summary is None:  # raced a config change between check and act
        sup.ledger.record("straggler_replan", step=step, signal=sig,
                          reason="re-plan refused by the engine",
                          outcome="skipped:no-replannable-site")
        return
    sup.ledger.record(
        "straggler_replan", step=step, signal=sig,
        reason=f"re-planned the DP-grad collective around link "
               f"axes {list(axes)}",
        params={"axes": list(axes), "penalty": round(penalty, 2),
                "plan": summary, "ranks": ranks})


def rule_memory(sup, step: int) -> None:
    """Memory gauge near ``bytes_limit`` -> raise remat; when the remat
    ladder is exhausted, halve the micro-batch (GAS doubles — the global
    batch and the training math are unchanged, per-microbatch activation
    residency halves).

    Each escalation stage is its OWN guard rule (``mem_pressure:<stage>``,
    the stage counter advancing on every successful actuation): a firing
    latches only its stage, so *sustained* pressure — the gauge never
    dropping below the watermark because the last action freed too little
    — escalates to the next rung after another ``trigger_streak`` asserted
    observations instead of latching the whole rule forever. A statically
    exhausted ladder (nothing left to actuate) is one explanatory ledger
    note, never a budget-charging no-op loop."""
    mem = sup.mem_sample() or {}
    in_use, limit = mem.get("bytes_in_use"), mem.get("bytes_limit")
    wm = float(sup.cfg.supervisor.mem_watermark)
    asserted = bool(in_use and limit and in_use >= wm * limit)
    engine = sup.engine
    # static feasibility BEFORE the guard: pressure with nothing left to
    # actuate is one explanatory note, never a budget-charging no-op loop
    can_remat = getattr(engine, "_remat_policy", None) != "nothing_saveable"
    mbs = int(getattr(engine, "micro_batch_size", 0) or 0)
    can_halve = (getattr(engine, "_train_dataloader", None) is None
                 and mbs >= 2 and mbs % 2 == 0)
    if asserted and not (can_remat or can_halve):
        frac = in_use / limit
        sig = f"mem gauge hit {frac:.2f}x bytes_limit (watermark {wm:g})"
        if getattr(engine, "_train_dataloader", None) is not None:
            # a built dataloader yields fixed-size micro batches; halving
            # the engine's micro size without reshaping the stream would
            # feed doubled draws, not smaller ones — leave the shape alone
            sup.note_infeasible(
                "halve_micro_batch", "mem_pressure", step=step, signal=sig,
                reason="remat exhausted; the training dataloader owns the "
                       "batch shape", outcome="skipped:dataloader")
        else:
            sup.note_infeasible(
                "halve_micro_batch", "mem_pressure", step=step, signal=sig,
                reason="remat ladder and micro-batch both exhausted — "
                       "operator attention needed",
                outcome="skipped:exhausted")
        return
    rule = f"mem_pressure:{sup._mem_stage}"
    if not sup.guard.should_fire(rule, asserted):
        return
    frac = in_use / limit
    sig = f"mem gauge hit {frac:.2f}x bytes_limit (watermark {wm:g})"
    policy = engine.raise_remat()
    if policy is not None:
        sup._mem_stage += 1
        sup.ledger.record(
            "raise_remat", step=step, rule=rule, signal=sig,
            reason=f"raised remat to {policy} after {sig}",
            params={"policy": policy, "frac": round(frac, 3)})
        return
    if engine.halve_micro_batch():
        sup._mem_stage += 1
        sup.ledger.record(
            "halve_micro_batch", step=step, rule=rule, signal=sig,
            reason=f"halved micro-batch to {engine.micro_batch_size} "
                   f"(gas {engine.gas}) after {sig}",
            params={"micro_batch": engine.micro_batch_size,
                    "gas": engine.gas})
    else:  # raced a structural change between check and act
        sup.ledger.record(
            "halve_micro_batch", step=step, rule=rule, signal=sig,
            reason="nothing left to actuate", outcome="skipped:exhausted")


def rule_rollbacks(sup, step: int) -> None:
    """Repeated sentinel rollbacks -> the existing degraded-mode entry
    (exact collectives). Complements ``degraded_mode``'s own built-in
    trigger: the control path runs with its OWN threshold/guard so fleets
    that enable control but not the resilience-side auto-degrade still
    converge to exact transports under repeated divergence."""
    sc = sup.cfg.supervisor
    recent = sup.recent_rollbacks(sc.rollback_window_s)
    asserted = len(recent) >= int(sc.rollback_threshold)
    if not sup.guard.should_fire("rollback_degrade", asserted):
        return
    sig = (f"{len(recent)} sentinel rollback(s) within "
           f"{sc.rollback_window_s:g}s")
    rz = getattr(sup.engine, "resilience", None)
    if rz is None:
        sup.ledger.record("enter_degraded", step=step,
                          rule="rollback_degrade", signal=sig,
                          reason="no resilience manager to degrade",
                          outcome="skipped:no-resilience")
        return
    if rz.degraded:
        sup.ledger.record("enter_degraded", step=step,
                          rule="rollback_degrade", signal=sig,
                          reason="already in degraded mode",
                          outcome="skipped:already-degraded")
        return
    rz.enter_degraded(reason=f"control: {sig}")
    sup.ledger.record(
        "enter_degraded", step=step, rule="rollback_degrade", signal=sig,
        reason=f"fell back to exact collectives after {sig}")


def rule_integrity(sup, step: int) -> None:
    """Fingerprint-divergence verdicts (integrity tier) ->
    rollback to the newest VERIFIED snapshot; a ``sticky`` minority rank is
    additionally quarantined — ledger-recorded as ``sdc_quarantine`` and,
    when the planner can, the DP-grad collective is re-planned around it
    (the straggler re-plan actuator: a corrupt host and a slow host both
    need traffic routed away). Transient flips only roll back: the host is
    fine, the state is not. The verdict queue is drained ONLY when the
    guard fires, so hysteresis sees a steady asserted signal, and a
    rollback clears the queue either way (restored state moots stale
    verdicts)."""
    rz = getattr(sup.engine, "resilience", None)
    mon = getattr(rz, "integrity", None) if rz is not None else None
    if mon is None:
        return  # integrity off: not even a clear observation to feed
    verdicts = mon.pending_verdicts()
    if not sup.guard.should_fire("integrity", bool(verdicts)):
        return
    verdicts = mon.drain_verdicts()
    if not verdicts:  # raced note_rollback
        return
    steps = sorted(v["step"] for v in verdicts)
    sticky = sorted({r for v in verdicts if v.get("verdict") == "sticky"
                     for r in v.get("minority", ())})
    kinds = sorted({str(v.get("verdict")) for v in verdicts})
    sig = (f"fingerprint divergence at step(s) {steps}, "
           f"verdict(s) {kinds}, minority "
           f"{sorted({r for v in verdicts for r in v.get('minority', ())})}")
    ic = rz.cfg.integrity
    if sticky and ic.quarantine:
        fresh = [r for r in sticky if r not in mon.quarantined]
        mon.quarantined.extend(fresh)
        axes = sup.slow_link_axes()
        replanned = None
        if axes and sup.can_replan():
            replanned = sup.engine.replan_dp_grad(
                axes, penalty=float(sup.cfg.supervisor.straggler_penalty))
        sup.ledger.record(
            "sdc_quarantine", step=step, rule="integrity", signal=sig,
            reason=f"quarantined sticky-SDC rank(s) {sticky}: shadow "
                   "replay reproduced the corruption, so the host — not "
                   "the state — is bad; routed collectives around it "
                   + ("(re-planned)" if replanned else
                      "(no re-plannable site; demotion recorded for the "
                      "scheduler/operator)"),
            params={"ranks": sticky, "steps": steps,
                    "replanned": bool(replanned)})
    if ic.rollback:
        ok = rz.integrity_rollback()
        sup.ledger.record(
            "integrity_rollback", step=step, rule="integrity", signal=sig,
            reason=("restored the newest verified snapshot (corrupt state "
                    "discarded)" if ok else
                    "no verified snapshot available — training continues "
                    "on suspect state, loudly"),
            params={"steps": steps,
                    "max_step": mon.last_clean_step},
            outcome="ok" if ok else "skipped:no-verified-snapshot")
    else:
        sup.ledger.record(
            "integrity_detected", step=step, rule="integrity", signal=sig,
            reason="integrity.rollback disabled — verdict recorded only",
            params={"steps": steps}, outcome="skipped:rollback-disabled")


# ---------------------------------------------------------------------------
# serving-side rule (called from the LLMServer engine thread)
# ---------------------------------------------------------------------------


def rule_sla(sup, server) -> None:
    """Repeated SLA violations -> scale out (registered ``scale_fn``) or
    shed load (halve this replica's admission); violation rate recovering
    restores full admission. Per-replica guard rules: one hot replica must
    not shed its healthy peers."""
    sc = sup.cfg.supervisor
    m = server.metrics
    sid = int(server.replica_id)
    dv, dt = sup.sla_delta(sid, m.sla_violations, m.sla_tracked)
    rate = (dv / dt) if dt > 0 else 0.0
    asserted = dt >= int(sc.sla_min_tracked) and \
        rate >= float(sc.sla_violation_rate)
    step = server._steps
    rule = f"sla_pressure:{sid}"
    if sup.guard.should_fire(rule, asserted):
        sig = (f"replica {sid}: {dv}/{dt} SLA violations since last "
               f"tick ({rate:.0%})")
        if sup.scale_fn is not None:
            try:
                added = sup.scale_fn(sup)
                sup.ledger.record(
                    "serving_scale", step=step, rule=rule, signal=sig,
                    reason="scaled out via the registered scale_fn",
                    params={"added": str(added), "replica": sid})
                return
            except Exception as e:  # fall through to shedding
                sup.ledger.record(
                    "serving_scale", step=step, rule=rule, signal=sig,
                    reason="scale_fn raised; falling back to shedding",
                    outcome=f"failed:{type(e).__name__}")
        current = server.control_max_queue or server._ingress.maxsize
        new = max(1, int(current) // 2)
        server.control_max_queue = new
        sup.ledger.record(
            "serving_shed", step=step, rule=rule, signal=sig,
            reason=f"halved admission to {new} queued request(s)",
            params={"max_queue": new, "replica": sid})
        return
    if server.control_max_queue is not None and sup.guard.should_fire(
            f"sla_recovered:{sid}",
            dt >= int(sc.sla_min_tracked)
            and rate < float(sc.sla_violation_rate) / 2,
            restorative=True):  # un-shedding never consults the budget: an
        # exhausted budget must not pin a recovered replica at 1 request
        server.control_max_queue = None
        sup.ledger.record(
            "serving_unshed", step=step, rule=f"sla_recovered:{sid}",
            signal=f"replica {sid}: violation rate {rate:.0%}",
            reason="SLA recovered; restored full admission",
            params={"replica": sid})
