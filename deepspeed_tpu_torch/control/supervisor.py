"""ControlSupervisor: the object that closes the telemetry -> knobs loop.

Port of ``deepspeed_tpu/control/supervisor.py``, host logic unchanged.
LLMServer engine threads call :meth:`on_serving_tick` every
``control_interval_steps`` serving steps; each call reads the replica's
``ServingMetrics`` SLA counters and runs the rule book
(``control/policy.py``) through the :class:`~.guard.FlapGuard`. Every
decision (including guarded no-ops) lands in the
:class:`~.ledger.ControlLedger`, which rides flight dumps, the Prometheus
registry and the monitor event stream.

The training engine's wiring (``attach_engine``, ``on_step``) waits for
ROADMAP.md Queue A item 9 and raises until then. The port has no comm
planner, so :meth:`can_replan` and :meth:`slow_link_axes` take the JAX
package's "planner off" branch.
"""

import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from ..utils.logging import log_dist
from . import policy
from .guard import FlapGuard
from .ledger import ControlLedger, describe_action


def _engine_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the training engine's control wiring is not ported yet: "
        "ROADMAP.md Queue A item 9 (control/*)")


class ControlSupervisor:
    def __init__(self, cfg, *, ledger: Optional[ControlLedger] = None,
                 guard: Optional[FlapGuard] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg                      # runtime.config.ControlConfig
        gc = cfg.guard
        # None-check, not truthiness: a caller-supplied EMPTY ledger (it
        # has __len__) must not be silently replaced — the caller shares
        # it with other recorders (e.g. a FleetManager) and reads it back
        self.ledger = (ControlLedger(max_entries=cfg.ledger_size)
                       if ledger is None else ledger)
        self.guard = guard or FlapGuard(
            trigger_streak=gc.trigger_streak, clear_streak=gc.clear_streak,
            cooldown_s=gc.cooldown_s, budget=gc.budget,
            budget_window_s=gc.budget_window_s, clock=clock)
        self.clock = clock
        self.engine = None
        self.scale_fn: Optional[Callable] = None  # serving scale-out hook
        self._rollbacks: "deque[Tuple[float, int]]" = deque(maxlen=64)
        self._mem_fn: Optional[Callable] = None   # test-injectable probe
        self._mem_stage = 0   # memory-escalation rung (policy.rule_memory)
        self._sla_last: Dict[int, Tuple[int, int]] = {}
        self._budget_noted = False
        self._infeasible_noted: set = set()  # one ledger note per rule
        self._step_i = 0

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    @classmethod
    def for_engine(cls, engine, cfg) -> "ControlSupervisor":
        sup = cls(cfg)
        sup.attach_engine(engine)
        return sup

    def attach_engine(self, engine) -> "ControlSupervisor":
        """The training engine's wiring (rollback reports, the telemetry
        manager's flight dumps, ``Control/*`` monitor events) is not
        ported yet."""
        raise _engine_not_ported("ControlSupervisor.attach_engine")

    def attach_server(self, server, *,
                      interval_steps: Optional[int] = None,
                      scale_fn: Optional[Callable] = None):
        """Wire into one LLMServer: its engine thread ticks
        :meth:`on_serving_tick` every ``control_interval_steps`` serving
        steps. ``scale_fn(supervisor)`` — when provided — is the scale-out
        actuator (e.g. build a replica and ``router.add_replica`` it);
        without one, sustained SLA pressure sheds load instead."""
        server.control = self
        if interval_steps is not None:
            server.control_interval_steps = int(interval_steps)
        if scale_fn is not None:
            self.scale_fn = scale_fn
        if self.ledger._counter is None:
            try:
                from ..telemetry import get_registry, telemetry_active

                if telemetry_active():
                    self.ledger.bind_counter(get_registry().counter(
                        "dstpu_control_actions_total",
                        "automated control-plane actions by kind"))
            except Exception:
                pass  # swallow-ok: optional telemetry binding must never block serving attach
        return server

    # ------------------------------------------------------------------
    # signal taps (policy.py reads through these; tests inject here)
    # ------------------------------------------------------------------
    def straggler_rows(self):
        """``[(rank, ratio)]`` for every straggler the HealthTable calls
        out — read from the rows the resilience heartbeat tick ALREADY
        fetched this beat (``ResilienceManager.last_health``), never a
        fresh transport read: the control loop runs every step, and a
        per-step ``read_all()`` against a bucket transport would put
        network I/O on the training hot path the resilience tier
        deliberately paces by ``heartbeat.interval_steps``."""
        rz = getattr(self.engine, "resilience", None)
        rows = getattr(rz, "last_health", None) if rz is not None else None
        if not rows:
            return []
        return [(r.rank, r.ratio) for r in rows if r.straggler]

    def can_replan(self) -> bool:
        """Static feasibility of the straggler re-plan on THIS engine:
        planner on and a re-plannable DP-grad site resolved. Checked
        BEFORE the guard so a permanently impossible action never charges
        the global budget."""
        return False   # no comm planner in the port

    def note_infeasible(self, action: str, rule: str, *, step: int,
                        signal: str, reason: str, outcome: str) -> None:
        """Record a statically-impossible actuation ONCE per rule — the
        operator should see why the supervisor stands down, but neither a
        ledger entry per step nor a budget charge for a guaranteed no-op."""
        if rule in self._infeasible_noted:
            return
        self._infeasible_noted.add(rule)
        self.ledger.record(action, step=step, rule=rule, signal=signal,
                           reason=reason, outcome=outcome)

    def slow_link_axes(self) -> Tuple[str, ...]:
        """Which mesh axes carry the straggler's traffic: the operator
        override wins; else (no planner fingerprint in the port) the outermost dp axis of a
        multi-axis dp span (the cross-host hop by construction). A
        single-axis span has no alternative route — empty."""
        sc = self.cfg.supervisor
        if sc.replan_axes:
            return tuple(sc.replan_axes)
        topo = getattr(self.engine, "topo", None)
        if topo is not None and len(topo.dp_axes) > 1:
            return (topo.dp_axes[0],)
        return ()

    def mem_sample(self) -> Optional[Dict[str, int]]:
        """The newest device-memory gauge sample: the telemetry manager's
        last per-step read (one step stale by design — same contract as
        the sentinel's delayed metrics), or an injected probe."""
        if self._mem_fn is not None:
            return self._mem_fn()
        tm = getattr(self.engine, "telemetry", None)
        return getattr(tm, "last_mem", None) if tm is not None else None

    def note_rollback(self, step: int) -> None:
        """Called by ResilienceManager._rollback — the rollback-rate signal."""
        self._rollbacks.append((self.clock(), int(step)))

    def recent_rollbacks(self, window_s: float):
        now = self.clock()
        return [s for t, s in self._rollbacks if now - t <= window_s]

    def sla_delta(self, sid: int, violations: int,
                  tracked: int) -> Tuple[int, int]:
        last_v, last_t = self._sla_last.get(sid, (0, 0))
        self._sla_last[sid] = (int(violations), int(tracked))
        return int(violations) - last_v, int(tracked) - last_t

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def on_step(self, step: Optional[int] = None) -> None:
        """Per-training-step hook (engine ``_train_batch_inner``): evaluate
        every training-side rule. Pure host work — never touches device
        state except through the actuators a fired rule invokes. ``step``
        is the EXECUTING step number (the engine passes the pre-increment
        N its spans, flight ring, and watchdog all stamp, so ledger
        entries cross-correlate with the other post-mortem surfaces)."""
        engine = self.engine
        if engine is None:
            raise _engine_not_ported("ControlSupervisor.on_step")
        self._step_i += 1
        sc = self.cfg.supervisor
        n = max(1, int(sc.interval_steps))
        if self._step_i % n:
            return
        step = engine.global_steps if step is None else int(step)
        if sc.straggler_replan:
            policy.rule_straggler(self, step)
        if sc.memory_guard:
            policy.rule_memory(self, step)
        if sc.rollback_degrade:
            policy.rule_rollbacks(self, step)
        if sc.integrity_guard:
            policy.rule_integrity(self, step)
        self._note_budget(step)

    def on_serving_tick(self, server) -> None:
        """Per-serving-interval hook (LLMServer engine thread)."""
        if self.cfg.supervisor.sla_guard:
            policy.rule_sla(self, server)
            self._note_budget(server._steps)

    def _note_budget(self, step: int) -> None:
        if self.guard.budget_exhausted_observed and not self._budget_noted:
            self._budget_noted = True
            gc = self.cfg.guard
            entry = self.ledger.record(
                "budget_exhausted", step=step, rule="budget",
                signal="global action budget",
                reason=f"action budget ({gc.budget} per "
                       f"{gc.budget_window_s:g}s) exhausted — the "
                       "supervisor observes but no longer acts until the "
                       "window drains", outcome="skipped:budget")
            log_dist(f"control: {describe_action(entry.to_dict())}")
