"""Flap guard: hysteresis + cooldown + budget for automated actions.

Port of ``deepspeed_tpu/control/guard.py``, host logic unchanged.

A control loop that reacts instantly to every signal edge will *flap*: an
alternating straggler/clear verdict would re-plan collectives every step,
each re-plan costing a retrace, until the cure is worse than the disease.
Every rule the supervisor runs is therefore filtered through this state
machine, which only lets an action fire when ALL of:

- **hysteresis** — the signal has been asserted for ``trigger_streak``
  consecutive observations (a one-observation blip never acts), and the
  rule has re-armed: after a firing, the signal must first be observed
  *clear* for ``clear_streak`` consecutive observations before the same
  rule may fire again (a signal that never clears fires once, not forever);
- **cooldown** — at least ``cooldown_s`` since this rule last fired
  (re-arming via the clear streak still respects the cooldown);
- **budget** — fewer than ``budget`` firings across ALL rules within the
  trailing ``budget_window_s`` (the global circuit breaker: a pathological
  environment exhausts the budget and the fleet keeps running on whatever
  knobs it has, loudly, instead of thrashing).

Stdlib-only, clock-injectable, and deliberately free of any engine
knowledge so the unit tests exercise the exact state machine production
runs (``tests/unit/test_control.py``).
"""

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional


class _RuleState:
    __slots__ = ("assert_streak", "clear_streak", "latched", "last_fire",
                 "fires")

    def __init__(self):
        self.assert_streak = 0
        self.clear_streak = 0
        self.latched = False      # fired; needs clear_streak clears to re-arm
        self.last_fire: Optional[float] = None
        self.fires = 0


class FlapGuard:
    def __init__(self, *, trigger_streak: int = 2, clear_streak: int = 2,
                 cooldown_s: float = 120.0, budget: int = 8,
                 budget_window_s: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.trigger_streak = max(1, int(trigger_streak))
        self.clear_streak = max(1, int(clear_streak))
        self.cooldown_s = float(cooldown_s)
        self.budget = int(budget)
        self.budget_window_s = float(budget_window_s)
        self.clock = clock
        self._rules: Dict[str, _RuleState] = {}
        self._fire_times: "deque[float]" = deque()
        self._lock = threading.Lock()
        self.budget_exhausted_observed = False  # ledger records this ONCE

    # ------------------------------------------------------------------
    def _state(self, rule: str) -> _RuleState:
        st = self._rules.get(rule)
        if st is None:
            st = self._rules[rule] = _RuleState()
        return st

    def _budget_left(self, now: float) -> int:
        while self._fire_times and \
                now - self._fire_times[0] > self.budget_window_s:
            self._fire_times.popleft()
        return self.budget - len(self._fire_times)

    # ------------------------------------------------------------------
    def should_fire(self, rule: str, asserted: bool, *,
                    restorative: bool = False) -> bool:
        """Feed one observation of ``rule``'s signal; True means: act NOW
        (the firing is recorded — cooldown starts, the budget is charged,
        and the rule latches until the signal clears).

        ``restorative`` marks actions that UNDO an earlier degradation
        (un-shed, restore admission): they keep the hysteresis/cooldown/
        latch semantics but neither consult nor charge the global budget —
        an exhausted budget must never leave a recovered system stuck in
        its degraded configuration."""
        now = self.clock()
        with self._lock:
            st = self._state(rule)
            if asserted:
                st.assert_streak += 1
                st.clear_streak = 0
            else:
                st.clear_streak += 1
                st.assert_streak = 0
                if st.latched and st.clear_streak >= self.clear_streak:
                    st.latched = False  # re-armed
                return False
            if st.latched:
                return False
            if st.assert_streak < self.trigger_streak:
                return False
            if st.last_fire is not None and \
                    now - st.last_fire < self.cooldown_s:
                return False
            if not restorative:
                if self._budget_left(now) <= 0:
                    self.budget_exhausted_observed = True
                    return False
            # fire
            st.latched = True
            st.last_fire = now
            st.fires += 1
            st.assert_streak = 0
            if not restorative:
                self._fire_times.append(now)
            return True

    # ------------------------------------------------------------------
    def rearm(self, prefix: str = "") -> int:
        """Forcibly re-arm latched rules whose name starts with ``prefix``
        (all rules for ""). Returns how many were re-armed.

        The latch-until-clear hysteresis assumes the world the rule fired
        in still exists: a signal that never clears keeps the rule latched
        because re-firing would just repeat the same actuation. After a
        TOPOLOGY change — a replica died, capacity freed up — that memory
        is stale: an ``sla_pressure`` rule that latched on a scale-out
        attempt rejected at capacity must not block the first scale-out of
        the new, smaller fleet. Cooldown and budget still apply to the
        next firing; only the clear-streak requirement is waived."""
        n = 0
        with self._lock:
            for name, st in self._rules.items():
                if name.startswith(prefix) and st.latched:
                    st.latched = False
                    st.assert_streak = 0
                    n += 1
        return n

    # ------------------------------------------------------------------
    def fires(self, rule: str) -> int:
        with self._lock:
            st = self._rules.get(rule)
            return st.fires if st else 0

    def total_fires(self) -> int:
        with self._lock:
            return sum(st.fires for st in self._rules.values())

    def budget_left(self) -> int:
        with self._lock:
            return max(0, self._budget_left(self.clock()))

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Serializable guard state (rides the control ledger dumps)."""
        with self._lock:
            return {rule: {"fires": st.fires, "latched": st.latched,
                           "assert_streak": st.assert_streak,
                           "clear_streak": st.clear_streak}
                    for rule, st in self._rules.items()}
