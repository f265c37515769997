"""Deterministic fault injection: the test harness the subsystem is sworn to.

Port of ``deepspeed_tpu/runtime/resilience/faults.py``, host logic unchanged.

A resilience layer that is only exercised by real failures is untested by
definition. This module turns each failure mode into a scheduled, repeatable
event so the suite can prove end-to-end recovery:

- ``nan_loss_at_steps`` — the step's observed loss becomes NaN (a streak of
  N consecutive steps trips the sentinel deterministically);
- ``grad_spike_at_steps`` — the observed grad norm is multiplied by
  ``spike_magnitude``;
- ``preempt_at_step`` — the preemption watcher's flag is raised as if
  SIGTERM had arrived;
- ``torn_write_at_steps`` — the snapshot taken at that step has its newest
  shard corrupted AFTER checksumming (restore must detect and skip it);
- ``crash_before_commit_at_steps`` — the snapshot writer raises
  :class:`InjectedCrash` after the data directory lands but before the
  manifest commit (restore must resolve the previous tag);
- ``hang_at_step`` — the step never completes (the post-step hook spins
  until released), so the armed step watchdog must fire: hangdump +
  distinctive exit code + supervised restart;
- ``slow_rank`` — the named rank sleeps ``slow_step_s`` every step (a
  steady straggler the heartbeat table must call out);
- ``heartbeat_loss_at_steps`` — the host's beacon write is suppressed at
  those steps (peers must derive a dead-host verdict once the beacon ages
  past the threshold);
- ``sdc_transient_at_steps`` / ``sdc_sticky_from_step`` — a seeded bit
  flip in ``sdc_rank``'s params (one-shot at the listed steps, or on EVERY
  step from the sticky threshold — a broken host stays broken); the
  integrity tier's cross-rank fingerprints must detect it, the shadow
  replay must call transient vs sticky, and the supervisor must quarantine
  (chaos classes ``sdc_bitflip_transient`` / ``sdc_bitflip_sticky``).

Loss/grad injections rewrite the *observed* metrics fed to the sentinel,
not the device state — the rollback that follows is the real code path
(restore last-good snapshot, continue), executed on healthy arrays so the
test can assert training actually continues.

Each scheduled injection fires ONCE: a rollback rewinds the step counter
past an already-fired step, and a transient fault that re-fired on every
replay would turn the recovery test into an infinite loop. The ``fired``
audit trail records what actually happened.
"""

from dataclasses import dataclass, field
from typing import Optional, Set, Tuple


class InjectedCrash(RuntimeError):
    """A scheduled crash-before-commit (never raised outside fault plans)."""


def _steps(v) -> Tuple[int, ...]:
    if v is None:
        return ()
    if isinstance(v, int):
        return (v,)
    return tuple(int(s) for s in v)


@dataclass
class FaultPlan:
    nan_loss_at_steps: Tuple[int, ...] = ()
    grad_spike_at_steps: Tuple[int, ...] = ()
    spike_magnitude: float = 1e6
    preempt_at_step: Optional[int] = None
    torn_write_at_steps: Tuple[int, ...] = ()
    crash_before_commit_at_steps: Tuple[int, ...] = ()
    hang_at_step: Optional[int] = None
    slow_rank: Optional[int] = None
    slow_step_s: float = 0.25
    heartbeat_loss_at_steps: Tuple[int, ...] = ()
    sdc_transient_at_steps: Tuple[int, ...] = ()
    sdc_sticky_from_step: Optional[int] = None
    sdc_rank: int = -1
    sdc_bit: int = 17

    fired: list = field(default_factory=list)  # (step, kind) audit trail
    _spent: Set[Tuple[int, str]] = field(default_factory=set)

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan":
        """Build from a ``resilience.faults`` config block (or any object
        with the same attribute names)."""
        return cls(
            nan_loss_at_steps=_steps(getattr(cfg, "nan_loss_at_steps", ())),
            grad_spike_at_steps=_steps(getattr(cfg, "grad_spike_at_steps", ())),
            spike_magnitude=float(getattr(cfg, "spike_magnitude", 1e6)),
            preempt_at_step=getattr(cfg, "preempt_at_step", None),
            torn_write_at_steps=_steps(getattr(cfg, "torn_write_at_steps", ())),
            crash_before_commit_at_steps=_steps(
                getattr(cfg, "crash_before_commit_at_steps", ())),
            hang_at_step=getattr(cfg, "hang_at_step", None),
            slow_rank=getattr(cfg, "slow_rank", None),
            slow_step_s=float(getattr(cfg, "slow_step_s", 0.25)),
            heartbeat_loss_at_steps=_steps(
                getattr(cfg, "heartbeat_loss_at_steps", ())),
            sdc_transient_at_steps=_steps(
                getattr(cfg, "sdc_transient_at_steps", ())),
            sdc_sticky_from_step=getattr(cfg, "sdc_sticky_from_step", None),
            sdc_rank=int(getattr(cfg, "sdc_rank", -1)),
            sdc_bit=int(getattr(cfg, "sdc_bit", 17)),
        )

    def _fire(self, step: int, kind: str, scheduled) -> bool:
        if step not in _steps(scheduled) or (step, kind) in self._spent:
            return False
        self._spent.add((step, kind))
        self.fired.append((step, kind))
        return True

    # -- metric injections (consumed by ResilienceManager.post_step) -----
    def observe_loss(self, step: int, loss: float) -> float:
        if self._fire(step, "nan_loss", self.nan_loss_at_steps):
            return float("nan")
        return loss

    def observe_grad_norm(self, step: int, grad_norm: float) -> float:
        if self._fire(step, "grad_spike", self.grad_spike_at_steps):
            return float(grad_norm) * self.spike_magnitude
        return grad_norm

    def preempt_now(self, step: int) -> bool:
        return self._fire(step, "preempt", self.preempt_at_step)

    # -- fleet injections (consumed by ResilienceManager.post_step) ------
    def hang_now(self, step: int) -> bool:
        """One-shot: this step wedges (the manager spins until released or
        the watchdog kills the process)."""
        return self._fire(step, "hang", self.hang_at_step)

    def slow_now(self, step: int, rank: int) -> float:
        """Per-step straggler sleep for ``slow_rank`` (seconds; 0 elsewhere).
        Deliberately NOT one-shot — a straggler is a *steady* condition the
        heartbeat median must surface; only the first firing is audited."""
        if self.slow_rank is None or int(rank) != int(self.slow_rank):
            return 0.0
        if ("slow", "slow") not in self._spent:
            self._spent.add(("slow", "slow"))
            self.fired.append((step, "slow"))
        return float(self.slow_step_s)

    def _sdc_rank_match(self, rank: int) -> bool:
        return self.sdc_rank < 0 or int(rank) == int(self.sdc_rank)

    def sdc_transient_now(self, step: int, rank: int) -> bool:
        """One-shot bit flip in this rank's post-step state (chaos class
        ``sdc_bitflip_transient``): the hardware glitched once; the flipped
        bit persists in params until a rollback heals it."""
        return self._sdc_rank_match(rank) and self._fire(
            step, "sdc_bitflip_transient", self.sdc_transient_at_steps)

    def sdc_sticky_now(self, step: int, rank: int) -> bool:
        """Sticky-host SDC (chaos class ``sdc_bitflip_sticky``): from the
        scheduled step onward EVERY step on ``sdc_rank`` computes a flipped
        bit. Deliberately NOT one-shot — a broken ALU stays broken and a
        shadow replay on the same host must reproduce the corruption (the
        sticky verdict); only the first firing is audited."""
        if (self.sdc_sticky_from_step is None
                or not self._sdc_rank_match(rank)
                or int(step) < int(self.sdc_sticky_from_step)):
            return False
        if ("sdc_sticky", "sdc_sticky") not in self._spent:
            self._spent.add(("sdc_sticky", "sdc_sticky"))
            self.fired.append((step, "sdc_bitflip_sticky"))
        return True

    def heartbeat_lost(self, step: int) -> bool:
        """One-shot per scheduled step: suppress this step's beacon write."""
        return self._fire(step, "heartbeat_loss", self.heartbeat_loss_at_steps)

    # -- snapshot write hook (SnapshotManager.fault_hook) ----------------
    def snapshot_hook(self, stage: str, step: int) -> Optional[str]:
        if stage == "post_data" and self._fire(step, "torn_write",
                                               self.torn_write_at_steps):
            return "torn"
        if stage == "pre_manifest" and self._fire(
                step, "crash_before_commit", self.crash_before_commit_at_steps):
            return "crash"
        return None
