"""The port's control plane against the JAX package's.

A scripted sequence of SLA counters drives each package's
``ControlSupervisor`` through ``on_serving_tick`` (as an ``LLMServer``'s
engine thread does) on a fake clock: the ``FlapGuard``'s decisions, the
``rule_sla`` actions (shed, scale out, recover, the budget's exhaustion)
and every ``ControlLedger`` entry must be equal, exactly. The training
engine's wiring is not ported and raises naming its ROADMAP.md item; the
rule book and its names are the JAX package's.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from deepspeed_tpu import control as jcontrol
from deepspeed_tpu.control import guard as jguard
from deepspeed_tpu.control import policy as jpolicy
from deepspeed_tpu.runtime.config import ControlConfig as JControlConfig
from deepspeed_tpu_torch import control as tcontrol
from deepspeed_tpu_torch.control import guard as tguard
from deepspeed_tpu_torch.control import policy as tpolicy
from deepspeed_tpu_torch.runtime.config import ControlConfig

PACKAGES = {"port": (tcontrol, ControlConfig), "jax": (jcontrol, JControlConfig)}

#: (violations, tracked) added between ticks: quiet, a burst of violations,
#: recovery, then pressure again until the action budget runs out
SCRIPT = ([(0, 4)] * 3 + [(9, 10)] * 4 + [(0, 12)] * 5 + [(10, 10)] * 12
          + [(1, 1)] * 3 + [(0, 9)] * 4 + [(10, 10)] * 6)


class _Clock:
    def __init__(self):
        self.t = itertools.count(100.0, 7.5)
        self.now = 100.0

    def __call__(self):
        return self.now

    def tick(self):
        self.now = next(self.t)


def _server(rid=0):
    return SimpleNamespace(replica_id=rid, _steps=0, control=None,
                           control_interval_steps=25, control_max_queue=None,
                           _ingress=SimpleNamespace(maxsize=64),
                           metrics=SimpleNamespace(sla_violations=0, sla_tracked=0))


def _run(mod, cfg_cls, scale_every=0, budget=5):
    cfg = cfg_cls.from_dict({"enabled": True, "guard": {
        "trigger_streak": 2, "clear_streak": 2, "cooldown_s": 20.0, "budget": budget,
        "budget_window_s": 600.0}, "supervisor": {"sla_min_tracked": 8,
                                                 "sla_violation_rate": 0.5}})
    clock = _Clock()
    ledger = mod.ControlLedger(max_entries=64, clock=clock)
    sup = mod.ControlSupervisor(cfg, ledger=ledger, clock=clock)
    calls = []
    if scale_every:
        def scale(s):
            calls.append(len(calls))
            if len(calls) % scale_every == 0:
                raise RuntimeError("no capacity")
            return f"replica-{len(calls)}"
        scale_fn = scale
    else:
        scale_fn = None
    servers = [_server(0), _server(1)]
    for s in servers:
        assert sup.attach_server(s, interval_steps=10, scale_fn=scale_fn) is s
        assert s.control is sup and s.control_interval_steps == 10
    trace = []
    for i, (dv, dt) in enumerate(SCRIPT):
        clock.tick()
        for k, s in enumerate(servers):
            s._steps += 10
            s.metrics.sla_violations += dv if k == 0 else (2 * dv) // 3
            s.metrics.sla_tracked += dt
            sup.on_serving_tick(s)
        trace.append(tuple(s.control_max_queue for s in servers))
    return (trace, ledger.snapshot(), ledger.total, sup.guard.snapshot(),
            sup.guard.total_fires(), sup.guard.budget_left(), calls,
            [mod.describe_action(e) for e in ledger.snapshot()])


@pytest.mark.parametrize("scale_every, budget", [(0, 2), (0, 100), (2, 5)])
def test_sla_rule_and_ledger_match_jax(scale_every, budget):
    got = _run(tcontrol, ControlConfig, scale_every, budget)
    want = _run(jcontrol, JControlConfig, scale_every, budget)
    assert got == want
    trace, entries = got[0], got[1]
    actions = {e["action"] for e in entries}
    assert "serving_shed" in actions or "serving_scale" in actions
    if budget == 2:
        assert "budget_exhausted" in actions and "serving_unshed" in actions
        assert any(q is not None for q, _ in trace)


def _guard_trace(mod):
    now = [0.0]
    g = mod.FlapGuard(trigger_streak=3, clear_streak=2, cooldown_s=5.0, budget=3,
                      budget_window_s=30.0, clock=lambda: now[0])
    rng = np.random.default_rng(4)
    out = []
    for i in range(120):
        now[0] += float(rng.uniform(0.2, 2.0))
        rule = ("a", "b", "c")[int(rng.integers(0, 3))]
        asserted = bool(rng.random() < 0.7)
        out.append(g.should_fire(rule, asserted, restorative=bool(i % 17 == 0)))
        if i == 60:
            out.append(g.rearm("b"))
    return out, g.snapshot(), g.fires("a"), g.total_fires(), g.budget_left(), \
        g.budget_exhausted_observed


def test_flap_guard_decisions_match_jax():
    got, want = _guard_trace(tguard), _guard_trace(jguard)
    assert got == want
    assert any(got[0]) and not all(got[0])


def test_policy_table_and_names_are_jax_s():
    assert tpolicy.POLICY_TABLE == jpolicy.POLICY_TABLE
    assert tpolicy.RULE_NAMES == jpolicy.RULE_NAMES
    assert tcontrol.RULE_NAMES == jcontrol.RULE_NAMES


def test_engine_wiring_and_autotuner_raise_naming_item_9():
    sup = tcontrol.ControlSupervisor(ControlConfig())
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        sup.attach_engine(object())
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tcontrol.ControlSupervisor.for_engine(object(), ControlConfig())
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        sup.on_step(1)
    for name in ("ControlAutotuner", "build_space"):
        with pytest.raises(NotImplementedError, match="Queue A item 9"):
            getattr(tcontrol, name)
    # the winner cache is ported (the fleet's warm join reads it)
    assert tcontrol.WinnerCache.__name__ == "WinnerCache"
    assert tcontrol.space_signature({"d": ["a", "b"]}, "m") == jcontrol.space_signature(
        {"d": ["b", "a"]}, "m")
    assert sup.can_replan() is False and sup.slow_link_axes() == ()


def test_training_rules_read_an_injected_engine_as_jax():
    """The rule book is the JAX package's: with an engine stand-in set on
    the supervisor, the memory and rollback rules decide and record as
    JAX's do (the port's engine wires none of this yet)."""
    out = []
    for mod, cfg_cls in PACKAGES.values():
        clock = _Clock()
        sup = mod.ControlSupervisor(cfg_cls.from_dict({"enabled": True}),
                                    ledger=mod.ControlLedger(clock=clock), clock=clock)
        remat = iter(["dots_saveable", "nothing_saveable", None])
        engine = SimpleNamespace(global_steps=0, micro_batch_size=4, gas=1,
                                 _remat_policy=None, _train_dataloader=None,
                                 raise_remat=lambda: next(remat, None),
                                 halve_micro_batch=lambda: True, resilience=None,
                                 telemetry=None, topo=None)
        sup.engine = engine
        sup._mem_fn = lambda: {"bytes_in_use": 95, "bytes_limit": 100}
        for step in range(12):
            clock.tick()
            sup.on_step(step)
            if step == 6:
                engine._remat_policy = "nothing_saveable"
        sup.note_rollback(3)
        sup.note_rollback(4)
        for step in range(12, 15):
            sup.on_step(step)
        out.append(sup.ledger.snapshot())
    assert out[0] == out[1]
    assert {e["action"] for e in out[0]} >= {"raise_remat", "halve_micro_batch",
                                             "enter_degraded"}
