"""The port's chaos schedules, fault plans, retry loop and heartbeats
against the JAX package's.

Both packages draw seeded schedules from ``random.Random(seed)``, so a seed
gives the same manifest in each (compared exactly, JSON included); the
injection-site API (``fire`` / ``value`` / ``maybe_raise`` /
``mangle_bytes``) answers the same sequence of calls with the same results.
The beacon files are one format: each package's ``HealthTable`` reads the
other's beacons, fresh, stale, torn and absent, to the same verdicts on an
injected clock. The retry loop runs on injected sleep, rng and clock, so its
sleeps compare exactly.
"""

import json
import random

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedTPUConfig as JConfig
from deepspeed_tpu.runtime.resilience import chaos as jchaos
from deepspeed_tpu.runtime.resilience import faults as jfaults
from deepspeed_tpu.runtime.resilience import heartbeat as jhb
from deepspeed_tpu.utils import retry as jretry
from deepspeed_tpu_torch.runtime.config import DeepSpeedTPUConfig as TConfig
from deepspeed_tpu_torch.runtime.resilience import chaos as tchaos
from deepspeed_tpu_torch.runtime.resilience import faults as tfaults
from deepspeed_tpu_torch.runtime.resilience import heartbeat as thb
from deepspeed_tpu_torch.utils import retry as tretry

SERVING = ["replica_kill", "kv_exhaustion", "slow_prefill", "drop_token"]


@pytest.fixture(autouse=True)
def _no_chaos():
    for mod in (tchaos, jchaos):
        mod.configure_chaos(None)
    yield
    for mod in (tchaos, jchaos):
        mod.configure_chaos(None)
        mod.clear_config_chaos()


def test_fault_classes_are_jax_s():
    assert tchaos.FAULT_CLASSES == jchaos.FAULT_CLASSES
    assert tchaos._GENERATE_DEFAULTS == jchaos._GENERATE_DEFAULTS
    assert tchaos.MANIFEST_NAME == jchaos.MANIFEST_NAME


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 2024])
@pytest.mark.parametrize("classes", [SERVING, sorted(jchaos._GENERATE_DEFAULTS)])
def test_generated_manifest_matches_jax(seed, classes):
    kw = dict(horizon=97, events_per_class=3, sites={"replica_kill": "replica1"})
    got = tchaos.ChaosSchedule.generate(seed, classes, **kw)
    want = jchaos.ChaosSchedule.generate(seed, classes, **kw)
    assert got.to_manifest() == want.to_manifest()
    assert json.dumps(got.to_manifest()) == json.dumps(want.to_manifest())


def _drive(mod, seed):
    """A fixed sequence of site consults against a seeded schedule plus
    explicit events; returns every answer and the audit trail."""
    sched = mod.ChaosSchedule.generate(seed, SERVING + ["torn_beacon",
                                                        "transport_put_error"],
                                       horizon=12)
    sched.events.append(mod.ChaosEvent(kind="slow_prefill", site="replica0", at=3,
                                       count=2, param=0.25))
    sched._by_kind.setdefault("slow_prefill", []).append(sched.events[-1])
    rng = random.Random(seed + 1)
    sites = ["replica0", "replica1", "scheduler.admit", "heartbeat.put"]
    out = []
    for _ in range(60):
        kind = rng.choice(SERVING + ["torn_beacon", "transport_put_error"])
        site = rng.choice(sites)
        if kind == "torn_beacon":
            out.append(sched.mangle_bytes(kind, site, b"0123456789abcdef"))
        elif kind == "transport_put_error":
            try:
                sched.maybe_raise(kind, site)
                out.append("ok")
            except mod.ChaosInjectedError as e:
                out.append(f"raised {e}")
        elif kind == "slow_prefill":
            out.append(sched.value(kind, site))
        else:
            out.append(sched.fire(kind, site))
    return out, sched.all_fired(), sched.classes_fired()


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_site_answers_and_audit_match_jax(seed):
    assert _drive(tchaos, seed) == _drive(jchaos, seed)


def test_from_config_and_install_match_jax():
    block = {"chaos": {"enabled": True, "seed": 4, "classes": SERVING, "horizon": 40,
                       "events": [{"kind": "replica_kill", "site": "replica1", "at": 60}],
                       "training": {"enabled": True, "nan_loss_at_steps": [3, 4],
                                    "preempt_at_step": 9}}}
    got = tchaos.ChaosSchedule.from_config(TConfig.from_dict(block).chaos)
    want = jchaos.ChaosSchedule.from_config(JConfig.from_dict(block).chaos)
    assert got.to_manifest() == want.to_manifest()
    assert (tchaos._training_identity(got.training)
            == jchaos._training_identity(want.training))
    # an engine-style install keeps a live schedule built from the same drill
    cfg = TConfig.from_dict(block).chaos
    first = tchaos.install_chaos_from_config(cfg)
    assert first.fire("replica_kill", "replica1") is False
    assert tchaos.install_chaos_from_config(cfg) is first and tchaos.chaos_active()
    tchaos.clear_config_chaos()
    assert tchaos.get_chaos() is None
    manual = tchaos.configure_chaos(tchaos.ChaosSchedule([]))
    tchaos.clear_config_chaos()                    # a manual install stays
    assert tchaos.get_chaos() is manual
    with pytest.raises(ValueError, match="unknown chaos fault class"):
        tchaos.ChaosSchedule([tchaos.ChaosEvent(kind="meteor")])


def test_fault_plan_fires_as_jax():
    kw = dict(nan_loss_at_steps=(2,), grad_spike_at_steps=(3, 5), preempt_at_step=6,
              hang_at_step=7, slow_rank=1, heartbeat_loss_at_steps=(4,),
              sdc_transient_at_steps=(5,), sdc_sticky_from_step=8, sdc_rank=1)
    plans = tfaults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    answers = []
    for plan in plans:
        a = []
        for step in list(range(10)) + [2, 3]:        # a rollback revisits steps
            a += [plan.observe_loss(step, 1.0), plan.observe_grad_norm(step, 2.0),
                  plan.preempt_now(step), plan.hang_now(step), plan.slow_now(step, 1),
                  plan.heartbeat_lost(step), plan.sdc_transient_now(step, 1),
                  plan.sdc_sticky_now(step, 1),
                  plan.snapshot_hook("post_data", step)]
        answers.append((repr(a), plan.fired))
    assert answers[0] == answers[1]


def _retry_trace(mod, policy_kw):
    """retry_call over a function failing ``n`` times, on injected sleep,
    rng and clock: the sleeps, the result or error, and the log sites."""
    mod.clear_retry_log()
    sleeps, now = [], [0.0]
    fails = iter([OSError("eagain")] * 3 + [ConnectionError("reset")])

    def fn():
        err = next(fails, None)
        if err is not None:
            raise err
        return "landed"

    def sleep(s):
        sleeps.append(s)
        now[0] += s
    try:
        out = mod.retry_call(fn, site="heartbeat.put", policy=mod.RetryPolicy(**policy_kw),
                             sleep=sleep, rng=random.Random(3), clock=lambda: now[0])
    except mod.RetryError as e:
        out = ("gave up", e.attempts, repr(e.last))
    log = [(e["site"], e["attempt"], e["error"], e["final"]) for e in mod.retry_log_snapshot()]
    return sleeps, out, log


@pytest.mark.parametrize("policy_kw", [dict(max_attempts=6), dict(max_attempts=3),
                                       dict(max_attempts=9, deadline_s=0.2, base_s=0.1)])
def test_retry_loop_matches_jax(policy_kw):
    assert _retry_trace(tretry, policy_kw) == _retry_trace(jretry, policy_kw)
    with pytest.raises(FileNotFoundError):         # an absent object is a fact
        tretry.retry_call(lambda: open("/nonexistent/beacon"), site="x",
                          sleep=lambda s: None)


# ---------------------------------------------------------------------------
# heartbeats: one beacon format, both readers
# ---------------------------------------------------------------------------


def _beacons(writer_mod, transport, clock):
    """Ranks 0-3: rank 0 fresh, 1 stale, 2 a slow straggler, 3 torn."""
    steps = {0: 0.10, 1: 0.11, 2: 0.55}
    for rank, st in steps.items():
        w = writer_mod.HeartbeatWriter(transport, rank, clock=clock)
        w.beat(step=10 + rank, step_time_s=st)
    return steps


def _rows(mod, transport, now):
    table = mod.HealthTable(transport, dead_after_s=5.0, straggler_factor=3.0,
                            clock=lambda: now[0])
    return [(r.rank, r.step, r.step_time_s, r.age_s, r.alive, r.straggler,
             round(r.ratio, 12)) for r in table.read()], table.verdicts()


@pytest.mark.parametrize("store", ["file", "bucket"])
@pytest.mark.parametrize("writer_port", [True, False])
def test_health_verdicts_match_across_packages(tmp_path, store, writer_port):
    now = [1000.0]
    wmod = thb if writer_port else jhb

    def transport(mod):
        if store == "file":
            return mod.FileHeartbeatTransport(str(tmp_path / "hb"))
        return mod.ObjectStoreHeartbeatTransport(str(tmp_path / "bucket"))
    _beacons(wmod, transport(wmod), lambda: now[0])
    now[0] += 3.0
    # rank 1 beats late: its beacon is the oldest when the clock moves on
    wmod.HeartbeatWriter(transport(wmod), 1, clock=lambda: now[0] - 4.0).beat(step=11)
    # rank 3's body is torn: readers must take it as absent
    raw = json.dumps({"rank": 3, "step": 1, "wall_time": now[0]})
    if store == "file":
        (tmp_path / "hb" / "hb-3.json").write_text(raw[:len(raw) // 2])
    else:
        (tmp_path / "bucket" / "heartbeats" / "hb-3.json").write_text(raw[:len(raw) // 2])
    now[0] += 2.5
    for _ in range(2):
        assert _rows(thb, transport(thb), now) == _rows(jhb, transport(jhb), now)
        now[0] += 10.0                              # everyone goes stale


def test_bucket_transport_chaos_sites_match_jax(tmp_path):
    """A torn PUT reads as absent, transient PUT / GET errors are retried
    and counted in the retry log, and a stale-health consult returns the
    previous rows: the same answers in both packages."""
    results = []
    for k, (mod, rmod) in enumerate(((thb, tretry), (jhb, jretry))):
        chaos = tchaos if mod is thb else jchaos
        chaos.configure_chaos(chaos.ChaosSchedule([
            chaos.ChaosEvent(kind="torn_beacon", site="heartbeat.put", at=1),
            chaos.ChaosEvent(kind="transport_put_error", site="heartbeat.put", at=2, count=2),
            chaos.ChaosEvent(kind="transport_get_error", site="heartbeat.get", at=0),
            chaos.ChaosEvent(kind="stale_health", site="health.read", at=1)]))
        rmod.clear_retry_log()
        now = [500.0]
        fast = rmod.RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0, deadline_s=None)
        tr = mod.ObjectStoreHeartbeatTransport(str(tmp_path / f"b{k}"), retry=fast,
                                               get_retry=fast)
        for rank in range(3):
            mod.HeartbeatWriter(tr, rank, clock=lambda: now[0]).beat(step=rank,
                                                                     step_time_s=0.1)
        table = mod.HealthTable(tr, dead_after_s=5.0, clock=lambda: now[0])
        first = [(r.rank, r.alive) for r in table.read()]
        now[0] += 9.0
        stale = [(r.rank, r.alive) for r in table.read()]     # the old rows again
        fresh = [(r.rank, r.alive) for r in table.read()]
        log = [(e["site"], e["attempt"], e["final"]) for e in rmod.retry_log_snapshot()]
        results.append((first, stale, fresh, log, chaos.get_chaos().classes_fired()))
        chaos.configure_chaos(None)
    assert results[0] == results[1]
    first, stale, fresh, log, fired = results[0]
    assert 1 not in dict(first)                    # torn: absent
    assert stale == first and not any(alive for _, alive in fresh)
    assert ("heartbeat.put", 1, False) in log and ("heartbeat.get", 1, False) in log
