"""The port's fleet lifecycle, FleetManager and subprocess replica against
the JAX package's.

Port of JAX ``tests/unit/test_fleet.py``'s lifecycle, manager and warm-join
sections. Each state-machine and manager scenario runs in both packages on
stub servers (the protocol surface the router and the lifecycle touch, no
engine) and their traces must be equal: handle states and transitions,
router membership, and the control ledger's entries (kind, rule, outcome,
params; the warm seconds left out). The warm join runs on the port's tiny
fp32 servers on the CPU; its warm generation must give the JAX engine's
tokens exactly, from the same weights (``params_from_jax``). One round trip
through ``SubprocessReplica`` runs a child interpreter on the CPU with a
60 s limit on each wait, the child killed in a ``finally``.

Process-wide state (chaos, the planner, the probe memo) is reset around
every test; caches live under pytest's ``tmp_path``.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu.comm.planner as jplan
import deepspeed_tpu.control.guard as jguard
import deepspeed_tpu.control.supervisor as jsup
import deepspeed_tpu.fleet as jfleet
import deepspeed_tpu.runtime.config as jconfig
import deepspeed_tpu.runtime.resilience.chaos as jchaos
import deepspeed_tpu.serving as jserving
import deepspeed_tpu_torch.comm.planner as tplan
import deepspeed_tpu_torch.control.guard as tguard
import deepspeed_tpu_torch.control.supervisor as tsup
import deepspeed_tpu_torch.fleet as tfleet
import deepspeed_tpu_torch.runtime.config as tconfig
import deepspeed_tpu_torch.runtime.resilience.chaos as tchaos
import deepspeed_tpu_torch.serving as tserving

#: every wait on a thread or a child process, in seconds
WAIT_S = 60

PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, chaos=jchaos, guard=jguard, sup=jsup,
                           config=jconfig, serving=jserving),
    "port": SimpleNamespace(fleet=tfleet, chaos=tchaos, guard=tguard, sup=tsup,
                            config=tconfig, serving=tserving),
}


@pytest.fixture(autouse=True)
def _clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def reset():
        for pkg in PKGS.values():
            pkg.chaos.configure_chaos(None)
        for plan in (jplan, tplan):
            plan.reset_planner()
            plan.reset_probe_memo()
    reset()
    yield
    reset()
    torch.set_num_threads(threads)


class _StubServer:
    """The protocol surface the router + lifecycle touch, with no engine:
    warm() skips generation/probing and the stub records halt/drain."""

    def __init__(self, replica_id, metrics):
        self.replica_id = int(replica_id)
        self.engine = None
        self.error = None
        self.heartbeat = None
        self.warmed = False
        self.metrics = metrics
        self._thread = None
        self._steps = 0
        self.outstanding = 0
        self.halted = False
        self.drained = False

    def start(self):
        return self

    def halt(self):
        self.halted = True

    def drain(self, timeout=None):
        self.drained = True
        return True

    def steal_unfinished(self):
        return []


class _FakeRouter:
    def __init__(self):
        self.added = []

    def add_replica(self, server, **kw):
        self.added.append(server)


def _stub(pkg, rid=None):
    if rid is None:
        return lambda r: _StubServer(r, pkg.serving.ServingMetrics())
    return lambda r: _StubServer(rid, pkg.serving.ServingMetrics())


def _ledger(mgr):
    """The ledger's entries without wall times and warm seconds."""
    out = []
    for e in mgr.ledger.entries():
        params = {k: v for k, v in (e.params or {}).items() if k != "warm_s"}
        out.append((e.action, e.rule, e.outcome, e.reason, params))
    return out


def _states(mgr):
    return {rid: (h.state, [s for s, _ in h.transitions])
            for rid, h in sorted(mgr.handles.items())}


def _both(scenario):
    """Run ``scenario(pkg)`` in both packages; their traces must be equal.
    Returns the port's."""
    want, got = scenario(PKGS["jax"]), scenario(PKGS["port"])
    assert got == want
    return got


# ---------------------------------------------------------------------------
# lifecycle state machine (stub servers)
# ---------------------------------------------------------------------------


def test_lifecycle_walk_and_illegal_transitions():
    def walk(pkg):
        f = pkg.fleet
        h = f.ReplicaHandle(0, _stub(pkg))
        trace = [h.state]
        with pytest.raises(RuntimeError, match="illegal transition"):
            h._set_state(f.JOINED)
        srv = h.spawn()
        trace.append((h.state, srv.replica_id))
        report = h.warm()
        trace.append((srv.warmed, report.zero_probe_join(),
                      {k: v for k, v in report.to_params().items() if k != "warm_s"}))
        router = _FakeRouter()
        h.join(router)
        trace.append((h.state, router.added == [srv]))
        trace.append((h.drain(), h.state, srv.drained))
        trace.append([s for s, _ in h.transitions])
        return trace

    trace = _both(walk)
    assert trace[-1] == list(tfleet.STATES)
    assert trace[2][:2] == (True, True)
    assert tfleet.STATES == jfleet.STATES
    assert {k: tuple(v) for k, v in tfleet.lifecycle._TRANSITIONS.items()} == {
        k: tuple(v) for k, v in jfleet.lifecycle._TRANSITIONS.items()}
    assert tfleet.lifecycle.SERVING_SPACE_DIMS == jfleet.lifecycle.SERVING_SPACE_DIMS
    assert tfleet.serving_space_signature() == jfleet.serving_space_signature()


def test_lifecycle_replica_id_mismatch_and_kill():
    def run(pkg):
        f = pkg.fleet
        h = f.ReplicaHandle(5, _stub(pkg, 99))
        with pytest.raises(f.ReplicaSpawnError, match="replica_id=99") as e:
            h.spawn()
        h2 = f.ReplicaHandle(6, _stub(pkg))
        h2.spawn()
        h2.kill()                                 # kill is legal from any state
        return str(e.value), h.state, h2.state, h2.server.halted

    assert _both(run)[1:] == (tfleet.DEAD, tfleet.DEAD, True)


def test_chaos_slow_warm_stalls_bring_up():
    def run(pkg):
        c = pkg.chaos
        sched = c.ChaosSchedule([c.ChaosEvent(kind="replica_slow_warm", site="replica0",
                                              at=0, param=0.05)])
        c.configure_chaos(sched)
        try:
            h = pkg.fleet.ReplicaHandle(0, _stub(pkg))
            h.spawn()
            t0 = time.monotonic()
            h.warm()
            stalled = time.monotonic() - t0 >= 0.05
        finally:
            c.configure_chaos(None)
        return stalled, [e["kind"] for e in sched.fired]

    assert _both(run) == (True, ["replica_slow_warm"])


# ---------------------------------------------------------------------------
# FleetManager: scale-out, reap, scale-in
# ---------------------------------------------------------------------------


def test_manager_start_and_scale_out():
    def run(pkg):
        mgr = pkg.fleet.FleetManager(_stub(pkg), max_replicas=3)
        router = mgr.start(1)
        trace = [router is mgr.router, sorted(router.replicas), _states(mgr)]
        trace.append(mgr.scale_out())
        trace.append(sorted(router.alive_ids()))     # warmed pre-join
        mgr.scale_out()
        with pytest.raises(pkg.fleet.FleetAtCapacity):
            mgr.scale_out()
        trace += [_states(mgr), _ledger(mgr), mgr.describe()["joined"]]
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[3] == 1 and trace[4] == [0, 1]
    joins = [e for e in trace[6] if e[0] == "replica_join"]
    assert [e[1] for e in joins] == ["fleet_start", "fleet_scale_out", "fleet_scale_out"]
    assert joins[1][4]["zero_probe"] == "True"


def test_manager_reaps_failed_spawn():
    def run(pkg):
        c = pkg.chaos
        mgr = pkg.fleet.FleetManager(_stub(pkg), max_replicas=4)
        router = mgr.start(1)
        sched = c.ChaosSchedule([c.ChaosEvent(kind="replica_spawn_fail",
                                              site="replica1", at=0)])
        c.configure_chaos(sched)
        try:
            with pytest.raises(pkg.fleet.ReplicaSpawnError):
                mgr.scale_out()
        finally:
            c.configure_chaos(None)
        trace = [sorted(router.replicas), sorted(router._warming), _states(mgr),
                 [e["kind"] for e in sched.fired]]
        trace.append(mgr.scale_out())         # the fleet recovers with a fresh id
        trace.append(_ledger(mgr))
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[:2] == [[0], []] and trace[2][1][0] == tfleet.DEAD
    assert trace[4] == 2
    reaps = [e for e in trace[5] if e[0] == "replica_reap"]
    assert len(reaps) == 1 and reaps[0][2] == "failed:ReplicaSpawnError"


def test_manager_reaps_failure_after_registration():
    def run(pkg):
        mgr = pkg.fleet.FleetManager(_stub(pkg))
        router = mgr.start(1)
        h = mgr._new_handle()
        mgr.handles[h.replica_id] = h
        h.spawn()
        h.warm()
        h.join(router)
        joined = h.replica_id in router.replicas
        mgr._reap(h, during="scale_out", error=RuntimeError("post-join failure"))
        trace = [joined, h.replica_id in router.replicas, h.state, h.server.halted,
                 _ledger(mgr)[-1]]
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[:4] == [True, False, tfleet.DEAD, True]
    assert trace[4][2] == "failed:RuntimeError"


def test_manager_flap_guarded_scale_in():
    def run(pkg):
        guard = pkg.guard.FlapGuard(trigger_streak=2, cooldown_s=0.0)
        mgr = pkg.fleet.FleetManager(_stub(pkg), guard=guard, min_replicas=1,
                                     scale_in_low_watermark=0.5)
        router = mgr.start(2)
        trace = [mgr.poll()]                      # hysteresis: streak 1 of 2
        rid = mgr.poll()                          # streak 2 -> fires
        trace += [rid, mgr.handles[rid].state, rid in router._draining]
        trace.append([mgr.poll() for _ in range(5)])   # at min_replicas: never
        trace += [len(mgr._joined()), _ledger(mgr)]
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[0] is None and trace[1] is not None and trace[2] == tfleet.DEAD
    assert trace[3] and trace[4] == [None] * 5 and trace[5] == 1
    scale_in = [e for e in trace[6] if e[0] == "serving_scale_in"]
    assert len(scale_in) == 1 and scale_in[0][1:3] == ("fleet_scale_in", "ok")


def test_manager_poll_reconciles_router_declared_deaths():
    def run(pkg):
        guard = pkg.guard.FlapGuard(trigger_streak=1, cooldown_s=0.0)
        mgr = pkg.fleet.FleetManager(_stub(pkg), guard=guard, min_replicas=1)
        router = mgr.start(2)
        with router._lock:                    # a kill the manager did not make
            router._dead.add(0)
        trace = [mgr.poll(), mgr.handles[0].state, _ledger(mgr),
                 [h.replica_id for h in mgr._joined()]]
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[0] is None and trace[1] == tfleet.DEAD and trace[3] == [1]
    reaps = [e for e in trace[2] if e[0] == "replica_reap"]
    assert len(reaps) == 1 and reaps[0][1] == "fleet_reconcile"
    assert "died outside the fleet's control" in reaps[0][3]


def test_manager_reconcile_rearms_latched_sla_rules():
    def run(pkg):
        sup = pkg.sup.ControlSupervisor(
            pkg.config.ControlConfig(enabled=True),
            guard=pkg.guard.FlapGuard(trigger_streak=1, cooldown_s=0.0))
        # a scale-out rejected at capacity latched the rule in the old fleet
        trace = [sup.guard.should_fire("sla_pressure:1", True),
                 sup.guard.snapshot()["sla_pressure:1"]["latched"]]
        mgr = pkg.fleet.FleetManager(
            _stub(pkg), supervisor=sup, min_replicas=1,
            guard=pkg.guard.FlapGuard(trigger_streak=1, cooldown_s=0.0))
        router = mgr.start(2)
        with router._lock:
            router._dead.add(0)
        mgr.poll()
        trace += [mgr.handles[0].state, sup.guard.snapshot()["sla_pressure:1"]["latched"],
                  sup.guard.should_fire("sla_pressure:1", True), mgr.ledger is sup.ledger]
        mgr.close()
        return trace

    assert _both(run) == [True, True, tfleet.DEAD, False, True, True]


def test_manager_scale_in_keeps_loaded_replicas():
    def run(pkg):
        mgr = pkg.fleet.FleetManager(_stub(pkg))
        mgr.start(3)
        for rid, load in ((0, 4), (1, 0), (2, 2)):   # 1 is the least loaded
            mgr.handles[rid].server.outstanding = load
        trace = [mgr.scale_in(), mgr.handles[1].state,
                 sorted(h.replica_id for h in mgr._joined()), _ledger(mgr)[-1]]
        mgr.close()
        return trace

    trace = _both(run)
    assert trace[:3] == [1, tfleet.DEAD, [0, 2]]
    assert trace[3][4] == {"replica": "1", "drained_clean": "True"}


def test_supervisor_keeps_caller_supplied_empty_ledger():
    from deepspeed_tpu_torch.control.ledger import ControlLedger

    led = ControlLedger()
    sup = tsup.ControlSupervisor(tconfig.ControlConfig(), ledger=led)
    mgr = tfleet.FleetManager(_stub(PKGS["port"]), supervisor=sup)
    assert sup.ledger is led and mgr.ledger is led


# ---------------------------------------------------------------------------
# warm join on real tiny engines
# ---------------------------------------------------------------------------


def _gpu_measure_planner(cache_dir):
    """A measuring planner that prices the decode site as on the card (the
    CPU's fingerprint gives the kernel's plain version no chance), with a
    margin wide enough that both probes run."""
    pl = tplan.configure_planner("measure", cache_dir=cache_dir, margin=8.0)
    pl.fingerprint = dataclasses.replace(pl.fingerprint, platform="gpu",
                                         device_kind="NVIDIA H100 80GB HBM3")
    pl.cost = tplan.CostModel(pl.fingerprint, block=pl.block)
    cached = pl.cache.load(pl.fingerprint)
    pl.plan = tplan.Plan(fingerprint=pl.fingerprint.digest(),
                         decisions=cached.decisions if cached else None)
    pl._from_cache = set(cached.decisions) if cached else set()
    return pl


def test_warm_join_zero_probe_via_winner_cache(tmp_path):
    from deepspeed_tpu_torch.fleet._testing import make_tiny_server

    cache_dir = str(tmp_path / "winners")
    _gpu_measure_planner(cache_dir)
    made = {}

    def factory(rid):
        made[rid] = make_tiny_server(rid)
        return made[rid]

    h0 = tfleet.ReplicaHandle(0, factory, autotune_cache_dir=cache_dir)
    h0.spawn()        # the engine asks the planner: both decode probes run
    assert tplan.probe_stats()["built"] == 2
    r0 = h0.warm()
    # first replica on this mesh: probes every candidate once, stores
    assert r0.autotune_from_cache is False and r0.autotune_probes == 2
    assert r0.winner_name in ("fd0", "fd8") and not r0.zero_probe_join()
    assert made[0].fused_decode_chunk == r0.fused_decode_chunk
    assert r0.warm_tokens > 0 and (r0.plan_decisions, r0.plan_from_cache) == (1, 0)

    h1 = tfleet.ReplicaHandle(1, factory, autotune_cache_dir=cache_dir)
    h1.spawn()        # the planner's decision is in memory: no new probe
    r1 = h1.warm()
    assert tplan.probe_stats()["built"] == 2
    assert made[1].engine.decode_attn_source in ("planner", "fallback")
    # second replica: cached winner applied, ZERO probes of either kind
    assert r1.autotune_from_cache is True and r1.autotune_probes == 0
    assert r1.probes_built == 0 and r1.zero_probe_join()
    assert r1.winner_name == r0.winner_name
    assert made[1].fused_decode_chunk == r0.fused_decode_chunk
    assert r1.to_params()["zero_probe"] == "True"

    # a replica in a fresh process: a new planner on the same cache directory
    # and an empty probe memo; the plan comes from disk
    tplan.reset_probe_memo()
    _gpu_measure_planner(cache_dir)
    h2 = tfleet.ReplicaHandle(2, factory, autotune_cache_dir=cache_dir)
    h2.spawn()
    r2 = h2.warm()
    assert tplan.probe_stats()["built"] == 0
    assert (r2.plan_decisions, r2.plan_from_cache, r2.zero_probe_join()) == (1, 1, True)
    for srv in made.values():
        srv.halt()


def test_warm_generation_gives_jax_tokens():
    """The warm step's generation (the packed step the first request would
    otherwise build) through each package's engine from the same weights."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
    from deepspeed_tpu.models.transformer import TransformerConfig as JConfig
    from deepspeed_tpu.models.transformer import TransformerLM as JLM
    from deepspeed_tpu_torch.fleet import _testing
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import params_from_jax
    from deepspeed_tpu_torch.serving import LLMServer

    jcfg = JConfig(vocab_size=97, hidden_size=48, intermediate_size=96, num_layers=2,
                   num_heads=4, num_kv_heads=2, max_seq_len=128, dtype=jnp.float32,
                   norm="rmsnorm", activation="swiglu")
    params = jax.device_get(JLM(jcfg).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 8), jnp.int32))["params"])
    ecfg = dataclasses.asdict(_testing.tiny_engine_config())
    cfg = _testing.tiny_config()
    servers = {
        "jax": jserving.LLMServer(JEngine(JLM(jcfg), params, JEC(**ecfg)), replica_id=0),
        "port": LLMServer(InferenceEngineV2(cfg, params_from_jax(params, cfg, device="cpu"),
                                            _testing.tiny_engine_config(), device="cpu"),
                          replica_id=0)}
    tokens = {}
    for name, srv in servers.items():
        out = []
        generate = srv.engine.generate
        srv.engine.generate = lambda *a, _g=generate, **k: out.append(_g(*a, **k)) or out[-1]
        h = PKGS[name].fleet.ReplicaHandle(0, lambda rid, s=srv: s, use_winner_cache=False)
        h.spawn()
        report = h.warm()
        tokens[name] = [[int(t) for t in seq] for seq in out[0]]
        assert report.warm_tokens == sum(len(t) for t in tokens[name]) == 8
    assert tokens["port"] == tokens["jax"]


# ---------------------------------------------------------------------------
# subprocess replica (its own interpreter and engine, on the CPU)
# ---------------------------------------------------------------------------


def test_subprocess_replica_round_trip(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.fleet._testing import make_tiny_server
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, Request

    monkeypatch.setenv("DSTPU_PLAN_CACHE", str(tmp_path / "cache"))
    hb = tmp_path / "hb"
    prompt = np.arange(1, 6, dtype=np.int32)
    rep = None
    try:
        rep = tfleet.SubprocessReplica(
            0, "deepspeed_tpu_torch.fleet._testing:make_tiny_server",
            heartbeat_dir=str(hb), hello_timeout_s=WAIT_S)
        assert rep.warmed                         # hello implies the child warmed
        assert rep.warm_params.get("replica") == "0"
        assert rep.warm_params.get("autotune_probes") == "2"
        resp = rep.submit(Request(prompt, max_new_tokens=4, tenant="gold"))
        assert resp.wait(WAIT_S), "subprocess completion did not land"
        assert len(resp.tokens) == 4 and resp.finish_reason == FINISH_LENGTH
        assert rep.metrics.completed == 1 and rep.outstanding == 0
        assert list((hb).glob("*")), "the child wrote no heartbeat"
        assert rep.drain(WAIT_S)
    finally:
        if rep is not None and rep.proc.poll() is None:
            rep.proc.kill()
            rep.proc.wait(WAIT_S)
    # the child's tokens are an in-process replica's of the same seed
    local = make_tiny_server(0)
    (want,) = local.engine.generate([prompt], max_new_tokens=4)
    assert list(resp.tokens) == [int(t) for t in want]
