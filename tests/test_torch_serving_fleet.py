"""The port's serving fleet against the JAX package's.

Open-loop traffic, tenancy, ``LLMServer.from_config``, the replica router's
dead-replica takeover, the ``drop_token`` fence, the requeue budget, the
integrity canary and the router's warm gate. Tiny models converted with
``params_from_jax`` serve in float32 on the CPU, so greedy tokens must be
equal, exactly: the port's drills against the JAX router's and against an
undisturbed port run. Schedules and watermarks are compared bitwise; latency
orderings on fake clocks exactly. Every wait on a thread has a time limit.
"""

import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.fleet.tenancy import TenancyMap as JTenancy
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.models.transformer import TransformerLM as JLM
from deepspeed_tpu.runtime.resilience import chaos as jchaos
from deepspeed_tpu.runtime.resilience.heartbeat import \
    FileHeartbeatTransport as JTransport
from deepspeed_tpu.serving import LLMServer as JServer
from deepspeed_tpu.serving import ReplicaRouter as JRouter
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServedResponse as JResp
from deepspeed_tpu.serving import scheduler as jsched
from deepspeed_tpu.serving import traffic as jtraffic
from deepspeed_tpu_torch.fleet import DEFAULT_CLASSES, TenancyMap
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.runtime.resilience import chaos as tchaos
from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
from deepspeed_tpu_torch.serving import (FINISH_FAILED, FINISH_LENGTH, LLMServer,
                                         ReplicaRouter, Request, ServedResponse)
from deepspeed_tpu_torch.serving import scheduler as tsched
from deepspeed_tpu_torch.serving import traffic as ttraffic
from tests.test_torch_model import tiny_pair
from tests.unit.test_serving import _FakeEngine

#: every wait on an engine thread, in seconds
WAIT_S = 120

ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=8, max_blocks_per_seq=16,
              dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_chaos():
    """The chaos schedule is process-wide: no drill leaks into the next."""
    tchaos.configure_chaos(None)
    jchaos.configure_chaos(None)
    yield
    tchaos.configure_chaos(None)
    jchaos.configure_chaos(None)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, numpy params) of a llama at head dim 64."""
    return tiny_pair("llama", hidden_size=128, num_heads=2, max_seq_len=256)


def _port_engine(tiny, **over):
    _, tcfg, params_np = tiny
    return TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                   TEC(**{**ENGINE, **over}), device="cpu")


def _jax_engine(tiny, **over):
    jcfg, _, params_np = tiny
    return JEngine(JLM(jcfg), params_np, JEC(**{**ENGINE, **over}))


def _until(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# open-loop traffic and tenancy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed, kind, pool", [(0, "uniform", 0), (3, "lognormal", 0),
                                              (11, "uniform", 3)])
def test_traffic_schedule_is_jax_bitwise(seed, kind, pool):
    def cfg(mod):
        return mod.TrafficConfig(rate_rps=3.0, num_requests=24, seed=seed, vocab_size=32000,
                                 prompt_len=mod.LengthDist(kind, 128, 1024),
                                 output_len=mod.LengthDist("uniform", 8, 128),
                                 deadline_s=5.0, priorities=(0, 1, 2),
                                 system_prompt_pool=pool, system_prompt_len=16)
    got = ttraffic.OpenLoopTraffic(cfg(ttraffic)).schedule()
    want = jtraffic.OpenLoopTraffic(cfg(jtraffic)).schedule()
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.max_new_tokens, g.priority, g.deadline_s, g.request_id) == \
            (w.max_new_tokens, w.priority, w.deadline_s, w.request_id)


TENANCY = {"classes": {"gold": {"weight": 4, "deadline_s": 2.0}, "silver": 2.0,
                       "bronze": {"weight": 1}},
           "tenants": {"acme": "gold", "hobby": "bronze"}, "default": "silver"}


@pytest.mark.parametrize("spec", [TENANCY, {"tenants": {"gold": "gold", "bronze": "bronze"}}])
def test_tenancy_classes_and_shed_watermarks_match_jax(spec):
    got, want = TenancyMap.from_config(spec), JTenancy.from_config(spec)
    assert got.default == want.default and got.max_weight == want.max_weight
    for tenant in ("acme", "hobby", "gold", "silver", "bronze", "nobody", None):
        assert got.cls_for(tenant).name == want.cls_for(tenant).name
        assert got.default_deadline_s(tenant) == want.default_deadline_s(tenant)
        for base in (1, 2, 3, 7, 64, 256):
            assert got.shed_watermark(base, tenant) == want.shed_watermark(base, tenant)
    assert [c.name for c in DEFAULT_CLASSES] == ["gold", "silver", "bronze"]


def _tenant_admission_order(sched_mod, resp_cls, req_cls, tenancy):
    """Six requests of three tenants under contention (a pool of four
    blocks holds two): the deadline scheduler with tenancy
    admits by weighted deadline; returns the admit order."""
    eng = _FakeEngine(num_blocks=4, block_size=4)
    sched = sched_mod.ContinuousBatchScheduler(eng, "deadline", tenancy=tenancy,
                                               clock=lambda: 0.0)
    tenants = ["hobby", "acme", None, "hobby", "acme", "nobody"]
    for uid, tenant in enumerate(tenants):
        req = req_cls(np.arange(1, 5, dtype=np.int32), max_new_tokens=4,
                      deadline_s=4.0 + uid, tenant=tenant)
        sched.add(resp_cls(req, uid, float(uid) * 0.1))
    order = []
    for step in range(6):
        order += [r.uid for r in sched.admit(float(step))]
        for uid in order[-2:]:
            eng.flush(uid)
            sched.complete(uid)
    return order


def test_tenant_weighted_admission_matches_jax():
    got = _tenant_admission_order(tsched, ServedResponse, Request,
                                  TenancyMap.from_config(TENANCY))
    want = _tenant_admission_order(jsched, JResp, JRequest, JTenancy.from_config(TENANCY))
    assert got == want and sorted(got) == list(range(6))
    assert got[0] in (1, 4)                  # a gold tenant first


def test_from_config_builds_the_jax_server(tiny, tmp_path):
    jcfg, tcfg, params_np = tiny
    block = {"serving": {"enabled": True, "policy": "deadline", "max_queue": 7,
                         "default_deadline_s": 9.0, "replica_id": 3,
                         "heartbeat_dir": str(tmp_path), "heartbeat_interval_s": 0.5,
                         "metrics_interval_steps": 5, "fused_decode_chunk": 4,
                         "resume_checkpoint_tokens": 8, "tenancy": TENANCY,
                         "canary_interval_steps": 16, "canary_prompt": [7, 8, 9],
                         "canary_max_tokens": 6, "canary_expect": "ab" * 8,
                         "engine": dict(ENGINE, num_kv_blocks=24)}}
    got = LLMServer.from_config(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                                block, device="cpu")
    want = JServer.from_config(JLM(jcfg), params_np, block)
    for attr in ("replica_id", "default_deadline_s", "fused_decode_chunk",
                 "resume_checkpoint_tokens", "metrics_interval_steps",
                 "heartbeat_interval_s", "canary_interval_steps", "canary_max_tokens",
                 "canary_expect", "control_interval_steps", "control_max_queue",
                 "warmed", "idle_s"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.scheduler.policy == want.scheduler.policy == "deadline"
    assert got.scheduler.preempt == want.scheduler.preempt
    assert got._ingress.maxsize == want._ingress.maxsize == 7
    np.testing.assert_array_equal(got._canary_prompt, want._canary_prompt)
    assert got.engine.config == TEC(**dict(ENGINE, num_kv_blocks=24))
    assert got.engine.device == torch.device("cpu")
    assert got.heartbeat.rank == want.heartbeat.rank == 3
    assert got.heartbeat.transport.dir == want.heartbeat.transport.dir
    assert sorted(got.tenancy.classes) == sorted(want.tenancy.classes)
    # the shorthand, a training-only ds_config and a bare block
    for cfg, policy in (({"serving": "priority"}, "priority"),
                        ({"train_batch_size": 8}, "fcfs"), ({"policy": "deadline"}, "deadline")):
        srv = LLMServer.from_config(tcfg, got.engine.params, cfg, device="cpu")
        assert srv.scheduler.policy == policy
    if not torch.cuda.is_available():          # the engine lives on the card by default
        with pytest.raises(RuntimeError, match="cuda"):
            LLMServer.from_config(tcfg, got.engine.params, block)


# ---------------------------------------------------------------------------
# the replica-death drill (JAX tests/unit/test_serving.py:578, by chaos)
# ---------------------------------------------------------------------------

PROMPTS = [np.arange(1, 11, dtype=np.int32), np.arange(20, 27, dtype=np.int32),
           np.arange(40, 52, dtype=np.int32), np.arange(60, 69, dtype=np.int32)]
NEW = 40


def _kill_drill(mods, make_engine, tmp_path, kill_at=12, max_restarts=3):
    """Two replicas behind a router; chaos kills replica 0 at its serving
    step ``kill_at``; a fake wall clock ages its beacon past
    ``dead_after_s``. Returns (responses, victims, router, streams)."""
    server_cls, router_cls, transport_cls, req_cls, chaos = mods
    chaos.configure_chaos(chaos.ChaosSchedule([
        chaos.ChaosEvent(kind="replica_kill", site="replica0", at=kill_at)]))
    wall = [1000.0]
    servers = [server_cls(make_engine(), replica_id=i, heartbeat_interval_s=0.005,
                          resume_checkpoint_tokens=8) for i in range(2)]
    router = router_cls(servers, transport=transport_cls(str(tmp_path)),
                        dead_after_s=5.0, clock=lambda: wall[0]).start()
    streams = {i: [] for i in range(len(PROMPTS))}
    resps = [router.submit(req_cls(p, max_new_tokens=NEW, max_restarts=max_restarts,
                                   stream=lambda tok, r, i=i: streams[i].append(
                                       (r._delivered - 1, tok))), block=True)
             for i, p in enumerate(PROMPTS)]
    assert {r.replica_id for r in resps} == {0, 1}
    _until(lambda: not servers[0]._thread.is_alive(), "the chaos kill")
    victims = [r for r in resps if r.replica_id == 0 and not r.done]
    assert router.check() == []                 # the beacon is still fresh
    wall[0] += 10.0                             # ... until it ages past 5 s
    beat = servers[1].heartbeat
    _until(lambda: beat.transport.read_all().get(1, {}).get("wall_time", 0) >= wall[0],
           "the survivor's next beacon")
    assert router.check() == [0]
    return resps, victims, router, streams


def _mods(port):
    if port:
        return LLMServer, ReplicaRouter, FileHeartbeatTransport, Request, tchaos
    return JServer, JRouter, JTransport, JRequest, jchaos


def test_replica_death_drill_matches_jax_and_an_undisturbed_run(tiny, tmp_path):
    ref = _port_engine(tiny).generate(PROMPTS, max_new_tokens=NEW)
    got = {}
    for port in (True, False):
        make = (lambda: _port_engine(tiny)) if port else (lambda: _jax_engine(tiny))
        resps, victims, router, streams = _kill_drill(_mods(port), make,
                                                      tmp_path / f"hb{int(port)}")
        assert victims, "replica 0 finished everything before the kill"
        assert router.requeues == len(victims)
        for i, r in enumerate(resps):
            assert r.wait(WAIT_S) and r.finish_reason == FINISH_LENGTH
            assert len(r.tokens) == NEW
            # the stream fired once per token index, in order
            assert [k for k, _ in streams[i]] == list(range(NEW))
        for v in victims:
            assert v.preemptions >= 1 and v.requeues == 1 and v.replica_id == 1
        assert router.drain(timeout=WAIT_S)
        assert router.replicas[1].engine._outstanding_blocks() == 0
        got[port] = [r.result() for r in resps]
    for p, j, w in zip(got[True], got[False], ref):
        np.testing.assert_array_equal(p, np.asarray(j))
        np.testing.assert_array_equal(p, w)


def test_requeue_budget_fails_the_nth_requeue(tiny, tmp_path):
    resps, victims, router, _ = _kill_drill(_mods(True), lambda: _port_engine(tiny), tmp_path,
                                            kill_at=6, max_restarts=0)
    assert victims and router.requeues == len(victims)
    for v in victims:
        assert v.wait(WAIT_S) and v.finish_reason == FINISH_FAILED
        assert v.requeues == 1 and v.replica_id == 0
        with pytest.raises(RuntimeError, match="failed"):
            v.result(0)
    for r in resps:
        assert r.wait(WAIT_S)
    assert router.replicas[0].metrics.failed == len(victims)
    assert router.drain(timeout=WAIT_S)


def test_drop_token_redelivers_exactly_once_as_jax(tiny):
    """Dropped stream deliveries on the packed and the fused path land with
    the next delivery or at finish: every token index once, in order, and
    the same callback sequence as the JAX server's under one schedule."""
    seqs = {}
    for port in (True, False):
        chaos = tchaos if port else jchaos
        chaos.configure_chaos(chaos.ChaosSchedule([
            chaos.ChaosEvent(kind="drop_token", site="replica0", at=2, count=3),
            chaos.ChaosEvent(kind="drop_token", site="replica0", at=17, count=4),
            chaos.ChaosEvent(kind="kv_exhaustion", site="scheduler.admit", at=0, count=2),
            chaos.ChaosEvent(kind="slow_prefill", site="replica0", at=1, param=0.01)]))
        eng = _port_engine(tiny) if port else _jax_engine(tiny)
        srv = (LLMServer if port else JServer)(eng, replica_id=0, fused_decode_chunk=4).start()
        got = []
        resp = srv.submit((Request if port else JRequest)(
            PROMPTS[0], max_new_tokens=24,
            stream=lambda tok, r: got.append((r._delivered - 1, tok))), block=True)
        assert resp.wait(WAIT_S) and resp.finish_reason == FINISH_LENGTH
        assert srv.drain(timeout=WAIT_S)
        assert [k for k, _ in got] == list(range(24))
        assert [t for _, t in got] == resp.tokens
        assert chaos.get_chaos().classes_fired() == ["drop_token", "kv_exhaustion",
                                                     "slow_prefill"]
        seqs[port] = got
    assert seqs[True] == seqs[False]


# ---------------------------------------------------------------------------
# the integrity canary and the warm gate
# ---------------------------------------------------------------------------


def test_canary_learns_then_quarantines_a_corrupted_replica(tiny, tmp_path):
    """Both replicas learn their probe's hash; replica 0's ``wo`` of layer
    0 is then negated, its next probe fails, its engine thread dies with
    the canary error, the router takes it over, and new requests all land
    on replica 1, whose canary stays clean. The JAX server learns the same
    hash from the same weights."""
    wall = [1000.0]
    servers = [LLMServer(_port_engine(tiny), replica_id=i, heartbeat_interval_s=0.005,
                         canary_interval_steps=4, canary_max_tokens=4) for i in range(2)]
    router = ReplicaRouter(servers, transport=FileHeartbeatTransport(str(tmp_path)),
                           dead_after_s=5.0, clock=lambda: wall[0]).start()
    warm = [router.submit(Request(p, max_new_tokens=8), block=True) for p in PROMPTS]
    _until(lambda: all(s.canary_expect is not None for s in servers), "two learned hashes")
    for r in warm:
        assert r.wait(WAIT_S) and r.finish_reason == FINISH_LENGTH
    assert servers[0].canary_expect == servers[1].canary_expect
    jsrv = JServer(_jax_engine(tiny), canary_interval_steps=4, canary_max_tokens=4).start()
    jsrv.submit(JRequest(PROMPTS[0], max_new_tokens=8), block=True)
    _until(lambda: jsrv.canary_expect is not None, "the JAX server's hash")
    assert jsrv.drain(timeout=WAIT_S)
    assert jsrv.canary_expect == servers[0].canary_expect

    servers[0].engine.params["layer_0"]["attn"]["o_proj"]["kernel"].neg_()  # goes bad
    servers[0].submit(Request(PROMPTS[1], max_new_tokens=16), block=True)
    _until(lambda: servers[0].error is not None, "the canary verdict")
    assert "integrity canary failed" in str(servers[0].error)
    assert servers[0].metrics.canary_fails == 1
    assert router.alive_ids() == [1]
    wall[0] += 10.0
    beat = servers[1].heartbeat
    _until(lambda: beat.transport.read_all().get(1, {}).get("wall_time", 0) >= wall[0],
           "the survivor's next beacon")
    assert router.check() == [0]
    after = [router.submit(Request(p, max_new_tokens=8), block=True) for p in PROMPTS]
    ref = _port_engine(tiny).generate(PROMPTS, max_new_tokens=8)
    for r, w in zip(after, ref):
        assert r.wait(WAIT_S) and r.replica_id == 1
        np.testing.assert_array_equal(r.result(), w)
    assert router.drain(timeout=WAIT_S)
    assert servers[1].error is None and servers[1].metrics.canary_fails == 0
    assert servers[1].metrics.canary_probes >= 2


class _Stub:
    """The surface the router's warm gate reads."""

    def __init__(self, rid, warmed=False):
        self.replica_id, self.warmed, self.error = rid, warmed, None
        self.heartbeat, self._thread, self.outstanding = None, None, 0

    def start(self):
        return self

    def halt(self):
        pass


@pytest.mark.parametrize("port", [True, False])
def test_warm_gate_keeps_traffic_off_a_cold_replica(port, tiny):
    router_cls = ReplicaRouter if port else JRouter
    router = router_cls([_Stub(0, warmed=True)])
    router.add_replica(_Stub(1))                 # cold: registered, not routed
    assert router.alive_ids() == [0]
    router.mark_ready(1)
    assert router.alive_ids() == [0, 1]
    lazy = _Stub(2)
    router.add_replica(lazy)
    assert router.alive_ids() == [0, 1]
    lazy.warmed = True
    assert router.alive_ids() == [0, 1, 2]
    router.add_replica(_Stub(3), ready=True)
    assert 3 in router.alive_ids()
    with pytest.raises(ValueError, match="already registered"):
        router.add_replica(_Stub(3))
    assert router.remove_replica(3).replica_id == 3
    if port:                                     # a real server warms on its first step
        srv = LLMServer(_port_engine(tiny), replica_id=9)
        assert srv.warmed is False
        router.add_replica(srv)
        assert 9 not in router.alive_ids()
        srv.submit(Request(PROMPTS[0], max_new_tokens=2), block=True).wait(WAIT_S)
        assert srv.warmed and 9 in router.alive_ids()
        assert srv.drain(timeout=WAIT_S)


def test_loop_death_by_a_base_exception_fails_requests_as_jax(tiny, monkeypatch):
    """A ``BaseException`` that is not an ``Exception`` (here
    ``SystemExit``) kills the engine thread as an ``Exception`` does: the
    server records it, fails every outstanding request, stops advertising,
    and does not re-raise it out of the thread — the JAX loop's behaviour."""
    import threading

    raised = []
    monkeypatch.setattr(threading, "excepthook", lambda args: raised.append(args))
    for port in (True, False):
        eng = _port_engine(tiny) if port else _jax_engine(tiny)

        def boom():
            raise SystemExit("engine torn down")
        eng.step = boom
        srv = (LLMServer if port else JServer)(eng).start()
        resps = [srv.submit((Request if port else JRequest)(p, max_new_tokens=4),
                            block=True) for p in PROMPTS[:2]]
        for r in resps:
            assert r.wait(WAIT_S) and r.finish_reason == FINISH_FAILED
        srv._thread.join(WAIT_S)
        assert isinstance(srv.error, SystemExit) and not srv._thread.is_alive()
        assert srv.metrics.failed == 2
    assert raised == []
