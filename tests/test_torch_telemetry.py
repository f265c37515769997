"""The port's telemetry spine against the JAX package's.

Spans, the Chrome trace, the Prometheus exposition, the flight recorder's
dumps, the collective recorder and the serving-metrics bridge, driven by the
same calls in both packages on a fake clock (``time.perf_counter_ns`` and
``time.time`` patched to counters), must give equal results: span trees and
trace JSON equal, exposition text equal line for line, dumps equal in keys
and entries, samples equal. The port's comm layer records its launches into
the collective recorder, and a live ``TelemetryManager`` gets every
``LLMServer``'s ``dstpu_serving_*`` samples and its engine loop's spans.
"""

import itertools
import json
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.runtime.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu.serving import metrics as jmetrics
from deepspeed_tpu.serving import request as jrequest
from deepspeed_tpu.telemetry import manager as jmanager
from deepspeed_tpu.utils import retry as jretry
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.runtime.config import TelemetryConfig
from deepspeed_tpu_torch.serving import metrics as tmetrics
from deepspeed_tpu_torch.serving import request as trequest
from deepspeed_tpu_torch.telemetry import manager as tmanager
from deepspeed_tpu_torch.utils import retry as tretry

PACKAGES = {"port": (ttel, tmetrics, trequest, tmanager, tretry),
            "jax": (jtel, jmetrics, jrequest, jmanager, jretry)}


@pytest.fixture
def fake_time(monkeypatch):
    """``perf_counter_ns`` and ``time`` as counters; ``reset()`` restarts
    them so each package's run sees the same readings."""
    class Clock:
        def reset(self):
            self.ns = itertools.count(10_000, 1_000)
            self.wall = itertools.count(1_700_000_000, 1)
    clock = Clock()
    clock.reset()
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock.ns))
    monkeypatch.setattr(time, "time", lambda: float(next(clock.wall)))
    return clock


def _reset(tel):
    tel.configure_tracer(enabled=False)
    tel.get_tracer().set_step(None)
    tel.get_tracer().clear()
    tel.configure_collective_recorder(enabled=False)
    tel.get_collective_recorder().clear()
    tel.reset_registry()


@pytest.fixture(autouse=True)
def _clean_globals():
    """Both packages' process-wide tracer, recorder and registry start and
    end each test cleared: other test files in this process use them."""
    for tel in (ttel, jtel):
        _reset(tel)
    yield
    for tel in (ttel, jtel):
        _reset(tel)


def _span_run(tel):
    tracer = tel.SpanTracer(enabled=True, max_spans=64)
    tracer.set_step(3)
    with tracer.span("serve/step", mode="fused"):
        with tracer.span("serve/deliver"):
            pass
        with tracer.span("compute/dispatch", n=2):
            pass
    tracer.set_step(4)
    with tracer.span("serve/ingress"):
        pass
    hung = tracer.span("serve/decode")
    hung.__enter__()                           # never closed: a hang
    return tracer


@pytest.mark.parametrize("rank", [None, 2])
def test_span_tree_and_chrome_trace_match_jax(fake_time, tmp_path, rank):
    out = {}
    for name, (tel, *_ ) in PACKAGES.items():
        fake_time.reset()
        tracer = _span_run(tel)
        closed, open_ = tracer.snapshot(), tracer.open_spans()
        path = tel.export_chrome(str(tmp_path / name / "trace.json"), closed, open_, rank=rank)
        with open(path) as f:
            out[name] = (closed, open_, tel.chrome_trace(closed, open_, rank=rank), json.load(f))
        assert tracer.drain() == closed and tracer.snapshot() == []
    assert out["port"] == out["jax"]
    closed = out["port"][0]
    assert [(s["name"], s["depth"], s["step"]) for s in closed] == [
        ("serve/deliver", 1, 3), ("compute/dispatch", 1, 3), ("serve/step", 0, 3),
        ("serve/ingress", 0, 4)]
    assert out["port"][1][0]["name"] == "serve/decode"


def test_fleet_tracer_switch_matches_jax(fake_time):
    for tel in (ttel, jtel):
        assert tel.span("x") is tel.span("y")          # off: one shared no-op
        tel.configure_tracer(enabled=True, max_spans=2)
        for n in ("a", "b", "c"):
            with tel.span(n):
                pass
    assert ([s["name"] for s in ttel.get_tracer().snapshot()]
            == [s["name"] for s in jtel.get_tracer().snapshot()] == ["b", "c"])


def _registry_run(tel):
    reg = tel.MetricsRegistry()
    reg.counter("dstpu_steps_total", "engine steps").inc(3)
    c = reg.counter("dstpu_retry_total", "retries by site")
    c.inc(site="heartbeat.put")
    c.inc(2.5, site='odd "site"\\n')
    g = reg.gauge("dstpu_mem_bytes_in_use", "bytes")
    g.set(17, device="0")
    g.set(1 << 40, device="1")
    reg.gauge("dstpu_live", "a callback gauge").set_fn(lambda: 0.25)
    h = reg.histogram("dstpu_step_phase_seconds", "phase seconds")
    for v, phase in ((0.004, "a"), (0.2, "a"), (3.0, "b"), (1e9, "b")):
        h.observe(v, phase=phase)
    reg.register_collector("extra", lambda: [
        ("dstpu_extra_total", "counter", "from a collector",
         [("", {"k": "v"}, 4.0), ("", {"k": "w"}, 5.0)])])
    return reg


def test_registry_exposition_matches_jax_line_for_line():
    got, want = _registry_run(ttel), _registry_run(jtel)
    assert got.exposition().splitlines() == want.exposition().splitlines()
    assert got.monitor_events(7) == want.monitor_events(7)
    got.unregister_collector("extra")
    want.unregister_collector("extra")
    assert got.exposition() == want.exposition()
    assert "dstpu_extra_total" not in got.exposition()


def test_flight_dump_matches_jax(fake_time, tmp_path):
    docs = {}
    for name, (tel, _m, _r, _mgr, retry) in PACKAGES.items():
        fake_time.reset()
        retry.clear_retry_log()
        retry._note("heartbeat.put", 1, OSError("eagain"), final=False)
        tracer = tel.SpanTracer(enabled=True)
        coll = tel.CollectiveRecorder(enabled=True, max_records=3)
        rec = tel.FlightRecorder(tracer, str(tmp_path / name), steps=2, rank=1,
                                 clock=lambda: float(next(fake_time.wall)), collectives=coll)
        for step in range(3):
            tracer.set_step(step)
            with tracer.span("serve/step"):
                coll.record("all_reduce", shape=(8, 4), dtype="float32", axes=("dp",))
            rec.record_step(step, step_time_s=0.5 + step, metrics={"loss": 2.0, "x": "no"},
                            mem={"bytes_in_use": 10 * step})
        with tracer.span("serve/deliver"):
            with open(rec.dump("watchdog", {"fired_step": 2})) as f:
                docs[name] = json.load(f)
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    assert [s["step"] for s in doc["steps"]] == [1, 2]
    assert doc["last_phase"] == "serve/deliver" and doc["fired_step"] == 2
    assert len(doc["collectives"]) == 3 and doc["retries"][0]["site"] == "heartbeat.put"
    assert ttel.flightdump_path(str(tmp_path), 1).endswith("flightdump-1.json")


def _metrics_history(metrics_mod, request_mod):
    now = [0.0]
    m = metrics_mod.ServingMetrics(clock=lambda: now[0])
    rng = np.random.default_rng(5)
    for uid in range(12):
        tenant = (None, "gold", "bronze")[uid % 3]
        req = request_mod.Request(np.arange(1, 6, dtype=np.int32), max_new_tokens=4,
                                  deadline_s=2.0 if uid % 2 else None, tenant=tenant)
        resp = request_mod.ServedResponse(req, uid, now[0])
        m.on_submit(resp)
        if uid == 5:
            m.on_reject(req)
            continue
        resp._on_admit(now[0] + 0.1)
        for k in range(4):
            resp._on_token(7 + k, now[0] + 0.2 + float(rng.random()) + k)
        reason = ("cancelled" if uid == 7 else "failed" if uid == 8 else "length")
        resp._on_finish(reason, now[0] + 5.0 * float(rng.random()) + 4)
        m.on_finish(resp)
        now[0] += 0.75
    m.preemptions, m.requeues, m.canary_probes, m.canary_fails = 2, 3, 4, 1
    m.sample(queue_depth=3, inflight=2, kv_free_blocks=10, kv_total_blocks=41)
    return m, now


def test_serving_metrics_samples_match_jax():
    outs = {}
    for name, (tel, metrics_mod, request_mod, mgr, _r) in PACKAGES.items():
        m, now = _metrics_history(metrics_mod, request_mod)
        tel.reset_registry()
        mgr.register_serving_metrics(m, replica_id=3)
        outs[name] = (mgr.serving_metrics_samples(m, {"replica": "3"}),
                      tel.get_registry().exposition().splitlines(),
                      m.monitor_events(9), m.snapshot(), m.tokens_per_sec_per_chip(4),
                      {k: ts.snapshot() for k, ts in m.tenants.items()})
    assert outs["port"] == outs["jax"]
    samples, text, events, snap, _, tenants = outs["port"]
    assert sorted(tenants) == ["bronze", "gold"]
    # uids 1, 2, 4, 10, 11: tenanted, neither rejected, cancelled nor failed
    assert sum(t["completed"] for t in tenants.values()) == 5
    assert any('tenant="gold"' in line and line.startswith("dstpu_serving_completed_total")
               for line in text)
    assert snap["requeues"] == 3 and snap["canary_fails"] == 1
    m, _ = _metrics_history(tmetrics, trequest)
    if not torch.cuda.is_available():
        assert m.tokens_per_sec_per_chip() == m.tokens_per_sec()


def test_collective_recorder_rides_the_port_comm_layer(fake_time):
    from deepspeed_tpu_torch import comm

    recs = {}
    for name, (tel, *_ ) in PACKAGES.items():
        fake_time.reset()
        rec = tel.configure_collective_recorder(enabled=True, max_records=3)
        first = tel.record_launch("barrier", eager=True, detail="ckpt")
        assert rec.record("all_gather", shape=(2, 3), dtype="bfloat16", axes=("dp", "tp"),
                          impl="int8", link="ici") == first + 1
        # seq runs on from earlier records in this process: compare from the first
        recs[name] = [{**r, "seq": r["seq"] - first} for r in rec.snapshot()]
        tel.configure_collective_recorder(enabled=False)
        assert tel.record_launch("barrier") is None
    assert recs["port"] == recs["jax"]
    rec = ttel.configure_collective_recorder(enabled=True, max_records=3)
    rec.clear()
    base = rec.record("mark")
    comm.barrier("before-save")
    comm.log_compressed("quantized_all_reduce", 4096, 1040, axes="dp", impl="int8")
    comm.log_chunked("all_gather", 512, axes=("dp",))
    comm.all_reduce(torch.ones(4))
    got = [(r["op"], r.get("detail"), r.get("impl"), r.get("shape")) for r in rec.snapshot()]
    assert got == [("quantized_all_reduce", None, "int8", [4096]),
                   ("all_gather", None, "ring", [512]), ("all_reduce", None, None, [16])]
    assert rec.last_seq() == base + 4


def test_manager_serves_spans_and_scrape_samples(tmp_path):
    """A live ``TelemetryManager``: every ``LLMServer`` built meanwhile
    exports ``dstpu_serving_*{replica=...}`` until its loop ends, the engine
    loop's phases are spans, and closing the manager turns the spine off."""
    from tests.test_torch_model import tiny_pair
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import params_from_jax
    from deepspeed_tpu_torch.serving import LLMServer, Request

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = TelemetryConfig(enabled=True, max_spans=4096, flight_steps=4,
                              flight_dir=str(tmp_path), trace_dir=str(tmp_path / "trace"))
        assert not ttel.telemetry_active()
        tm = ttel.TelemetryManager(cfg, rank=0)
        assert ttel.telemetry_active() and ttel.get_tracer().enabled
        _, tcfg, params_np = tiny_pair("llama", hidden_size=128, num_heads=2)
        eng = InferenceEngineV2(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                                RaggedInferenceEngineConfig(
                                    token_budget=32, max_ragged_sequence_count=4,
                                    max_chunk_size=16, num_kv_blocks=64, kv_block_size=8,
                                    max_blocks_per_seq=16, dtype="float32"), device="cpu")
        srv = LLMServer(eng, replica_id=5, fused_decode_chunk=4)
        text = tm.registry.exposition()
        assert 'dstpu_serving_requests_total{replica="5"} 0' in text
        resp = srv.submit(Request(np.arange(1, 9, dtype=np.int32), max_new_tokens=12),
                          block=True)
        assert resp.wait(120)
        assert 'dstpu_serving_completed_total{replica="5"} 1' in tm.registry.exposition()
        assert srv.drain(timeout=120)
        assert 'replica="5"' not in tm.registry.exposition()
        names = {s["name"] for s in ttel.get_tracer().snapshot()}
        assert {"serve/ingress", "serve/admit", "serve/prefill", "serve/decode",
                "serve/deliver"} <= names
        tids = {s["tid"] for s in ttel.get_tracer().snapshot() if s["name"] == "serve/deliver"}
        assert tids == {srv._thread.ident}
        tm.on_step_end(1, step_time_s=0.01)
        assert tm.flight.steps()[0]["spans"] and tm.sample_memory() is None
        if not torch.cuda.is_available():
            assert tmanager.device_memory_sampler()() == []
        path = tm.flight_dump("crash", {"note": 1})
        assert json.load(open(path))["note"] == 1
        tm.close()
        assert not ttel.telemetry_active() and not ttel.get_tracer().enabled
        trace = json.load(open(tmp_path / "trace" / "spans-0.trace.json"))
        assert {e["name"] for e in trace["traceEvents"]} >= {"serve/deliver"}
        # off again: a server built now registers nothing
        LLMServer(eng, replica_id=6).close()
        assert 'replica="6"' not in ttel.get_registry().exposition()
    finally:
        torch.set_num_threads(threads)


def test_manager_config_defaults_match_jax():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(TelemetryConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JTelemetryConfig)])
