"""The port's comm planner against the JAX package's.

Plan IR signatures and JSON must be byte-for-byte equal; cost-model
estimates equal within a relative 1e-12 (the formulas are the same float
arithmetic); static decisions and compiled program beams equal. Both
packages price the same hand-built CPU fingerprints: one host, and one with
a DCN axis. The ``cpu`` and ``host`` entries of the cost tables are JAX's;
the ``ici`` and ``dcn`` link entries are the H100's NVLink and network
figures in the port (a deliberate difference, ROADMAP.md), so the DCN
fingerprint's comparisons set the JAX module's ``LINK_TABLE`` to the port's
entries first: what is held equal there is the arithmetic.

Port-only behaviour (named so, no JAX counterpart): the fingerprint of this
process, the DCN rule read from ranks, a ``gpu`` fingerprint picking the
paged kernel, and measure mode timing the decode probes on the CPU. Every
test resets the process-wide planner, probe memo and plan records of both
packages, and caches live under pytest's ``tmp_path``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu.comm as jdist
import deepspeed_tpu.comm.planner as jplan
import deepspeed_tpu.comm.planner.topo as jtopo
import deepspeed_tpu_torch.comm as tdist
import deepspeed_tpu_torch.comm.planner as tplan
import deepspeed_tpu_torch.comm.planner.topo as ttopo

EST_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for pkg, dist in ((jplan, jdist), (tplan, tdist)):
        pkg.reset_planner()
        pkg.reset_probe_memo()
        dist.get_comms_logger().plan_records.clear()
    yield
    for pkg, dist in ((jplan, jdist), (tplan, tdist)):
        pkg.reset_planner()
        pkg.reset_probe_memo()
        dist.get_comms_logger().plan_records.clear()
    torch.set_num_threads(threads)


def _fp(pkg, dcn=()):
    """A CPU fingerprint of 64 ranks over (dp_outer 8, ep 8); ``dcn`` marks
    cross-host axes."""
    return pkg.MeshFingerprint(platform="cpu", device_kind="cpu", n_devices=64,
                               n_processes=8,
                               axis_sizes=(("pp", 1), ("dp_outer", 8), ("ep", 8),
                                           ("sp", 1), ("tp", 1)),
                               dcn_axes=tuple(dcn))


FINGERPRINTS = {"one_host": (), "dcn": ("dp_outer",)}


@pytest.fixture
def same_links(monkeypatch):
    """Give the JAX cost model the port's ``ici`` / ``dcn`` link figures."""
    def apply():
        for name in ("ici", "dcn"):
            p = ttopo.LINK_TABLE[name]
            monkeypatch.setitem(jtopo.LINK_TABLE, name,
                                jtopo.LinkParams(alpha=p.alpha, beta=p.beta))
    return apply


def _site_specs():
    """(op, shape, dtype, axes, consumer, axis_size) of every estimable kind."""
    big, small = 1 << 22, 512
    out = []
    for n in (big, small):
        out += [("all_reduce", (n,), "float32", ("dp_outer", "ep"), "dp-grad", None),
                ("all_reduce", (n,), "float32", ("dp_outer", "ep"), "ulysses", None),
                ("all_reduce", (n,), "bfloat16", ("ep",), "dp-grad", None),
                ("all_gather", (n // 8,), "float32", ("dp_outer", "ep"), "zeropp", None),
                ("all_gather", (n // 8,), "bfloat16", ("dp",), "zeropp", 4),
                ("reduce_scatter", (n,), "float32", ("dp_outer", "ep"), "zeropp", None),
                ("reduce_scatter", (n,), "float32", ("dp_outer",), "tp-linear", None),
                ("all_to_all", (8, n // 64), "float32", ("ep",), "moe-a2a", None),
                ("all_to_all", (8, n // 64), "float32", ("dp_outer", "ep"), "ulysses",
                 None),
                ("gather_matmul", (64, n // 64), "bfloat16", ("ep",), "tp-linear", None),
                ("embed_gather", (n // 128, 128), "float32", ("ep",), "embed", None)]
    for dtype in ("float32", "bfloat16", "int8"):
        out.append(("decode_attn", (16, 2048, 32, 128), dtype, (), "decode", None))
    return out


def _sites(pkg, dtype_of=str):
    return [pkg.make_site(op=op, shape=shape, dtype=dtype_of(dtype), axes=axes,
                          consumer=consumer, axis_size=axis_size)
            for op, shape, dtype, axes, consumer, axis_size in _site_specs()]


def _torch_dtype(name):
    return getattr(torch, name)


def test_site_signatures_and_plan_json_are_jax_s():
    jsites, tsites = _sites(jplan), _sites(tplan, _torch_dtype)
    assert [s.signature() for s in tsites] == [s.signature() for s in jsites]
    assert [s.nbytes for s in tsites] == [s.nbytes for s in jsites]
    decisions = [
        dict(impl="int8", block=512, source="measured", est_us=12.5),
        dict(impl="pallas", source="cost-model", est_us=3.25),
        dict(impl="xla", source="default"),
        dict(impl="program", block=2048, source="cost-model", est_us=7.0)]

    def plan(pkg):
        p = pkg.Plan(fingerprint="abc123")
        prog = (pkg.make_phase("reduce_scatter", ("ep",), link="ici"),
                pkg.make_phase("all_reduce", ("dp_outer",), wire_dtype="int8_ef",
                               block=2048, link="dcn", chunks=1),
                pkg.make_phase("all_gather", ("ep",), via="fused_matmul", link="ici",
                               compute=pkg.FusedCompute(role="consumer",
                                                        site="dp-grad/apply")))
        for site, d in zip(_sites(pkg), decisions * 8):
            kw = dict(d, program=prog) if d["impl"] == "program" else d
            p.set(site, pkg.PlanDecision(**kw))
        return p

    jp, tp = plan(jplan), plan(tplan)
    assert tp.to_json() == jp.to_json()
    assert tplan.Plan.from_json(jp.to_json()) == tp
    assert jplan.Plan.from_json(tp.to_json()) == jp
    for pkg in (jplan, tplan):
        with pytest.raises(ValueError, match="unknown PlanDecision fields"):
            pkg.PlanDecision.from_dict({"impl": "xla", "colour": "red"})
        with pytest.raises(ValueError, match="newer than this build"):
            pkg.Plan.from_dict({"format": pkg.PLAN_FORMAT + 1})
    for name in ("IMPLEMENTATIONS", "OP_MENU", "CONSUMERS", "PHASE_OPS", "PHASE_VIAS",
                 "WIRE_DTYPES", "LINK_CLASSES", "FUSED_PHASE_OPS", "FUSED_ROLES",
                 "PLAN_FORMAT", "SEARCH_SPACE", "DEFAULT_BEAM_WIDTH", "PROGRAM_CAPABLE",
                 "MODES"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    assert sorted(tplan.__all__) == sorted(jplan.__all__)


@pytest.mark.parametrize("fp_name", sorted(FINGERPRINTS))
def test_cost_model_estimates_and_decisions_are_jax_s(fp_name, same_links):
    dcn = FINGERPRINTS[fp_name]
    if dcn:
        same_links()
    jcm, tcm = jplan.CostModel(_fp(jplan, dcn)), tplan.CostModel(_fp(tplan, dcn))
    assert tcm.fp.digest() == jcm.fp.digest()
    n = 0
    for js, ts in zip(_sites(jplan), _sites(tplan)):
        assert tcm.candidates(ts) == jcm.candidates(js)
        for impl in jplan.OP_MENU[js.op]:
            want, got = jcm.estimate(js, impl), tcm.estimate(ts, impl)
            if np.isfinite(want):
                assert got == pytest.approx(want, rel=EST_RTOL, abs=0.0), (ts, impl)
                n += 1
            else:
                assert got == want, (ts, impl)
        assert tcm.decide(ts).to_dict() == jcm.decide(js).to_dict()
        assert [i for i, _ in tcm.prune(ts)] == [i for i, _ in jcm.prune(js)]
    assert n > 60


@pytest.mark.parametrize("fp_name", sorted(FINGERPRINTS))
def test_static_planner_decisions_are_jax_s(fp_name, same_links):
    """The static planner's argmin over single impls and compiled programs,
    on the same fingerprint in both packages (the planners' own captured
    fingerprints replaced)."""
    dcn = FINGERPRINTS[fp_name]
    if dcn:
        same_links()
    got = {}
    for pkg in (jplan, tplan):
        pl = pkg.CollectivePlanner("static", use_cache=False)
        pl.fingerprint = _fp(pkg, dcn)
        pl.cost = pkg.CostModel(pl.fingerprint, block=pl.block)
        pl.plan = pkg.Plan(fingerprint=pl.fingerprint.digest())
        got[pkg] = [pl.resolve(s).to_dict() for s in _sites(pkg)]
    assert got[tplan] == got[jplan]
    if dcn:   # the DCN mesh makes the dp-grad reduction a hierarchical program
        assert got[tplan][0]["impl"] == "program"
    # both ledgers hold the same plan table
    jrec = jdist.get_comms_logger().plan_records
    trec = tdist.get_comms_logger().plan_records
    assert trec == jrec
    assert (tdist.get_comms_logger().plan_table_lines()
            == jdist.get_comms_logger().plan_table_lines())


def _compiler_sites(pkg):
    """The sites JAX's planner tests synthesize programs for
    (``tests/unit/test_comm_planner.py``, the multi-phase section), and
    gather / scatter / exchange twins."""
    mk = pkg.make_site
    return [mk(op="all_reduce", shape=(1 << 22,), dtype="float32",
               axes=("dp_outer", "ep"), consumer="dp-grad"),
            mk(op="all_reduce", shape=(1 << 20,), dtype="float32",
               axes=("dp_outer", "ep"), consumer="ulysses"),
            mk(op="all_reduce", shape=(1 << 20,), dtype="float32", axes=("ep",),
               consumer="dp-grad"),
            mk(op="all_gather", shape=(1 << 18,), dtype="float32",
               axes=("dp_outer", "ep"), consumer="zeropp"),
            mk(op="reduce_scatter", shape=(1 << 21,), dtype="float32",
               axes=("dp_outer", "ep"), consumer="zeropp"),
            mk(op="all_to_all", shape=(64, 4096), dtype="float32",
               axes=("dp_outer", "ep"), consumer="moe-a2a"),
            mk(op="all_gather", shape=(4096,), dtype="float32", axes=("dp_outer",),
               consumer="zeropp", axis_size=8)]


@pytest.mark.parametrize("fp_name", sorted(FINGERPRINTS))
def test_compiled_programs_are_jax_s(fp_name, same_links):
    dcn = FINGERPRINTS[fp_name]
    if dcn:
        same_links()
    jcm, tcm = jplan.CostModel(_fp(jplan, dcn)), tplan.CostModel(_fp(tplan, dcn))
    beams = 0
    for js, ts in zip(_compiler_sites(jplan), _compiler_sites(tplan)):
        want = jplan.compile_programs(js, jcm)
        got = tplan.compile_programs(ts, tcm)
        assert ([tplan.program_summary(p) for p, _ in got]
                == [jplan.program_summary(p) for p, _ in want]), ts
        assert ([[s.to_dict() for s in p] for p, _ in got]
                == [[s.to_dict() for s in p] for p, _ in want])
        for (_, e_got), (_, e_want) in zip(got, want):
            assert e_got == pytest.approx(e_want, rel=EST_RTOL, abs=0.0)
        assert ([[s.to_dict() for s in p] for p in tplan.synthesize_programs(ts, tcm)]
                == [[s.to_dict() for s in p] for p in jplan.synthesize_programs(js, jcm)])
        beams += len(got)
    assert (beams > 0) == bool(dcn)


def test_plan_cache_round_trip_and_foreign_fingerprint(tmp_path):
    site = tplan.make_site(op="decode_attn", shape=(4, 64, 2, 16), dtype=torch.float32,
                           axes=(), consumer="decode")
    a = tplan.CollectivePlanner("static", cache_dir=str(tmp_path))
    da = a.resolve(site)
    assert (da.impl, da.source) == ("einsum", "cost-model")
    body = json.loads(open(a.cache.path_for(a.fingerprint)).read())
    assert body["fingerprint"] == a.fingerprint.digest()
    assert body["search_space"] == tplan.SEARCH_SPACE
    b = tplan.CollectivePlanner("static", cache_dir=str(tmp_path))
    db = b.resolve(site)
    assert db.source == "cache" and db.impl == da.impl and db.est_us == da.est_us
    # a plan stored for another fingerprint is never applied here
    foreign = dataclasses.replace(a.fingerprint, device_kind="another card")
    cache = tplan.PlanCache(str(tmp_path), space_version=tplan.SEARCH_SPACE)
    other = tplan.Plan(fingerprint=foreign.digest())
    other.set(site, tplan.PlanDecision(impl="pallas", source="measured", est_us=1.0))
    cache.store(foreign, other)
    assert cache.load(foreign).get(site).impl == "pallas"
    assert cache.load(a.fingerprint).get(site).impl == "einsum"
    # a foreign file copied over this fingerprint's path reads as a miss
    with open(cache.path_for(foreign)) as f:
        text = f.read()
    with open(cache.path_for(a.fingerprint), "w") as f:
        f.write(text)
    assert cache.load(a.fingerprint) is None
    c = tplan.CollectivePlanner("static", cache_dir=str(tmp_path))
    assert c.resolve(site).source == "cost-model"


def test_default_cache_dir_is_the_port_s_own(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.comm.planner.cache import default_cache_dir

    monkeypatch.delenv("DSTPU_PLAN_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert default_cache_dir() == str(tmp_path / ".cache" / "deepspeed_tpu_torch"
                                      / "comm_plans")
    monkeypatch.setenv("DSTPU_PLAN_CACHE", str(tmp_path / "plans"))
    assert default_cache_dir() == str(tmp_path / "plans")


def _on_the_card(pl):
    """``pl`` priced as on an H100 (the cost model's ``gpu`` platform)."""
    pl.fingerprint = dataclasses.replace(pl.fingerprint, platform="gpu",
                                         device_kind="NVIDIA H100 80GB HBM3")
    pl.cost = tplan.CostModel(pl.fingerprint, block=pl.block)
    pl.plan = tplan.Plan(fingerprint=pl.fingerprint.digest())
    return pl


def test_measure_mode_times_both_decode_probes_then_hits_the_memo():
    """Port-only (no JAX counterpart): on a ``gpu`` fingerprint both decode
    implementations survive a wide pruning margin, so measure mode builds
    and times two probes (here the plain versions on the CPU); a second
    planner resolving the same site reads both from the process memo."""
    site = tplan.make_site(op="decode_attn", shape=(4, 64, 2, 16), dtype=torch.float32,
                           axes=(), consumer="decode")

    def planner():
        return _on_the_card(tplan.CollectivePlanner("measure", use_cache=False, margin=8.0))

    d = planner().resolve(site)
    assert d.source == "measured" and d.impl in ("einsum", "pallas")
    assert tplan.probe_stats() == {"calls": 2, "built": 2, "hits": 0}
    d2 = planner().resolve(site)
    assert tplan.probe_stats() == {"calls": 4, "built": 2, "hits": 2}
    assert d2 == d
    # the default margin prunes the einsum there (the model prices it 4x the
    # kernel), so the cost model decides without a probe
    tplan.reset_probe_memo()
    pl = planner()
    pl.margin = 3.0
    assert pl.resolve(site).source == "cost-model"
    assert tplan.probe_stats()["built"] == 0


@pytest.fixture
def failing_kernel_probe(monkeypatch):
    """The kernel's decode probe raises at launch; the einsum's runs on the
    CPU. ``on(device)`` makes the probes' device that one."""
    from deepspeed_tpu_torch.comm.planner import microbench

    real = microbench._decode_attn_probe

    def probe(site, impl, **kw):
        if impl != "pallas":
            return real(site, impl, device="cpu", **kw)

        def launch(q):
            raise RuntimeError("paged_flash_decode: kernel launch failed")
        return launch, torch.zeros(1)
    monkeypatch.setattr(microbench, "_decode_attn_probe", probe)
    return lambda device: monkeypatch.setattr(microbench, "probe_device",
                                              lambda: torch.device(device))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_failing_kernel_probe_raises_on_the_card_and_loses_on_the_cpu(
        failing_kernel_probe, device):
    """Port-only (no JAX counterpart): on the card a kernel probe that fails
    is a fault the planner raises (``ProbeError``), never a candidate that
    loses to the einsum; on the CPU it loses, as in JAX."""
    from deepspeed_tpu_torch.comm.planner.microbench import ProbeError

    failing_kernel_probe(device)
    site = tplan.make_site(op="decode_attn", shape=(4, 64, 2, 16), dtype=torch.float32,
                           axes=(), consumer="decode")
    pl = _on_the_card(tplan.CollectivePlanner("measure", use_cache=False, margin=8.0))
    if device == "cuda":
        with pytest.raises(ProbeError, match="kernel launch failed"):
            pl.resolve(site)
        assert site.signature() not in pl.plan.decisions
    else:
        d = pl.resolve(site)
        assert (d.impl, d.source) == ("einsum", "measured")


def test_an_engine_on_the_card_raises_when_the_kernel_probe_fails(failing_kernel_probe):
    """Port-only (no JAX counterpart): the engine passes over a planner that
    fails, but not a kernel probe that failed on the card."""
    from deepspeed_tpu_torch.comm.planner.microbench import ProbeError
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    failing_kernel_probe("cuda")
    _on_the_card(tplan.configure_planner("measure", use_cache=False, margin=8.0))
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, intermediate_size=96,
                            num_layers=1, num_heads=4, dtype=torch.float32)
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ProbeError, match="kernel launch failed"):
        InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(**ENGINE), device="cpu")


def test_decode_probe_runs_both_forms_and_collective_probes_name_item_8():
    from deepspeed_tpu_torch.comm.planner.microbench import build_probe

    for dtype in ("float32", "int8"):
        site = tplan.make_site(op="decode_attn", shape=(2, 40, 2, 16), dtype=dtype,
                               axes=(), consumer="decode")
        outs = []
        for impl in ("einsum", "pallas"):
            fn, q = build_probe(site, impl, reps=2)
            assert q.shape == (2, 2, 16) and q.device.type == "cpu"
            outs.append(float(fn(q)))
        assert np.isfinite(outs).all()
        assert outs[0] == pytest.approx(outs[1], rel=1e-4, abs=1e-5)
    site = tplan.make_site(op="all_reduce", shape=(1024,), dtype="float32",
                           axes=("dp_outer",), consumer="dp-grad")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        build_probe(site, "xla")


def test_capture_on_the_cpu_is_one_host_and_stable():
    fp = tplan.MeshFingerprint.capture()
    assert (fp.platform, fp.device_kind, fp.n_devices, fp.n_processes) == ("cpu", "cpu",
                                                                         1, 1)
    assert fp.dcn_axes == ()
    assert dict(fp.axis_sizes) == {"pp": 1, "dp_outer": 1, "ep": 1, "sp": 1, "tp": 1}
    assert tplan.MeshFingerprint.capture() == fp
    assert tplan.MeshFingerprint.capture().digest() == fp.digest()


@pytest.mark.parametrize("per_host, dcn", [(None, ()), ("4", ()), ("2", ("dp_outer",))])
def test_dcn_axes_are_read_from_ranks(monkeypatch, per_host, dcn):
    """Port-only (no JAX counterpart, which reads process indices off its
    devices): four ranks on the dp axis are DCN once a host holds fewer."""
    class FourRanks:
        @staticmethod
        def axis_size(name):
            return 4 if name == "dp_outer" else 1

    monkeypatch.setattr(tdist, "get_world_size", lambda axis=None: 4)
    if per_host is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", per_host)
    fp = tplan.MeshFingerprint.capture(topology=FourRanks())
    assert fp.dcn_axes == dcn
    assert (fp.n_devices, fp.n_processes) == (4, 4)


def test_gpu_fingerprint_resolves_decode_attn_to_the_kernel():
    """Port-only (no JAX counterpart): on the card's platform the cost model
    prices the paged kernel's single pass under the einsum's gathered copy,
    for bf16, fp32 and int8 pools; on the CPU the kernel's plain version
    never wins."""
    gpu = dataclasses.replace(tplan.MeshFingerprint.capture(), platform="gpu",
                              device_kind="NVIDIA H100 80GB HBM3")
    cm, cpu = tplan.CostModel(gpu), tplan.CostModel(tplan.MeshFingerprint.capture())
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        site = tplan.make_site(op="decode_attn", shape=(16, 2048, 32, 128), dtype=dtype,
                               axes=(), consumer="decode")
        assert cm.decide(site).impl == "pallas"
        assert np.isfinite(cm.estimate(site, "pallas"))
        assert cpu.decide(site).impl == "einsum"
        assert cpu.estimate(site, "pallas") == float("inf")
    assert set(ttopo.HBM_BW) == set(ttopo.QUANT_COST_PER_BYTE) == {"gpu", "cpu"}
    assert ttopo.HBM_BW["cpu"] == jtopo.HBM_BW["cpu"]
    assert ttopo.QUANT_COST_PER_BYTE["cpu"] == jtopo.QUANT_COST_PER_BYTE["cpu"]
    assert dataclasses.astuple(ttopo.LINK_TABLE["host"]) == dataclasses.astuple(
        jtopo.LINK_TABLE["host"])


def test_comms_log_summary_prints_the_plan_table(capsys):
    site = tplan.make_site(op="decode_attn", shape=(4, 64, 2, 16), dtype="float32",
                           axes=(), consumer="decode")
    tplan.configure_planner("static", use_cache=False)
    assert tplan.planner_active()
    assert tplan.resolve_site(op="decode_attn", shape=(4, 64, 2, 16), dtype="float32",
                              axes=(), consumer="decode").impl == "einsum"
    ledger = tdist.get_comms_logger()
    assert ledger.plan_records[site.signature()]["source"] == "cost-model"
    ledger.reset()
    assert site.signature() in ledger.plan_records     # plan facts survive reset
    ledger.log_summary()
    out = capsys.readouterr().out
    assert "Collective plan:" in out and "decode_attn" in out and "einsum" in out


ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=8, max_blocks_per_seq=16,
              dtype="float32")


def _engine_pair(**over):
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
    from deepspeed_tpu.models.transformer import TransformerLM as JLM
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
    from deepspeed_tpu_torch.models import params_from_jax
    from tests.test_torch_model import tiny_pair

    jcfg, tcfg, params_np = tiny_pair("llama", **over)
    return (JEngine(JLM(jcfg), params_np, JEC(**ENGINE)),
            TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"), TEC(**ENGINE),
                    device="cpu"))


def test_engines_resolve_decode_attn_through_the_static_planner_as_jax():
    """Under a static planner both ragged engines ask it for the fused decode
    path: on the CPU the kernel prices to infinity, so both take the einsum
    with source ``planner``, record one plan row, and generate equal tokens."""
    jplan.configure_planner("static", use_cache=False)
    tplan.configure_planner("static", use_cache=False)
    jeng, teng = _engine_pair()
    for eng in (jeng, teng):
        assert (eng.decode_attn_impl, eng.decode_attn_source) == ("einsum", "planner")
    site = teng._decode_attn_site(torch.float32)
    assert site.signature() == jeng._decode_attn_site(np.float32).signature()
    jrow = jdist.get_comms_logger().plan_records[site.signature()]
    trow = tdist.get_comms_logger().plan_records[site.signature()]
    assert trow == jrow
    assert (trow["impl"], trow["source"], trow["mode"]) == ("einsum", "cost-model",
                                                             "static")
    prompts = [np.random.default_rng(3).integers(0, 97, n).astype(np.int32)
               for n in (5, 13)]
    want = jeng.generate(prompts, max_new_tokens=6)
    got = teng.generate(prompts, max_new_tokens=6)
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]


def test_engine_records_its_decode_plan_without_a_planner_as_jax():
    jeng, teng = _engine_pair(hidden_size=256)      # D 64: the kernels build it
    site = teng._decode_attn_site(torch.float32)
    trow = tdist.get_comms_logger().plan_records[site.signature()]
    jrow = jdist.get_comms_logger().plan_records[site.signature()]
    assert (trow["source"], trow["mode"]) == (jrow["source"], jrow["mode"]) == (
        "heuristic", "engine")
    # the port's heuristic is the kernel path (its plain version on the
    # CPU), JAX's off-TPU heuristic the einsum
    assert (trow["impl"], jrow["impl"]) == ("pallas", "einsum")


@pytest.mark.parametrize("hidden, heads, impl, source", [
    (256, 4, "pallas", "planner"),        # D 64: a head dim the kernels build
    (64, 4, "einsum", "fallback")])       # D 16: demoted with a one-time warning
def test_planner_kernel_pick_at_an_unbuilt_head_dim_demotes(hidden, heads, impl, source):
    """Port-only (no JAX counterpart): a planner on the card's platform picks
    the paged kernel; the port's head-dim bail demotes that pick where the
    kernels are not built, as it demotes the heuristic's."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    _on_the_card(tplan.configure_planner("static", use_cache=False))
    cfg = TransformerConfig(vocab_size=97, hidden_size=hidden, intermediate_size=96,
                            num_layers=1, num_heads=heads, dtype=torch.float32)
    eng = InferenceEngineV2(cfg, init_params(cfg, device="cpu", dtype=torch.float32),
                            RaggedInferenceEngineConfig(**ENGINE), device="cpu")
    assert (eng.decode_attn_impl, eng.decode_attn_source) == (impl, source)
    row = tdist.get_comms_logger().plan_records[
        eng._decode_attn_site(torch.float32).signature()]
    # the planner's row, or the engine's over it where the pick was demoted
    assert (row["impl"], row["source"]) == (
        impl, "cost-model" if source == "planner" else source)
