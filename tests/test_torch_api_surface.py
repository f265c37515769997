"""The port's public names and signatures against the JAX package's.

For every name that the landed slices were missing (ROADMAP.md Queue C item
2), and for the ``runtime.zero`` package and the ``utils.tensor_fragment``
accessors, the port has it, and its parameters carry the JAX counterpart's names in
the JAX order (``inspect.signature``; defaults may differ where the port's
types do). A JAX ``mixtral_config`` constructs the port's
``TransformerConfig``, trains a step and serves; ALiBi and windowed models
serve the JAX engine's stream and refuse the paged kernels' backend; an
expert-parallel ``moe`` section is refused with ``NotImplementedError``
naming the ROADMAP.md Queue A item. The kernel
wrappers accept the Pallas ``interpret`` switch and ignore it; the block
kwargs refuse the sizes the JAX functions refuse, and every size they accept
gives the same result (on the CPU, the plain versions).
"""

import dataclasses
import functools
import importlib
import inspect

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtransformer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM, init_params

# module -> names that Queue C item 2 lists for it
SURFACE = {
    "comm.comm": ["reduce", "gather", "scatter", "all_reduce_coalesced",
                  "all_gather_coalesced", "group_all_reduce", "monitored_barrier",
                  "inference_all_reduce", "mpi_discovery", "initialize_mesh_device",
                  "MeshGroup", "log_chunked", "init_distributed",
                  # tensor parallelism (ROADMAP.md Queue A item 8)
                  "ppermute", "send_next_recv_prev", "send_prev_recv_next"],
    "comm.compressed": ["feedback_state", "store_feedback", "clear_feedback"],
    "checkpoint.engine": ["CheckpointEngine"],
    "utils.fs": ["fsync_dir"],
    "utils.groups": ["initialize", "_get_model_parallel_group",
                     "_get_model_parallel_world_size"],
    "runtime.engine": ["initialize"],
    "accelerator": ["set_accelerator", "set_accelerator_by_name"],
    "runtime.config": ["AUTO"],
    "runtime.zero": ["Init", "ZeroShardingRules", "shard_param_spec",
                     "estimate_zero_model_states_mem_needs",
                     "estimate_zero2_model_states_mem_needs_all_live",
                     "estimate_zero3_model_states_mem_needs_all_live", "tiled_matmul",
                     "ZeroPPState", "hierarchical_all_gather", "hpz_remat_policy",
                     "zeropp_train_step_factory"],
    "utils.tensor_fragment": ["safe_get_full_fp32_param", "safe_set_full_fp32_param",
                              "safe_get_full_grad", "safe_set_full_grad",
                              "safe_get_full_optimizer_state",
                              "safe_set_full_optimizer_state", "safe_get_local_fp32_param",
                              "safe_get_local_grad", "safe_get_local_optimizer_state",
                              "safe_set_local_fp32_param", "safe_set_local_grad",
                              "safe_set_local_optimizer_state"],
    "": ["add_config_arguments", "version"],
    # ZeRO-Offload's host libraries (DeepSpeedCPUAdam.step takes one more
    # keyword, out=, and the swapper's swap_in a device for shardings:
    # tests/test_torch_offload.py and test_torch_aio.py hold them)
    "ops.adam": ["CPUAdamBuilder"],
    "ops.aio": ["AsyncIOBuilder", "AsyncIOHandle"],
    # the optimizer library, the error-feedback compression and the
    # device-prefetch loader (ROADMAP.md Queue A items 7.5-7.6)
    "ops.optimizers": ["fused_adam", "fused_lamb", "fused_lion", "adagrad", "sgd",
                       "mu_optimizer", "build_optimizer", "ScaleByAdamState",
                       "ScaleByLionState", "ScaleByAdagradState"],
    "compression.onebit": ["ErrorFeedbackState", "init_error_feedback", "onebit_compress",
                           "compressed_allreduce", "server_error_shape"],
    "runtime.dataloader": ["PrefetchLoader", "RepeatingLoader"],
    # mixture of experts (ROADMAP.md Queue A item 7.7)
    "moe.sharded_moe": ["compute_capacity", "load_balance_aux", "topk_gating",
                        "moe_dispatch", "expert_ffn", "moe_combine", "dropless_moe",
                        "quantized_ep_ready", "quantized_ep_moe"],
    "models.transformer": ["mixtral_config"],
    # the HF loader, ALiBi / windowed serving and speculative decoding
    # (ROADMAP.md Queue A items 1, 3 and 8's inference/hf.py)
    "inference.hf": ["config_from_hf", "params_from_hf"],
    "inference.v2.model": ["paged_attention", "verify_step",
                           # TP decode (ROADMAP.md Queue A item 4)
                           "resolve_decode_tp_impl", "tp_decode_matmul",
                           "tp_decode_out_proj", "tp_decode_logits", "tp_greedy_token"],
    "inference.v2.engine_v2": ["RaggedInferenceEngineConfig", "ReuseStats",
                               "InferenceEngineV2.spec_decode_batch",
                               "InferenceEngineV2._ngram_propose"],
    "serving.metrics": ["ServingMetrics.spec_acceptance_rate",
                        "ServingMetrics.sample_reuse"],
    "serving.server": ["LLMServer._spec_decode_ready"],
    # checkpoint interchange (ROADMAP.md Queue A item 7.8)
    "checkpoint.state_dict_factory": ["SDLoaderFactory", "SDLoader", "merge_state_dicts",
                                      "split_state_dict", "merge_qkv", "split_qkv",
                                      "megatron_specs", "save_shard_npz"],
    "inference.megatron": ["load_megatron_checkpoint", "megatron_config", "megatron_params",
                           "params_to_megatron"],
    "module_inject.auto_tp": ["flatten_with_paths", "tp_parser", "infer_tp_roles",
                              "sharded_dim", "shard_checkpoint_leaf", "AutoTPResult"],
    # the serving fleet (ROADMAP.md Queue A items 5 and 6): retry, chaos,
    # heartbeats, telemetry, tenancy, the control plane, the router, traffic
    "utils.retry": ["RetryPolicy", "retry_call", "RetryError", "retry_log_snapshot",
                    "clear_retry_log", "add_retry_monitor", "remove_retry_monitor"],
    "runtime.resilience.faults": ["FaultPlan"],
    "runtime.resilience.chaos": ["FAULT_CLASSES", "ChaosEvent", "ChaosSchedule",
                                 "configure_chaos",
                                 "install_chaos_from_config", "clear_config_chaos",
                                 "get_chaos", "chaos_active"],
    "runtime.resilience.heartbeat": ["FileHeartbeatTransport", "ObjectStoreHeartbeatTransport",
                                     "_LocalBucketStub", "HeartbeatWriter", "HealthTable",
                                     "HostHealth"],
    "runtime.resilience": ["FaultPlan", "ChaosSchedule", "HeartbeatWriter", "HealthTable",
                           "configure_chaos", "get_chaos", "chaos_active"],
    "telemetry.spans": ["SpanTracer", "span", "get_tracer", "configure_tracer",
                        "chrome_trace", "export_chrome"],
    "telemetry.registry": ["Counter", "Gauge", "Histogram", "MetricsRegistry",
                           "MetricsServer", "get_registry", "reset_registry"],
    "telemetry.flight": ["FlightRecorder", "flightdump_path"],
    "telemetry.collective": ["CollectiveRecorder", "configure_collective_recorder",
                             "get_collective_recorder", "record_launch"],
    "telemetry.manager": ["TelemetryManager", "register_serving_metrics",
                          "telemetry_active", "device_memory_sampler",
                          "serving_metrics_samples", "comms_ledger_samples"],
    "telemetry": ["TelemetryManager", "register_serving_metrics", "telemetry_active"],
    "fleet.tenancy": ["SLAClass", "TenancyMap"],
    "fleet": ["SLAClass", "TenancyMap", "ReplicaHandle", "WarmReport", "FleetManager",
              "SubprocessReplica", "SPAWNING", "WARMING", "JOINED",
              "DRAINING", "DEAD", "STATES", "serving_space_signature"],
    # the fleet's warm join (ROADMAP.md Queue A items 6 and 9): the replica
    # lifecycle, the scale actuator, subprocess replicas, the winner cache
    # and the comm planner
    "fleet.lifecycle": ["ReplicaHandle", "WarmReport", "serving_space_signature", "SERVING_SPACE_DIMS",
                        "SERVING_SPACE_METRIC"],
    "fleet.manager": ["FleetManager"],
    "fleet.subproc": ["SubprocessReplica", "worker_main"],
    "control.winners": ["WinnerCache", "space_signature"],
    "comm.planner": ["CollectiveSite", "Plan", "PlanDecision", "PhaseStep", "FusedCompute",
                     "make_site", "make_phase", "program_summary", "synthesize_programs",
                     "compile_programs", "legacy_menu_programs", "program_capable",
                     "MeshFingerprint", "CostModel", "LinkParams", "PlanCache",
                     "default_cache_dir", "benchmark_site", "probe_stats",
                     "reset_probe_memo", "CollectivePlanner", "configure_planner",
                     "configure_from_config", "get_planner", "planner_active",
                     "reset_planner", "resolve_site", "IMPLEMENTATIONS", "OP_MENU",
                     "CONSUMERS", "MODES"],
    "comm.planner.planner": ["CollectivePlanner.replan_around",
                             "CollectivePlanner.calibrate_overlap_credit"],
    "comm.planner.microbench": ["build_probe"],
    "utils.comms_logging": ["CommsLogger.record_plan", "CommsLogger.plan_table_lines"],
    "control.ledger": ["ControlAction", "ControlLedger", "describe_action"],
    "control.guard": ["FlapGuard"],
    "control.policy": ["POLICY_TABLE", "RULE_NAMES", "rule_straggler", "rule_memory",
                       "rule_rollbacks", "rule_integrity", "rule_sla"],
    "control.supervisor": ["ControlSupervisor"],
    "control": ["ControlSupervisor", "FlapGuard", "ControlLedger", "WinnerCache",
                "space_signature"],
    "serving.request": ["Request", "ServedResponse"],
    "serving.metrics": ["TenantStats", "ServingMetrics"],
    "serving.scheduler": ["ContinuousBatchScheduler"],
    "serving.replica": ["ReplicaRouter"],
    "serving.traffic": ["LengthDist", "TrafficConfig", "OpenLoopTraffic"],
    "serving": ["TenantStats", "ReplicaRouter", "LengthDist", "OpenLoopTraffic",
                "TrafficConfig", "LLMServer"],
    # tensor parallelism (ROADMAP.md Queue A items 8 and 4): the tp axis, the
    # rings, the rules layer, the vocab-parallel loss and TP decode
    "ops.collective_matmul": ["all_gather_matmul", "matmul_reduce_scatter",
                              "fused_qkv_all_gather_matmul", "ring_all_gather",
                              "ring_reduce_scatter", "fused_ring_all_gather",
                              "fused_ring_reduce_scatter", "ring_embedding_gather",
                              "ring_tied_lm_head", "embedding_overlap_ready",
                              "overlap_ready", "overlap_enabled", "set_overlap_enabled"],
    "sharding.rules": ["Rule", "RuleSet", "spec_tree_axis_sizes", "RULES_FORMAT"],
    "sharding.packs": ["generic_pack", "llama_pack", "mistral_pack", "gpt2_pack",
                       "gpt_neox_pack", "mixtral_pack", "get_pack", "pack_for_config"],
    "sharding.sites": ["replicated", "seq_sharded_act", "heads_sharded_act", "ulysses_act",
                       "col_kernel3", "col_bias2", "row_kernel3", "col_kernel2",
                       "row_kernel2", "col_bias1", "vocab_sharded_table", "tokens_act",
                       "embed_act", "kv_cache_entry", "moe_batch_act",
                       "moe_expert_major_act", "moe_expert_weight", "zero_flat_shard",
                       "batch_layout"],
    "sharding.derive": ["derive_rules", "derived_matches_parser"],
    "sharding.autotp": ["resolve_rules", "shard_checkpoint_tree",
                        "register_param_collectives", "autotp_initialize"],
    "sharding.audit_entry": ["toy_hf_checkpoint", "family_engine", "family_audit_report",
                             "llama", "mistral", "gpt_neox", "mixtral", "FAMILIES"],
    "sequence.cross_entropy": ["vocab_parallel_cross_entropy",
                               "vocab_sequence_parallel_cross_entropy", "sharded_lm_loss"],
    "runtime.activation_checkpointing": ["model_parallel_reconfigure_tp_seed"],
}
# kernel wrappers: port module -> (JAX module, names)
WRAPPERS = {
    "ops.flash_attention": ("ops.pallas.flash_attention", ["flash_attention"]),
    "ops.fused_loss": ("ops.pallas.fused_loss", ["fused_vocab_nll"]),
    "ops.paged_attention": ("ops.pallas.paged_attention",
                            ["paged_attention", "paged_flash_decode"]),
    "ops.quant": ("ops.pallas.quant", ["quantize_int8", "dequantize_int8"]),
    "ops.fused_adam": ("ops.pallas.fused_adam", ["adam_update"]),
    "ops.sparse_attention": ("ops.pallas.sparse_attention", ["sparse_attention"]),
}


def _module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}" if name else pkg)


def _params(obj):
    """Parameter names; a keyword-only ``device`` (the port's entry points
    place their results on the card unless told otherwise) is left out."""
    return [n for n, p in inspect.signature(obj).parameters.items()
            if not (n == "device" and p.kind is inspect.Parameter.KEYWORD_ONLY)]


def _cases():
    for mod, names in SURFACE.items():
        for name in names:
            yield mod, mod, name
    for mod, (jmod, names) in WRAPPERS.items():
        for name in names:
            yield mod, jmod, name


@pytest.mark.parametrize("mod, jmod, name", list(_cases()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_name_exists_with_the_jax_signature(mod, jmod, name):
    # a dotted name is a class's method
    port = functools.reduce(getattr, name.split("."), _module("deepspeed_tpu_torch", mod))
    ref = functools.reduce(getattr, name.split("."), _module("deepspeed_tpu", jmod))
    if inspect.ismodule(ref):                       # the top level's ``version``
        assert inspect.ismodule(port) and port.__version__
    elif callable(ref):
        assert _params(port) == _params(ref), (mod, name)
        if inspect.isclass(ref):                    # the methods too
            for meth, fn in vars(ref).items():
                if inspect.isfunction(fn) and not meth.startswith("_"):
                    assert _params(getattr(port, meth)) == _params(fn), (name, meth)
    else:
        assert port == ref


def test_checkpoint_engine_is_the_base_class():
    from deepspeed_tpu_torch.checkpoint import CheckpointEngine, TorchCheckpointEngine

    assert issubclass(TorchCheckpointEngine, CheckpointEngine)
    with pytest.raises(NotImplementedError):
        CheckpointEngine().save({}, "unused")
    with pytest.raises(FileNotFoundError, match="missing"):
        TorchCheckpointEngine().load("unused", shardings={})


def test_feedback_registry(monkeypatch):
    from deepspeed_tpu_torch.comm import compressed

    compressed.clear_feedback()
    with pytest.raises(ValueError, match="shape"):
        compressed.feedback_state("g")
    if not torch.cuda.is_available():
        # (shape, world) builds the zero state on the card, as every entry
        # point does: on the host the caller passes ``init``
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compressed.feedback_state("g", shape=(5,), world=2)
    fb = compressed.feedback_state(
        "g", init=lambda: compressed.allreduce_feedback_init((5,), 2, device="cpu"))
    assert fb.worker_error.shape == (5,) and fb.server_error.shape == (3,)
    assert fb.worker_error.device.type == "cpu"
    assert compressed.feedback_state("g") is fb
    compressed.store_feedback("g", "next")
    assert compressed.feedback_state("g") == "next"
    compressed.clear_feedback("g")
    assert compressed.feedback_state("g", init=lambda: 7) == 7
    compressed.clear_feedback()


def test_small_names(tmp_path):
    from deepspeed_tpu_torch.accelerator import (CUDA_Accelerator, get_accelerator,
                                                 set_accelerator, set_accelerator_by_name)
    from deepspeed_tpu_torch.runtime.config import AUTO
    from deepspeed_tpu_torch.utils import fs, groups

    fs.fsync_dir(str(tmp_path))
    fs.fsync_dir(str(tmp_path / "missing"))          # best effort: no error
    groups.initialize(ep_size=1)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        groups.initialize(ep_size=2)
    before = get_accelerator()
    try:
        assert isinstance(set_accelerator_by_name("cuda"), CUDA_Accelerator)
        with pytest.raises(ValueError, match="cuda"):
            set_accelerator_by_name("tpu")
    finally:
        set_accelerator(before)
    assert get_accelerator() is before and AUTO == "auto"
    import argparse

    args = tds.add_config_arguments(argparse.ArgumentParser()).parse_args(
        ["--deepspeed", "--deepspeed_config", "ds.json"])
    assert (args.deepspeed, args.deepspeed_config) == (True, "ds.json")
    assert tds.version.__version__ == tds.__version__


def _port_config(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update(dtype=torch.float32, **over)
    return TransformerConfig(**fields)


def test_transformer_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(TransformerConfig)]
            == [f.name for f in dataclasses.fields(jtransformer.TransformerConfig)])


def test_mixtral_config_trains_and_serves():
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import make_loss_fn, mixtral_config

    cfg = _port_config(jtransformer.mixtral_config("tiny", num_layers=1, vocab_size=128,
                                                   hidden_size=64, intermediate_size=64))
    assert cfg == mixtral_config("tiny", num_layers=1, vocab_size=128, hidden_size=64,
                                 intermediate_size=64, dtype=torch.float32)
    assert cfg.num_experts == 4 and cfg.moe_top_k == 2
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    config = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 10**9,
              "moe": {"enabled": True, "ep_size": 1}}
    engine, *_ = tds.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                model_parameters=params, config=config, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 16)))
    assert np.isfinite(float(engine.train_batch(tokens)))
    serve = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        kv_block_size=8, num_kv_blocks=16, dtype="float32"), device="cpu")
    (out,) = serve.generate([np.arange(5, dtype=np.int32)], max_new_tokens=4)
    assert len(out) == 4 and all(0 <= t < 128 for t in out)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tds.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                       model_parameters=params, device="cpu",
                       config=dict(config, moe={"enabled": True, "ep_size": 2}))


def _tiny_loss_and_params():
    from deepspeed_tpu_torch.models import make_loss_fn

    cfg = TransformerConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                            num_layers=1, num_heads=2, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    return make_loss_fn(TransformerLM(cfg, params)), params


@pytest.mark.parametrize("kind", ["Topology", "TopologySpec"])
def test_initialize_honours_a_dp_only_topology(kind):
    """``initialize(topology=...)`` with the port's dp-only topology: the
    engine runs on that topology and it is the process's topology."""
    from deepspeed_tpu_torch.parallel import Topology, TopologySpec, get_topology

    loss, params = _tiny_loss_and_params()
    given = Topology() if kind == "Topology" else TopologySpec(dp=1)
    engine, *_ = tds.initialize(model=loss, model_parameters=params, device="cpu",
                                config={"train_micro_batch_size_per_gpu": 1},
                                topology=given)
    if kind == "Topology":
        assert engine.topo is given
    else:
        assert engine.topo.spec is given
    assert get_topology() is engine.topo and engine.dp_world == 1


@pytest.mark.parametrize("over", ["tp", "pp", "sp", "ep", "dp", "jax_topology",
                                  "batch_spec", "zero2_tp"])
def test_initialize_refuses_what_it_cannot_honour(over):
    """A topology with pp / sp / ep above 1, a dp degree other than world /
    tp, a JAX topology, a ``batch_spec`` and ZeRO 2-3 beside a tp axis raise
    naming ROADMAP.md Queue A item 8, where they were once dropped without a
    word; a tp axis the world cannot hold (tp 2 in one process) raises as
    the JAX ``TopologySpec`` does."""
    from deepspeed_tpu.parallel import TopologySpec as JaxTopologySpec
    from deepspeed_tpu_torch.parallel import TopologySpec

    loss, params = _tiny_loss_and_params()
    config = {"train_micro_batch_size_per_gpu": 1}
    kwargs = {"tp": {"topology": TopologySpec(tp=2)},
              "pp": {"topology": TopologySpec(pp=2)},
              "sp": {"topology": TopologySpec(sp=2)},
              "ep": {"topology": TopologySpec(ep=2)},
              "dp": {"topology": TopologySpec(dp=2)},
              "jax_topology": {"topology": JaxTopologySpec()},
              "batch_spec": {"batch_spec": ("dp",)},
              "zero2_tp": {"config": dict(config, zero_optimization={"stage": 2},
                                          tensor_parallel={"enabled": True,
                                                           "tp_size": 2})}}[over]
    kwargs.setdefault("config", config)
    if over == "tp":
        with pytest.raises(ValueError, match="not divisible"):
            tds.initialize(model=loss, model_parameters=params, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tds.initialize(model=loss, model_parameters=params, device="cpu", **kwargs)


@pytest.mark.parametrize("specs", ["rule_set", "auto", "tree"])
def test_initialize_takes_param_specs(specs):
    """``param_specs`` as a ``RuleSet``, ``"auto"`` or an explicit spec tree
    (JAX ``engine.py:240-286``); over a tp axis of 1 every leaf stays whole
    and the engine trains as without them. A loss that is not
    ``make_loss_fn``'s at tp 2 with no specs raises
    ``ForeignModelShardingError`` (tests/test_torch_tp.py, in a world of
    tp 2)."""
    from deepspeed_tpu_torch import sharding

    loss, params = _tiny_loss_and_params()
    given = {"rule_set": sharding.llama_pack(), "auto": "auto",
             "tree": sharding.generic_pack().match(params)}[specs]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 8)))
    config = {"train_micro_batch_size_per_gpu": 2}
    base, *_ = tds.initialize(model=loss, model_parameters=params, device="cpu",
                              config=config)
    want = float(base.train_batch(tokens))
    _, params = _tiny_loss_and_params()
    engine, *_ = tds.initialize(model=loss, model_parameters=params, device="cpu",
                                config=config, param_specs=given)
    assert engine._tp_dims is None
    assert float(engine.train_batch(tokens)) == want


@pytest.mark.parametrize("field, value", [("position", "alibi"),
                                          ("layer_windows", (None, 8))])
def test_alibi_and_window_serving_are_refused_by_name(field, value):
    """ALiBi and windowed families are served, on the einsum path, with the
    JAX engine's greedy stream; what stays refused by name is the paged
    kernels' backend, which computes plain scaled causal attention."""
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models.convert import _flatten, _nest

    jcfg = dataclasses.replace(jtransformer.TransformerConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
        norm="layernorm", activation="gelu",
        position="learned" if field == "layer_windows" else "rope"), **{field: value})
    cfg = _port_config(jcfg)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    engine = dict(kv_block_size=8, num_kv_blocks=16, dtype="float32")
    prompt = np.random.default_rng(1).integers(0, 128, 13).astype(np.int32)
    (got,) = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(**engine),
                               device="cpu").generate([prompt], max_new_tokens=6)
    numpy_params = _nest({k: v.numpy() for k, v in _flatten(params).items()})
    (want,) = JEngine(jtransformer.TransformerLM(jcfg), numpy_params,
                      JEC(**engine)).generate([prompt], max_new_tokens=6)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="ALiBi / layer_windows"):
        InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            **engine, attn_backend="pallas"), device="cpu")


@pytest.mark.parametrize("field, value, item", [
    ("no_lm_head", True, "deliberate"), ("vocab_parallel_loss", True, "runs"),
    ("sequence_parallel", True, 8), ("embed_overlap", "ring", "runs"),
    ("overlap_collective_matmul", True, "runs")])
def test_unported_config_fields_raise_naming_their_item(field, value, item):
    """Each field the port cannot run raises naming its ROADMAP.md item; a
    model without an LM head trains (its forward is the hidden states) and
    serving it is refused on purpose, as the JAX ragged model cannot serve
    one either. The tensor-parallel fields run (over a tp axis of 1 the
    dense path; tests/test_torch_tp.py holds them at tp 2)."""
    cfg = _port_config(jtransformer.TransformerConfig(vocab_size=128, hidden_size=32,
                                                      intermediate_size=64, num_layers=1,
                                                      num_heads=2), **{field: value})
    if item == "deliberate":
        from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                      RaggedInferenceEngineConfig)

        model = TransformerLM(cfg, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match="deliberate differences"):
            InferenceEngineV2(cfg, model.param_tree(), RaggedInferenceEngineConfig(
                kv_block_size=8, num_kv_blocks=16, dtype="float32"), device="cpu")
        return
    if item == "runs":
        from deepspeed_tpu_torch.models import make_loss_fn

        model = TransformerLM(cfg, seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 8)))
        dense = make_loss_fn(TransformerLM(dataclasses.replace(cfg, **{field: _OFF[field]}),
                                           model.param_tree(), device="cpu"))
        params = model.param_tree()
        torch.testing.assert_close(make_loss_fn(model)(params, tokens), dense(params, tokens),
                                   rtol=1e-6, atol=1e-6)
        return
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}"):
        TransformerLM(cfg, seed=0, device="cpu")


_OFF = {"vocab_parallel_loss": False, "embed_overlap": "auto",
        "overlap_collective_matmul": False}


def test_default_blocks_match_jax():
    # the modules (both packages export the functions under the modules' names)
    jfa, jfl, tfa, tfl = (importlib.import_module(f"{pkg}.{mod}") for pkg, mod in (
        ("deepspeed_tpu.ops.pallas", "flash_attention"), ("deepspeed_tpu.ops.pallas",
                                                          "fused_loss"),
        ("deepspeed_tpu_torch.ops", "flash_attention"), ("deepspeed_tpu_torch.ops",
                                                         "fused_loss")))
    assert (tfa.DEFAULT_BLOCK_Q, tfa.DEFAULT_BLOCK_K) == (jfa.DEFAULT_BLOCK_Q,
                                                          jfa.DEFAULT_BLOCK_K) == (512, 512)
    assert (tfl.DEFAULT_BLOCK_T, tfl.DEFAULT_BLOCK_V) == (jfl.DEFAULT_BLOCK_T,
                                                          jfl.DEFAULT_BLOCK_V) == (256, 512)


@pytest.mark.parametrize("block_q, block_k, refused", [
    (512, 512, False), (128, 128, False), (300, 512, False), (64, 64, False),
    (100, 128, True), (0, 128, True), (256, 96, True), (200, 200, True), (-1, 512, True)])
def test_flash_blocks_refused_as_jax_refuses(block_q, block_k, refused):
    """At a sequence of 256 the JAX function raises for these sizes exactly
    (a ``ValueError``, or a ``ZeroDivisionError`` at 0); every size that it
    takes gives the port's one result, and ``interpret`` changes nothing."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    q = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 256, 2, 8))
                         .astype(np.float32))
    if refused:
        with pytest.raises(ValueError, match="block"):
            flash_attention(q, q, q, block_q=block_q, block_k=block_k)
        return
    want = flash_attention(q, q, q)
    got = flash_attention(q, q, q, block_q=block_q, block_k=block_k, interpret=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block_t, block_v, refused", [
    (256, 512, False), (12, 512, False), (8, 128, False), (7, 512, False),
    (16, 256, False), (256, 384, False), (256, 192, False),
    (0, 512, True), (256, 0, True), (-8, 512, True), (256, 300, True), (256, 100, True)])
def test_fused_loss_blocks(block_t, block_v, refused):
    """The JAX function raises for a block of 0 or below; at block_v 300 or
    100 over a 384-column vocab it runs but skips the vocab's last columns
    (a wrong loss), which the port refuses. Every size taken gives the same
    loss."""
    from deepspeed_tpu_torch.ops.fused_loss import fused_vocab_nll

    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((16, 384)).astype(np.float32) * 0.1)
    t = torch.from_numpy(rng.integers(0, 384, 20).astype(np.int32))
    if refused:
        with pytest.raises(ValueError, match="block"):
            fused_vocab_nll(h, k, t, block_t=block_t, block_v=block_v)
        return
    got = fused_vocab_nll(h, k, t, block_t=block_t, block_v=block_v, interpret=False)
    assert torch.equal(got, fused_vocab_nll(h, k, t))


def test_wrappers_ignore_interpret():
    from deepspeed_tpu_torch.ops import fused_adam, quant
    from deepspeed_tpu_torch.ops.sparse_attention import fixed_layout, sparse_attention

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300).astype(np.float32))
    q0, s0, shape = quant.quantize_int8(x, 128)
    q1, s1, _ = quant.quantize_int8(x, 128, True)
    assert torch.equal(q0, q1) and torch.equal(s0, s1)
    assert torch.equal(quant.dequantize_int8(q0, s0, shape, torch.float32, True),
                       quant.dequantize_int8(q0, s0, shape))
    args = (x, torch.zeros_like(x), torch.zeros_like(x), x, 1e-3, 0.9, 0.999, 1e-8, 0.01,
            True, True, 1)
    for a, b in zip(fused_adam.adam_update(*args, interpret=True),
                    fused_adam.adam_update(*args)):
        assert torch.equal(a, b)
    qs = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 128, 2, 8))
                          .astype(np.float32))
    layout = fixed_layout(2, 128 // 32, num_local_blocks=2)
    assert torch.equal(sparse_attention(qs, qs, qs, layout, block=32, interpret=True),
                       sparse_attention(qs, qs, qs, layout, block=32))
