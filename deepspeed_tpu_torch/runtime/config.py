"""Typed configuration tree.

Port of ``deepspeed_tpu/runtime/config.py``: the same dataclass tree, field
names, defaults, shorthands and batch-size triangle, so one JSON config
parses to the same values in both packages. Only ``compute_dtype`` differs:
it is a ``torch.dtype`` here. Sections the port's trainer cannot honour yet
still parse; the engine raises ``NotImplementedError`` naming the ROADMAP
item when one is switched on (``runtime/engine.py``), and
``elasticity.enabled`` raises in ``finalize``.

The JAX package's note on the vocabulary: keeps the reference's knob
names — ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, ``optimizer``, ``scheduler``,
``fp16``/``bf16``, ``zero_optimization``, ``gradient_clipping``,
``pipeline``, ``moe``, ``sequence_parallel_size``, ``tensor_parallel`` — so
a DeepSpeed JSON config ports with minimal edits.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from .config_utils import AUTO, ConfigError, ConfigModel, register_config

# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@register_config
@dataclass
class FP16Config(ConfigModel):
    """fp16 + dynamic loss scaling (reference ``runtime/fp16/loss_scaler.py:91``)."""
    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    auto_cast: bool = False


@register_config
@dataclass
class BF16Config(ConfigModel):
    enabled: bool = False
    # keep fp32 master weights + fp32 grad accumulation (reference bf16_optimizer.py:34)
    master_weights: bool = True

    # loss-scaling keys copied from an fp16 section are meaningless under
    # bf16 (fp32 exponent range — no overflow to scale around); the
    # reference tolerates them in configs (tests/torch_compile/ds_config),
    # so accept-and-drop rather than reject
    _DEPRECATED_KEYS = {k: None for k in
                        ("loss_scale", "initial_scale_power",
                         "loss_scale_window", "hysteresis",
                         "min_loss_scale", "consecutive_hysteresis",
                         "fp16_master_weights_and_grads", "auto_cast")}


# ---------------------------------------------------------------------------
# Optimizer / scheduler
# ---------------------------------------------------------------------------


@register_config
@dataclass
class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)


@register_config
@dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------


@register_config
@dataclass
class OffloadOptimizerConfig(ConfigModel):
    """Reference ``runtime/zero/offload_config.py``. ``device`` in {none,cpu,nvme}."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = True
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    # D2H gradient transport dtype for the host-Adam tier. The reference
    # ZeRO-Offload ships the compute-dtype (fp16/bf16) grads to the CPU
    # optimizer (zero/stage_1_and_2.py copy_grads_in_partition); "bfloat16"
    # matches that and halves the host-link bytes. Accumulation and the
    # grad-norm/clip math stay fp32 on device; only the final transfer
    # narrows. "float32" (default) keeps full-width transport.
    grad_dtype: str = "float32"

    def transport_dtype(self) -> torch.dtype:
        """``grad_dtype`` as a torch dtype (JAX ``engine.py:646-658``).
        fp16 is refused: the narrowing comes after the finite check, so an
        fp16 overflow (|g| > 65504) would carry inf past it into the
        masters; bf16 has fp32's exponent range and cannot overflow."""
        table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "fp32": torch.float32}
        raw = self.grad_dtype.lower()
        if raw not in table:
            raise ValueError(
                f"offload_optimizer.grad_dtype={raw!r}: use 'float32' or 'bfloat16' "
                "(fp16 transport would need its own overflow gate — bf16 is the "
                "range-safe narrow dtype)")
        return table[raw]


@register_config
@dataclass
class OffloadParamConfig(ConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = True


@register_config
@dataclass
class ZeroConfig(ConfigModel):
    """ZeRO knobs (reference ``runtime/zero/config.py:84``).

    On TPU the stages lower to sharding rules over the ``dp`` mesh axis:
      stage 0 — replicate everything, psum grads
      stage 1 — shard optimizer state
      stage 2 — + reduce_scatter grads (grads materialized sharded)
      stage 3 — + shard parameters, allgather-on-use
    """
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    offload_optimizer: OffloadOptimizerConfig = field(default_factory=OffloadOptimizerConfig)
    offload_param: OffloadParamConfig = field(default_factory=OffloadParamConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    stage3_module_granularity_threshold: int = 0

    @classmethod
    def _migrate_legacy(cls, d):
        # pre-0.3.16 vocabulary (reference deprecated it the same way:
        # runtime/zero/config.py read_zero_config_deprecated)
        if d.pop("cpu_offload", False):
            off = dict(d.get("offload_optimizer") or {})
            off.setdefault("device", "cpu")
            d["offload_optimizer"] = off
        if d.pop("cpu_offload_params", False):
            offp = dict(d.get("offload_param") or {})
            offp.setdefault("device", "cpu")
            d["offload_param"] = offp
        pin = d.pop("cpu_offload_use_pin_memory", None)
        if pin is not None:
            for key in ("offload_optimizer", "offload_param"):
                if key in d:
                    node = dict(d[key])
                    node.setdefault("pin_memory", bool(pin))
                    d[key] = node
        return d
    # ZeRO++ (hpZ secondary shard / quantized weights / quantized gradients).
    # hpZ's no-second-gather guarantee is realized as a remat policy in the
    # explicit path: zeropp_train_step_factory(remat="hpz") saves gathered
    # weights across fwd->bwd (runtime/zero/zeropp.py hpz_remat_policy)
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    # MiCS-style sub-group sharding: shard params over groups of this size (<= dp size)
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    elastic_checkpoint: bool = False
    ignore_unused_parameters: bool = True


# ---------------------------------------------------------------------------
# Parallel topology
# ---------------------------------------------------------------------------


@register_config
@dataclass
class PipelineConfig(ConfigModel):
    """Pipeline parallelism (reference ``runtime/pipe/``)."""
    stages: int = 1
    partition_method: str = "parameters"  # uniform | parameters | type:<regex>
    micro_batches: Optional[int] = None  # default = gradient_accumulation_steps
    activation_checkpoint_interval: int = 0
    # 'gpipe' or 'interleaved': the SPMD circulating pipeline has no
    # instruction list to reorder — 1F1B-style fwd/bwd interleaving is XLA's
    # scheduling job. 'interleaved' (+ virtual_stages) is the Megatron
    # virtual-pipeline bubble reduction: v layer chunks per stage, bubble
    # (p-1)/(v*m) instead of (p-1)/m.
    schedule: str = "gpipe"
    virtual_stages: int = 1


@register_config
@dataclass
class TensorParallelConfig(ConfigModel):
    """Training tensor parallelism (reference AutoTP / external mpu)."""
    enabled: bool = False
    tp_size: int = 1
    # latency-hiding collective matmul (ops/collective_matmul.py): run the
    # column/row-parallel linears, the Ulysses projection exchange, and the
    # exact ZeRO-3 gather/scatter as ppermute rings overlapped with the
    # partial matmuls (T3, arxiv 2401.16677). Ragged shapes fall back to
    # the declarative GSPMD composition per call site.
    overlap_collective_matmul: bool = False


@register_config
@dataclass
class CompressedCollectivesConfig(ConfigModel):
    """EQuARX-style quantized collectives (``comm/compressed.py``).

    ``mode``: ``none`` (default — every wired site stays the bit-identical
    exact path), ``int8`` (block-quantized payloads, nearest rounding), or
    ``int8_sr`` (stochastic rounding on gradient reductions — unbiased
    compression). Per-site toggles gate the four consumers independently;
    ``hierarchical`` switches the DP gradient all-reduce to the two-level
    form (inner mesh hop exact, outer hops quantized). Also accepted as a
    bare string: ``"compressed_collectives": "int8"``.
    """
    mode: str = "none"           # none | int8 | int8_sr
    block: int = 2048            # quantization block (elements per scale)
    hierarchical: bool = False
    # per-site toggles (only meaningful when mode != none)
    dp_gradients: bool = True    # engine DP gradient reduction
    zero_weights: bool = True    # ZeRO++ qwZ param gather
    zero_gradients: bool = True  # ZeRO++ qgZ gradient reduce-scatter
    moe_alltoall: bool = True    # MoE EP dispatch/combine exchange
    ulysses_alltoall: bool = True  # Ulysses head/sequence exchanges

    def site_map(self):
        return {"dp_gradients": self.dp_gradients,
                "zero_weights": self.zero_weights,
                "zero_gradients": self.zero_gradients,
                "moe": self.moe_alltoall,
                "ulysses": self.ulysses_alltoall}


@register_config
@dataclass
class TrainingFastpathConfig(ConfigModel):
    """Fused training hot path (``ops/fastpath.py`` fleet knobs).

    ``attn_impl``: ``auto`` (flash on a real accelerator for eligible
    shapes), ``flash`` (force the Pallas kernel; alibi/window sites warn
    once and fall back), or ``xla`` (the reference attention everywhere).
    ``loss_impl``: ``auto`` / ``fused`` (Pallas online-softmax LM loss,
    ``ops/pallas/fused_loss.py`` — the ``[B, S, V]`` logits tensor is never
    materialized) / ``xla``. ``embedding_overlap``: ``auto`` (planner
    decides per topology) / ``ring`` (ring-overlapped vocab-sharded
    embedding gather, ``ops/collective_matmul.py``) / ``xla``. Model-level
    ``TransformerConfig`` fields (non-auto) win over these fleet defaults;
    the all-``xla`` setting is bit-identical to the pre-fastpath tree.
    """
    attn_impl: str = "auto"          # auto | xla | flash
    loss_impl: str = "auto"          # auto | xla | fused
    embedding_overlap: str = "auto"  # auto | xla | ring


@register_config
@dataclass
class CommPlannerConfig(ConfigModel):
    """Collective planner (``comm/planner/``): topology-aware per-site
    selection of the PR1/PR2 fast paths.

    ``mode``: ``off`` (default — every wired site behaves bit-identically
    to a planner-less tree), ``static`` (alpha-beta cost model picks each
    site's implementation from the mesh fingerprint, deterministic), or
    ``measure`` (cost-model pruning then microbenchmarks pick the winner;
    results cache on disk keyed by mesh fingerprint so tuning runs once per
    topology). Explicitly-set raw knobs (``compressed_collectives``,
    ``overlap_collective_matmul``) always win at their sites. Also accepted
    as a bare string: ``"comm_planner": "static"``.

    ``dcn_axes`` force-marks mesh axes as cross-slice (DCN) in the planner's
    fingerprint — the multi-slice rehearsal knob: a single-host (or CPU)
    mesh plans exactly as the target fleet would (hierarchical multi-phase
    programs with int8+error-feedback DCN hops become eligible for the
    DP-grad site; see ``docs/multislice.md``). On a real multi-slice mesh
    leave it unset — DCN axes are detected from process boundaries.
    """
    mode: str = "off"            # off | static | measure
    cache_dir: Optional[str] = None  # default ~/.cache/deepspeed_tpu/comm_plans
    use_cache: bool = True
    margin: float = 3.0          # cost-model pruning margin (x best estimate)
    measure_reps: int = 4        # chained executions per timed probe
    measure_max_elems: int = 1 << 16  # probe tensor cap (elements)
    dcn_axes: Optional[List[str]] = None  # force-mark axes as DCN (simulation)
    # program-compiler beam width: how many searched multi-phase programs
    # survive slot pruning to compete with the flat impls (and, in measure
    # mode, get microbenched). None = compiler default.
    beam_width: Optional[int] = None
    # fused/chunked overlap credit override (0..0.95): the fraction of a
    # phase's wire time hidden behind the bound matmul tiles / the next
    # chunk's compute. None = the calibrated/compiled-in default; planners
    # can also measure it (CollectivePlanner.calibrate_overlap_credit).
    overlap_credit: Optional[float] = None


@register_config
@dataclass
class MoEConfig(ConfigModel):
    """Expert parallelism (reference ``deepspeed/moe/``)."""
    enabled: bool = False
    ep_size: int = 1
    num_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None  # None | 'Jitter' | 'RSample'
    drop_tokens: bool = True
    use_residual: bool = False
    aux_loss_weight: float = 0.01


# ---------------------------------------------------------------------------
# Diagnostics / aux subsystems
# ---------------------------------------------------------------------------


@register_config
@dataclass
class FlopsProfilerConfig(ConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 3
    detailed: bool = True
    output_file: Optional[str] = None


@register_config
@dataclass
class CommsLoggerConfig(ConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@register_config
@dataclass
class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"


@register_config
@dataclass
class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@register_config
@dataclass
class CSVConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"


@register_config
@dataclass
class CometConfig(ConfigModel):
    """Reference ``monitor/config.py`` CometConfig (monitor/comet.py:23)."""
    enabled: bool = False
    samples_log_interval: int = 100
    project: Optional[str] = None
    workspace: Optional[str] = None
    api_key: Optional[str] = None
    experiment_name: Optional[str] = None
    experiment_key: Optional[str] = None
    online: Optional[bool] = None
    mode: Optional[str] = None


@register_config
@dataclass
class MonitorConfig(ConfigModel):
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)
    comet: CometConfig = field(default_factory=CometConfig)


@register_config
@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """Rematerialization knobs; maps to jax.checkpoint policies."""
    partition_activations: bool = False
    number_checkpoints: Optional[int] = None
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    profile: bool = False
    # jax-native: remat policy name ('nothing_saveable','dots_saveable',...)
    policy: Optional[str] = None
    # apply ``policy`` as one jax.checkpoint wrap around the WHOLE loss at
    # the engine (the control plane's remat actuator / autotune 'remat'
    # dim). Opt-in: models using the per-layer compat API
    # (``deepspeed_tpu.checkpointing.checkpoint``) read the same ``policy``
    # field, and wrapping the engine on top would double-rematerialize.
    engine_wrap: bool = False


@register_config
@dataclass
class ElasticityConfig(ConfigModel):
    """Elastic batch config (reference ``elasticity/elasticity.py:233``)."""
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True


@register_config
@dataclass
class CompressionConfig(ConfigModel):
    """QAT / pruning knobs (reference ``compression/``)."""
    weight_quantization: Dict[str, Any] = field(default_factory=dict)
    activation_quantization: Dict[str, Any] = field(default_factory=dict)
    sparse_pruning: Dict[str, Any] = field(default_factory=dict)
    row_pruning: Dict[str, Any] = field(default_factory=dict)
    head_pruning: Dict[str, Any] = field(default_factory=dict)
    channel_pruning: Dict[str, Any] = field(default_factory=dict)
    layer_reduction: Dict[str, Any] = field(default_factory=dict)


@register_config
@dataclass
class DataEfficiencyConfig(ConfigModel):
    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = field(default_factory=dict)
    data_routing: Dict[str, Any] = field(default_factory=dict)


@register_config
@dataclass
class AutotuningConfig(ConfigModel):
    enabled: bool = False
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    fast: bool = True
    max_train_batch_size: Optional[int] = None
    mp_size: int = 1
    num_tuning_micro_batch_sizes: int = 3
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    # launcher-arg rewrites per tuned knob (reference autotuning docs);
    # consumed by the autotuner CLI when re-launching trials
    arg_mappings: Optional[Dict[str, str]] = None


@register_config
@dataclass
class SentinelConfig(ConfigModel):
    """Divergence sentinel (``runtime/resilience/sentinel.py``): NaN/inf-loss
    streaks and grad-norm spikes trip ``policy``."""
    enabled: bool = True          # within an enabled resilience block
    nan_streak: int = 3           # consecutive non-finite steps to trip
    spike_factor: float = 10.0    # grad_norm > factor * rolling median
    spike_streak: int = 2         # consecutive spike steps to trip
    spike_window: int = 64        # rolling-median history length
    min_history: int = 8          # samples before spike verdicts start
    policy: str = "rollback"      # rollback | warn | halt
    lr_drop_factor: float = 1.0   # <1.0 multiplies the LR on each rollback


@register_config
@dataclass
class PreemptionConfig(ConfigModel):
    """Preemption watcher (``runtime/resilience/preempt.py``)."""
    enabled: bool = True
    install_signal_handler: bool = True
    signals: List[str] = field(default_factory=lambda: ["SIGTERM"])
    probe_file: Optional[str] = None  # also honors $DSTPU_PREEMPT_FILE


@register_config
@dataclass
class FaultInjectionConfig(ConfigModel):
    """Deterministic fault harness (``runtime/resilience/faults.py``) —
    test/chaos-drill use only; every injection is off by default."""
    enabled: bool = False
    nan_loss_at_steps: List[int] = field(default_factory=list)
    grad_spike_at_steps: List[int] = field(default_factory=list)
    spike_magnitude: float = 1e6
    preempt_at_step: Optional[int] = None
    torn_write_at_steps: List[int] = field(default_factory=list)
    crash_before_commit_at_steps: List[int] = field(default_factory=list)
    hang_at_step: Optional[int] = None      # step wedges; watchdog must fire
    slow_rank: Optional[int] = None         # steady straggler rank
    slow_step_s: float = 0.25               # per-step sleep on slow_rank
    heartbeat_loss_at_steps: List[int] = field(default_factory=list)
    # silent-data-corruption drills (chaos classes sdc_bitflip_transient /
    # sdc_bitflip_sticky): flip ``sdc_bit`` of one param element on rank
    # ``sdc_rank`` — once at each listed step (transient) or on every step
    # from ``sdc_sticky_from_step`` (sticky host)
    sdc_transient_at_steps: List[int] = field(default_factory=list)
    sdc_sticky_from_step: Optional[int] = None
    sdc_rank: int = -1                      # -1 = every rank (single-rank tests)
    sdc_bit: int = 17                       # bit index flipped in the leaf


@register_config
@dataclass
class ChaosConfig(ConfigModel):
    """Full-stack chaos engine (``runtime/resilience/chaos.py``, see
    ``docs/fleet_robustness.md``): deterministic, seeded fault schedules
    across the transport layer (object-store heartbeat PUT/GET errors,
    torn beacons, plan-cache read errors, snapshot-commit I/O errors), the
    serving layer (replica kill, KV-pool exhaustion, slow prefill, dropped
    token delivery, fleet replica spawn failure, slow replica warm-up),
    and the control layer (stale health rows, flapping
    straggler verdicts) — drill/test use only. Disabled by default:
    nothing is constructed, every injection site is a single None check,
    and the stack is bitwise identical to a tree without the subsystem."""
    enabled: bool = False
    seed: int = 0
    # explicit deterministic schedule: [{kind, site, at, count, param}...]
    events: List[Dict[str, Any]] = field(default_factory=list)
    # seeded auto-generation: events_per_class arming indices per listed
    # fault class, drawn from random.Random(seed) over [0, horizon)
    classes: List[str] = field(default_factory=list)
    horizon: int = 64
    events_per_class: int = 1
    # training-layer injections (NaN loss, grad spikes, hang, ...) ride
    # along as the existing FaultPlan; the ResilienceManager adopts it
    # when resilience.faults itself is not enabled
    training: FaultInjectionConfig = field(
        default_factory=FaultInjectionConfig)


@register_config
@dataclass
class WatchdogConfig(ConfigModel):
    """Step watchdog (``runtime/resilience/watchdog.py``): a deadline
    derived from the rolling median step time; on expiry all-thread stacks
    are dumped to ``hangdump-<rank>.txt`` and the process exits with the
    distinctive watchdog code so the launcher restarts it."""
    enabled: bool = False
    factor: float = 8.0        # deadline = factor * rolling median step time
    floor_s: float = 30.0      # never below (short steps jitter)
    cap_s: float = 600.0       # never above (also the pre-history deadline)
    window: int = 32           # rolling-median history length
    dump_dir: Optional[str] = None  # default: resilience.snapshot_dir


@register_config
@dataclass
class HeartbeatConfig(ConfigModel):
    """Cross-host health beacons (``runtime/resilience/heartbeat.py``):
    per-host files in a shared dir carrying step/step-time; readers derive
    dead-host and straggler verdicts and emit Resilience/* events."""
    enabled: bool = False
    interval_steps: int = 1         # beacon (and table check) cadence
    dir: Optional[str] = None       # default: <snapshot_dir>/heartbeats
    dead_after_s: float = 60.0      # beacon older than this = dead host
    straggler_factor: float = 3.0   # step_time > k * fleet median


@register_config
@dataclass
class DegradedModeConfig(ConfigModel):
    """Degraded-mode collective fallback: after ``rollback_threshold``
    sentinel rollbacks within ``window_s`` seconds, the run drops every
    approximate collective (compressed int8 paths, planner decisions) back
    to exact XLA collectives. Persisted in snapshot meta so restarts
    inherit it; re-escalation only via operator action
    (``ResilienceManager.clear_degraded()``)."""
    enabled: bool = False
    rollback_threshold: int = 2
    window_s: float = 600.0


@register_config
@dataclass
class IntegrityConfig(ConfigModel):
    """Silent-corruption integrity tier
    (``runtime/resilience/integrity.py``, see ``docs/fleet_robustness.md``):
    periodic cross-rank fingerprints of DP-replicated state, shadow-step
    replay to call transient-vs-sticky, verified snapshot stamping, and SDC
    quarantine through the control supervisor's ``integrity`` rule.
    Disabled by default — nothing is constructed and stepping is bitwise
    identical to a tree without the subsystem."""
    enabled: bool = False
    interval_steps: int = 32        # fingerprint cadence (detection latency)
    chunks: int = 8                 # digest words; more = finer localization
    shadow_replay: bool = True      # replay-classify divergences
    resolve_timeout_steps: int = 8  # quorum / peer-verdict wait, in steps
    dir: Optional[str] = None       # fp exchange dir; default <snapshot_dir>/integrity
    rank: int = -1                  # -1 = engine artifact rank
    world: int = 0                  # voters expected; <2 = detect-only (no vote)
    quarantine: bool = True         # demote/replan around a sticky minority
    rollback: bool = True           # roll back to newest VERIFIED snapshot


@register_config
@dataclass
class ResilienceConfig(ConfigModel):
    """Resilience subsystem (``runtime/resilience/``): async snapshots,
    divergence sentinel with rollback, preemption drain, restore-on-restart.
    Disabled by default — the engine step is then bit-identical to a tree
    without the subsystem."""
    enabled: bool = False
    snapshot_dir: Optional[str] = None  # REQUIRED when enabled
    snapshot_interval: int = 100        # steps between cadence snapshots
    async_snapshot: bool = True         # background writer thread
    keep_snapshots: int = 2             # manifest entries retained
    shard_mb: int = 256                 # target checksummed-shard size
    restore_on_start: bool = True       # resume from latest valid at init
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    faults: FaultInjectionConfig = field(default_factory=FaultInjectionConfig)
    # fleet-robustness block (all off by default — stepping stays bit-identical)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    heartbeat: HeartbeatConfig = field(default_factory=HeartbeatConfig)
    degraded_mode: DegradedModeConfig = field(default_factory=DegradedModeConfig)
    integrity: IntegrityConfig = field(default_factory=IntegrityConfig)


@register_config
@dataclass
class AnalysisConfig(ConfigModel):
    """Static graph auditor (``deepspeed_tpu/analysis/``, see
    ``docs/static_analysis.md``): at ``engine.compile()`` time the staged
    train step is audited — unplanned collectives reconciled against the
    planner's plan table / comms ledger / jaxpr, precision leaks, donation
    misses, host-sync hazards — with findings logged as plan-table rows
    and ``Analysis/*`` monitor events.  Disabled by default: nothing runs
    and the compiled program is bit-identical (the audit never edits the
    program either way — it only reads it).  Also accepted as a bare bool
    (``"analysis": true``) or a severity string (``"analysis": "error"``
    == enabled + ``fail_on: error``)."""
    enabled: bool = False
    # raise at compile() when findings at/above this severity exist
    # (None = report only); same ladder as the CLI --fail-on
    fail_on: Optional[str] = None     # None | info | warning | error
    strict: bool = False              # unmatched reductions become warnings
    small_bytes: int = 64 << 10       # gather-class unplanned: info below
    big_bytes: int = 1 << 20          # gather-class unplanned: error at/above
    precision_min_elems: int = 4096   # smaller upcasts never reported
    precision_big_elems: int = 1 << 20  # upcast warning -> error at/above
    donation_min_bytes: int = 1 << 20   # smaller non-donated inputs ignored
    # regexes vs HLO metadata op_name/source: a hit marks the collective
    # planned (the annotation escape hatch for intentional reshards)
    collective_allowlist: List[str] = field(default_factory=list)
    # regexes vs named-scope paths: allowed f32 accumulation scopes
    precision_allowlist: List[str] = field(default_factory=list)
    # where audit-report.json lands (the doctor cross-reads it from the
    # dump dir); default: resilience.snapshot_dir when set, else unwritten
    report_dir: Optional[str] = None


@register_config
@dataclass
class TelemetryConfig(ConfigModel):
    """Unified telemetry spine (``deepspeed_tpu/telemetry/``, see
    ``docs/observability.md``): step-phase span tracing, the crash flight
    recorder, and the pull-based metrics registry with Prometheus
    exposition. Disabled by default — nothing is constructed and stepping
    is bit-identical to a tree without the subsystem. Also accepted as a
    bare bool (``"telemetry": true``) or a string flight-dump directory
    (``"telemetry": "<dir>"``)."""
    enabled: bool = False
    spans: bool = True                # span tracer (engine/serving phases)
    max_spans: int = 8192             # bounded closed-span buffer
    # every N steps the engine drains the device INSIDE a compute/drain
    # span, attributing device work to the timeline without a per-span
    # sync; 0 = never (spans measure host/dispatch time only)
    drain_interval_steps: int = 0
    trace_dir: Optional[str] = None   # Chrome-trace export dir (on close())
    flight_steps: int = 32            # flight-recorder ring size (0 = off)
    flight_dir: Optional[str] = None  # default: resilience.snapshot_dir or .
    # collective flight recorder: bounded ring of every collective launch
    # (seq/op/axes/shape/dtype/impl/phase), recorded host-side at trace/
    # dispatch time in the comm wrappers and dumped with the flightdump —
    # the stream `python -m deepspeed_tpu.doctor` aligns across ranks to
    # name a desync. 0 = off.
    collective_ring: int = 256
    # per-step device-memory gauges from device.memory_stats() (bytes in
    # use / peak / limit), folded into the flight ring and exported as
    # dstpu_mem_* — auto-disables where the backend reports nothing (CPU)
    memory: bool = True
    # AOT-compile each train-step variant once to record its compile-time
    # memory_analysis() (arg/output/temp/generated bytes) in the plan table
    # and registry; the measured executable then serves the steps, so the
    # compile is paid once, not twice. Program + numerics are identical.
    memory_analysis: bool = False
    prometheus_port: Optional[int] = None  # serve /metrics + /healthz (0 = ephemeral)
    monitor_bridge: bool = False      # registry -> Monitor events each print


@register_config
@dataclass
class ControlGuardConfig(ConfigModel):
    """Flap guard for automated actions (``control/guard.py``): an action
    fires only after ``trigger_streak`` consecutive asserted observations,
    re-arms only after ``clear_streak`` consecutive clear ones, waits
    ``cooldown_s`` between firings of the same rule, and the whole
    supervisor stops acting once ``budget`` actions fired within
    ``budget_window_s`` (observing and ledgering continue)."""
    trigger_streak: int = 2
    clear_streak: int = 2
    cooldown_s: float = 120.0
    budget: int = 8
    budget_window_s: float = 3600.0


@register_config
@dataclass
class ControlAutotuneConfig(ConfigModel):
    """Autotuner v2 (``control/autotune.py``): the generalized knob search
    {GAS, remat, training_fastpath, compressed_collectives, +stage/
    micro_batch}, probed with the in-process engine-warmup path and cached
    per mesh-fingerprint digest beside the comm-plan cache. Invoked
    explicitly — never implicitly at ``initialize()``: this block
    parameterizes ``ControlAutotuner.from_config(ds_config)`` (or pass the
    knobs directly to ``ControlAutotuner(...)``)."""
    enabled: bool = False
    dims: List[str] = field(default_factory=lambda: [
        "gas", "remat", "fastpath", "compression"])
    metric: str = "throughput"
    warmup_steps: int = 1
    measure_steps: int = 2
    tuner_type: str = "model"     # model | gridsearch | random
    early_stop: int = 3           # model/random tuner early-stop patience
    use_cache: bool = True        # per-mesh winner cache (DSTPU_PLAN_CACHE)
    cache_dir: Optional[str] = None  # default: the comm-plan cache dir
    probe_programs: bool = True   # microbench the dp-grad program variants


@register_config
@dataclass
class ControlSupervisorConfig(ConfigModel):
    """Online supervisor policy (``control/supervisor.py``): the rule book
    reacting to live signals. Rule toggles gate each signal->action edge
    independently; ``replan_axes`` overrides which mesh axes a straggler
    re-plan treats as the slow link (default: fingerprint DCN axes, else
    the outermost dp axis of a multi-axis span)."""
    enabled: bool = True              # within an enabled control block
    interval_steps: int = 1           # rule-evaluation cadence (steps)
    straggler_replan: bool = True
    straggler_penalty: float = 4.0    # slow-link cost multiplier floor
    replan_axes: Optional[List[str]] = None
    memory_guard: bool = True
    mem_watermark: float = 0.92       # bytes_in_use / bytes_limit trigger
    sla_guard: bool = True
    sla_violation_rate: float = 0.5   # violations / tracked per tick
    sla_min_tracked: int = 8          # finishes per tick before judging
    rollback_degrade: bool = True
    rollback_threshold: int = 2
    rollback_window_s: float = 600.0
    integrity_guard: bool = True      # act on fingerprint-divergence verdicts


@register_config
@dataclass
class ControlConfig(ConfigModel):
    """Control-plane subsystem (``deepspeed_tpu/control/``, see
    ``docs/autotuning.md``): Autotuner v2 + the online supervisor policy,
    sharing one decision ledger that rides flight dumps, the Prometheus
    registry (``dstpu_control_actions_total``), ``Control/*`` monitor
    events, and the doctor's post-mortem. Disabled by default — nothing is
    constructed and engine stepping is bit-identical. Also accepted as a
    bare bool (``"control": true``)."""
    enabled: bool = False
    ledger_size: int = 256
    autotune: ControlAutotuneConfig = field(
        default_factory=ControlAutotuneConfig)
    supervisor: ControlSupervisorConfig = field(
        default_factory=ControlSupervisorConfig)
    guard: ControlGuardConfig = field(default_factory=ControlGuardConfig)


@register_config
@dataclass
class ServingConfig(ConfigModel):
    """Serving tier (``deepspeed_tpu/serving/``): continuous-batching
    ``LLMServer`` over the ``inference/v2`` ragged engine.

    ``policy`` orders admission: ``fcfs`` (arrival), ``priority``
    (``Request.priority``, with preempt-and-requeue of lower-priority
    prefills when the KV pool runs dry), or ``deadline`` (earliest SLA
    deadline first). ``engine`` holds ``RaggedInferenceEngineConfig``
    overrides (token_budget, num_kv_blocks, kv_block_size,
    kv_cache_dtype, ...) — notably ``enable_prefix_cache`` (content-
    addressed prefix KV reuse: repeated system prompts map already-written
    pages instead of re-prefilling; resumed/migrated requests pay only the
    uncached tail) and ``spec_decode_k``/``spec_ngram`` (n-gram
    speculative decoding, greedy-only; the server runs the verify path
    automatically whenever every live sequence is in steady decode). See
    docs/serving.md. ``heartbeat_dir`` enables the beacon transport
    for replica health (``ReplicaRouter``)."""
    enabled: bool = False
    policy: str = "fcfs"                 # fcfs | priority | deadline
    preempt: bool = True                 # preempt prefills under block pressure
    max_queue: int = 256                 # bounded ingress (overload sheds)
    # fused multi-token decode chunk (engine.decode_batch — the pallas
    # paged flash-decode fast path): when > 1 and every live sequence is in
    # steady decode, one server step runs a whole chunk in ONE compiled
    # dispatch; tokens stream in chunk-sized bursts. 0 = off.
    fused_decode_chunk: int = 0
    # resumable requests: every N generated tokens a response checkpoints
    # its generation state; a replica-loss requeue then resumes from the
    # last checkpoint (one prefill over prompt+generated, stream delivery
    # deduped) instead of replaying from scratch. 0 = full replays.
    # MUST mirror serving/request.py DEFAULT_RESUME_CHECKPOINT_TOKENS
    # (config cannot import the serving tier); change both together.
    resume_checkpoint_tokens: int = 16
    default_deadline_s: Optional[float] = None  # SLA stamped when unset
    idle_s: float = 0.001                # engine-thread sleep when idle
    metrics_interval_steps: int = 50     # Serving/* monitor event cadence
    replica_id: int = 0
    heartbeat_dir: Optional[str] = None  # shared dir for replica beacons
    heartbeat_interval_s: float = 2.0
    dead_after_s: float = 10.0           # beacon staler than this = dead
    # multi-tenant SLA classes (``deepspeed_tpu/fleet/tenancy.py``
    # TenancyMap.from_config; see docs/fleet_serving.md):
    #   {"classes": {"gold": {"weight": 4, "deadline_s": 2.0}, "bronze": 1},
    #    "tenants": {"acme": "gold"}, "default": "bronze"}
    # With the deadline policy, admission sorts by arrival + deadline/weight
    # and the control-plane shed door scales per class (low classes shed
    # first). None = tenancy off (single-tenant behavior unchanged).
    tenancy: Optional[Dict[str, Any]] = None
    # integrity canary probe (see docs/fleet_robustness.md):
    # every ``canary_interval_steps`` engine steps the replica runs a
    # seeded greedy canary request through its own admission path and
    # hashes the generated tokens. A hash that differs from the recorded
    # expectation (``canary_expect``, or the first probe's result when
    # unset) marks the replica failed via the router health path — a
    # replica that silently computes wrong bits stops taking traffic.
    canary_interval_steps: int = 0       # 0 = canary off
    canary_prompt: List[int] = field(default_factory=lambda: [3, 1, 4, 1, 5])
    canary_max_tokens: int = 8
    canary_expect: Optional[str] = None  # known-good token hash (hex)
    engine: Dict[str, Any] = field(default_factory=dict)


@register_config
@dataclass
class CheckpointConfig(ConfigModel):
    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = field(default_factory=dict)
    async_save: bool = False


@register_config
@dataclass
class AIOConfig(ConfigModel):
    """Host async-IO knobs for the NVMe offload tier (reference ``csrc/aio``)."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------


@register_config
@dataclass
class EigenvalueConfig(ConfigModel):
    """Hessian power-iteration knobs for MoQ (reference ``eigenvalue``
    section, ``runtime/constants.py:340``); consumed by
    ``runtime/eigenvalue.Eigenvalue.from_config``."""
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0
    model_name: Optional[str] = None  # appears in reference test configs


@register_config
@dataclass
class QuantizeBitsConfig(ConfigModel):
    start_bits: int = 16
    target_bits: int = 8


@register_config
@dataclass
class QuantizeScheduleConfig(ConfigModel):
    quantize_period: int = 1000
    schedule_offset: int = 1000


@register_config
@dataclass
class FP16MixedQuantizeConfig(ConfigModel):
    enabled: bool = False
    quantize_change_ratio: float = 0.001


@register_config
@dataclass
class QuantizeTrainingConfig(ConfigModel):
    """MoQ vocabulary (reference ``quantize_training`` section,
    ``runtime/config.py:567``); ``runtime/quantize.MoQQuantizer.from_config``
    builds the annealing quantizer from it."""
    enabled: bool = True  # presence of the section implies it in the reference
    quantize_bits: QuantizeBitsConfig = field(default_factory=QuantizeBitsConfig)
    quantize_type: str = "symmetric"
    quantize_schedule: QuantizeScheduleConfig = field(
        default_factory=QuantizeScheduleConfig)
    quantize_groups: int = 1
    fp16_mixed_quantize: FP16MixedQuantizeConfig = field(
        default_factory=FP16MixedQuantizeConfig)
    quantize_verbose: bool = False
    quantize_eigenvalue: bool = False
    quantize_algo: Optional[Dict[str, Any]] = None
    rounding: str = "nearest"


@register_config
@dataclass
class ProgressiveLayerDropConfig(ConfigModel):
    """PLD knobs (reference top-level ``progressive_layer_drop`` section,
    ``runtime/config.py`` PLD group); consumed by
    ``runtime/progressive_layer_drop.ProgressiveLayerDrop.from_config``."""
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@register_config
@dataclass
class HybridEngineConfig(ConfigModel):
    """RLHF train/generate engine knobs (reference ``hybrid_engine``
    section, ``runtime/config.py:544``)."""
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@register_config
@dataclass
class DeepSpeedTPUConfig(ConfigModel):
    """Root config (reference ``DeepSpeedConfig``, ``runtime/config.py:706``)."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    # reference memory_breakdown / see_memory_usage: log device+host memory
    # at engine init and the compiled step's XLA accounting at step 1
    memory_breakdown: bool = False
    dump_state: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    disable_allgather: bool = False

    seed: int = 42

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    tensor_parallel: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    compressed_collectives: CompressedCollectivesConfig = field(
        default_factory=CompressedCollectivesConfig)
    comm_planner: CommPlannerConfig = field(default_factory=CommPlannerConfig)
    training_fastpath: TrainingFastpathConfig = field(
        default_factory=TrainingFastpathConfig)

    # topology: sizes multiply to world size; dp is inferred
    sequence_parallel_size: int = 1
    data_parallel_size: Optional[int] = None

    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)
    comet: CometConfig = field(default_factory=CometConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    compression_training: CompressionConfig = field(default_factory=CompressionConfig)
    data_efficiency: DataEfficiencyConfig = field(default_factory=DataEfficiencyConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    aio: AIOConfig = field(default_factory=AIOConfig)
    eigenvalue: EigenvalueConfig = field(default_factory=EigenvalueConfig)
    quantize_training: Optional[QuantizeTrainingConfig] = None
    hybrid_engine: HybridEngineConfig = field(default_factory=HybridEngineConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(
        default_factory=ProgressiveLayerDropConfig)

    @classmethod
    def _migrate_legacy(cls, d):
        # legacy top-level curriculum_learning (reference
        # curriculum_enabled_legacy, docs/_tutorials/curriculum-learning.md)
        # is the same scheduler the data_efficiency form configures — move
        # it to the modern location the engine reads
        # string shorthand: "compressed_collectives": "int8" == {"mode": "int8"}
        cc = d.get("compressed_collectives")
        if isinstance(cc, str):
            d["compressed_collectives"] = {"mode": cc}
        # string shorthand: "comm_planner": "static" == {"mode": "static"}
        cp = d.get("comm_planner")
        if isinstance(cp, str):
            d["comm_planner"] = {"mode": cp}
        # string shorthand: "resilience": "<dir>" enables snapshots there
        rz = d.get("resilience")
        if isinstance(rz, str):
            d["resilience"] = {"enabled": True, "snapshot_dir": rz}
        # string shorthand: "serving": "priority" == {"enabled": true,
        # "policy": "priority"}
        sv = d.get("serving")
        if isinstance(sv, str):
            d["serving"] = {"enabled": True, "policy": sv}
        # bool/string shorthand: "telemetry": true enables the spine with
        # defaults; "telemetry": "<dir>" additionally aims flight dumps there
        tl = d.get("telemetry")
        if isinstance(tl, bool):
            d["telemetry"] = {"enabled": tl}
        elif isinstance(tl, str):
            d["telemetry"] = {"enabled": True, "flight_dir": tl}
        # bool/string shorthand: "analysis": true runs the compile-time
        # audit report-only; "analysis": "error" additionally fails
        # compile() on findings at/above that severity
        an = d.get("analysis")
        if isinstance(an, bool):
            d["analysis"] = {"enabled": an}
        elif isinstance(an, str):
            d["analysis"] = {"enabled": True, "fail_on": an}
        # bool shorthand: "control": true arms the supervisor policy (and
        # the autotuner API) with defaults
        ct = d.get("control")
        if isinstance(ct, bool):
            d["control"] = {"enabled": ct}
        cl = d.pop("curriculum_learning", None)
        if cl:
            de = dict(d.get("data_efficiency") or {})
            ds = dict(de.get("data_sampling") or {})
            ds.setdefault("curriculum_learning", dict(cl))
            de["data_sampling"] = ds
            # the reference legacy default is disabled; only an explicit
            # "enabled": true switches the scheduler on
            de.setdefault("enabled", bool(cl.get("enabled", False)))
            d["data_efficiency"] = de
        return d

    # free-form escape hatch for experiments
    extra: Dict[str, Any] = field(default_factory=dict)

    _DEPRECATED_KEYS = {
        "train_micro_batch_size_per_device": "train_micro_batch_size_per_gpu",
        "zero_allow_untested_optimizer": None,
        "zero_force_ds_cpu_optimizer": None,
        "communication_data_type": None,
        "amp": None,
    }

    # ------------------------------------------------------------------
    def __post_init__(self):
        # Keep the raw user-specified triangle so finalize() can re-resolve at
        # the true dp world size without conflicting with defaults filled here.
        self._user_batch = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                            self.gradient_accumulation_steps)
        self._resolve_batch_sizes(strict=False)

    def _resolve_batch_sizes(self, world_dp_size: int = 1, strict: bool = True):
        """Reference ``config.py`` batch-size triangle: tbs = mbs * gas * dp.

        ``strict=False`` (config load time, before the engine knows the real
        dp size) keeps a fully-specified but dp-inconsistent triangle as-is;
        ``finalize(world_dp_size)`` re-resolves strictly."""
        raw_tbs, raw_mbs, raw_gas = self._user_batch
        tbs = raw_tbs if isinstance(raw_tbs, int) else None
        mbs = raw_mbs if isinstance(raw_mbs, int) else None
        gas = raw_gas if isinstance(raw_gas, int) else None
        if tbs and mbs and gas:
            if tbs != mbs * gas * world_dp_size:
                if not strict:
                    return  # defer to finalize() with the true dp size
                raise ConfigError(
                    f"train_batch_size({tbs}) != micro_batch({mbs}) * gas({gas}) * dp({world_dp_size})")
        elif tbs and mbs:
            gas = tbs // (mbs * world_dp_size)
        elif tbs and gas:
            mbs = tbs // (gas * world_dp_size)
        elif mbs and gas:
            tbs = mbs * gas * world_dp_size
        elif tbs:
            mbs = max(1, tbs // world_dp_size)
            gas = tbs // (mbs * world_dp_size)
        elif mbs:
            gas = 1
            tbs = mbs * world_dp_size
        else:
            mbs, gas = 1, 1
            tbs = world_dp_size
        if not (tbs and mbs and gas) or tbs != mbs * gas * world_dp_size:
            raise ConfigError(
                f"Inconsistent batch config: train_batch_size={tbs}, micro={mbs}, gas={gas}, "
                f"dp={world_dp_size}")
        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = mbs
        self.gradient_accumulation_steps = gas

    def finalize(self, world_dp_size: int) -> "DeepSpeedTPUConfig":
        """Re-resolve batch sizes once the dp world size is known.

        With ``elasticity.enabled`` the elastic schedule OWNS the batch
        triangle (reference ``config.py`` elasticity integration over
        ``elasticity/elasticity.py:233``): the final batch and micro-batch
        come from ``compute_elastic_config`` at the CURRENT world size, so a
        rescaled relaunch picks consistent sizes with no retuning. User
        batch keys then conflict unless ``ignore_non_elastic_batch_info``
        says to drop them (reference ``elasticity/constants.py``)."""
        if self.elasticity.enabled:
            raise NotImplementedError(
                "elasticity (the elastic batch schedule, elasticity/*) is not "
                "ported yet: ROADMAP.md Queue A item 9")
        self._resolve_batch_sizes(world_dp_size)
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        return self

    # convenience ------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    @property
    def zero_stage(self) -> int:
        return self.zero_optimization.stage


def _fold_monitor_keys(cfg: DeepSpeedTPUConfig) -> DeepSpeedTPUConfig:
    # The reference accepts monitor configs both top-level ("tensorboard": {...})
    # and the MonitorConfig grouping; fold top-level into cfg.monitor (idempotent).
    import copy

    for key in ("tensorboard", "wandb", "csv_monitor", "comet"):
        top = getattr(cfg, key)
        if top.enabled and not getattr(cfg.monitor, key).enabled:
            setattr(cfg.monitor, key, copy.deepcopy(top))
    return cfg


def load_config(config: Union[str, Mapping[str, Any], DeepSpeedTPUConfig, None]) -> DeepSpeedTPUConfig:
    """Accept a path to a JSON file, a dict, an existing config, or None."""
    if config is None:
        return DeepSpeedTPUConfig()
    if isinstance(config, DeepSpeedTPUConfig):
        return _fold_monitor_keys(config)
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    return _fold_monitor_keys(DeepSpeedTPUConfig.from_dict(config))
