"""The training engine: the port of the core of
``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTPUEngine`` and
``initialize``).

One training step (``train_batch``) is the JAX package's ``train_step``
written out eagerly: ``gas`` micro-batches each run the loss on a compute
copy of the parameters (every floating leaf cast to the compute dtype, the
LM head included) and back-propagate through that cast into fp32 gradient
accumulators on the fp32 master weights; the sum is divided by
``loss_scale * gas``; the global L2 norm is taken and the gradients clipped
by ``min(1, clip / (norm + 1e-6))``; the optimizer updates the masters
(``p + u`` in fp32); fp16 steps whose norm is not finite are skipped and the
dynamic loss scale moves as the reference's ``DynamicLossScaler`` moves it.
The learning rate and Adam's bias correction see ``step + 1``.

PyTorch idiom where it differs from the JAX package: parameters that are
already float32 on the engine's device are trained IN PLACE (the masters
alias the caller's tensors, as a torch module's parameters are trained in
place; the JAX package copies because its step donates its buffers), and the
gradient accumulators are the masters' ``.grad`` tensors, which autograd
sums into in place, so a step holds one fp32 gradient buffer whatever
``gas`` is.

``activation_checkpointing.engine_wrap`` recomputes the whole loss call in
the backward under ``activation_checkpointing.policy``
(``runtime/activation_checkpointing.py``); ``save_checkpoint`` and
``load_checkpoint`` delegate to ``checkpoint/engine.py``.

Data parallelism (world size > 1; JAX ``engine.py:586-595, 676-681,
940-1060``): ``train_batch`` takes the GLOBAL batch, ``[gas, micro * world,
...]`` or ``[gas * micro * world, ...]``, and each rank computes on its
contiguous slice of the micro dimension (a ``data_iter`` yields this rank's
micro-batches already: ``DeepSpeedDataLoader`` with a rank and world); the
reported loss is the rank mean.

* ZeRO stage 0: each rank accumulates its fp32 gradients over ``gas`` in ONE
  flat buffer (the masters' ``.grad`` tensors are views into it), divides by
  ``loss_scale * gas``, and the step mean-reduces the buffer across ranks:
  ``all_reduce(SUM)`` and a divide (gloo has no AVG), or, where the JAX
  package's compressed DP site is eligible (stage 0, pure dp, no fp16) and
  ``compressed_collectives`` asks for it, one ``quantized_all_reduce`` (int8
  payloads, ``comm/compressed.py``; ``int8_sr`` seeded per step, rank and
  stage). Norm, clipping and the update then run on identical gradients, so
  the masters stay bitwise equal across ranks.
* ZeRO stages 1-3 (``runtime/zero/partition.py``: the leaves end to end in
  one flat buffer padded to a multiple of the world, rank r owning the
  contiguous slice r). Stage 1: full fp32 masters on every rank (views of
  one flat buffer), gradients accumulated over ``gas`` in the full flat
  buffer as at stage 0, then one mean ``reduce_scatter`` into this rank's
  fp32 shard. Stage 2 holds no full gradient buffer (JAX: the accumulators
  are dp-sharded from stage 2): a post-accumulate-grad hook on each master
  copies its gradient into its unit's buffer (a top-level subtree, as at
  stage 3) and drops it, and once the unit's last leaf has its gradient the
  buffer is mean-reduced in fp32 (buckets of ``reduce_bucket_size``), each
  rank adding its part into the shard accumulator, every micro-batch
  (``runtime/zero/stage3.py``, ``UnitReduce``). Stage 3: each rank keeps
  only its fp32 master shard, and the loss runs on compute-dtype leaves
  that gather a unit (a top-level subtree: ``embed``, ``layer_i``, ...) at
  a time on use and free it after (``runtime/zero/stage3.py``): the unit's slice of the
  shards is cast to the compute dtype and gathered (each owning rank
  broadcasts its part, in buckets of ``allgather_bucket_size``) at the
  first torch call that touches it, at most two units stay gathered
  through the forward, the backward gathers a unit again for its saved
  tensors or its remat recompute, and once a unit's leaves all have their
  gradients they are mean-reduced in fp32 (buckets of
  ``reduce_bucket_size``), each rank adding its part into the shard
  accumulator, and the unit is freed. No whole-model buffer exists. The
  cast commutes with the gather, so the forward sees the same compute
  weights as at stage 0. Then the global norm is the square root of an
  ``all_reduce`` of the shards' squared sums, the clip scales the shard, and
  the optimizer updates the shard: the Adam family (a transformation with
  an in-place ``apply``) in one fused Adam launch over ``ceil(n / world)``
  elements; any other rule (LAMB's per-tensor trust ratio, muP's per-leaf
  factor, a caller's transformation), and every run with frozen leaves,
  over this rank's fragment of each leaf (1-D views of the shard, some
  empty) under ``ops.optimizers.sharded_leaves``, which gives LAMB one
  ``all_reduce`` of its per-leaf squared norms a step and muP each leaf's
  full shape. Stages 1 and 2 all-gather the updated shard back into
  the full masters, which stay bitwise equal across ranks. fp16 overflow is
  read from the global norm, so every rank skips the same step. The
  compressed reduction is stage 0's only: other stages keep the exact one.

The imperative ``forward``/``backward``/``step`` path reduces each
micro-batch through the same transport (a reduce-scatter into the shard
accumulator at stages 1-3); ``no_sync`` defers it (at stages 2 and 3 the
units' gradients wait in one full local fp32 buffer).

What the state holds over several ranks: ``state.params`` and ``_masters``
are the full fp32 masters at stages 0-2 (one leaf each) and this rank's
fragments of them at stage 3 (1-D views into the master shard, empty where
the rank owns none of a leaf); ``state.opt_state`` holds the optimizer
state of the whole tree at stage 0 and at stages 1-3 that of this rank's
fragments of the leaves or, for the Adam family, of its flat shard (a
one-leaf list). ``utils/tensor_fragment.py`` reads and writes any leaf
at every stage. At world size 1 ZeRO stages 0-3 are the same math and all
run stage 0's path. Config sections this trainer cannot honour yet raise
``NotImplementedError`` naming their ROADMAP.md item.

``frozen_params`` (JAX ``engine.py:150-172, 343-359, 817-824``): leaves
whose path a pattern hits at a name boundary get no gradient (their
masters do not require one; at stage 3 their fragments of the reduced
gradient are zeroed), which is zero before the norm, and no update and no
optimizer state: the optimizer sees the tree with each frozen leaf replaced
by an empty node. A pattern that matches nothing raises ``ValueError``.

A loss that takes an rng (``rng``, ``rngs`` or ``key``, or three
positional parameters) gets an integer seed each micro-batch from the
engine's stream (``_next_rng``: ``config.seed``, the draw count, the dp
rank), which checkpoints save, so a resumed run draws the same dropout
masks; ``eval_batch`` passes none.

ZeRO-Offload (``zero_optimization.offload_optimizer``; JAX ``engine.py:286-308,
534-566, 864-902, 1422-1462, 1617-1634``), in the JAX package's two tiers,
chosen by its rule and logged, never because something failed:

* the host-Adam tier: ``device: cpu``, no optimizer object passed, an Adam
  type in the config, world size 1 (at world size > 1 the JAX rule takes
  the storage tier). The fp32 masters and both moments live on the host in
  ``ops/adam.DeepSpeedCPUAdam`` (``_host_adam``); the device keeps only the
  compute-dtype leaves, which are the model's parameters (``_masters`` and
  ``state.params`` hold them; ``state.opt_state`` is empty). Each leaf's
  gradient is added in fp32 into a flat fp32 accumulator on the device as
  autograd makes it and then freed (a post-accumulate-grad hook: the JAX
  package sums ``acc + g.astype(f32)``, and autograd would sum two
  micro-batches in the leaf's dtype). The step divides by ``gas``, takes
  the global norm and clips on the device in fp32; then (a non-finite norm
  skips this but counts the step) it walks the leaves laid end to end in
  chunks of ``HOST_RING_CHUNK_BYTES`` through a ring of two pinned chunk
  buffers each way: chunk k + 1 is narrowed to
  ``offload_optimizer.grad_dtype`` and copied to the host while the host
  step runs on chunk k at ``lr_schedule(global_steps + 1)``, and chunk k's
  new compute-dtype values are copied into the live leaves, stream-ordered
  before the next forward. The host needs 12P for the masters and moments
  and the ring's fixed 4 x 64 MiB. fp16 raises ``ValueError``; the
  imperative ``step`` takes the same path.
* the pinned-host storage tier: ``device: cpu`` with a caller's optimizer,
  ``device: nvme``, and world size > 1. The optimizer state lives in host
  memory between steps (pinned with a card, plain on the CPU), is copied to
  the device for the update (at stages 0-3 the fused Adam kernel) and back:
  the same kernel on the same values as without offload.

``offload_states`` / ``reload_states`` move the optimizer state or the
params to host memory or, through ``runtime/zero/swapper.py``, to files and
back (JAX ``engine.py:1923-1997``); the params' tensors keep their identity
while their storage is away; training in between raises.
"""

import contextlib
import inspect
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from .. import comm
from ..comm.compressed import configure_compression, quantized_all_reduce
from ..ops.fastpath import configure_fastpath
from ..ops.optimizers import build_optimizer, path_name, sharded_leaves
from ..ops.quant import fold_in, seeded_generator
from ..parallel.topology import Topology, TopologySpec, set_topology
from ..utils.logging import log_dist
from .config import DeepSpeedTPUConfig, load_config
from .loss_scaler import LossScaleState, make_loss_scale_state, update_loss_scale
from .lr_schedules import build_lr_schedule
from .zero.partition import FlatPartition
from .zero.sharding import ZeroShardingRules

# the control plane's remat escalation ladder: no remat -> keep only matmul
# outputs -> keep nothing (runtime/activation_checkpointing.POLICIES)
REMAT_LADDER = (None, "dots_saveable", "nothing_saveable")


def _not_ported(what: str, item: int, area: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A item {item} ({area})")


def _check_supported(config: DeepSpeedTPUConfig, world_size: int) -> None:
    """Raise for every switched-on section the trainer cannot honour yet,
    rather than ignore it."""
    dp = config.data_parallel_size
    if dp is not None and dp != world_size:
        raise _not_ported(f"data_parallel_size={dp} at world size {world_size} (a dp "
                          "degree other than the world's)", 8,
                          "model-parallel axes beside dp")
    zc = config.zero_optimization
    cc = config.compressed_collectives
    if zc.offload_param.device != "none":
        raise NotImplementedError(
            "zero_optimization.offload_param is refused on purpose: the JAX package "
            "parses it, but its engine reads none of its fields, so there is no "
            "behaviour to port (ROADMAP.md, deliberate differences)")
    checks = [
        (zc.zero_quantized_weights or zc.zero_quantized_gradients
         or zc.zero_hpz_partition_size > 1,
         "ZeRO++ (zero_quantized_weights, zero_quantized_gradients, "
         "zero_hpz_partition_size)", 8, "runtime/zero/zeropp.py"),
        ((config.pipeline.stages or 1) > 1, "pipeline.stages > 1", 8,
         "runtime/pipe/pipeline.py"),
        (config.tensor_parallel.enabled and config.tensor_parallel.tp_size > 1,
         "tensor_parallel.tp_size > 1", 8, "sharding/, module_inject/auto_tp.py"),
        (config.sequence_parallel_size > 1, "sequence_parallel_size > 1", 8,
         "sequence/{layer,ring}.py"),
        (config.moe.enabled and config.moe.ep_size > 1,
         f"moe.ep_size={config.moe.ep_size} (expert parallelism)", 8,
         "the ep axis and the moe exchange sites"),
        (cc.mode != "none" and cc.hierarchical, "compressed_collectives.hierarchical",
         8, "hierarchical_quantized_all_reduce over the expert axis split"),
        (config.comm_planner.mode != "off", "comm_planner", 9, "comm/planner/*"),
        (config.resilience.enabled, "resilience", 9, "runtime/resilience/*"),
        (config.chaos.enabled, "chaos", 9, "runtime/resilience/chaos.py"),
        (config.telemetry.enabled, "telemetry", 9, "telemetry/*"),
        (config.control.enabled, "control", 9, "control/*"),
        (config.autotuning.enabled, "autotuning", 9, "autotuning/*"),
        (config.flops_profiler.enabled, "flops_profiler", 9, "profiling/*"),
        (any(m.enabled for m in (config.monitor.tensorboard, config.monitor.wandb,
                                 config.monitor.csv_monitor, config.monitor.comet)),
         "monitor", 9, "monitor/*"),
        (config.quantize_training is not None and config.quantize_training.enabled,
         "quantize_training (MoQ)", 10, "runtime/quantize.py, compression/*"),
        (config.data_efficiency.enabled,
         "data_efficiency (curriculum, random-LTD)", 10, "runtime/data_pipeline/*"),
        (config.progressive_layer_drop.enabled, "progressive_layer_drop", 10,
         "runtime/progressive_layer_drop.py"),
        (config.hybrid_engine.enabled, "hybrid_engine", 10,
         "runtime/hybrid_engine.py"),
    ]
    for on, what, item, area in checks:
        if on:
            raise _not_ported(what, item, area)


def _recorded_event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


#: the host-Adam tier's transfer ring: chunk bytes (a power of two, so the
#: pinned allocator's power-of-two blocks waste nothing) of the wider of the
#: transport and compute dtypes, and chunk buffers in each direction
HOST_RING_CHUNK_BYTES = 1 << 26
HOST_RING_SLOTS = 2


def ring_plan(sizes: List[int], chunk: int) -> List[List[tuple]]:
    """The leaves of ``sizes`` laid end to end and cut into chunks of
    ``chunk`` elements: per chunk, ``(leaf, a, b, offset)`` for each run of
    the flattened leaf's elements ``[a, b)`` that lies in it at ``offset``."""
    plan, cur, used = [], [], 0
    for i, n in enumerate(sizes):
        a = 0
        while a < n:
            k = min(n - a, chunk - used)
            cur.append((i, a, a + k, used))
            a, used = a + k, used + k
            if used == chunk:
                plan.append(cur)
                cur, used = [], 0
    if cur:
        plan.append(cur)
    return plan


def _frozen_labels(paths: List[str], patterns) -> List[bool]:
    """Per leaf (its ``"/"``-joined path), whether it is frozen (JAX
    ``_frozen_label_tree``): a pattern hits a path at a name-component
    boundary. A pattern matching nothing raises, so a typo cannot silently
    train (and hold optimizer state for) everything."""
    def hit(pattern: str, path: str) -> bool:
        return re.search(rf"(^|[/_.\-]){re.escape(pattern)}([/_.\-]|$)", path) is not None

    unmatched = [p for p in patterns if not any(hit(p, path) for path in paths)]
    if unmatched:
        raise ValueError(f"frozen_params patterns {unmatched} match no "
                         f"parameter path; available paths include "
                         f"{paths[:8]}...")
    return [any(hit(p, path) for p in patterns) for path in paths]


def _accepts_rng(fn) -> bool:
    """Whether a loss function takes a third, rng argument (JAX
    ``_accepts_rng``): three positional parameters, or one named rng, rngs
    or key."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    n_positional = sum(1 for p in sig.parameters.values()
                       if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
    return n_positional >= 3 or any(p.name in ("rng", "rngs", "key")
                                    for p in sig.parameters.values())


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm across all gradients (reference ``clip_grad_norm_``), a 0-dim
    fp32 tensor on the gradients' device."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class TrainState:
    """Engine state: ``params`` are the fp32 master weights (the compute
    dtype's when ``bf16.master_weights`` is off), nested like the tree the
    caller gave: whole leaves at ZeRO stages 0-2, this rank's 1-D fragments
    of them at stage 3 over several ranks. ``opt_state`` covers the tree's
    trainable leaves at stage 0, and at stages 1-3 this rank's fragments of
    them or (the Adam family) its flat shard."""
    step: int
    params: Any
    opt_state: Any
    loss_scale: LossScaleState


class DeepSpeedTPUEngine:
    def __init__(self, loss_fn: Callable, params: Any, config: DeepSpeedTPUConfig,
                 optimizer=None, lr_scheduler: Optional[Callable] = None,
                 device="cuda", frozen_params: Optional[List[str]] = None,
                 topology: Optional[Topology] = None):
        from ..accelerator import resolve_device

        if isinstance(loss_fn, torch.nn.Module):
            raise TypeError("model must be a loss function f(params, batch[, rng]); "
                            "for a TransformerLM pass make_loss_fn(model)")
        world = comm.get_world_size()
        self.config = config
        config.finalize(world_dp_size=world)
        _check_supported(config, world)
        self.device = resolve_device(device)
        self.topo = topology if topology is not None else Topology()
        set_topology(self.topo)
        self.dp_world = self.topo.dp_size
        self.dp_rank = comm.axis_index(self.topo.dp_axes)
        zc = config.zero_optimization
        # raises for MiCS (mics_shard_size > 0), whose ep axis is item 8's
        self.rules = ZeroShardingRules(zc.stage, self.topo,
                                       mics_shard_size=zc.mics_shard_size)
        comm.configure(comms_logger=config.comms_logger)
        self._dp_grad_mode = self._resolve_dp_grad_site()
        tf = config.training_fastpath
        configure_fastpath(attn_impl=tf.attn_impl, loss_impl=tf.loss_impl,
                           embedding_overlap=tf.embedding_overlap)
        self.loss_fn_raw = loss_fn
        # a loss that takes an rng gets a fresh seed every micro-batch
        # (_next_rng), from config.seed
        self._loss_takes_rng = _accepts_rng(loss_fn)
        self._rng_draws = 0
        # engine-level remat (JAX engine.py): with engine_wrap, ``policy``
        # wraps the whole loss call (an unknown policy raises here); None
        # never wraps
        ac = config.activation_checkpointing
        self._remat_policy = ac.policy if ac.engine_wrap else None
        self._loss_call = loss_fn
        if self._remat_policy is not None:
            from .activation_checkpointing import checkpoint_wrapper

            self._loss_call = checkpoint_wrapper(loss_fn, self._remat_policy)
        self.data_sampler = None   # a resumable loader, saved with the checkpoint
        self.gas = config.gradient_accumulation_steps
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size

        # --- precision ---------------------------------------------------
        self.compute_dtype = config.compute_dtype
        self.fp16 = config.fp16.enabled
        self.master_weights = config.bf16.master_weights if config.bf16.enabled else True

        # --- ZeRO-Offload: the tier, by the JAX package's rule -------------
        off = zc.offload_optimizer
        self._grad_transport = off.transport_dtype()      # raises for fp16
        self._offload_optimizer = off.device in ("cpu", "nvme")
        self._host_adam = None
        self._host_adam_mode = (
            off.device == "cpu" and optimizer is None
            and config.optimizer.type.lower().replace("_", "") in
            ("adam", "adamw", "fusedadam", "cpuadam", "deepspeedcpuadam"))
        if self._host_adam_mode and self.fp16:
            raise ValueError(
                "fp16 dynamic loss scaling is not supported with "
                "offload_optimizer.device='cpu' (the host Adam step runs outside the "
                "scaled step); use bf16")
        if self._host_adam_mode and world > 1:
            # the host step needs every rank's whole gradient: over several
            # ranks the JAX rule keeps the state on the host between steps
            # and updates it on the device
            log_dist("offload_optimizer.device=cpu: world size > 1 — pinned-host "
                     "optimizer state with the update on the device (the storage tier)")
            self._host_adam_mode = False
        self._offloaded: Dict[str, tuple] = {}
        self._swappers: Dict[str, Any] = {}
        #: seconds of the last host-Adam step's phases (``offload_timings``)
        self._offload_marks: Optional[dict] = None

        if callable(params) and not isinstance(params, torch.Tensor):
            # zero.Init or a bare zero-arg closure (JAX engine.py:503-518):
            # its tree is built here and dropped once the masters (at stage
            # 3 over several ranks: this rank's shard) are taken from it
            params = params()
        keypaths = [kp for kp, _ in pytree.tree_flatten_with_path(params)[0]]
        self._keypaths = [tuple(kp) for kp in keypaths]
        self._paths = [path_name(kp) for kp in keypaths]

        # --- frozen parameters (JAX engine.py:343-359): no gradient, no
        # update, no optimizer state ---------------------------------------
        self._frozen = _frozen_labels(self._paths, tuple(frozen_params or ()))
        if any(self._frozen) and self._host_adam_mode:
            log_dist("frozen_params: host-Adam offload tier does not mask updates — "
                     "using pinned-host state with on-device compute instead")
            self._host_adam_mode = False

        # --- optimizer ---------------------------------------------------
        opt_params = dict(config.optimizer.params)
        base_lr = opt_params.get("lr", 1e-3)
        self.lr_schedule = lr_scheduler or build_lr_schedule(
            config.scheduler.type, dict(config.scheduler.params), base_lr)
        if optimizer is not None and callable(optimizer) and not hasattr(optimizer, "update"):
            # a client factory (reference DeepSpeedOptimizerCallable): called
            # with the tree's structure and shapes, as meta tensors (JAX
            # passes the abstract tree)
            optimizer = optimizer(pytree.tree_map(
                lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params))
            if not hasattr(optimizer, "update"):
                raise TypeError(
                    "optimizer callable must return an optax "
                    f"GradientTransformation, got {type(optimizer).__name__}")
            log_dist("using client callable to create basic optimizer")
        if optimizer is not None:
            if not hasattr(optimizer, "update"):
                raise TypeError("optimizer must be a GradientTransformation "
                                f"(init/update), got {type(optimizer).__name__}")
            self.tx = optimizer
        else:
            opt_params["lr"] = self.lr_schedule if config.scheduler.type else base_lr
            self.tx = build_optimizer(config.optimizer.type, opt_params)

        self._build_state(params)
        self._compat_acc: Optional[torch.Tensor] = None   # reduced micro-batch grads
        self._pending_local = False   # flat buffer holds grads not reduced yet
        self._compat_count = 0
        self._compat_pending = False
        self._no_sync_depth = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self._metrics_dev: Dict[str, Any] = {}
        tier = ("host Adam" if self._host_adam_mode else
                "pinned-host storage" if self._offload_optimizer else "none")
        log_dist(f"engine initialized on {self.device}: zero_stage="
                 f"{config.zero_optimization.stage}, gas={self.gas}, "
                 f"micro_bs={self.micro_batch_size}, dtype={self.compute_dtype}, "
                 f"dp={self.dp_world}, dp_grad_reduce={self._dp_grad_mode or 'exact'}, "
                 f"optimizer offload={tier}")

    def _resolve_dp_grad_site(self) -> Optional[str]:
        """The compressed mode of the DP gradient reduction, or None for the
        exact all-reduce (JAX ``engine.py:664-690``): the site needs pure
        data parallelism at ZeRO stage 0 over more than one rank, no
        ``moe`` section (its expert gradients keep the exact reduction), and
        no fp16, whose overflow check needs the non-finite values the exact
        reduction carries."""
        cc = self.config.compressed_collectives
        configure_compression(cc.mode, block=cc.block, hierarchical=cc.hierarchical,
                              sites=cc.site_map())
        eligible = (self.config.zero_optimization.stage == 0 and self.dp_world > 1
                    and not self.config.moe.enabled and not self.config.fp16.enabled)
        if cc.mode == "none" or not cc.dp_gradients:
            return None
        if not eligible:
            log_dist("compressed_collectives: DP gradient site needs pure data "
                     "parallelism at ZeRO stage 0 without fp16 loss scaling — keeping "
                     "the exact reduction (ZeRO++/MoE/Ulysses sites gate separately)")
            return None
        return cc.mode

    # ------------------------------------------------------------------
    def _build_state(self, params):
        store = torch.float32 if self.master_weights else self.compute_dtype
        leaves, self._spec = pytree.tree_flatten(params)
        for p in leaves:
            if not p.is_floating_point():
                raise ValueError(f"model_parameters must be floating tensors, got {p.dtype}")
        self._flat_grad = None
        self._zero: Optional[FlatPartition] = None
        self._leafwise = False  # stages 1-3: the optimizer sees leaf fragments
        self._stage3 = False
        self._z3 = None         # stage 3's unit gatherer (runtime/zero/stage3.py)
        self._units = None      # stages 2-3: the units' gradient reduction
        if self._host_adam_mode:
            opt_state = self._build_host_adam(leaves)
        elif self.dp_world > 1 and self.config.zero_optimization.stage >= 1:
            opt_state = self._build_zero(leaves, store)
        else:
            # .to() returns the tensor itself when it already has this
            # device and dtype: such parameters are trained in place
            self._masters = [p.detach().to(self.device, store).requires_grad_(not f)
                             for p, f in zip(leaves, self._frozen)]
            if self.dp_world > 1:
                # one flat buffer, reduced with one collective per step: the
                # masters' .grad are views into it, which autograd
                # accumulates into in place
                self._flat_grad = torch.zeros(sum(p.numel() for p in self._masters),
                                              dtype=store, device=self.device)
                offset = 0
                for p in self._masters:
                    p.grad = self._flat_grad[offset:offset + p.numel()].view_as(p)
                    offset += p.numel()
            opt_state = self.tx.init(self._opt_tree(self._masters))
        if self._offload_optimizer and not self._host_adam_mode:
            opt_state = pytree.tree_map(self._to_host_storage, opt_state)
        ls = make_loss_scale_state(self.config.fp16.initial_scale_power,
                                   self.config.fp16.loss_scale,
                                   self.config.fp16.hysteresis)
        self.state = TrainState(step=0, params=self._tree(self._masters),
                                opt_state=opt_state, loss_scale=ls)

    def _build_zero(self, leaves, store):
        """The flat partition of stages 1-3: the masters, this rank's shard
        of them and of the gradients; returns the optimizer state over the
        shard."""
        part = FlatPartition([p.shape for p in leaves], self.dp_world, self.dp_rank,
                             self.topo.dp_axes)
        self._zero = part
        self._stage3 = self.config.zero_optimization.stage >= 3
        if self._stage3:
            # only this rank's shard reaches the device
            self._master_shard = torch.zeros(part.shard, dtype=store, device=self.device)
            for i, p in enumerate(leaves):
                a, b = part.span(i)
                part.fragment(self._master_shard, i).copy_(p.detach().reshape(-1)[a:b])
            self._masters = [part.fragment(self._master_shard, i)
                             for i in range(len(leaves))]
        else:
            # stage 1 accumulates the step's gradients in a full flat buffer
            # (the masters' .grad are views into it); stage 2 holds none
            stage1 = self.config.zero_optimization.stage == 1
            self._flat_master = torch.zeros(part.padded, dtype=store, device=self.device)
            if stage1:
                self._flat_grad = torch.zeros_like(self._flat_master)
            self._masters = []
            for i, p in enumerate(leaves):
                master = part.leaf(self._flat_master, i)
                master.copy_(p.detach())
                master = master.detach().requires_grad_(not self._frozen[i])
                if stage1:
                    master.grad = part.leaf(self._flat_grad, i)
                self._masters.append(master)
            self._master_shard = self._flat_master[part.start:part.start + part.shard]
        self._shard_grad = torch.zeros(part.shard, dtype=store, device=self.device)
        zc = self.config.zero_optimization
        if zc.stage >= 2:
            from .zero.stage3 import UnitGather, UnitReduce, tree_units

            paths = [kp for kp, _ in pytree.tree_flatten_with_path(self._tree(leaves))[0]]
            if self._stage3:
                self._z3 = self._units = UnitGather(
                    part, tree_units(paths), self._master_shard, self._shard_grad,
                    self.compute_dtype, zc.allgather_bucket_size, zc.reduce_bucket_size)
            else:
                # each unit's gradients are reduce-scattered into the shard
                # as the backward finishes them
                self._units = UnitReduce(part, tree_units(paths), self._shard_grad,
                                         zc.reduce_bucket_size,
                                         trainable=[not f for f in self._frozen])
                for u, (_, i0, i1, lo, _) in enumerate(self._units.units):
                    for i in range(i0, i1):
                        if not self._frozen[i]:
                            self._masters[i].register_post_accumulate_grad_hook(
                                self._units.grad_hook(u, part.offsets[i] - lo))
        # the Adam family (an in-place ``apply``) updates the shard as one
        # flat tensor; any other rule, and any run with frozen leaves, gets
        # this rank's fragment of each leaf
        self._leafwise = getattr(self.tx, "apply", None) is None or any(self._frozen)
        if self._leafwise:
            return self.tx.init(self._opt_tree(self._fragments(self._master_shard)))
        return self.tx.init([self._master_shard])

    def _fragments(self, shard: torch.Tensor) -> List[torch.Tensor]:
        return [self._zero.fragment(shard, i) for i in range(len(self._zero.shapes))]

    def _opt_tree(self, leaves):
        """The tree the optimizer sees: ``leaves`` in the parameters'
        structure, a frozen leaf replaced by an empty node (JAX routes it to
        ``set_to_zero``: no state, no update)."""
        return self._tree([() if f else x for x, f in zip(leaves, self._frozen)])

    def _build_host_adam(self, leaves):
        """The host-Adam tier: fp32 masters and moments on the host, the
        compute-dtype leaves on the device (fresh tensors: their hooks must
        not reach the caller's), one flat fp32 gradient accumulator beside
        them, and the plan of the step's walk: the leaves laid end to end
        and cut into chunks of ``HOST_RING_CHUNK_BYTES`` (a leaf may span
        chunks), which pass through a ring of ``HOST_RING_SLOTS`` chunk
        buffers each way, pinned at the first step when the device is the
        card. Returns the (empty) device optimizer state."""
        from ..ops.adam import DeepSpeedCPUAdam

        op = dict(self.config.optimizer.params)
        self._host_adam = DeepSpeedCPUAdam(
            self._tree(leaves), lr=op.get("lr", 1e-3),
            betas=tuple(op.get("betas", (0.9, 0.999))), eps=op.get("eps", 1e-8),
            weight_decay=op.get("weight_decay", 0.0),
            adamw_mode=op.get("adam_w_mode", op.get("adamw_mode", True)),
            bias_correction=op.get("bias_correction", True))
        self._masters = [p.detach().to(self.device, self.compute_dtype, copy=True)
                         .contiguous().requires_grad_(True) for p in leaves]
        sizes = [p.numel() for p in self._masters]
        self._acc = torch.zeros(sum(sizes), dtype=torch.float32, device=self.device)
        self._acc_leaves = [v.view_as(p) for v, p in
                            zip(torch.split(self._acc, sizes), self._masters)]
        for p, acc in zip(self._masters, self._acc_leaves):
            p.register_post_accumulate_grad_hook(self._accumulate_into(acc))
        width = max(torch.empty(0, dtype=d).element_size()
                    for d in (self._grad_transport, self.compute_dtype))
        self._ring_chunk = max(1, HOST_RING_CHUNK_BYTES // width)
        self._ring_plan = ring_plan(sizes, self._ring_chunk)
        self._ring = None
        self._offload_walk_s = 0.0
        return ()

    @staticmethod
    def _accumulate_into(acc: torch.Tensor):
        def hook(p: torch.Tensor) -> None:
            acc.add_(p.grad)      # the leaf's gradient widened exactly, summed in fp32
            p.grad = None
        return hook

    def _to_host_storage(self, x):
        """The storage tier's home of an optimizer-state tensor: host memory,
        pinned when the device is the card."""
        if not isinstance(x, torch.Tensor):
            return x
        host = torch.empty_like(x, device="cpu", pin_memory=self.device.type == "cuda")
        host.copy_(x)
        return host

    def _tree(self, leaves):
        return pytree.tree_unflatten(list(leaves), self._spec)

    def _next_rng(self) -> int:
        """The next seed of the engine's stream (JAX: the step key split per
        micro-batch): draw k gives ``fold_in(fold_in(config.seed, k), dp
        rank)``, so every micro-batch and rank gets its own masks and a run
        resumed at draw k (``_rng_draws``, saved in checkpoints) draws what
        an uninterrupted run draws."""
        seed = fold_in(fold_in(self.config.seed, self._rng_draws), self.dp_rank)
        self._rng_draws += 1
        return seed

    def _loss(self, batch, rng: Optional[int] = None) -> torch.Tensor:
        """The loss of one micro-batch on the compute copy of the masters
        (autograd runs through the cast, so gradients land in fp32); at
        stage 3 on the unit leaves, which gather on use (the caller holds
        ``_z3.on_use()`` open). ``rng`` reaches a loss that takes one."""
        if self._z3 is not None:
            compute = self._z3.leaves
        else:
            compute = [p.to(self.compute_dtype) for p in self._masters]
        args = (self._tree(compute), batch) + ((rng,) if self._loss_takes_rng else ())
        return self._loss_call(*args).float()

    def _backward_micro(self, batch, scale: float) -> torch.Tensor:
        rng = self._next_rng() if self._loss_takes_rng else None
        if self._units is not None:
            # stages 2-3: each unit's gradients are reduced into the shard
            # accumulator as the backward finishes them (added into the full
            # local buffer inside no_sync)
            units, z = self._units, self._z3
            units.defer = self._no_sync_depth > 0
            with torch.enable_grad(), (z.on_use() if z is not None
                                       else contextlib.nullcontext()):
                loss = self._loss(batch, rng)
                if z is not None:
                    z.run_backward(loss * scale)
                else:
                    (loss * scale).backward()
                units.finish()
            return loss.detach()
        with torch.enable_grad():
            loss = self._loss(batch, rng)
            (loss * scale).backward()
        return loss.detach()

    def _grads(self) -> List[torch.Tensor]:
        if self._host_adam is not None:
            return self._acc_leaves
        for p in self._masters:
            if p.grad is None:   # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self._masters]

    def _sr_generator(self, *data: int) -> Optional[torch.Generator]:
        """The dither generator of an ``int8_sr`` reduction, from the config
        seed and ``data`` (the step, the micro-batch), as the JAX engine
        folds ``0x0151`` into its step key; None for the other modes."""
        if self._dp_grad_mode != "int8_sr":
            return None
        seed = self.config.seed
        for d in data + (0x0151,):
            seed = fold_in(seed, d)
        return seeded_generator(seed)

    def _reduce_grads(self, generator: Optional[torch.Generator]) -> None:
        """Mean-reduce the flat gradient buffer across the dp ranks in place:
        exact (SUM, then a divide) or the compressed int8 all-reduce."""
        axis = self.topo.dp_axes
        if self._dp_grad_mode is None:
            comm.all_reduce(self._flat_grad, axis, op="mean")
            return
        cc = self.config.compressed_collectives
        red = quantized_all_reduce(self._flat_grad, axis, block=cc.block,
                                   stochastic=self._dp_grad_mode == "int8_sr",
                                   generator=generator)
        self._flat_grad.copy_(red)

    def _rank_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss averaged over the dp ranks (JAX ``lax.pmean``)."""
        if self.dp_world > 1:
            comm.all_reduce(loss, self.topo.dp_axes, op="mean")
        return loss

    def _apply(self, reduced: bool = False) -> Dict[str, Any]:
        """Unscale, reduce across the dp ranks (unless ``reduced``), norm,
        clip, update (or skip on fp16 overflow), and reset the accumulators;
        returns the step's metrics (device tensors)."""
        if self._host_adam is not None:
            return self._apply_host()
        cfg = self.config
        ls = self.state.loss_scale
        scale = ls.scale if self.fp16 else 1.0
        if self._zero is not None:
            grads = [self._shard_grad]
            norm = self._unscale_shard(scale, reduced)
        else:
            grads = self._grads()
            for g in grads:
                g.div_(scale * self.gas)
            if self.dp_world > 1 and not reduced:
                self._reduce_grads(self._sr_generator(self.state.step))
            # frozen gradients are zeroed before the norm (JAX
            # engine.py:817-824), so they neither count nor clip
            for g, f in zip(grads, self._frozen):
                if f:
                    g.zero_()
            norm = global_grad_norm(grads)
        overflow = self.fp16 and not bool(torch.isfinite(norm))
        clip = cfg.gradient_clipping
        if clip and clip > 0:
            coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
        step = self.state.step
        if not overflow:
            with torch.no_grad():
                if self._zero is not None and self._leafwise:
                    shapes = dict(zip(self._paths, self._zero.shapes))
                    reduce = lambda v: comm.all_reduce(v, self.topo.dp_axes, op="sum")
                    with sharded_leaves(shapes, reduce):
                        self._update(self._opt_tree(self._fragments(self._shard_grad)),
                                     self._opt_tree(self._fragments(self._master_shard)))
                elif self._zero is not None:
                    self._update(grads, [self._master_shard])
                if self._zero is not None:
                    if not self._stage3:
                        self._zero.all_gather_flat(
                            self._master_shard, cfg.zero_optimization.allgather_bucket_size,
                            out=self._flat_master)
                else:
                    self._update(self._opt_tree(grads), self._opt_tree(self._masters))
        for g in grads:
            g.zero_()
        self.state.loss_scale = update_loss_scale(
            ls, overflow, dynamic=self.fp16 and cfg.fp16.loss_scale == 0,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale, max_hysteresis=cfg.fp16.hysteresis,
            consecutive_hysteresis=cfg.fp16.consecutive_hysteresis)
        self.state.step = step + 1
        self.skipped_steps += int(overflow)
        return {"grad_norm": norm, "lr": float(self.lr_schedule(step + 1)),
                "loss_scale": ls.scale, "overflow": overflow}

    def _apply_host(self) -> Dict[str, Any]:
        """The host-Adam tier's step (JAX ``_host_offload_step`` and
        ``_apply_host_adam``): divide the fp32 accumulator by ``gas``, norm
        and clip on the device; then, if the norm is finite, the walk
        (:meth:`_host_walk`) at ``lr_schedule(global_steps + 1)``. The step
        counts either way."""
        self._acc.div_(self.gas)
        norm = global_grad_norm(self._acc_leaves)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            self._acc.mul_(torch.clamp(clip / (norm + 1e-6), max=1.0))
        finite = bool(torch.isfinite(norm))
        lr = float(self.lr_schedule(self.global_steps + 1))
        self._offload_marks = self._host_walk(lr) if finite else {}
        self._acc.zero_()
        step = self.state.step
        self.state.step = step + 1
        return {"grad_norm": norm, "lr": lr, "loss_scale": 1.0, "overflow": not finite}

    def _ring_buffers(self):
        """The ring's chunk buffers, (gradients, parameters), made at the
        first step: pinned when the device is the card."""
        if self._ring is None:
            pin = self.device.type == "cuda"
            make = lambda dt: [torch.empty(self._ring_chunk, dtype=dt, pin_memory=pin)
                               for _ in range(HOST_RING_SLOTS)]
            self._ring = make(self._grad_transport), make(self.compute_dtype)
        return self._ring

    def _host_walk(self, lr: float) -> Dict[str, Any]:
        """One host step over the ring, chunk by chunk: narrow chunk k + 1
        to the transport dtype and copy it to the host while the host step
        runs on chunk k, then copy chunk k's new compute-dtype values into
        the live leaves. On the card every copy is asynchronous on the
        current stream (the last ones land before the next forward), and a
        slot is written again only once the copy that last read it is done;
        on the CPU the same walk copies synchronously. Returns each phase's
        time: per copy direction a list of CUDA event pairs on the card,
        host seconds on the CPU; the host step's host seconds."""
        cuda = self.device.type == "cuda"
        g_ring, p_ring = self._ring_buffers()
        acc = [a.view(-1) for a in self._acc_leaves]
        live = [p.detach().view(-1) for p in self._masters]
        plan, slots = self._ring_plan, HOST_RING_SLOTS
        marks: Dict[str, Any] = {"d2h": [] if cuda else 0.0, "host_adam": 0.0,
                                 "h2d": [] if cuda else 0.0}
        emit = self.compute_dtype == torch.bfloat16

        def copies(key, pairs):
            t0 = _recorded_event() if cuda else time.perf_counter()
            for dst, src in pairs:
                dst.copy_(src, non_blocking=cuda)
            if not cuda:
                marks[key] += time.perf_counter() - t0
                return None
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            marks[key].append((t0, end))
            return end

        def send(k):
            g = g_ring[k % slots]
            return copies("d2h", [(g[o:o + b - a], acc[i][a:b].to(self._grad_transport))
                                  for i, a, b, o in plan[k]])

        self._host_adam.begin_step()
        t_walk = time.perf_counter()
        with torch.no_grad():
            arrived = send(0)
            for k, chunk in enumerate(plan):
                if cuda:
                    arrived.synchronize()
                    if k >= slots:        # the copy that last read this slot
                        marks["h2d"][k - slots][1].synchronize()
                nxt = send(k + 1) if k + 1 < len(plan) else None
                g, out = g_ring[k % slots], p_ring[k % slots]
                t0 = time.perf_counter()
                self._host_adam.step_slices(
                    [(i, a, b, g[o:o + b - a], out[o:o + b - a]) for i, a, b, o in chunk],
                    lr=lr, emit_bf16=emit)
                marks["host_adam"] += time.perf_counter() - t0
                copies("h2d", [(live[i][a:b], out[o:o + b - a]) for i, a, b, o in chunk])
                arrived = nxt
        self._offload_walk_s = time.perf_counter() - t_walk
        return marks

    def offload_timings(self) -> Dict[str, float]:
        """Seconds of the last host-Adam step's phases, each summed over the
        ring's chunks: ``d2h`` (narrowing and the copies to the host),
        ``host_adam`` and ``h2d`` (the copies into the live leaves; waited
        for here), from CUDA events on the card and the host clock on the
        CPU. The phases overlap; the walk's wall time is
        ``_offload_walk_s``. {} before a step and after a skipped one."""
        out = {}
        for key, mark in (self._offload_marks or {}).items():
            if isinstance(mark, list):
                if mark:
                    mark[-1][1].synchronize()
                mark = sum(a.elapsed_time(b) for a, b in mark) / 1e3
            out[key] = mark
        return out

    def _unscale_shard(self, scale: float, reduced: bool) -> torch.Tensor:
        """Stages 1-3: this rank's shard of the step's gradient, divided by
        ``scale * gas``, and the global norm. At stage 1 ``train_batch``
        leaves the gas-sum in the full buffer, which is divided (as at stage
        0) and reduce-scattered here; otherwise the shard accumulator holds
        it already. The norm is the square root of the ranks' summed squared
        shard norms, so every rank reads the same value. Frozen leaves'
        fragments are zeroed first."""
        if reduced or self.config.zero_optimization.stage >= 2:
            self._shard_grad.div_(scale * self.gas)
        else:
            self._flat_grad.div_(scale * self.gas)
            self._zero.reduce_scatter_flat(
                self._flat_grad, self._shard_grad,
                self.config.zero_optimization.reduce_bucket_size, accumulate=False)
            self._flat_grad.zero_()
        for i, f in enumerate(self._frozen):
            if f:
                self._zero.fragment(self._shard_grad, i).zero_()
        sq = torch.linalg.vector_norm(self._shard_grad).square().reshape(1)
        comm.all_reduce(sq, self.topo.dp_axes, op="sum")
        return sq.sqrt()[0]

    def _update(self, grads, params):
        """One optimizer step of ``params`` (a tree congruent with the
        optimizer state) in place."""
        home = self.state.opt_state
        if self._offload_optimizer:
            # the storage tier: the state visits the device for the update
            self.state.opt_state = self._opt_on_device(home)
        apply = getattr(self.tx, "apply", None)
        leaves = pytree.tree_leaves(params)
        if apply is not None and all(p.dtype == torch.float32 for p in leaves):
            self.state.opt_state = apply(grads, self.state.opt_state, params)
        else:
            updates, self.state.opt_state = self.tx.update(grads, self.state.opt_state,
                                                           params)
            for p, u in zip(leaves, pytree.tree_leaves(updates)):
                p.copy_((p.float() + u.float()).to(p.dtype))
        if self._offload_optimizer:
            self.state.opt_state = self._opt_back_home(self.state.opt_state, home)

    def _opt_on_device(self, tree):
        return pytree.tree_map(
            lambda x: x.to(self.device, non_blocking=True) if isinstance(x, torch.Tensor)
            else x, tree)

    def _opt_back_home(self, tree, home):
        """Copy the updated state into its host tensors (``home``), one wait;
        the non-tensor leaves (the step) come from ``tree``."""
        new, spec = pytree.tree_flatten(tree)
        out = []
        for x, h in zip(new, pytree.tree_leaves(home)):
            if isinstance(x, torch.Tensor):
                h.copy_(x, non_blocking=True)
                x = h
            out.append(x)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return pytree.tree_unflatten(out, spec)

    # the whole tree at every stage (checkpoints, utils/tensor_fragment) -
    def _full_param(self, i: int) -> torch.Tensor:
        """Leaf i of the masters in full: gathered at stage 3 over several
        ranks (a collective: every rank calls it), else the master itself."""
        if self._stage3:
            return self._zero.gather(self._master_shard, i)
        if self._host_adam is not None:
            return self._host_adam.leaves()[0][i].to(self.device)
        return self._masters[i].detach()

    def _set_full_param(self, i: int, value: torch.Tensor) -> None:
        """Write a full value of leaf i into the masters (at stage 3: this
        rank's fragment of it; under the host-Adam tier the host master and
        its compute-dtype leaf on the device)."""
        shape = self._zero.shapes[i] if self._zero is not None else tuple(self._masters[i].shape)
        if tuple(value.shape) != shape:
            raise ValueError(f"parameter {i}: shape {tuple(value.shape)} does not match "
                             f"the engine's {shape}")
        if self._host_adam is not None:
            self._host_adam.leaves()[0][i].copy_(value)
            with torch.no_grad():
                self._masters[i].copy_(self._host_adam.leaves()[0][i])
        elif self._stage3:
            self._zero.scatter(self._master_shard, i, value.to(self._master_shard.device))
        else:
            with torch.no_grad():
                self._masters[i].copy_(value)

    def _opt_layout(self):
        """The leaves and structure of the optimizer state as stage 0 lays
        it out (``tx.init`` over the whole tree, on the meta device). At
        stages 1-3 each tensor leaf of the sharded state stands for one run
        of parameter-congruent tensors of this layout."""
        meta = self._tree([torch.empty(s, dtype=self._master_shard.dtype, device="meta")
                           for s in self._zero.shapes])
        return pytree.tree_flatten(self.tx.init(meta))

    def _state_owners(self, state) -> List[Optional[int]]:
        """For each leaf of an optimizer state over the (masked) parameter
        tree, the index of the parameter it belongs to (the longest
        parameter key path its own key path ends with), or None for the
        leaves no parameter owns (a step count)."""
        owners = []
        for kp, x in pytree.tree_flatten_with_path(state)[0]:
            hit = None
            if isinstance(x, torch.Tensor):
                for i, pp in enumerate(self._keypaths):
                    if (0 < len(pp) <= len(kp) and tuple(kp[-len(pp):]) == pp
                            and (hit is None or len(pp) > len(self._keypaths[hit]))):
                        hit = i
            owners.append(hit)
        return owners

    def _full_opt_state(self, keep: Callable):
        """Stages 1-3: the optimizer state in its stage-0 layout, every
        shard tensor (or, leaf by leaf, every fragment) gathered leaf by
        leaf (a collective) and passed through ``keep`` (e.g. to the host,
        or to None where it is not needed)."""
        opt_state = self.state.opt_state
        if self._offload_optimizer:
            opt_state = self._opt_on_device(opt_state)    # the storage tier
        if self._leafwise:
            leaves, spec = pytree.tree_flatten(opt_state)
            return pytree.tree_unflatten(
                [x if i is None else keep(self._zero.gather_fragment(x, i))
                 for x, i in zip(leaves, self._state_owners(opt_state))], spec)
        layout, spec = self._opt_layout()
        n = len(self._zero.shapes)
        out = []
        for leaf in pytree.tree_leaves(opt_state):
            if isinstance(layout[len(out)], torch.Tensor):
                out.extend(keep(self._zero.gather(leaf, i)) for i in range(n))
            else:
                out.append(leaf)
        return pytree.tree_unflatten(out, spec)

    def _load_opt_state(self, leaves: List[Any]) -> None:
        """Stages 1-3: the optimizer state from the leaves of its stage-0
        layout, this rank's part of each tensor written into its shard."""
        cur, spec = pytree.tree_flatten(self.state.opt_state)
        if self._leafwise:
            if len(leaves) != len(cur):
                raise ValueError(f"optimizer state has {len(leaves)} leaves, the engine's "
                                 f"stage-0 layout {len(cur)}")
            new = []
            for k, (x, i) in enumerate(zip(cur, self._state_owners(self.state.opt_state))):
                if i is None:
                    new.append(leaves[k])
                    continue
                if tuple(leaves[k].shape) != self._zero.shapes[i]:
                    raise ValueError(f"optimizer leaf {k}: shape {tuple(leaves[k].shape)}, "
                                     f"the engine's {self._zero.shapes[i]}")
                a, b = self._zero.span(i)
                x.copy_(leaves[k].reshape(-1)[a:b])
                new.append(x)
            self.state.opt_state = pytree.tree_unflatten(new, spec)
            return
        layout, _ = self._opt_layout()
        if len(leaves) != len(layout):
            raise ValueError(f"optimizer state has {len(leaves)} leaves, the engine's "
                             f"stage-0 layout {len(layout)}")
        new, k = [], 0
        for leaf in cur:
            if isinstance(layout[k], torch.Tensor):
                for i, shape in enumerate(self._zero.shapes):
                    if tuple(leaves[k + i].shape) != shape:
                        raise ValueError(f"optimizer leaf {k + i}: shape "
                                         f"{tuple(leaves[k + i].shape)}, the engine's {shape}")
                    self._zero.scatter(leaf, i, leaves[k + i].to(leaf.device))
                new.append(leaf)
                k += len(self._zero.shapes)
            else:
                new.append(leaves[k])
                k += 1
        self.state.opt_state = pytree.tree_unflatten(new, spec)

    # ------------------------------------------------------------------
    def _shape_batch(self, batch):
        gas = self.gas

        def reshape(x):
            x = torch.as_tensor(x, device=self.device)
            if x.dim() >= 1 and x.shape[0] == gas:
                return x
            if x.shape[0] % gas:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by gas={gas}")
            return x.reshape(gas, x.shape[0] // gas, *x.shape[1:])

        return pytree.tree_map(reshape, batch)

    def _rank_slice(self, batch, dim: int):
        """This rank's contiguous share of ``dim`` of every batch leaf."""
        if self.dp_world == 1:
            return batch

        def take(x):
            m = x.shape[dim]
            if m % self.dp_world:
                raise ValueError(f"batch dim {dim} of size {m} is not divisible by the "
                                 f"{self.dp_world} data-parallel ranks")
            k = m // self.dp_world
            return x.narrow(dim, self.dp_rank * k, k)

        return pytree.tree_map(take, batch)

    def train_batch(self, batch=None, data_iter=None):
        """One full training step: ``gas`` micro-batches and the optimizer
        update. ``batch`` is the global batch: leaves ``[gas, micro * dp,
        ...]`` or ``[gas * micro * dp, ...]``, of which this rank takes its
        slice of the micro dimension; ``data_iter`` yields this rank's
        micro-batches. Returns the mean micro-batch loss over all ranks (a
        0-dim tensor on the device)."""
        if self._no_sync_depth > 0:
            raise RuntimeError("train_batch() applies the optimizer and is "
                               "incompatible with an open no_sync() context")
        self._check_states_home()
        if self._compat_count > 0:
            raise RuntimeError(
                f"train_batch() called with {self._compat_count} accumulated "
                "microbatch gradient(s) pending from backward(); finish the "
                "window with backward()+step() or discard it with zero_grad()")
        if batch is None:
            # this rank's micro-batches, each moved to the device (no copy
            # when a prefetching loader put it there already)
            micro = [pytree.tree_map(lambda x: torch.as_tensor(x, device=self.device),
                                     next(data_iter)) for _ in range(self.gas)]
        else:
            batch = self._rank_slice(self._shape_batch(batch), 1)
            micro = [pytree.tree_map(lambda x: x[i], batch) for i in range(self.gas)]
        scale = self.state.loss_scale.scale if self.fp16 else 1.0
        losses = []
        for mb in micro:
            losses.append(self._backward_micro(mb, scale))
        metrics = self._apply()
        metrics["loss"] = self._rank_mean(torch.stack(losses).mean())
        self._metrics_dev = metrics
        self.global_steps += 1
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                     f"lr={metrics['lr']:.3e} grad_norm={float(metrics['grad_norm']):.3f}")
        return metrics["loss"]

    def eval_batch(self, batch, compute_loss: bool = True) -> float:
        batch = pytree.tree_map(lambda x: torch.as_tensor(x, device=self.device), batch)
        with torch.no_grad(), (self._z3.on_use() if self._z3 is not None
                               else contextlib.nullcontext()):
            return float(self._loss(batch))

    # ------------------------------------------------------------------
    # reference-compat imperative API: forward -> backward (x gas) -> step
    # ------------------------------------------------------------------
    def forward(self, batch) -> float:
        """The loss of one micro-batch. Its gradients are accumulated at
        once (the JAX package fuses the two passes too), so a following
        ``backward()`` only returns this loss. Over several ranks ``batch``
        is the global micro-batch, of which this rank takes its slice of
        dim 0; its gradients are mean-reduced at once (outside ``no_sync``)
        and the loss is the rank mean."""
        batch = pytree.tree_map(lambda x: torch.as_tensor(x, device=self.device), batch)
        batch = self._rank_slice(batch, 0)
        scale = self.state.loss_scale.scale if self.fp16 else 1.0
        loss = self._backward_micro(batch, scale)
        if self.dp_world > 1:
            self._pending_local = True
            if self._no_sync_depth == 0:
                self._reduce_pending()
        self._compat_loss = float(self._rank_mean(loss))
        self._compat_pending = True
        self._compat_count += 1
        return self._compat_loss

    def backward(self, loss=None, batch=None) -> float:
        """Close one micro-batch: after ``forward`` its gradients are already
        accumulated; ``backward(batch=...)`` without a ``forward`` runs both.
        ``loss`` is accepted for API compatibility."""
        if batch is not None and not self._compat_pending:
            self.forward(batch)
        if not self._compat_pending:
            raise ValueError("backward() needs a microbatch: call forward(batch) "
                             "first or pass backward(batch=...)")
        self._compat_pending = False
        return self._compat_loss

    def _reduce_pending(self) -> None:
        """Reduce the micro-batch gradients held in the full local buffer
        (and any deferred by ``no_sync``): at stage 0 into the imperative
        path's accumulator, at stages 1-3 into the shard accumulator."""
        if self._zero is not None:
            full = self._units.local if self._units is not None else self._flat_grad
            if full is not None:
                self._zero.reduce_scatter_flat(
                    full, self._shard_grad,
                    self.config.zero_optimization.reduce_bucket_size, accumulate=True)
                if self._units is not None:
                    self._units.local = None    # freed until the next no_sync
                else:
                    full.zero_()
            self._pending_local = False
            return
        if self._compat_acc is None:
            self._compat_acc = torch.zeros_like(self._flat_grad)
        self._reduce_grads(self._sr_generator(self.state.step, self._compat_count + 1))
        self._compat_acc.add_(self._flat_grad)
        self._flat_grad.zero_()
        self._pending_local = False

    @contextlib.contextmanager
    def no_sync(self):
        """No optimizer step can fire on the imperative path inside, and the
        cross-rank gradient reduction waits until the first micro-batch
        after it."""
        self._no_sync_depth += 1
        try:
            yield
        finally:
            self._no_sync_depth -= 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._no_sync_depth == 0 and self._compat_count >= self.gas

    def step(self) -> None:
        """Apply the optimizer to the accumulated gradients; a no-op until
        the accumulation boundary, as in the reference."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._check_states_home()
        if self.dp_world > 1:
            if self._pending_local:
                self._reduce_pending()
            if self._zero is None:
                self._flat_grad.copy_(self._compat_acc)
                self._compat_acc.zero_()
        self._metrics_dev = self._apply(reduced=self.dp_world > 1)
        self._compat_count = 0
        self._compat_pending = False
        self.global_steps += 1

    def zero_grad(self) -> None:
        """Discard gradients accumulated on the imperative path."""
        for p in self._masters:
            if p.grad is not None:
                p.grad.zero_()
        if self._host_adam is not None:
            self._acc.zero_()
        if self._compat_acc is not None:
            self._compat_acc.zero_()
        if self._zero is not None:
            self._shard_grad.zero_()
            if self._units is not None:
                self._units.local = None
        self._pending_local = False
        self._compat_count = 0
        self._compat_pending = False

    # state offload (JAX engine.py:1923-1997, reference offload_states) ---
    def offload_states(self, include=("optimizer_state",), device: str = "cpu",
                       nvme_path: Optional[str] = None) -> None:
        """Move engine state off the device between training phases:
        ``cpu`` = host memory (pinned with a card), ``nvme`` = files through
        the aio swap tier (``runtime/zero/swapper.py``, the ``aio`` config's
        threads and block size). Training is invalid until
        ``reload_states``, as in the reference; here it raises. A tensor
        already in host memory (the storage tier's) stays where it is for
        ``cpu``. ``params`` moves the storages under ``state.params``: the
        masters (at stages 1-2 their flat buffer, at stage 3 this rank's
        shard) or, under the host-Adam tier, the compute leaves on the
        device; the tensors stay the same objects (autograd's leaves, the
        views, the optimizer's references) with their storage emptied."""
        if device not in ("cpu", "nvme"):
            raise ValueError(f"offload_states(device={device!r}): use 'cpu' or 'nvme'")
        for raw_kind in include:
            kind = self._canonical_kind(raw_kind)
            if kind in self._offloaded:
                continue
            if kind == "params":
                self._offload_params(device, nvme_path)
                continue
            leaves, spec = pytree.tree_flatten(self.state.opt_state)
            tensors = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
            homes = {i: leaves[i].device for i in tensors}
            if device == "nvme":
                sw = self._get_swapper(nvme_path)
                sw.swap_out(kind, [leaves[i] for i in tensors])
                sw.synchronize(kind)
                for i in tensors:
                    leaves[i] = torch.empty_like(leaves[i], device="meta")
                # the swapper's in-memory manifest is the only way back
                self._offloaded[kind] = ("nvme", homes, sw)
            else:
                pin = self.device.type == "cuda"
                for i in tensors:
                    if leaves[i].device.type != "cpu":
                        host = torch.empty_like(leaves[i], device="cpu", pin_memory=pin)
                        leaves[i] = host.copy_(leaves[i], non_blocking=pin)
                if pin:
                    torch.cuda.current_stream(self.device).synchronize()
                self._offloaded[kind] = ("cpu", homes, None)
            self.state.opt_state = pytree.tree_unflatten(leaves, spec)

    def reload_states(self) -> None:
        """Bring every offloaded state back where it lived, bitwise."""
        for kind, (where, homes, sw) in list(self._offloaded.items()):
            if kind == "params":
                self._reload_params(where, homes, sw)
                del self._offloaded[kind]
                continue
            leaves, spec = pytree.tree_flatten(self.state.opt_state)
            if where == "nvme":
                for i, x in zip(homes, sw.swap_in(kind, delete=True)):
                    leaves[i] = x
            pin = self.device.type == "cuda"
            for i, home in homes.items():
                if home.type != "cpu":
                    leaves[i] = leaves[i].to(home)
                elif pin and not leaves[i].is_pinned():
                    leaves[i] = leaves[i].pin_memory()
            self.state.opt_state = pytree.tree_unflatten(leaves, spec)
            del self._offloaded[kind]

    def _param_storages(self) -> List[torch.Tensor]:
        """One byte view (uint8, the whole storage) of each distinct storage
        that holds ``state.params``, in tree order."""
        if self._stage3:
            tensors = [self._master_shard]
        elif self._zero is not None:
            tensors = [self._flat_master]
        else:
            tensors = self._masters
        views, seen = [], set()
        for t in tensors:
            if not t.untyped_storage().resizable():
                # memory the engine does not own (a numpy array's, at stage
                # 0): the tensor moves onto a storage of its own first
                home = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                           device=t.device)
                with torch.no_grad():
                    home.copy_(t)
                    t.set_(home.untyped_storage(), 0, t.size(), t.stride())
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                views.append(torch.empty(0, dtype=torch.uint8, device=t.device).set_(st))
        return views

    def _offload_params(self, device: str, nvme_path: Optional[str]) -> None:
        """Copy each params storage to host memory (pinned with a card) or
        to files, then empty it (``resize_(0)``)."""
        views = self._param_storages()
        if device == "nvme":
            sw = self._get_swapper(nvme_path)
            sw.swap_out("params", views)
            sw.synchronize("params")
            self._offloaded["params"] = ("nvme", views, sw)
        else:
            pin = self.device.type == "cuda"
            host = [torch.empty(v.numel(), dtype=torch.uint8, pin_memory=pin)
                    .copy_(v, non_blocking=pin) for v in views]
            if pin:
                torch.cuda.current_stream(self.device).synchronize()
            self._offloaded["params"] = ("cpu", views, host)
        for v in views:
            v.untyped_storage().resize_(0)

    def _reload_params(self, where: str, views: List[torch.Tensor], saved) -> None:
        back = saved.swap_in("params", delete=True) if where == "nvme" else saved
        for v, h in zip(views, back):
            v.untyped_storage().resize_(h.numel())
            v.copy_(h, non_blocking=h.is_pinned())
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _canonical_kind(kind: str) -> str:
        if kind in ("optimizer_state", "optimizer"):
            return "optimizer_state"
        if kind in ("params", "fp32_params", "hp_params"):
            return "params"
        raise ValueError(f"unknown offload kind {kind!r} "
                         "(use 'optimizer_state' or 'params')")

    def _get_swapper(self, nvme_path: Optional[str]):
        path = nvme_path or self.config.zero_optimization.offload_optimizer.nvme_path
        if not path:
            raise ValueError(
                "offload to nvme needs a path: pass nvme_path= or set "
                "zero_optimization.offload_optimizer.nvme_path in the config")
        if path not in self._swappers:
            from .zero.swapper import AsyncTensorSwapper

            aio = self.config.aio
            where = os.path.join(path, "dstpu_swap")
            if comm.get_world_size() > 1:    # ranks sharing a path keep apart
                where = os.path.join(where, f"rank_{comm.get_rank()}")
            self._swappers[path] = AsyncTensorSwapper(
                where, num_threads=aio.thread_count, block_size=aio.block_size)
        return self._swappers[path]

    def _check_states_home(self) -> None:
        if self._offloaded:
            raise RuntimeError(f"engine state {sorted(self._offloaded)} is offloaded: call "
                               "reload_states() before training")

    # ------------------------------------------------------------------
    @property
    def _last_metrics(self) -> Dict[str, float]:
        m = {k: float(v) for k, v in self._metrics_dev.items()}
        if m.pop("overflow", 0.0):
            m["skipped"] = 1.0
        return m

    @property
    def loss_scale(self) -> float:
        return float(self.state.loss_scale.scale)

    def get_lr(self):
        return [float(self.lr_schedule(self.state.step))]

    def get_global_grad_norm(self) -> float:
        return self._last_metrics.get("grad_norm", 0.0)

    def zero_stage(self) -> int:
        return self.config.zero_optimization.stage

    # checkpointing (delegates to checkpoint/engine.py) -----------------
    def save_checkpoint(self, save_dir, tag=None, client_state=None, **kw):
        from ..checkpoint.engine import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state, **kw)

    def load_checkpoint(self, load_dir, tag=None, **kw):
        from ..checkpoint.engine import load_checkpoint as _load

        return _load(self, load_dir, tag=tag, **kw)


def _initial_topology(topology, param_specs, batch_spec,
                      world_size: int) -> Optional[Topology]:
    """The topology ``initialize`` was given, resolved over the world: a
    port ``Topology``, or a ``TopologySpec`` built into one, whose pp, ep,
    sp and tp are 1 and whose dp is the world's (None when none was given).
    Any other topology, and any ``param_specs`` or ``batch_spec``, raise
    ``NotImplementedError``: they place tensors over the model-parallel
    axes, which are not ported."""
    if param_specs is not None or batch_spec is not None:
        named = " and ".join(n for n, v in (("param_specs", param_specs),
                                             ("batch_spec", batch_spec)) if v is not None)
        raise _not_ported(f"initialize({named}=...)", 8,
                          "sharding/ and the sharded parameter and batch layouts")
    if topology is None:
        return None
    if not isinstance(topology, (Topology, TopologySpec)):
        raise _not_ported(f"initialize(topology={type(topology).__name__}) (a topology "
                          "other than the port's Topology or TopologySpec)", 8,
                          "the model-parallel axes of parallel/topology.py")
    spec = topology.spec if isinstance(topology, Topology) else topology
    over = {k: getattr(spec, k) for k in ("pp", "ep", "sp", "tp") if getattr(spec, k) > 1}
    if over:
        raise _not_ported(f"initialize(topology=...) with {over}", 8,
                          "the model-parallel axes of parallel/topology.py")
    dp = topology.dp_size if isinstance(topology, Topology) else spec.dp
    if dp is not None and dp != world_size:
        raise _not_ported(f"initialize(topology=...) with dp={dp} at world size "
                          f"{world_size} (a dp degree other than the world's)", 8,
                          "model-parallel axes beside dp")
    return topology if isinstance(topology, Topology) else Topology(spec)


def initialize(args=None, model: Optional[Callable] = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               distributed_port=None, mpu=None, dist_init_required=None,
               config=None, config_params=None, topology=None, param_specs=None,
               batch_spec=None, *, device="cuda", **kwargs):
    """Create an engine (reference ``deepspeed.initialize``; the JAX
    package's signature vocabulary). ``model`` is a loss function
    ``loss = f(params, batch[, rng])`` (``models.make_loss_fn(model)``; a
    loss that takes ``rng`` gets an integer seed per micro-batch),
    ``model_parameters`` the parameter tree. ``optimizer`` is a
    ``GradientTransformation`` or a factory called with the tree's shapes
    (meta tensors) that returns one. ``frozen_params`` (a keyword) lists
    path patterns of leaves that get no gradient, update or optimizer
    state. ``mpu`` is accepted and unused, as in the JAX package, whose
    mesh topology replaces it. ``topology`` (a port ``Topology`` or
    ``TopologySpec``) is set as the process's topology and used by the
    engine when its only axis above 1 is dp and dp is the world size; any
    other topology, and ``param_specs`` or ``batch_spec``, raise
    ``NotImplementedError`` (ROADMAP.md Queue A item 8). The engine runs on
    ``device``, the card unless the caller passes ``"cpu"``. Returns ``(engine, optimizer,
    dataloader, lr_schedule)``; with ``training_data`` (an indexable
    dataset) the dataloader yields this rank's micro-batches, else it is
    None. Joins the process group first (``comm.init_distributed``: the
    launcher's environment; a no-op at world size 1)."""
    cfg = load_config(config if config is not None else config_params)
    if dist_init_required is not False:
        comm.init_distributed()
    topo = _initial_topology(topology, param_specs, batch_spec, comm.get_world_size())
    engine = DeepSpeedTPUEngine(model, model_parameters, cfg, optimizer=optimizer,
                                lr_scheduler=lr_scheduler, device=device,
                                frozen_params=kwargs.get("frozen_params"), topology=topo)
    dataloader = None
    if training_data is not None:
        from .dataloader import DeepSpeedDataLoader

        dataloader = DeepSpeedDataLoader(training_data,
                                         batch_size=cfg.train_micro_batch_size_per_gpu,
                                         rank=engine.dp_rank, world_size=engine.dp_world)
        engine.data_sampler = dataloader
    return engine, engine.tx, dataloader, engine.lr_schedule
