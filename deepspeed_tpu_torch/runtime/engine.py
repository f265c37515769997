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

At world size 1 ZeRO stages 0-3 are the same math and all are accepted;
world size > 1 and the config sections this trainer cannot honour yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..ops.fastpath import configure_fastpath
from ..ops.optimizers import build_optimizer
from ..utils.logging import log_dist
from .config import DeepSpeedTPUConfig, load_config
from .loss_scaler import LossScaleState, make_loss_scale_state, update_loss_scale
from .lr_schedules import build_lr_schedule


def _not_ported(what: str, item: int, area: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A item {item} ({area})")


def _check_supported(config: DeepSpeedTPUConfig, world_size: int) -> None:
    """Raise for every switched-on section the trainer cannot honour yet,
    rather than ignore it."""
    if world_size > 1 or (config.data_parallel_size or 1) > 1:
        raise _not_ported(f"training at world size {max(world_size, config.data_parallel_size or 1)}",
                          7, "comm substrate over torch.distributed, then ZeRO "
                          "sharding over several cards")
    zc = config.zero_optimization
    checks = [
        (zc.offload_optimizer.device != "none", "zero_optimization.offload_optimizer",
         7, "ZeRO-Offload"),
        (zc.offload_param.device != "none", "zero_optimization.offload_param",
         7, "ZeRO-Offload"),
        (config.activation_checkpointing.engine_wrap,
         "activation_checkpointing.engine_wrap", 7,
         "runtime/activation_checkpointing.py"),
        ((config.pipeline.stages or 1) > 1, "pipeline.stages > 1", 8,
         "runtime/pipe/pipeline.py"),
        (config.tensor_parallel.enabled and config.tensor_parallel.tp_size > 1,
         "tensor_parallel.tp_size > 1", 8, "sharding/, module_inject/auto_tp.py"),
        (config.sequence_parallel_size > 1, "sequence_parallel_size > 1", 8,
         "sequence/{layer,ring}.py"),
        (config.moe.enabled, "moe", 8, "moe/*"),
        (config.compressed_collectives.mode != "none", "compressed_collectives", 8,
         "comm/compressed.py"),
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


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm across all gradients (reference ``clip_grad_norm_``), a 0-dim
    fp32 tensor on the gradients' device."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class TrainState:
    """Engine state: ``params`` are the fp32 master weights (the compute
    dtype's when ``bf16.master_weights`` is off), nested like the tree the
    caller gave."""
    step: int
    params: Any
    opt_state: Any
    loss_scale: LossScaleState


class DeepSpeedTPUEngine:
    def __init__(self, loss_fn: Callable, params: Any, config: DeepSpeedTPUConfig,
                 optimizer=None, lr_scheduler: Optional[Callable] = None,
                 device="cuda"):
        from ..accelerator import resolve_device

        if isinstance(loss_fn, torch.nn.Module):
            raise TypeError("model must be a loss function f(params, batch[, rng]); "
                            "for a TransformerLM pass make_loss_fn(model)")
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self.config = config
        config.finalize(world_dp_size=world)
        _check_supported(config, world)
        self.device = resolve_device(device)
        tf = config.training_fastpath
        configure_fastpath(attn_impl=tf.attn_impl, loss_impl=tf.loss_impl,
                           embedding_overlap=tf.embedding_overlap)
        self.loss_fn_raw = loss_fn
        self.gas = config.gradient_accumulation_steps
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size

        # --- precision ---------------------------------------------------
        self.compute_dtype = config.compute_dtype
        self.fp16 = config.fp16.enabled
        self.master_weights = config.bf16.master_weights if config.bf16.enabled else True

        # --- optimizer ---------------------------------------------------
        opt_params = dict(config.optimizer.params)
        base_lr = opt_params.get("lr", 1e-3)
        self.lr_schedule = lr_scheduler or build_lr_schedule(
            config.scheduler.type, dict(config.scheduler.params), base_lr)
        if optimizer is not None:
            if not hasattr(optimizer, "update"):
                raise TypeError("optimizer must be a GradientTransformation "
                                f"(init/update), got {type(optimizer).__name__}")
            self.tx = optimizer
        else:
            opt_params["lr"] = self.lr_schedule if config.scheduler.type else base_lr
            self.tx = build_optimizer(config.optimizer.type, opt_params)

        self._build_state(params)
        self._compat_count = 0
        self._compat_pending = False
        self._no_sync_depth = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self._metrics_dev: Dict[str, Any] = {}
        log_dist(f"engine initialized on {self.device}: zero_stage="
                 f"{config.zero_optimization.stage}, gas={self.gas}, "
                 f"micro_bs={self.micro_batch_size}, dtype={self.compute_dtype}")

    # ------------------------------------------------------------------
    def _build_state(self, params):
        store = torch.float32 if self.master_weights else self.compute_dtype
        leaves, self._spec = pytree.tree_flatten(params)
        for p in leaves:
            if not p.is_floating_point():
                raise ValueError(f"model_parameters must be floating tensors, got {p.dtype}")
        # .to() returns the tensor itself when it already has this device
        # and dtype: such parameters are trained in place
        self._masters = [p.detach().to(self.device, store).requires_grad_(True)
                         for p in leaves]
        opt_state = self.tx.init(self._tree(self._masters))
        ls = make_loss_scale_state(self.config.fp16.initial_scale_power,
                                   self.config.fp16.loss_scale,
                                   self.config.fp16.hysteresis)
        self.state = TrainState(step=0, params=self._tree(self._masters),
                                opt_state=opt_state, loss_scale=ls)

    def _tree(self, leaves):
        return pytree.tree_unflatten(list(leaves), self._spec)

    def _loss(self, batch) -> torch.Tensor:
        """The loss of one micro-batch on the compute copy of the masters
        (autograd runs through the cast, so gradients land in fp32)."""
        compute = [p.to(self.compute_dtype) for p in self._masters]
        return self.loss_fn_raw(self._tree(compute), batch).float()

    def _backward_micro(self, batch, scale: float) -> torch.Tensor:
        with torch.enable_grad():
            loss = self._loss(batch)
            (loss * scale).backward()
        return loss.detach()

    def _grads(self) -> List[torch.Tensor]:
        for p in self._masters:
            if p.grad is None:   # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self._masters]

    def _apply(self) -> Dict[str, Any]:
        """Unscale, norm, clip, update (or skip on fp16 overflow), and reset
        the accumulators; returns the step's metrics (device tensors)."""
        cfg = self.config
        ls = self.state.loss_scale
        scale = ls.scale if self.fp16 else 1.0
        grads = self._grads()
        for g in grads:
            g.div_(scale * self.gas)
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
                self._update(grads)
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

    def _update(self, grads):
        g_tree, p_tree = self._tree(grads), self._tree(self._masters)
        apply = getattr(self.tx, "apply", None)
        if apply is not None and all(p.dtype == torch.float32 for p in self._masters):
            self.state.opt_state = apply(g_tree, self.state.opt_state, p_tree)
            return
        updates, self.state.opt_state = self.tx.update(g_tree, self.state.opt_state, p_tree)
        for p, u in zip(self._masters, pytree.tree_leaves(updates)):
            p.copy_((p.float() + u.float()).to(p.dtype))

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

    def train_batch(self, batch=None, data_iter=None):
        """One full training step: ``gas`` micro-batches and the optimizer
        update. ``batch`` leaves are ``[gas, micro, ...]`` or
        ``[gas * micro, ...]``. Returns the mean micro-batch loss (a 0-dim
        tensor on the device)."""
        if self._no_sync_depth > 0:
            raise RuntimeError("train_batch() applies the optimizer and is "
                               "incompatible with an open no_sync() context")
        if self._compat_count > 0:
            raise RuntimeError(
                f"train_batch() called with {self._compat_count} accumulated "
                "microbatch gradient(s) pending from backward(); finish the "
                "window with backward()+step() or discard it with zero_grad()")
        if batch is None:
            mbs = [next(data_iter) for _ in range(self.gas)]
            batch = pytree.tree_map(lambda *xs: torch.stack(
                [torch.as_tensor(x) for x in xs]), *mbs)
        batch = self._shape_batch(batch)
        scale = self.state.loss_scale.scale if self.fp16 else 1.0
        losses = [self._backward_micro(pytree.tree_map(lambda x: x[i], batch), scale)
                  for i in range(self.gas)]
        metrics = self._apply()
        metrics["loss"] = torch.stack(losses).mean()
        self._metrics_dev = metrics
        self.global_steps += 1
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                     f"lr={metrics['lr']:.3e} grad_norm={float(metrics['grad_norm']):.3f}")
        return metrics["loss"]

    def eval_batch(self, batch, compute_loss: bool = True) -> float:
        with torch.no_grad():
            return float(self._loss(pytree.tree_map(
                lambda x: torch.as_tensor(x, device=self.device), batch)))

    # ------------------------------------------------------------------
    # reference-compat imperative API: forward -> backward (x gas) -> step
    # ------------------------------------------------------------------
    def forward(self, batch) -> float:
        """The loss of one micro-batch. Its gradients are accumulated at
        once (the JAX package fuses the two passes too), so a following
        ``backward()`` only returns this loss."""
        batch = pytree.tree_map(lambda x: torch.as_tensor(x, device=self.device), batch)
        scale = self.state.loss_scale.scale if self.fp16 else 1.0
        self._compat_loss = float(self._backward_micro(batch, scale))
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

    @contextlib.contextmanager
    def no_sync(self):
        """No optimizer step can fire on the imperative path inside."""
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
        self._metrics_dev = self._apply()
        self._compat_count = 0
        self._compat_pending = False
        self.global_steps += 1

    def zero_grad(self) -> None:
        """Discard gradients accumulated on the imperative path."""
        for p in self._masters:
            if p.grad is not None:
                p.grad.zero_()
        self._compat_count = 0
        self._compat_pending = False

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


def initialize(args=None, model: Optional[Callable] = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               distributed_port=None, mpu=None, dist_init_required=None,
               config=None, config_params=None, device="cuda", **kwargs):
    """Create an engine (reference ``deepspeed.initialize``; the JAX
    package's signature vocabulary). ``model`` is a loss function
    ``loss = f(params, batch[, rng])`` (``models.make_loss_fn(model)``),
    ``model_parameters`` the parameter tree. The engine runs on ``device``,
    the card unless the caller passes ``"cpu"``. Returns ``(engine,
    optimizer, dataloader, lr_schedule)``; with ``training_data`` (an
    indexable dataset) the dataloader yields its micro-batches, else it is
    None."""
    if mpu is not None or kwargs.get("frozen_params"):
        raise _not_ported("mpu / frozen_params", 7, "engine extras")
    cfg = load_config(config if config is not None else config_params)
    engine = DeepSpeedTPUEngine(model, model_parameters, cfg, optimizer=optimizer,
                                lr_scheduler=lr_scheduler, device=device)
    dataloader = None
    if training_data is not None:
        from .dataloader import DeepSpeedDataLoader

        dataloader = DeepSpeedDataLoader(training_data,
                                         batch_size=cfg.train_micro_batch_size_per_gpu)
    return engine, engine.tx, dataloader, engine.lr_schedule
