"""ZeRO-Offload in the port against the JAX package's, on the CPU.

* The host Adam (``ops/adam``, the port's copy of ``cpu_adam.cpp`` built
  with ``g++``) against the JAX ``DeepSpeedCPUAdam`` (its own build of the
  JAX source) over three steps: masters, moments and the bf16 emission
  bitwise, AdamW and L2, bias correction on and off, fp32 and bf16
  gradients (the port widens bf16 in its loop, the JAX package before the
  call); and against its plain version ``cpu_adam_reference`` bitwise
  (tolerance 0: the plain version repeats the kernel's four fused
  multiply-adds and rounds its square root once).
* The host-Adam tier of the engine (``offload_optimizer.device: cpu``)
  against the JAX engine's on one tiny Llama in fp32: 3 steps of gas 2 with
  clipping, losses and host masters within 1e-5 (the packages sum in other
  orders); bf16 transport within the JAX package's own tracking bound of
  fp32 transport; fp16 and ``grad_dtype`` fp16 raise; the imperative path
  equals ``train_batch`` bitwise; a resume is bitwise; the storage tier (a
  caller's optimizer, and ``device: nvme``) is bitwise the run without
  offload; ``offload_states`` / ``reload_states`` to cpu and nvme round-trip
  bitwise; the ``tensor_fragment`` accessors read the host masters.
* ``cpu_checkpointing``: bitwise ``dots_saveable``'s gradients, its pack
  hook seeing exactly the products' outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, cpu_adam_reference
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
from deepspeed_tpu_torch.ops.optimizers import fused_adam
from deepspeed_tpu_torch.runtime import activation_checkpointing as tac
from deepspeed_tpu_torch.utils import tensor_fragment as tfrag

TOL = 1e-5
MODEL = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
# no scheduler: the JAX engine's host step evaluates its schedule on a Python
# int, which the JAX WarmupLR does not take (test_offload_lr_follows_the_schedule
# holds the port's host step to the schedule)
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}
WARMUP = {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                         "warmup_num_steps": 3}}
OFFLOAD = {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    yield
    reset_fastpath()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {k: np.asarray(v.detach().float() if isinstance(v, torch.Tensor) else v,
                          np.float32)
            for k, v in convert._flatten(tree).items()}


@pytest.fixture(scope="module")
def problem():
    jcfg = jtf.TransformerConfig(**MODEL, dtype=jnp.float32)
    jmodel = jtf.TransformerLM(jcfg)
    tree = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 97, (4, 32)).astype(np.int32) for _ in range(5)]
    return jmodel, params, batches


def _port(problem, over=None, optimizer=None):
    _, params, _ = problem
    cfg = ttf.TransformerConfig(**MODEL, dtype=torch.float32)
    p = convert.params_from_jax(params, cfg, device="cpu")
    eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, p)),
                             model_parameters=p, config=dict(CONFIG, **(over or {})),
                             optimizer=optimizer, device="cpu")
    return eng


def _masters_close(got, want, what, steps):
    """Masters within TOL, but for the rare element whose gradient is of
    rounding size: Adam divides it by its own RMS, so the two packages'
    summation orders can move it by up to the learning rate per step either
    way (as in test_torch_train). At most one element in a thousand may do
    so."""
    off = ~np.isclose(got, want, rtol=TOL, atol=TOL)
    assert off.mean() <= 1e-3, (what, int(off.sum()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * steps * CONFIG["optimizer"]
                               ["params"]["lr"], err_msg=what)


def _train(eng, batches):
    return [float(eng.train_batch(torch.from_numpy(b))) for b in batches]


# ---------------------------------------------------------------------------
# the host kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adamw,bias_correction", [(True, True), (True, False),
                                                   (False, True), (False, False)])
def test_host_adam_bitwise_jax_cpu_adam_and_plain_version(adamw, bias_correction):
    rng = np.random.default_rng(0)
    shapes = {"w": (100, 129), "b": (70001,), "s": (3,)}    # b: two host threads
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, betas=(0.9, 0.95), weight_decay=0.01, adamw_mode=adamw,
              bias_correction=bias_correction)
    jax_adam = JaxCPUAdam(params, **kw)
    port = DeepSpeedCPUAdam({k: torch.from_numpy(v) for k, v in params.items()}, **kw)
    plain = {k: (torch.from_numpy(v), torch.zeros(v.shape), torch.zeros(v.shape))
             for k, v in params.items()}
    for step in range(1, 4):
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for k, s in shapes.items()}
        if step % 2 == 0:      # bf16 gradients: the port widens them in its loop
            grads = {k: g.to(torch.bfloat16) for k, g in grads.items()}
        want = jax_adam.step({k: g.float().numpy() for k, g in grads.items()},
                             emit_bf16=True)
        got = port.step(grads, emit_bf16=True)
        for k in shapes:
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          np.asarray(want[k]).view(np.int16), err_msg=k)
            plain[k] = cpu_adam_reference(*plain[k], grads[k], 1e-2, (0.9, 0.95), 1e-8,
                                          0.01, adamw, bias_correction, step)
    for k in shapes:
        for mine, theirs, ref in ((port.master, jax_adam.master, 0),
                                  (port.exp_avg, jax_adam.exp_avg, 1),
                                  (port.exp_avg_sq, jax_adam.exp_avg_sq, 2)):
            np.testing.assert_array_equal(mine[k].numpy(), theirs[k], err_msg=k)
            assert torch.equal(mine[k], plain[k][ref]), k
    assert port.step_count == jax_adam.step_count == 3
    # state_dict / load_state_dict round-trip in place
    other = DeepSpeedCPUAdam({k: torch.zeros(s) for k, s in shapes.items()}, **kw)
    other.load_state_dict(port.state_dict())
    assert other.step_count == 3
    assert all(torch.equal(other.master[k], port.master[k]) for k in shapes)


def test_host_adam_refuses_wrong_leaves():
    opt = DeepSpeedCPUAdam({"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="gradient leaves"):
        opt.step({"w": torch.zeros(4), "x": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        opt.step({"w": torch.zeros(5)})


# ---------------------------------------------------------------------------
# the host-Adam tier against the JAX engine's
# ---------------------------------------------------------------------------


def _jax_offload(problem, over):
    jmodel, params, batches = problem
    eng, *_ = jds.initialize(model=jtf.make_loss_fn(jmodel),
                             model_parameters=jax.tree.map(jnp.asarray, params),
                             config=dict(CONFIG, **over),
                             topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    losses = [float(eng.train_batch(jnp.asarray(b))) for b in batches[:3]]
    return eng, losses


@pytest.fixture(scope="module")
def jax_runs(problem):
    bf16 = {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu", "grad_dtype": "bfloat16"}}}
    out = {}
    for name, over in (("fp32", OFFLOAD), ("bf16", bf16)):
        eng, losses = _jax_offload(problem, over)
        assert eng._host_adam is not None
        out[name] = (losses, eng.get_global_grad_norm(),
                     _flat(jax.tree.map(np.asarray, eng._host_adam.master)))
    return out


def test_offload_engine_follows_jax_offload_engine(problem, jax_runs):
    eng = _port(problem, OFFLOAD)
    assert eng._host_adam is not None and eng.state.opt_state == ()
    assert all(p.dtype == torch.float32 for p in eng._masters)
    losses = _train(eng, problem[2][:3])
    want, want_norm, want_masters = jax_runs["fp32"]
    np.testing.assert_allclose(losses, want, rtol=TOL)
    np.testing.assert_allclose(eng.get_global_grad_norm(), want_norm, rtol=1e-4)
    got = _flat(eng._host_adam.master)
    assert set(got) == set(want_masters)
    for k, v in got.items():
        _masters_close(v, want_masters[k], k, steps=3)
    # the device leaves are the host masters after the step (fp32 compute)
    for k, v in _flat(eng.state.params).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert eng._host_adam.step_count == 3 and eng.state.step == 3
    assert set(eng.offload_timings()) == {"d2h", "host_adam", "h2d"}


def test_bf16_transport_tracks_fp32(problem, jax_runs):
    """JAX ``test_bf16_grad_transport_tracks_fp32``: the narrowing comes after
    the fp32 accumulation, norm and clip, so the losses stay within the JAX
    package's bound of full-width transport, and the port's bf16 run follows
    the JAX package's bf16 run."""
    eng = _port(problem, {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu", "grad_dtype": "bfloat16"}}})
    assert eng._grad_transport == torch.bfloat16
    losses = _train(eng, problem[2][:3])
    np.testing.assert_allclose(losses, jax_runs["fp32"][0], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(losses, jax_runs["bf16"][0], rtol=TOL)
    got, want = _flat(eng._host_adam.master), jax_runs["bf16"][2]
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=5e-2, atol=5e-3, err_msg=k)


@pytest.mark.parametrize("over", [
    {"fp16": {"enabled": True}, **OFFLOAD},
    {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu",
                                                             "grad_dtype": "float16"}}},
    {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu",
                                                             "grad_dtype": "fp16"}}}],
    ids=["fp16", "grad_dtype_float16", "grad_dtype_fp16"])
def test_fp16_with_offload_raises(problem, over):
    with pytest.raises(ValueError, match="fp16|grad_dtype"):
        _port(problem, over)


def test_offload_lr_follows_the_schedule(problem):
    """The host step runs at ``lr_schedule(global_steps + 1)`` (JAX
    ``_apply_host_adam``); a non-finite gradient norm skips the update but
    still counts the step."""
    eng = _port(problem, dict(OFFLOAD, scheduler=WARMUP))
    for step, b in enumerate(problem[2][:3], start=1):
        eng.train_batch(torch.from_numpy(b))
        assert eng._last_metrics["lr"] == eng.lr_schedule(step)
    assert len({eng.lr_schedule(s) for s in (1, 2, 3)}) == 3
    eng._acc.fill_(float("inf"))
    before = [x.clone() for x in eng._host_adam.leaves()[0]]
    metrics = eng._apply()
    assert metrics["overflow"] and eng.state.step == 4 and eng._host_adam.step_count == 3
    assert all(torch.equal(a, b) for a, b in zip(eng._host_adam.leaves()[0], before))
    assert not eng._acc.any()


def test_imperative_path_equals_train_batch(problem):
    fused, compat = _port(problem, OFFLOAD), _port(problem, OFFLOAD)
    for b in problem[2][:2]:
        fused.train_batch(torch.from_numpy(b))
        for mb in torch.from_numpy(b).reshape(2, 2, 32):
            compat.forward(mb)
            compat.backward()
            if compat.is_gradient_accumulation_boundary():
                grad = tfrag.safe_get_full_grad(compat, "lm_head/kernel")
                assert grad is not None and torch.isfinite(grad).all()
            compat.step()
    assert compat._host_adam.step_count == fused._host_adam.step_count == 2
    for a, b in zip(compat._host_adam.leaves()[0], fused._host_adam.leaves()[0]):
        assert torch.equal(a, b)


def test_checkpoint_resume_is_bitwise(problem, tmp_path):
    batches = problem[2]
    whole = _train(_port(problem, OFFLOAD), batches)
    first = _port(problem, OFFLOAD)
    got = _train(first, batches[:3])
    first.save_checkpoint(str(tmp_path), tag="t3")
    resumed = _port(problem, OFFLOAD)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed._host_adam.step_count == 3 and resumed.global_steps == 3
    for a, b in zip(resumed._host_adam.leaves(), first._host_adam.leaves()):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    got += _train(resumed, batches[3:])
    assert got == whole
    # zero_to_fp32 reads the host masters
    flat = tds.checkpoint.zero_to_fp32(str(tmp_path), tag="t3")
    for k, v in _flat(first._host_adam.master).items():
        np.testing.assert_array_equal(flat[k], v)
    # a params-only load re-seeds the masters from the loaded params
    fresh = _port(problem, OFFLOAD)
    fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert fresh._host_adam.step_count == 0
    for a, b in zip(fresh._host_adam.leaves()[0], first._host_adam.leaves()[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["caller_optimizer", "nvme"])
def test_storage_tier_is_bitwise_the_run_without_offload(problem, tmp_path, tier):
    if tier == "caller_optimizer":
        over = OFFLOAD
        tx = lambda: fused_adam(lr=1e-3, weight_decay=0.01)
    else:
        over = {"zero_optimization": {"stage": 1, "offload_optimizer": {
            "device": "nvme", "nvme_path": str(tmp_path)}}}
        tx = lambda: None
    plain = _port(problem, optimizer=tx())
    offload = _port(problem, over, optimizer=tx())
    assert offload._host_adam is None and offload._offload_optimizer
    assert _train(offload, problem[2][:3]) == _train(plain, problem[2][:3])
    for a, b in zip(offload._masters, plain._masters):
        assert torch.equal(a, b)
    for a, b in zip(torch.utils._pytree.tree_leaves(offload.state.opt_state),
                    torch.utils._pytree.tree_leaves(plain.state.opt_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("where", ["cpu", "nvme"])
def test_offload_states_round_trip_bitwise(problem, tmp_path, where):
    batches = problem[2]
    whole = _port(problem)
    want = _train(whole, batches[:4])
    eng = _port(problem)
    got = _train(eng, batches[:2])
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in torch.utils._pytree.tree_leaves(eng.state.opt_state)]
    eng.offload_states(include=("optimizer",), device=where, nvme_path=str(tmp_path))
    if where == "nvme":
        assert eng._swappers[str(tmp_path)].swapped_names() == ["optimizer_state"]
        assert all(x.device.type == "meta" for x in eng.state.opt_state.exp_avg.values()
                   if isinstance(x, torch.Tensor))
    with pytest.raises(RuntimeError, match="reload_states"):
        eng.train_batch(torch.from_numpy(batches[2]))
    eng.reload_states()
    after = torch.utils._pytree.tree_leaves(eng.state.opt_state)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    got += _train(eng, batches[2:4])
    assert got == want
    with pytest.raises(ValueError, match="unknown offload kind"):
        eng.offload_states(include=("gradients",))
    with pytest.raises(ValueError, match="nvme_path"):
        _port(problem).offload_states(device="nvme")


def test_tensor_fragment_reads_and_writes_the_host_masters(problem):
    eng = _port(problem, OFFLOAD)
    _train(eng, problem[2][:2])
    path = "layer_0/attn/q_proj/kernel"
    i = list(convert._flatten(eng.state.params)).index(path)
    master, m, v = (x[i] for x in eng._host_adam.leaves())
    assert torch.equal(tfrag.safe_get_full_fp32_param(eng, path), master)
    assert torch.equal(tfrag.safe_get_local_fp32_param(eng, path), master)
    assert torch.equal(tfrag.safe_get_full_optimizer_state(eng, path, "exp_avg"), m)
    assert torch.equal(tfrag.safe_get_local_optimizer_state(eng, path, "exp_avg_sq"), v)
    new = torch.full_like(master, 0.25)
    tfrag.safe_set_full_fp32_param(eng, path, new)
    assert torch.equal(eng._host_adam.leaves()[0][i], new)
    assert torch.equal(eng._masters[i].detach(), new)        # the device leaf too
    tfrag.safe_set_full_optimizer_state(eng, path, torch.ones_like(m), "exp_avg")
    assert torch.equal(eng._host_adam.leaves()[1][i], torch.ones_like(m))
    with pytest.raises(ValueError, match="exp_avg"):
        tfrag.safe_get_full_optimizer_state(eng, path, "momentum")


# ---------------------------------------------------------------------------
# cpu_checkpointing
# ---------------------------------------------------------------------------


def test_cpu_checkpointing_is_dots_saveable_in_host_memory(problem, monkeypatch):
    _, params, batches = problem
    cfg = ttf.TransformerConfig(**MODEL, dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(batches[0].astype(np.int64))}
    grads = {}
    saved = tac.get_config()
    packed = []
    real = tac._pack_to_host
    monkeypatch.setattr(tac, "_pack_to_host",
                        lambda t: packed.append(t.detach().clone()) or real(t))
    try:
        for name, knobs in (("dots", dict(policy="dots_saveable", checkpoint_in_cpu=False)),
                            ("cpu", dict(checkpoint_in_cpu=True))):
            tac._config["policy"] = None
            tac.configure(**knobs)
            p = convert.params_from_jax(params, cfg, device="cpu")
            for leaf in torch.utils._pytree.tree_leaves(p):
                leaf.requires_grad_(True)
            packed.clear()
            loss_fn = ttf.make_loss_fn(ttf.TransformerLM(cfg, p))
            loss = tac.checkpoint(loss_fn, p, batch)
            loss.backward()
            grads[name] = (float(loss.detach()),
                           [x.grad for x in torch.utils._pytree.tree_leaves(p)], list(packed))
    finally:
        tac._config.update(saved)
    loss_d, g_d, packed_d = grads["dots"]
    loss_c, g_c, packed_c = grads["cpu"]
    assert loss_c == loss_d and not packed_d
    assert all(torch.equal(a, b) for a, b in zip(g_c, g_d))
    # the pack hook saw exactly the outputs of the forward's matrix products
    # (the linear layers, the attention's batched products, the LM head),
    # in order: the products of a plain forward, recorded by a dispatch mode
    products = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in tac._SAVED_OPS["dots_saveable"]:
                products.append(out)
            return out

    p = convert.params_from_jax(params, cfg, device="cpu")
    with torch.no_grad(), Record():
        ttf.make_loss_fn(ttf.TransformerLM(cfg, p))(p, batch)
    assert len(products) == len(packed_c) > 4 * MODEL["num_layers"]
    assert all(torch.equal(a, b) for a, b in zip(packed_c, products))


def test_per_layer_remat_takes_cpu_checkpointing(problem):
    """A model's per-layer remat with no policy reads the checkpointing
    knobs: with ``cpu_checkpointing`` configured it keeps the products in
    host memory, with gradients bitwise those of per-layer
    ``dots_saveable``."""
    import dataclasses

    _, params, batches = problem
    base = ttf.TransformerConfig(**MODEL, dtype=torch.float32, remat=True)
    batch = {"tokens": torch.from_numpy(batches[1].astype(np.int64))}
    saved = tac.get_config()
    out = {}
    try:
        for name, policy, cpu in (("dots", "dots_saveable", False), ("cpu", None, True)):
            tac._config.update(policy=None, cpu_checkpointing=cpu)
            cfg = dataclasses.replace(base, remat_policy=policy)
            p = convert.params_from_jax(params, cfg, device="cpu")
            leaves = torch.utils._pytree.tree_leaves(p)
            for leaf in leaves:
                leaf.requires_grad_(True)
            ttf.make_loss_fn(ttf.TransformerLM(cfg, p))(p, batch).backward()
            out[name] = [x.grad for x in leaves]
    finally:
        tac._config.update(saved)
    assert all(torch.equal(a, b) for a, b in zip(out["cpu"], out["dots"]))
