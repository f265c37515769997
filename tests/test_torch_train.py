"""The port's training path against the JAX package's, on the CPU.

* ``TransformerLM`` logits and the ``make_loss_fn`` loss and gradients
  against the flax model on one parameter tree (``params_from_jax``), in
  float32 within 1e-5 (the packages sum in different orders): a tiny Llama
  with GQA 4/2, a tiny GPT-2-family model, bloom-like (ALiBi) and
  gpt-neo-like (local window) models, and a gpt-neox-like one (parallel
  residual, partial rotary, untied head).
* ``initialize`` + four ``train_batch`` calls (gas 2, AdamW with weight
  decay, WarmupLR, clipping at 1.0) against the JAX engine pinned to one
  device: the loss curve and the final fp32 master weights within 1e-5 in
  float32; in bf16 the losses within 2e-2 (both round activations to bf16,
  at different places). Adam divides each gradient by its own running RMS,
  so an element whose gradient is near rounding size moves by a learning
  rate either way: the learning rate stays at 1e-3 so that such an element
  stays inside 1e-5, and the key bias of the GPT-2 family (whose true
  gradient is zero: softmax ignores a shift shared by all keys) is
  compared only in size.
* The config and every LR schedule parse and evaluate to the same values
  in both packages (inline configs; the reference-corpus test needs a
  checkout the tier-1 run does not have).
* What the trainer cannot honour yet raises ``NotImplementedError`` (the
  fused loss and ``remat`` run: ``test_torch_fused_loss.py``,
  ``test_torch_remat.py``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import lr_schedules as tlr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5
FAMILIES = {
    "llama": dict(num_kv_heads=2),
    "gpt2": dict(norm="layernorm", activation="gelu", position="learned",
                 tie_embeddings=True),
    # bloom-like ALiBi and gpt-neo-like local windows: attention_core's bias
    # and window paths (the flash kernel takes neither)
    "alibi": dict(norm="layernorm", activation="gelu", position="alibi",
                  embed_norm=True, tie_embeddings=True),
    "window": dict(norm="layernorm", activation="gelu", position="learned",
                   layer_windows=(None, 8), attn_scale=1.0),
    # gpt-neox / Pythia: parallel residual with two norms, a quarter of each
    # head rotated, biased LayerNorm and projections, untied head
    "neox": dict(norm="layernorm", activation="gelu", position="rope",
                 parallel_residual=True, rotary_pct=0.25, tie_embeddings=False),
}
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 3}},
    "zero_optimization": {"stage": 3}, "gradient_clipping": 1.0,
    "steps_per_print": 10**9,
}


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    """``initialize`` sets the process-wide fast-path knobs; no test leaks
    its setting into the next."""
    yield
    reset_fastpath()


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree), np.float32)


def tiny_pair(family="llama", dtype="float32", seed=0):
    """(flax model, port config, numpy params) of one tiny model."""
    base = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
                num_layers=2, num_heads=4, max_seq_len=64, **FAMILIES[family])
    jcfg = jtf.TransformerConfig(**base, dtype=getattr(jnp, dtype))
    tcfg = ttf.TransformerConfig(**base, dtype=getattr(torch, dtype))
    jmodel = jtf.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, tcfg, _np_tree(params)


def _leaves(tree):
    if hasattr(tree, "items"):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_logits_loss_and_grads_match_flax(family):
    jmodel, tcfg, params = tiny_pair(family)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 97, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.2).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    model = ttf.TransformerLM(tcfg, convert.params_from_jax(params, tcfg, device="cpu"))
    np.testing.assert_allclose(
        model(torch.from_numpy(tokens)).detach().numpy(),
        np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(tokens))),
        rtol=TOL, atol=TOL)

    batch = {"tokens": tokens, "loss_mask": mask}
    jloss, jgrads = jax.value_and_grad(jtf.make_loss_fn(jmodel))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tparams = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), params)
    tloss = ttf.make_loss_fn(model)(tparams, jax.tree.map(torch.from_numpy, batch))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL)
    for g, w in zip(_leaves(jax.tree.map(lambda t: t.grad, tparams)), _leaves(jgrads)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def _engines(family, dtype, config):
    jmodel, tcfg, params = tiny_pair(family, dtype)
    jeng, *_ = jds.initialize(
        model=jtf.make_loss_fn(jmodel), model_parameters=jax.tree.map(jnp.asarray, params),
        config=config, topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    tparams = convert.params_from_jax(params, tcfg, device="cpu")
    teng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, tparams)),
                              model_parameters=tparams, config=config, device="cpu")
    return jeng, teng


def _batches(n):
    """One seeded batch, repeated: the model memorises it, so the loss
    falls."""
    return [np.random.default_rng(2).integers(0, 97, (4, 32)).astype(np.int32)] * n


@pytest.mark.parametrize("dtype,family", [("float32", "llama"), ("float32", "gpt2"),
                                          ("bfloat16", "llama")])
def test_train_batch_matches_jax_engine(dtype, family):
    config = dict(TRAIN_CONFIG, bf16={"enabled": dtype == "bfloat16"})
    jeng, teng = _engines(family, dtype, config)
    jl, tl = [], []
    for b in _batches(4):
        jl.append(float(jeng.train_batch(jnp.asarray(b))))
        tl.append(float(teng.train_batch(torch.from_numpy(b))))
        assert teng.get_lr()[0] == pytest.approx(float(np.asarray(jeng.get_lr()[0])), rel=1e-7)
    if dtype == "bfloat16":
        np.testing.assert_allclose(tl, jl, atol=2e-2)
        return
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(teng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=1e-4)
    tflat = convert._flatten(teng.state.params)
    jflat = convert._flatten(_np_tree(jeng.state.params))
    for path, t in tflat.items():
        t = t.detach().numpy()
        if path.endswith("k_proj/bias"):
            assert np.abs(t - jflat[path]).max() <= 4 * 1e-3 * 1.01
            continue
        np.testing.assert_allclose(t, jflat[path], rtol=TOL, atol=TOL, err_msg=path)


def test_imperative_steps_match_train_batch():
    """forward/backward/step over the micro-batches of a step give the same
    weights as train_batch on the whole step."""
    _, tcfg, params = tiny_pair()
    engines = []
    for _ in range(2):
        p = convert.params_from_jax(params, tcfg, device="cpu")
        engines.append(tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                                      model_parameters=p, config=TRAIN_CONFIG,
                                      device="cpu")[0])
    fused, compat = engines
    for b in _batches(2):
        fused.train_batch(torch.from_numpy(b))
        for mb in torch.from_numpy(b).reshape(2, 2, 32):
            compat.forward(mb)
            assert not compat.is_gradient_accumulation_boundary() or compat.backward()
            compat.step()
    assert compat.global_steps == fused.global_steps == 2
    for a, b in zip(_leaves(compat.state.params), _leaves(fused.state.params)):
        np.testing.assert_array_equal(a, b)


def test_training_after_serving_in_one_process():
    """Serving builds the shared rotary table under inference_mode; a
    trainer in the same process must still be able to use it."""
    _, tcfg, params = tiny_pair()
    ttf._rope_cs.cache_clear()
    with torch.inference_mode():
        ttf._rope_tables(tcfg, torch.device("cpu"))
    p = convert.params_from_jax(params, tcfg, device="cpu")
    eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                             model_parameters=p, config=TRAIN_CONFIG, device="cpu")
    assert np.isfinite(float(eng.train_batch(torch.from_numpy(_batches(1)[0]))))


CONFIGS = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
     "bf16": {"enabled": True}, "gradient_clipping": 1.0,
     "zero_optimization": {"stage": 3, "reduce_bucket_size": "auto"},
     "training_fastpath": {"loss_impl": "xla", "attn_impl": "flash"},
     "scheduler": {"type": "WarmupCosineLR",
                   "params": {"total_num_steps": 100, "warmup_num_steps": 10}}},
    {"train_batch_size": 16, "gradient_accumulation_steps": 4,
     "fp16": {"enabled": True, "loss_scale_window": 100, "hysteresis": 3},
     "optimizer": {"type": "Adam", "params": {"lr": 3e-4, "betas": [0.8, 0.95],
                                             "adam_w_mode": False}},
     "compressed_collectives": "int8", "resilience": "snapshots",
     "train_micro_batch_size_per_device": 4},
]


@pytest.mark.parametrize("raw", CONFIGS, ids=["triangle", "bf16-zero3", "fp16-shorthands"])
def test_config_parses_like_jax(raw):
    j = jconfig.load_config(dict(raw)).finalize(world_dp_size=1)
    t = tconfig.load_config(dict(raw)).finalize(world_dp_size=1)
    assert t.to_dict() == j.to_dict()
    assert str(t.compute_dtype).split(".")[-1] == jnp.dtype(j.compute_dtype).name


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-4, "warmup_num_steps": 7}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 1e-3, "warmup_num_steps": 6}),
    ("WarmupCosineLR", {"total_num_steps": 40, "warmup_num_steps": 6,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.05}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 8, "decay_step_size": 4,
                  "decay_lr_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 3,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}),
    (None, {}),
]


@pytest.mark.parametrize("kind,params", SCHEDULES, ids=[str(s[0]) for s in SCHEDULES])
def test_lr_schedule_matches_jax(kind, params):
    js = jlr.build_lr_schedule(kind, dict(params), 2e-3)
    ts = tlr.build_lr_schedule(kind, dict(params), 2e-3)
    for step in range(0, 50):
        want = np.float32(np.asarray(js(jnp.asarray(step, jnp.int32))))
        assert np.float32(ts(step)) == want, step


def test_unported_paths_raise():
    _, tcfg, params = tiny_pair()
    p = convert.params_from_jax(params, tcfg, device="cpu")
    loss_fn = ttf.make_loss_fn(ttf.TransformerLM(tcfg, p))
    for over in ({"pipeline": {"stages": 2}}, {"sequence_parallel_size": 2},
                 {"zero_optimization": {"offload_param": {"device": "cpu"}}},
                 {"resilience": "snapshots"}, {"data_parallel_size": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tds.initialize(model=loss_fn, model_parameters=p, device="cpu",
                           config=dict(TRAIN_CONFIG, **over))
    # offload_param is refused on purpose: the JAX engine reads none of its
    # fields (offload_optimizer trains: tests/test_torch_offload.py)
    with pytest.raises(NotImplementedError, match="reads none of its fields"):
        tds.initialize(model=loss_fn, model_parameters=p, device="cpu",
                       config=dict(TRAIN_CONFIG, zero_optimization={
                           "offload_param": {"device": "nvme"}}))


def test_dataloader_matches_jax_and_feeds_train_batch():
    """The port's loader yields the JAX loader's batches (the same seeded
    order, seed 0 as ``initialize`` builds it, over an epoch boundary), resumes from its ``state_dict``, and
    ``initialize(training_data=...)`` + ``train_batch(data_iter=...)`` trains
    exactly as ``train_batch`` on the same batches stacked by hand."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader

    rng = np.random.default_rng(3)
    data = [rng.integers(0, 97, 32).astype(np.int32) for _ in range(9)]
    jax_loader = JaxLoader(data, batch_size=2)
    want = [b for _ in range(2) for b in jax_loader]
    loader = DeepSpeedDataLoader(data, batch_size=2)
    got = [b for _ in range(2) for b in loader]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    first = DeepSpeedDataLoader(data, batch_size=2)
    it = iter(first)
    for _ in range(3):
        next(it)
    resumed = DeepSpeedDataLoader(data, batch_size=2)
    resumed.load_state_dict(first.state_dict())
    for g, w in zip(resumed, want[3:4]):
        np.testing.assert_array_equal(g, w)

    _, tcfg, params = tiny_pair()
    engines = []
    for training_data in (data, None):
        p = convert.params_from_jax(params, tcfg, device="cpu")
        eng, _, dl, _ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                                       model_parameters=p, config=TRAIN_CONFIG,
                                       training_data=training_data, device="cpu")
        assert (dl is None) == (training_data is None)
        engines.append((eng, dl))
    (fed, dl), (stacked, _) = engines
    data_iter = iter(RepeatingLoader(dl))
    for step in range(3):   # 4 micro-batches per epoch: the third step wraps
        fed.train_batch(data_iter=data_iter)
        stacked.train_batch(torch.from_numpy(np.stack(want[2 * step:2 * step + 2])))
    for a, b in zip(_leaves(fed.state.params), _leaves(stacked.state.params)):
        np.testing.assert_array_equal(a, b)


def test_world_size_above_one_raises(monkeypatch):
    _, tcfg, params = tiny_pair()
    p = convert.params_from_jax(params, tcfg, device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    # what the engine cannot honour at world size 2 raises before it joins
    # the world: here a dp degree other than the world's
    with pytest.raises(NotImplementedError, match="world size 2"):
        tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                       model_parameters=p, config=dict(TRAIN_CONFIG, data_parallel_size=1),
                       device="cpu")
    # ZeRO stage 3 at world size 2 is no such section any more
    # (tests/test_torch_dp_train.py trains it): the engine goes on to build
    # the dp mesh, which this faked world cannot give
    with pytest.raises(ValueError, match="process group"):
        tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                       model_parameters=p, config=TRAIN_CONFIG, device="cpu")
