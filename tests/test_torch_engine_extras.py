"""The training engine's remainder in the port, on the CPU: model dropout
and the engine's rng stream, ``frozen_params``, the optimizer factory and
``mpu``, the engine with LAMB and MuAdamW against the JAX engine,
``PrefetchLoader``, and LAMB, MuAdamW and frozen leaves at ZeRO stages 1-3
in a gloo world of two ranks against stage 0.

Tolerances: the port against the JAX package in fp32 within ``TOL``
relative (the two sum in other orders); remat against no remat within
``REMAT_TOL`` (the recompute runs the same fp32 ops); ZeRO stages against
stage 0 as ``tests/test_torch_dp_train.py`` holds them: the first loss
bitwise, later ones and the masters within ``STAGE_RTOL`` (the reductions
and the norms sum in other orders), the first moments within
``STAGE_RTOL`` of each one's largest element, LAMB's trust ratios within
``TRUST_RTOL``. Dropout's bits cannot match JAX's threefry, so with a seed
the tests hold reproducibility and statistics: the kept share of n
elements within 4 sigma of ``1 - rate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxDataLoader
from deepspeed_tpu.runtime.dataloader import PrefetchLoader as JaxPrefetchLoader
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, PrefetchLoader
from deepspeed_tpu_torch.utils import safe_get_full_optimizer_state

from .torch_dist_worker import run_world

TOL = 1e-5
REMAT_TOL = 1e-6
STAGE_RTOL = 1e-5
TRUST_RTOL = 1e-5
MODEL = dict(vocab_size=97, hidden_size=32, intermediate_size=48, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=32)
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}
LAMB = {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}}
MUADAMW = {"type": "MuAdamW", "params": {"lr": 1e-2, "weight_decay": 0.01,
                                         "base_width": 16}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    yield
    reset_fastpath()


@pytest.fixture(scope="module")
def problem():
    """(flax model, numpy params, batches [4, 16] x 3)."""
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**MODEL, dtype=jnp.float32))
    tree = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 97, (4, 16)).astype(np.int64) for _ in range(5)]
    return jmodel, params, batches


def _model(params, **over):
    cfg = ttf.TransformerConfig(**MODEL, dtype=torch.float32, **over)
    p = convert.params_from_jax(params, cfg, device="cpu")
    return ttf.TransformerLM(cfg, p), p


def _engine(params, config=None, model=None, **kw):
    model_over = model or {}
    m, p = _model(params, **model_over)
    eng, *rest = tds.initialize(model=ttf.make_loss_fn(m), model_parameters=p,
                                config=dict(CONFIG, **(config or {})), device="cpu", **kw)
    return eng, p


def _flat(eng):
    return {k: v.detach().clone() for k, v in convert._flatten(eng.state.params).items()}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_without_rng_is_the_jax_model(problem):
    """With no rng the model does not drop out: the loss is the JAX
    model's, whose loss drops out only when given a key."""
    _, params, batches = problem
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**MODEL, dtype=jnp.float32,
                                                     dropout=0.1))
    jloss = jtf.make_loss_fn(jmodel)(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(batches[0]))
    model, p = _model(params, dropout=0.1)
    tloss = ttf.make_loss_fn(model)(p, torch.from_numpy(batches[0]))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL)


def test_dropout_is_seeded_scaled_and_keeps_its_share(problem):
    _, params, batches = problem
    model, p = _model(params, dropout=0.1)
    loss_fn = ttf.make_loss_fn(model)
    tokens = torch.from_numpy(batches[0])
    a, b, c = (float(loss_fn(p, tokens, rng=r)) for r in (7, 7, 8))
    assert a == b and a != c and a != float(loss_fn(p, tokens))
    rate, n = 0.1, 1 << 20
    x = torch.full((n,), 3.0)
    y = ttf.dropout(x, rate, 12345)
    kept = float((y != 0).float().mean())
    assert abs(kept - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    np.testing.assert_allclose(y[y != 0].numpy(), 3.0 / 0.9, rtol=1e-6)
    assert torch.equal(y, ttf.dropout(x, rate, 12345))
    assert not torch.equal(y, ttf.dropout(x, rate, 12346))


@pytest.mark.parametrize("remat", [dict(remat=True, remat_policy="nothing_saveable"),
                                   dict(remat=True, remat_policy="dots_saveable"),
                                   "engine_wrap"])
def test_remat_with_dropout_equals_no_remat(problem, remat):
    """Each layer's mask comes from a seed fixed before the forward (an
    argument of the layer, or of the loss under the engine's wrap), so the
    recompute draws the mask the forward drew."""
    _, params, batches = problem
    runs = {}
    for name, model_over, config in (
            ("none", {}, {}),
            ("remat", remat if isinstance(remat, dict) else {},
             {"activation_checkpointing": {"engine_wrap": True,
                                           "policy": "nothing_saveable"}}
             if remat == "engine_wrap" else {})):
        eng, _ = _engine(params, config, dict(dropout=0.2, **model_over))
        runs[name] = ([float(eng.train_batch(torch.from_numpy(b))) for b in batches[:2]],
                      eng.get_global_grad_norm(), _flat(eng))
    (l0, n0, m0), (l1, n1, m1) = runs["none"], runs["remat"]
    np.testing.assert_allclose(l1, l0, rtol=REMAT_TOL)
    np.testing.assert_allclose(n1, n0, rtol=REMAT_TOL)
    for k in m0:
        np.testing.assert_allclose(m1[k].numpy(), m0[k].numpy(), rtol=REMAT_TOL,
                                   atol=REMAT_TOL, err_msg=k)


def test_engine_gives_each_micro_step_its_own_seed(problem):
    """A loss that takes an rng gets one integer seed per micro-batch, from
    ``config.seed``: distinct within and across steps, the same sequence
    from the same seed, another from another seed; ``eval_batch`` passes
    none."""
    _, params, batches = problem
    model, _ = _model(params)
    inner = ttf.make_loss_fn(model)

    def run(seed):
        seen = []

        def loss_fn(p, batch, rng=None):
            seen.append(rng)
            return inner(p, batch, rng)

        _, p = _model(params)
        eng, *_ = tds.initialize(model=loss_fn, model_parameters=p, device="cpu",
                                 config=dict(CONFIG, seed=seed))
        for b in batches[:2]:
            eng.train_batch(torch.from_numpy(b))
        eng.eval_batch(torch.from_numpy(batches[0]))
        return seen

    a, b, c = run(1), run(1), run(2)
    assert a == b and a[-1] is None and len(set(a[:-1])) == 4
    assert all(isinstance(s, int) for s in a[:-1]) and not set(a[:-1]) & set(c[:-1])


def test_checkpoint_resume_draws_the_same_masks(problem, tmp_path):
    """LAMB's state, the frozen layout and the rng stream save and resume
    bitwise: 3 steps, save, a fresh engine loads and takes 2, against 5
    uninterrupted steps, with dropout on."""
    _, params, batches = problem
    kw = dict(config={"optimizer": LAMB}, model=dict(dropout=0.1), frozen_params=["embed"])
    whole, _ = _engine(params, **kw)
    want = [float(whole.train_batch(torch.from_numpy(b))) for b in batches]
    first, _ = _engine(params, **kw)
    got = [float(first.train_batch(torch.from_numpy(b))) for b in batches[:3]]
    first.save_checkpoint(str(tmp_path))
    resumed, _ = _engine(params, **kw)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed._rng_draws == first._rng_draws == 6
    got += [float(resumed.train_batch(torch.from_numpy(b))) for b in batches[3:]]
    assert got == want
    for k, v in _flat(whole).items():
        assert torch.equal(_flat(resumed)[k], v), k


# ---------------------------------------------------------------------------
# frozen_params
# ---------------------------------------------------------------------------


def test_frozen_leaves_take_no_update_and_hold_no_state(problem):
    """AdamW with weight decay: the frozen leaves stay bitwise (decoupled
    decay would move them if they were in the optimizer), they have no
    optimizer state, and the losses are the JAX engine's with the same
    frozen_params."""
    jmodel, params, batches = problem
    config = dict(CONFIG, zero_optimization={"stage": 0})
    eng, p0 = _engine(params, frozen_params=["embed", "layer_0/attn"])
    before = {k: v.clone() for k, v in convert._flatten(p0).items()}
    jeng, *_ = jds.initialize(
        model=jtf.make_loss_fn(jmodel), model_parameters=jax.tree.map(jnp.asarray, params),
        config=config, topology=Topology(TopologySpec(), devices=jax.devices()[:1]),
        frozen_params=["embed", "layer_0/attn"])
    tl = [float(eng.train_batch(torch.from_numpy(b))) for b in batches[:3]]
    jl = [float(jeng.train_batch(jnp.asarray(b))) for b in batches[:3]]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    # "_" is a name boundary too: "layer_0/attn" freezes layer_0's attn_norm
    frozen = [k for k in before if k.startswith(("embed/", "layer_0/attn"))]
    assert len(frozen) == 6
    after = _flat(eng)
    for k in before:
        assert torch.equal(after[k], before[k]) == (k in frozen), k
    m = [topt.path_name(kp) for kp, _ in
         pytree.tree_flatten_with_path(eng.state.opt_state.exp_avg)[0]]
    assert sorted(m) == sorted(set(before) - set(frozen))
    assert eng._frozen == [k in frozen for k in
                           (topt.path_name(kp) for kp, _ in
                            pytree.tree_flatten_with_path(eng.state.params)[0])]
    with pytest.raises(ValueError, match="frozen"):
        safe_get_full_optimizer_state(eng, "embed/embedding", "exp_avg")


def test_unmatched_frozen_pattern_raises_as_jax(problem):
    _, params, _ = problem
    with pytest.raises(ValueError, match="match no parameter path"):
        _engine(params, frozen_params=["embed_tokens"])
    # a pattern hits at a name-component boundary only
    with pytest.raises(ValueError, match=r"\['mbed'\] match no"):
        _engine(params, frozen_params=["mbed"])


def test_host_adam_with_frozen_leaves_takes_the_storage_tier(problem):
    _, params, batches = problem
    offload = {"zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}},
               "optimizer": {"type": "adam", "params": {"lr": 1e-2, "weight_decay": 0.1}}}
    eng, p0 = _engine(params, offload, frozen_params=["embed"])
    assert eng._host_adam is None and eng._offload_optimizer
    assert not any(topt.path_name(kp).startswith("embed/") for kp, _ in
                   pytree.tree_flatten_with_path(eng.state.opt_state.exp_avg)[0])
    assert {t.device.type for t in pytree.tree_leaves(eng.state.opt_state)
            if isinstance(t, torch.Tensor)} == {"cpu"}
    emb = p0["embed"]["embedding"].clone()
    eng.train_batch(torch.from_numpy(batches[0]))
    assert torch.equal(eng.state.params["embed"]["embedding"], emb)
    ref, _ = _engine(params, {"optimizer": offload["optimizer"]}, frozen_params=["embed"])
    ref.train_batch(torch.from_numpy(batches[0]))
    for k, v in _flat(ref).items():
        assert torch.equal(_flat(eng)[k], v), k


# ---------------------------------------------------------------------------
# the optimizer factory, mpu, LAMB and MuAdamW against the JAX engine
# ---------------------------------------------------------------------------


def test_optimizer_factory_gets_the_shapes_and_mpu_is_accepted(problem):
    _, params, batches = problem
    seen = {}

    def factory(tree):
        seen.update({topt.path_name(kp): (tuple(x.shape), x.device.type)
                     for kp, x in pytree.tree_flatten_with_path(tree)[0]})
        return topt.fused_lion(lr=1e-3)

    eng, p = _engine(params, optimizer=factory, mpu=object())
    assert seen == {k: (tuple(v.shape), "meta") for k, v in convert._flatten(p).items()}
    assert isinstance(eng.state.opt_state, topt.ScaleByLionState)
    eng.train_batch(torch.from_numpy(batches[0]))
    with pytest.raises(TypeError, match="GradientTransformation"):
        _engine(params, optimizer=lambda tree: "not an optimizer")


@pytest.mark.parametrize("optimizer", [LAMB, MUADAMW], ids=["lamb", "muadamw"])
def test_engine_with_lamb_and_muadamw_matches_jax(problem, optimizer):
    jmodel, params, batches = problem
    config = dict(CONFIG, optimizer=optimizer, zero_optimization={"stage": 0})
    jeng, *_ = jds.initialize(
        model=jtf.make_loss_fn(jmodel), model_parameters=jax.tree.map(jnp.asarray, params),
        config=config, topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    eng, _ = _engine(params, {"optimizer": optimizer})
    tl = [float(eng.train_batch(torch.from_numpy(b))) for b in batches[:3]]
    jl = [float(jeng.train_batch(jnp.asarray(b))) for b in batches[:3]]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# PrefetchLoader
# ---------------------------------------------------------------------------


def _dataset(n=24):
    return [{"x": np.full((3,), i, np.float32)} for i in range(n)]


def _head(batch):
    return [int(v) for v in np.asarray(batch["x"])[:, 0]]


def test_prefetch_loader_keeps_order_len_and_reiterates():
    """JAX tests/unit/test_monitor_profiling.py:239 on the CPU: order and
    length kept, each leaf a tensor on the asked device; re-iteration and
    ``len`` follow the wrapped loader; a one-shot generator gives a
    one-shot loader whose ``len`` raises. The card is the default, so
    without one the loader raises."""
    batches = [{"x": np.full((4, 8), i, np.float32)} for i in range(6)]
    pf = PrefetchLoader(batches, sharding=torch.device("cpu"), depth=3)
    for _ in range(2):
        out = list(pf)
        assert len(pf) == len(out) == 6
        assert [float(b["x"][0, 0]) for b in out] == list(range(6))
        assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
                   for b in out)
    assert ([float(b["x"][0]) for b in PrefetchLoader(iter(_dataset(4)), "cpu")]
            == [0.0, 1.0, 2.0, 3.0])
    with pytest.raises(TypeError, match="unsized"):
        len(PrefetchLoader(iter([]), "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            PrefetchLoader(batches)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_loader_state_accounts_for_inflight(depth):
    """JAX tests/unit/test_fleet_watchdog.py:814: the state is the consumed
    position, rolled back by the batches in flight (across an epoch
    boundary), and equals the JAX loader's."""
    inner = DeepSpeedDataLoader(_dataset(), batch_size=4, seed=5)
    jinner = JaxDataLoader(_dataset(), batch_size=4, seed=5)
    pf, jpf = PrefetchLoader(inner, "cpu", depth=depth), JaxPrefetchLoader(jinner,
                                                                           depth=depth)
    it, jit = iter(pf), iter(jpf)
    consumed = [_head(next(it)) for _ in range(2)]
    assert consumed == [_head(next(jit)) for _ in range(2)]
    state = pf.state_dict()
    assert state == jpf.state_dict()
    assert state["batch_in_epoch"] == 2 and state["global_step"] == 2
    resumed = DeepSpeedDataLoader(_dataset(), batch_size=4, seed=5)
    resumed.load_state_dict(state)
    ref = [_head(b) for b in DeepSpeedDataLoader(_dataset(), batch_size=4, seed=5)]
    assert consumed + [_head(next(iter(resumed)))] == ref[:3]
    rest = [_head(b) for b in it]
    assert consumed + rest == ref
    with pytest.raises(TypeError, match="state_dict"):
        PrefetchLoader(iter([]), "cpu").state_dict()


def test_train_batch_takes_prefetched_micro_batches(problem):
    """``train_batch(data_iter=...)`` over a PrefetchLoader trains as on
    the global batches stacked by hand."""
    _, params, batches = problem
    micro = [torch.from_numpy(mb) for b in batches[:2] for mb in np.split(b, 2)]
    fed, _ = _engine(params)
    it = iter(PrefetchLoader(micro, "cpu"))
    stacked, _ = _engine(params)
    for b in batches[:2]:
        fed.train_batch(data_iter=it)
        stacked.train_batch(torch.from_numpy(b))
    for k, v in _flat(stacked).items():
        assert torch.equal(_flat(fed)[k], v), k


# ---------------------------------------------------------------------------
# ZeRO stages 1-3 with LAMB, MuAdamW and frozen leaves: two CPU ranks
# ---------------------------------------------------------------------------

RUNS = {"lamb": (LAMB, None), "muadamw": (MUADAMW, None),
        "frozen": (CONFIG["optimizer"], ["embed"]), "lamb_frozen": (LAMB, ["embed"])}


@pytest.fixture(scope="module")
def zero_ranks(problem, tmp_path_factory):
    _, params, batches = problem
    inputs = {"model": MODEL, "params": params, "batches": batches[:3],
              "config": dict(CONFIG, train_micro_batch_size_per_gpu=1), "runs": RUNS}
    return run_world("zero_optimizers", 2, tmp_path_factory.mktemp("zero_opt"), inputs,
                     timeout=300)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("run", list(RUNS))
def test_zero_stages_equal_stage_0(zero_ranks, run, stage):
    r0 = zero_ranks[0]
    ref, key = r0[f"{run}/stage0"], f"{run}/stage{stage}"
    for r in zero_ranks:
        assert r[key] == r0[key]                                  # one loss on both ranks
        for a, b in zip(r[key + "/masters"], r0[key + "/masters"]):
            np.testing.assert_array_equal(a, b)                   # masters equal across ranks
    assert r0[key][0] == ref[0]                                   # no update has acted yet
    np.testing.assert_allclose(r0[key], ref, rtol=STAGE_RTOL)
    for a, b in zip(r0[key + "/masters"], r0[f"{run}/stage0/masters"]):
        np.testing.assert_allclose(a, b, rtol=STAGE_RTOL, atol=STAGE_RTOL)
    for a, b in zip(r0[key + "/exp_avg"], r0[f"{run}/stage0/exp_avg"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=STAGE_RTOL,
                                       atol=STAGE_RTOL * np.abs(b).max())
    if run.startswith("lamb"):
        np.testing.assert_allclose(r0[key + "/trust"], r0[f"{run}/stage0/trust"],
                                   rtol=TRUST_RTOL)
    # the optimizer sees leaf fragments; some are empty on each rank and one
    # leaf lies across the rank boundary
    assert r0[key + "/leafwise"]
    spans = [r[key + "/spans"] for r in zero_ranks]
    for s in spans:
        assert any(a == b for a, b in s) and any(a < b for a, b in s)
    assert any(a0 < b0 and a1 < b1 for (a0, b0), (a1, b1) in zip(*spans))
    # the accessors write and read a moment of that leaf in full
    assert all(r[key + "/set_get"][1] for r in zero_ranks)


@pytest.mark.parametrize("run", ["frozen", "lamb_frozen"])
def test_frozen_leaves_stay_and_hold_no_state_at_every_stage(problem, zero_ranks, run):
    _, params, _ = problem
    emb = params["embed"]["embedding"]
    r0 = zero_ranks[0]
    i = r0["paths"].index("embed/embedding")
    for stage in (0, 1, 2, 3):
        key = f"{run}/stage{stage}"
        np.testing.assert_array_equal(r0[key + "/masters"][i], emb)
        assert r0[key + "/exp_avg"][i] is None
        if stage:
            # the two moments cover the trainable leaves' fragments only,
            # each element on one rank
            n = sum(np.prod(np.shape(m)) for m in r0[key + "/masters"])
            total = sum(r[key + "/state_elems"] for r in zero_ranks)
            assert total == 2 * (n - emb.size)


def test_frozen_leaves_under_the_storage_tier_at_stage_2(zero_ranks):
    """offload_optimizer cpu over two ranks takes the storage tier: the
    state lives in host memory, holds nothing for the frozen leaf, and the
    run is bitwise the device run."""
    for r in zero_ranks:
        storage, homes, elems = r["frozen_offload/state"]
        assert storage and homes == {"cpu"}
        assert elems == r["frozen/stage2/state_elems"]
        assert r["frozen_offload"] == r["frozen/stage2"]
        for a, b in zip(r["frozen_offload/masters"], r["frozen/stage2/masters"]):
            np.testing.assert_array_equal(a, b)


def test_zero_lamb_with_frozen_leaves_resumes_bitwise(zero_ranks):
    r0 = zero_ranks[0]
    assert r0["resumed"] == r0["lamb_frozen/stage2"][2]
    for a, b in zip(r0["resumed/masters"], r0["lamb_frozen/stage2/masters"]):
        np.testing.assert_array_equal(a, b)
