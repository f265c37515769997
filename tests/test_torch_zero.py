"""The port's ``runtime.zero`` package against the JAX package's, on the CPU.

* ``shard_param_spec`` and ``ZeroShardingRules`` (every spec and spec tree)
  equal to the JAX ones over a grid of shapes, base specs, stages and fsdp
  sizes 1, 2, 4 and 8 (a JAX ``Topology`` on that many CPU devices; the
  port's rules read the same axis sizes from a topology of the same
  sizes); ``shardings`` gives ``Shard(d)`` on the dim the spec names;
* the memory estimators equal to the JAX ones on counts, on carried
  parameter trees and on an ``nn.Module``;
* ``tiled_matmul`` forward and gradients against the JAX function over
  splits and ``remat`` (``RTOL``: the two packages' matmuls round
  differently), its divisibility error; ``TiledLinear`` against flax's on
  carried weights;
* ``Init``'s closure semantics and refusals, and the ROADMAP.md items the
  unported names (MiCS, ZeRO++, the swapper) name.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu.runtime.zero import sharding as jsharding
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.parallel import topology as ttopology
from deepspeed_tpu_torch.runtime.zero import sharding as tsharding
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(), (7,), (2048,), (4096,), (64, 96), (96, 64), (48, 48), (3, 5, 7),
          (128, 128), (8, 2048, 3), (4097,), (2, 3, 1024)]
BASES = [None, ("tp",), (None, "tp"), (("dp_outer", "ep", "sp"),), ("dp_outer",)]
SIZES = (1, 2, 4, 8)


class _Topo:
    """The port topology's axis accessors at a given dp size, without a
    process group (the port builds its mesh only over a live world)."""
    fsdp_axes = ttopology.Topology.fsdp_axes

    def __init__(self, dp):
        self._sizes = {"pp": 1, "dp_outer": dp, "ep": 1, "sp": 1, "tp": 1, "dp": dp}

    axis_size = ttopology.Topology.axis_size


def _jax_topo(size):
    return Topology(TopologySpec(), devices=jax.devices()[:size])


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("size", SIZES)
def test_shard_param_spec_matches_jax(size):
    axes = ("dp_outer", "ep", "sp")
    for shape, base, min_size in itertools.product(SHAPES, BASES, (2 ** 11, 1)):
        if base is not None and len(base) > len(shape):
            continue
        want = jsharding.shard_param_spec(
            shape, None if base is None else jax.sharding.PartitionSpec(*base), axes, size,
            min_size)
        got = tsharding.shard_param_spec(shape, base, axes, size, min_size)
        assert got == _spec(want) + (None,) * (len(shape) - len(want)), (shape, base)
    # one shard axis names the axis, not a tuple
    assert tsharding.shard_param_spec((4096, 8), None, ("dp",), 2) == ("dp", None)


@pytest.mark.parametrize("stage", (0, 1, 2, 3))
@pytest.mark.parametrize("size", SIZES)
def test_zero_sharding_rules_match_jax(stage, size):
    jr = jsharding.ZeroShardingRules(stage, _jax_topo(size))
    tr = tsharding.ZeroShardingRules(stage, _Topo(size))
    assert tr.fsdp_axes == jr.fsdp_axes and tr.fsdp_size == jr.fsdp_size == size
    for shape in SHAPES:
        for meth in ("param_spec", "opt_state_spec", "grad_accum_spec"):
            want = _spec(getattr(jr, meth)(shape, None))
            assert getattr(tr, meth)(shape, None) == want, (meth, shape)
    # the tree helpers, with and without base specs
    tree = {"a": np.zeros((4096, 8)), "b": {"c": np.zeros((8,)), "d": np.zeros((64, 2048))}}
    ttree = {"a": torch.zeros(4096, 8), "b": {"c": torch.zeros(8), "d": torch.zeros(64, 2048)}}
    P = jax.sharding.PartitionSpec
    jbase = {"a": P(None, "tp"), "b": {"c": None, "d": P("tp")}}
    tbase = {"a": (None, "tp"), "b": {"c": None, "d": ("tp",)}}
    for meth in ("param_spec_tree", "opt_spec_tree", "grad_spec_tree"):
        for jb, tb in ((None, None), (jbase, tbase)):
            want = jax.tree.map(_spec, getattr(jr, meth)(tree, jb),
                                is_leaf=lambda x: isinstance(x, P))
            assert getattr(tr, meth)(ttree, tb) == want, (meth, tb)


def test_shardings_are_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    tr = tsharding.ZeroShardingRules(3, _Topo(2))
    specs = tr.param_spec_tree({"a": torch.zeros(4096, 8), "b": torch.zeros(8, 4096),
                                "c": torch.zeros(7)})
    assert tr.shardings(specs) == {"a": (Shard(0),), "b": (Shard(1),), "c": (Replicate(),)}
    assert tsharding.ZeroShardingRules(3, _Topo(1)).shardings(specs)["a"] == (Replicate(),)


def test_mics_and_zeropp_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tsharding.ZeroShardingRules(3, _Topo(2), mics_shard_size=2)
    z = tds.zero
    for call in (lambda: z.hierarchical_all_gather(None, "ep", "dp_outer"),
                 z.hpz_remat_policy, lambda: z.ZeroPPState(0, None, None),
                 lambda: z.zeropp_train_step_factory(None, None, None)):
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            call()
    # the NVMe swapper of ZeRO-Offload is ported (tests/test_torch_aio.py)
    from deepspeed_tpu_torch.runtime.zero.swapper import AsyncTensorSwapper
    assert z.AsyncTensorSwapper is AsyncTensorSwapper
    assert z.__all__ == jds.zero.__all__
    assert all(hasattr(z, name) for name in z.__all__)


def _model_trees():
    cfg = dict(vocab_size=97, hidden_size=32, intermediate_size=48, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=16)
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**cfg, dtype=jnp.float32))
    jtree = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = ttf.TransformerConfig(**cfg, dtype=torch.float32)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(jtree))
    return jtree, convert.params_from_jax(params, tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("stage", (0, 1, 2, 3))
def test_estimators_match_jax(stage):
    from deepspeed_tpu.runtime.zero import memory_estimators as jme
    from deepspeed_tpu_torch.runtime.zero import memory_estimators as tme

    jtree, ttree, tcfg = _model_trees()
    module = ttf.TransformerLM(tcfg, ttree)
    for dp, cb in itertools.product((1, 2, 3, 8), (2, 4)):
        for count in (1_100_048_384, 21_728, 7):
            assert (tme.estimate_zero_model_states_mem_needs(count, stage, dp, cb)
                    == jme.estimate_zero_model_states_mem_needs(count, stage, dp, cb))
        want = jme.estimate_zero_model_states_mem_needs(jtree, stage, dp, cb)
        assert tme.estimate_zero_model_states_mem_needs(ttree, stage, dp, cb) == want
        assert tme.estimate_zero_model_states_mem_needs(module, stage, dp, cb) == want
    for fn in ("estimate_zero2_model_states_mem_needs_all_live",
               "estimate_zero3_model_states_mem_needs_all_live"):
        assert getattr(tme, fn)(ttree, 4, 2) == getattr(jme, fn)(jtree, 4, 2)
    # TinyLlama-1.1B: 18P bytes at stage 0 against 9P at stage 3 on 2 ranks
    p = 1_100_048_384
    assert tme.estimate_zero_model_states_mem_needs(p, 0, 2)["total_bytes"] == 18 * p
    assert tme.estimate_zero_model_states_mem_needs(p, 3, 2)["total_bytes"] == 9 * p


@pytest.mark.parametrize("out_splits, in_splits", [(1, 1), (2, 1), (1, 4), (3, 2), (6, 8)])
@pytest.mark.parametrize("remat", [False, True])
def test_tiled_matmul_matches_jax(out_splits, in_splits, remat):
    rng = np.random.default_rng(out_splits * 10 + in_splits)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    ct = rng.standard_normal((2, 5, 12)).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jtiling.tiled_matmul(x, w, out_splits, in_splits, remat) * ct)

    jy = jtiling.tiled_matmul(jnp.asarray(x), jnp.asarray(w), out_splits, in_splits, remat)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = ttiling.tiled_matmul(tx, tw, out_splits, in_splits, remat)
    (ty * torch.from_numpy(ct)).sum().backward()
    for got, want in ((ty, jy), (tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_tiled_matmul_refuses_indivisible_splits():
    w = torch.zeros(16, 12)
    with pytest.raises(ValueError, match=r"w \(16, 12\) not divisible by splits \(3, 1\)"):
        ttiling.tiled_matmul(torch.zeros(2, 16), w, 1, 3)
    with pytest.raises(ValueError, match="not divisible"):
        ttiling.tiled_matmul(torch.zeros(2, 16), w, 5, 1)


@pytest.mark.parametrize("use_bias", [True, False])
def test_tiled_linear_matches_flax_on_carried_weights(use_bias):
    jmod = jtiling.TiledLinear(16, 12, in_splits=2, out_splits=3, use_bias=use_bias)
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if use_bias:   # a non-zero bias, so the carry is checked
        variables = dict(variables, bias=jnp.linspace(-1, 1, 12))
    want = jmod.apply({"params": variables}, jnp.asarray(x))
    tmod = ttiling.TiledLinear(16, 12, 2, 3, use_bias, device="cpu")
    assert tuple(tmod.kernel.shape) == tuple(variables["kernel"].shape) == (16, 12)
    with torch.no_grad():
        tmod.kernel.copy_(torch.from_numpy(np.array(variables["kernel"])))
        if use_bias:
            tmod.bias.copy_(torch.from_numpy(np.array(variables["bias"], np.float32)))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # its own draw: lecun_normal's scale, truncated at two standard deviations
    k = ttiling.TiledLinear(256, 512, device="cpu").kernel.detach()
    std = (1 / 256) ** 0.5
    assert abs(float(k.std()) - std) < 0.05 * std and float(k.abs().max()) <= 2 * std / 0.8796
    if not torch.cuda.is_available():   # the card by default, as every entry point
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttiling.TiledLinear(4, 4)


def test_init_wraps_a_closure():
    tree = {"w": torch.ones(3)}
    init = tds.zero.Init(lambda: tree)
    assert init() is tree
    with pytest.raises(RuntimeError, match="init closure"):
        with tds.zero.Init(lambda: tree):
            pass
    with pytest.raises(TypeError, match="zero-arg init closure"):
        tds.zero.Init(tree)
    with pytest.raises(ValueError, match="without an init closure"):
        tds.zero.Init()()


def test_initialize_takes_the_init_closure():
    """One process: the engine calls a zero.Init closure (or a bare lambda)
    and trains what it built, as from the tree itself."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath

    _, ttree, tcfg = _model_trees()
    batch = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (4, 16)))
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "zero_optimization": {"stage": 3}}
    from torch.utils import _pytree as pytree

    copy = lambda: pytree.tree_map(torch.clone, ttree)
    losses = []
    for params in (copy, tds.zero.Init(copy), copy()):
        model = ttf.TransformerLM(tcfg, ttree)
        eng, *_ = tds.initialize(model=ttf.make_loss_fn(model), model_parameters=params,
                                 config=config, device="cpu")
        losses.append([float(eng.train_batch(batch)) for _ in range(2)])
        reset_fastpath()
    assert losses[0] == losses[1] == losses[2]


def test_tensor_fragment_in_one_process_matches_jax():
    """World size 1: the accessors on the port's engine against the JAX
    package's on its engine, after two steps and inside a backward()
    window (the gradients are the masters' ``.grad``), and the setters."""
    from deepspeed_tpu.utils import tensor_fragment as jacc
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
    from deepspeed_tpu_torch.utils import tensor_fragment as tacc

    jtree, ttree, tcfg = _model_trees()
    cfg = dict(vocab_size=97, hidden_size=32, intermediate_size=48, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=16)
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**cfg, dtype=jnp.float32))
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}, "steps_per_print": 10**9}
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 97, (4, 16)) for _ in range(2)]
    micro = rng.integers(0, 97, (2, 16))
    jeng, *_ = jds.initialize(model=jtf.make_loss_fn(jmodel), model_parameters=jtree,
                              config=config, topology=Topology(TopologySpec(),
                                                               devices=jax.devices()[:1]))
    teng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, ttree)),
                              model_parameters=ttree, config=config, device="cpu")
    for b in batches:
        jeng.train_batch(jnp.asarray(b))
        teng.train_batch(torch.from_numpy(b))
    assert tacc.safe_get_full_grad(teng, "lm_head/kernel") is None
    jeng.forward(jnp.asarray(micro))
    jeng.backward()
    teng.forward(torch.from_numpy(micro))
    teng.backward()
    paths = ["embed/embedding", "layer_1/attn/q_proj/kernel", "final_norm/scale"]
    for p in paths:
        for got, want in ((tacc.safe_get_full_fp32_param(teng, p),
                           jacc.safe_get_full_fp32_param(jeng, p)),
                          (tacc.safe_get_local_fp32_param(teng, p),
                           jacc.safe_get_local_fp32_param(jeng, p)),
                          (tacc.safe_get_full_grad(teng, p), jacc.safe_get_full_grad(jeng, p)),
                          (tacc.safe_get_local_grad(teng, p), jacc.safe_get_local_grad(jeng, p)),
                          (tacc.safe_get_full_optimizer_state(teng, p, "exp_avg"),
                           jacc.safe_get_full_optimizer_state(jeng, p, "exp_avg")),
                          (tacc.safe_get_local_optimizer_state(teng, p, "exp_avg_sq"),
                           jacc.safe_get_local_optimizer_state(jeng, p, "exp_avg_sq"))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6,
                                       err_msg=p)
    p, shape = paths[2], (32,)
    tacc.safe_set_full_fp32_param(teng, p, torch.full(shape, 0.5))
    tacc.safe_set_local_optimizer_state(teng, p, torch.full(shape, 0.25), "exp_avg")
    tacc.safe_set_full_grad(teng, p, torch.full(shape, 3.0))
    assert torch.equal(tacc.safe_get_local_fp32_param(teng, p), torch.full(shape, 0.5))
    assert torch.equal(tacc.safe_get_full_optimizer_state(teng, p, "exp_avg"),
                       torch.full(shape, 0.25))
    assert torch.equal(tacc.safe_get_full_grad(teng, p), torch.full(shape, 3.0))
    # the copies never alias the live state
    tacc.safe_get_full_fp32_param(teng, p).zero_()
    assert torch.equal(tacc.safe_get_full_fp32_param(teng, p), torch.full(shape, 0.5))
    with pytest.raises(ValueError, match="shape mismatch"):
        tacc.safe_set_full_fp32_param(teng, p, torch.zeros(3))
    with pytest.raises(KeyError, match="subtree"):
        tacc.safe_get_full_fp32_param(teng, "layer_0")
    with pytest.raises(ValueError, match="device_index"):
        tacc.safe_get_local_fp32_param(teng, p, device_index=1)
    reset_fastpath()
