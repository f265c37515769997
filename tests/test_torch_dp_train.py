"""Data-parallel training of the port in a gloo world of 2, on the CPU.

The ranks (``tests/torch_dist_worker.py``, torch only) train a 2-layer fp32
``TransformerLM`` through ``initialize`` + ``train_batch`` on the same global
batches as the references here:

* the exact reduction against the one-process port on the global batch and
  against the JAX engine at dp = 2 on two CPU devices with the same weights
  (``params_from_jax``): the first loss within 1e-5 relative, the next two
  within 1e-4 (the packages and the rank split sum in different orders);
* ``compressed_collectives`` ``int8`` and ``int8_sr`` (block 512) within the
  JAX package's tracking bound, 2% + 1e-3, of the exact losses, their first
  loss bitwise equal to the exact path's (no reduction has acted yet);
* ``mode: none`` bitwise equal to no section; the masters bitwise equal
  across ranks after every run;
* the imperative ``forward``/``backward``/``step`` path, exact and
  compressed, and ``no_sync``; the distributed loader;
* the gates: ZeRO stage 1 at world size 2 and ``hierarchical`` raise, fp16
  keeps the exact reduction;
* a save at world size 2 resumed by a fresh engine bitwise (``int8_sr``,
  whose dither is seeded by the step).
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
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath

from .torch_dist_worker import run_world

WORLD = 2
MODEL = dict(vocab_size=97, hidden_size=32, intermediate_size=48, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=16)
SEQ, MICRO, GAS = 16, 2, 2
CONFIG = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
          "steps_per_print": 10**9}
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-4


def _track(ref, got):
    """The JAX package's compressed-tracking bound (test_compressed_collectives)."""
    return all(abs(a - b) < 0.02 * abs(a) + 1e-3 for a, b in zip(ref, got))


@pytest.fixture(scope="module")
def problem():
    jcfg = jtf.TransformerConfig(**MODEL, dtype=jnp.float32)
    jmodel = jtf.TransformerLM(jcfg)
    tree = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))
    rng = np.random.default_rng(5)
    dataset = [rng.integers(0, 97, SEQ).astype(np.int64) for _ in range(16)]
    # the global batches the distributed loader yields (seed 0, epoch e)
    step = MICRO * WORLD * GAS
    batches = []
    for epoch in range(2):
        order = np.arange(len(dataset))
        np.random.default_rng(epoch).shuffle(order)
        for i in range(len(dataset) // step):
            batches.append(np.stack([dataset[j] for j in order[i * step:(i + 1) * step]]))
    return jmodel, params, dataset, batches[:3]


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    _, params, dataset, batches = problem
    inputs = {"model": MODEL, "params": params, "config": CONFIG, "batches": batches,
              "dataset": dataset, "cc_block": 512}
    return run_world("train", WORLD, tmp_path_factory.mktemp("dp_train"), inputs,
                     timeout=150)


@pytest.fixture(scope="module")
def one_process(problem):
    _, params, _, batches = problem
    cfg = ttf.TransformerConfig(**MODEL, dtype=torch.float32)
    p = convert.params_from_jax(params, cfg, device="cpu")
    eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, p)),
                             model_parameters=p, device="cpu",
                             config=dict(CONFIG, train_micro_batch_size_per_gpu=MICRO * WORLD))
    losses = [float(eng.train_batch(torch.from_numpy(b))) for b in batches]
    reset_fastpath()
    return losses


@pytest.fixture(scope="module")
def jax_dp2(problem):
    jmodel, params, _, batches = problem
    eng, *_ = jds.initialize(model=jtf.make_loss_fn(jmodel),
                             model_parameters=jax.tree.map(jnp.asarray, params),
                             config=CONFIG,
                             topology=Topology(TopologySpec(), devices=jax.devices()[:WORLD]))
    return [float(eng.train_batch(jnp.asarray(b))) for b in batches]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=LATER_RTOL)


def test_exact_reduction_matches_one_process_and_jax_engine(ranks, one_process, jax_dp2):
    got = ranks[0]["exact"]
    assert ranks[1]["exact"] == got        # the rank mean is one value
    _close(got, one_process)
    _close(got, jax_dp2)
    assert got[-1] < got[0]
    assert ranks[0]["exact/mode"] is None


def test_masters_bitwise_equal_across_ranks(ranks):
    names = [k for k in ranks[0] if k.endswith("/masters")]
    assert len(names) >= 10
    for name in names:
        for a, b in zip(ranks[0][name], ranks[1][name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_mode_none_bitwise_equal_to_no_section(ranks):
    r = ranks[0]
    assert r["none"] == r["exact"]
    for a, b in zip(r["none/masters"], r["exact/masters"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "int8_sr"])
def test_compressed_reduction_tracks_exact(ranks, jax_dp2, mode):
    r = ranks[0]
    assert r[mode + "/mode"] == mode
    assert r[mode][0] == r["exact"][0]      # no reduction has acted yet
    assert _track(r["exact"], r[mode]), (r["exact"], r[mode])
    assert _track(jax_dp2, r[mode]), (jax_dp2, r[mode])
    assert r[mode] != r["exact"]            # the int8 transport did act


def test_imperative_path_reduces_each_micro_batch(ranks):
    r = ranks[0]
    # per-micro exact reductions sum to the step's reduction (fp32 order only)
    for a, b in zip(r["imperative_exact/masters"], r["exact/masters"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert _track(r["imperative_exact"], r["imperative_int8"])
    assert r["imperative_int8/masters"][0].tobytes() != r["imperative_exact/masters"][0].tobytes()
    # no_sync defers the reduction to the window's last micro-batch: the same
    # step as train_batch on that batch
    for a, b in zip(r["no_sync/masters"], r["exact_1step/masters"]):
        np.testing.assert_array_equal(a, b)


def test_distributed_loader_feeds_each_rank_its_share(ranks):
    r = ranks[0]
    assert r["loader/len"] == 16 // (MICRO * WORLD)
    assert r["loader"] == r["exact"][:2]


def test_gates(ranks):
    gates = ranks[0]["gates"]
    assert "ZeRO stage 1 at world size 2" in gates["stage1"] and "ROADMAP" in gates["stage1"]
    assert "hierarchical" in gates["hierarchical"] and "ROADMAP" in gates["hierarchical"]
    assert ranks[0]["fp16_int8/mode"] is None          # fp16 keeps the exact reduction
    assert all(np.isfinite(ranks[0]["fp16_int8"]))


def test_checkpoint_at_world_two_resumes_bitwise(ranks):
    for r in ranks:
        assert r["ckpt/loaded_equal"]
        assert r["ckpt/client"] == {"step": 2}
        assert r["ckpt/losses"] == r["int8_sr"]
        for a, b in zip(r["ckpt/masters"], r["int8_sr/masters"]):
            np.testing.assert_array_equal(a, b)
    assert "latest" in ranks[0]["ckpt/files"]
