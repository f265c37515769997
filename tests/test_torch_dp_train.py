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
* the gates: ``mics_shard_size`` and ``hierarchical`` raise, fp16 keeps
  the exact reduction;
* a save at world size 2 resumed by a fresh engine bitwise (``int8_sr``,
  whose dither is seeded by the step);
* ZeRO stages 1, 2 and 3 in the same world: each against the JAX engine at
  dp = 2 at the same stage (``FIRST_RTOL`` / ``LATER_RTOL``) and against the
  port's stage 0 (the first loss bitwise equal, the later within
  ``STAGE_RTOL``: the reductions and the norm sum in other orders); the full
  masters equal on both ranks, the Adam state ``ceil(n / 2)`` elements per
  rank, at stage 3 no full master on either rank; the imperative path and
  ``no_sync`` at stages 2 and 3; an fp16 overflow skipped on both ranks; the
  ``tensor_fragment`` accessors at stage 3 against the JAX package's at
  stage 3 (``ACCESSOR_RTOL`` / ``ACCESSOR_ATOL``: after three Adam steps);
  a stage-3 save resumed bitwise at stage 3 and at stage 0, and read by
  ``zero_to_fp32``;
* ``offload_optimizer`` cpu at stage 1: the storage tier (the JAX rule at
  world size > 1), bitwise stage 1.
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
STAGE_RTOL = 1e-5
ACCESSOR_RTOL, ACCESSOR_ATOL = 1e-4, 1e-6
STAGES = (1, 2, 3)
# leaves the accessor test reads: one that rank 0 and rank 1 split
# (layer_0's mlp_norm straddles the middle of the flat partition), and
# three that one rank holds alone
PATHS = ["layer_0/mlp_norm/scale", "layer_1/attn/q_proj/kernel", "embed/embedding",
         "lm_head/kernel"]


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
    micro = np.stack([dataset[j] for j in range(MICRO * WORLD)])   # the window's batch
    return jmodel, params, dataset, batches[:3], micro


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    _, params, dataset, batches, micro = problem
    inputs = {"model": MODEL, "params": params, "config": CONFIG, "batches": batches,
              "dataset": dataset, "cc_block": 512, "paths": PATHS, "micro": micro}
    return run_world("train", WORLD, tmp_path_factory.mktemp("dp_train"), inputs,
                     timeout=150)


@pytest.fixture(scope="module")
def one_process(problem):
    _, params, _, batches, _ = problem
    cfg = ttf.TransformerConfig(**MODEL, dtype=torch.float32)
    p = convert.params_from_jax(params, cfg, device="cpu")
    eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, p)),
                             model_parameters=p, device="cpu",
                             config=dict(CONFIG, train_micro_batch_size_per_gpu=MICRO * WORLD))
    losses = [float(eng.train_batch(torch.from_numpy(b))) for b in batches]
    reset_fastpath()
    return losses


def _jax_engine(problem, stage):
    jmodel, params, _, _, _ = problem
    eng, *_ = jds.initialize(model=jtf.make_loss_fn(jmodel),
                             model_parameters=jax.tree.map(jnp.asarray, params),
                             config=dict(CONFIG, zero_optimization={"stage": stage}),
                             topology=Topology(TopologySpec(), devices=jax.devices()[:WORLD]))
    return eng


@pytest.fixture(scope="module")
def jax_dp2(problem):
    eng = _jax_engine(problem, 0)
    return [float(eng.train_batch(jnp.asarray(b))) for b in problem[3]]


@pytest.fixture(scope="module")
def jax_zero(problem):
    """The JAX engine at dp = 2 at each stage: its losses, and at stage 3
    the accessors after the steps and inside a backward() window."""
    from deepspeed_tpu.utils import tensor_fragment as jtf_acc

    out = {}
    for stage in STAGES:
        eng = _jax_engine(problem, stage)
        out[stage] = [float(eng.train_batch(jnp.asarray(b))) for b in problem[3]]
    out["param"] = [jtf_acc.safe_get_full_fp32_param(eng, p) for p in PATHS]
    out["exp_avg"] = [jtf_acc.safe_get_full_optimizer_state(eng, p, "exp_avg") for p in PATHS]
    out["exp_avg_sq"] = [jtf_acc.safe_get_full_optimizer_state(eng, p, "exp_avg_sq")
                         for p in PATHS]
    eng.forward(jnp.asarray(problem[4]))
    eng.backward()
    out["grad"] = [jtf_acc.safe_get_full_grad(eng, p) for p in PATHS]
    return out


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
    assert "mics_shard_size=2" in gates["mics"] and "Queue A item 8" in gates["mics"]
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


@pytest.mark.parametrize("stage", STAGES)
def test_zero_stage_matches_jax_engine_and_stage_zero(ranks, jax_zero, stage):
    got = ranks[0][f"stage{stage}"]
    assert ranks[1][f"stage{stage}"] == got
    _close(got, jax_zero[stage])
    exact = ranks[0]["exact"]
    assert got[0] == exact[0]               # no update has acted yet
    np.testing.assert_allclose(got[1:], exact[1:], rtol=STAGE_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("stage", STAGES)
def test_zero_masters_equal_across_ranks_and_adam_sharded(ranks, stage):
    name = f"stage{stage}"
    n = ranks[0][name + "/n"]
    for r in ranks:
        assert r[name + "/adam"] == [(-(-n // WORLD),)]     # ceil(n / 2) per rank
    for a, b, ref in zip(ranks[0][name + "/full"], ranks[1][name + "/full"],
                         ranks[0]["exact/masters"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, ref, rtol=STAGE_RTOL, atol=1e-7)
    full = [tuple(a.shape) for a in ranks[0][name + "/full"]]
    if stage < 3:
        assert ranks[0][name + "/shapes"] == full
    else:   # no rank holds a full master: 1-D fragments, ceil(n / 2) in all
        for r in ranks:
            assert all(len(s) == 1 for s in r[name + "/shapes"])
            assert sum(s[0] for s in r[name + "/shapes"]) <= -(-n // WORLD)
        assert sum(s[0] for r in ranks for s in r[name + "/shapes"]) == n


def test_offload_at_world_two_is_the_storage_tier_and_bitwise_stage_one(ranks):
    """offload_optimizer cpu over two ranks takes the pinned-host storage
    tier (the JAX rule: the host step needs the whole gradient): the same
    stage-1 update on the same values, so losses and masters are bitwise
    stage 1's, and the full moments gather from host memory."""
    for r in ranks:
        assert r["stage1_offload"] == r["stage1"]
        assert r["stage1_offload/tier"] == [True, True, ["cpu"]]
        for a, b in zip(r["stage1_offload/full"], r["stage1/full"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ranks[0]["stage1_offload/moments"], ranks[1]["stage1_offload/moments"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", (2, 3))
def test_zero_imperative_path_and_no_sync(ranks, stage):
    r = ranks[0]
    got = r[f"imperative_stage{stage}"]
    assert got == ranks[1][f"imperative_stage{stage}"]
    np.testing.assert_allclose(got, r["imperative_exact"], rtol=STAGE_RTOL)
    for a, b in zip(r[f"imperative_stage{stage}/full"], r["imperative_exact/masters"]):
        np.testing.assert_allclose(a, b, rtol=STAGE_RTOL, atol=1e-7)
    # no_sync defers the reduce-scatter to the window's last micro-batch:
    # the step train_batch takes on that batch; unreduced gradients refuse
    # to be read
    assert "no_sync()" in r[f"no_sync_stage{stage}/pending"]
    for a, b in zip(r[f"no_sync_stage{stage}/full"], r["exact_1step/masters"]):
        np.testing.assert_allclose(a, b, rtol=STAGE_RTOL, atol=1e-7)


def test_zero_fp16_overflow_skipped_on_both_ranks(ranks):
    for r in ranks:
        assert r["fp16_stage3"]["skipped"] == 1 and r["fp16_stage3"]["kept"]
    assert ranks[0]["fp16_stage3"] == ranks[1]["fp16_stage3"]


def test_tensor_fragment_at_stage3_matches_jax(ranks, jax_zero):
    acc = [r["accessors"] for r in ranks]
    for key in ("param", "exp_avg", "exp_avg_sq", "grad"):
        for i, want in enumerate(jax_zero[key]):
            np.testing.assert_array_equal(acc[0][key][i], acc[1][key][i])
            np.testing.assert_allclose(acc[0][key][i], want, rtol=ACCESSOR_RTOL,
                                       atol=ACCESSOR_ATOL, err_msg=f"{key} {PATHS[i]}")
    for r in ranks:    # stage 0's window: the reduced flat accumulator
        a0 = r["accessors0"]
        for i, want in enumerate(jax_zero["grad"]):
            np.testing.assert_allclose(a0["grad"][i], want, rtol=ACCESSOR_RTOL,
                                       atol=ACCESSOR_ATOL, err_msg=f"stage 0 {PATHS[i]}")
            np.testing.assert_array_equal(a0["local_grad"][i], a0["grad"][i])
            np.testing.assert_allclose(a0["param"][i], jax_zero["param"][i],
                                       rtol=ACCESSOR_RTOL, atol=ACCESSOR_ATOL)
    for a in acc:
        assert a["grad_outside"] is None          # train_batch keeps no gradients
        for i in range(len(PATHS)):
            lo, hi = a["spans"][i]
            for key, local in (("param", "local_param"), ("exp_avg", "local_exp_avg"),
                               ("grad", "local_grad")):
                np.testing.assert_array_equal(a[local][i], a[key][i].reshape(-1)[lo:hi])
    # PATHS[0] straddles the ranks: each holds a non-empty part of it
    assert all(0 < hi - lo < acc[0]["param"][0].size for lo, hi in
               (a["spans"][0] for a in acc))
    for a in acc:
        s = a["set"]
        np.testing.assert_array_equal(s["param"], np.full_like(s["param"], 0.5))
        np.testing.assert_array_equal(s["exp_avg"], np.full_like(s["exp_avg"], 0.25))
        np.testing.assert_allclose(s["grad"], np.full_like(s["grad"], 2.0), rtol=1e-6)
        # each rank's local writes land in its own fragment
        flat = s["local_param"].reshape(-1)
        ref = acc[0]["param"][0].reshape(-1)
        np.testing.assert_allclose(flat, ref + 1.0, rtol=1e-6)
        np.testing.assert_array_equal(s["local_grad"], np.zeros_like(s["local_grad"]))
        np.testing.assert_array_equal(s["local_exp_avg_sq"],
                                      np.ones_like(s["local_exp_avg_sq"]))


def test_stage3_checkpoint_resumes_at_stage3_and_stage0(ranks):
    for r in ranks:
        for stage in (3, 0):
            c = r[f"ckpt3_to{stage}"]
            assert c["client"] == {"stage": 3} and c["step"] == 2
            assert c["loaded_equal"] and c["adam_equal"]
        assert r["ckpt3_to3"]["losses"] == r["stage3"][2:]       # bitwise
        np.testing.assert_allclose(r["ckpt3_to0"]["losses"], r["stage3"][2:],
                                   rtol=STAGE_RTOL)
    assert ranks[0]["ckpt3/zero_to_fp32"]
