"""Tensor-parallel training of the port against the JAX engine, on the CPU.

One gloo world of 4 ranks (``tests/torch_dist_worker.py``, scenario
``tp_train``: dp 2 x tp 2, ranks 0-1 one tp row) trains a 2-layer fp32
``TransformerLM`` (vocab 256, so each vocab shard is 128 wide, as the fused
loss's plain version asks) through ``initialize`` + ``train_batch`` with
``tensor_parallel.tp_size`` 2 on the same global batches as:

* the JAX engine at tp 2 on four of the 8 CPU devices (dp 2 x tp 2), the
  parameters placed by ``param_specs`` (the generic pack), with and
  without ``vocab_parallel_loss``;
* the port in one process at tp 1 (the dense model).

Tolerances (fp32; the packages and the tp split sum in other orders): the
first loss within 1e-5 relative, the later ones within 1e-4; the loss's
gradients on the shards, gathered, within 1e-4 relative and 1e-6 absolute
of the JAX gradients; the masters after three AdamW steps within 1e-4
relative and 1e-4 absolute (a tenth of the learning rate: AdamW moves a
weight whose gradient is near zero by up to lr whatever its size). Bitwise: every replicated leaf's master (and
gradient) on the ranks of a tp row; a checkpoint saved at tp 2 resumed at
tp 2; the masters of that checkpoint loaded at tp 1 equal to the tp 2
engine's gathered masters. ``param_specs`` as ``"auto"``, a ``RuleSet`` and
an explicit tree (the MLP whole), ZeRO 1 over the dp group, the
collective-matmul rings with the embedding ring, kv heads that do not
divide over tp (replicated by the JAX rule) and dropout (the same masks on
the tp ranks of a dp replica) each against the references above.
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

WORLD, TP = 4, 2
DP = WORLD // TP
MODEL = dict(vocab_size=256, hidden_size=32, intermediate_size=48, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=16)
KVREP = dict(MODEL, num_kv_heads=1)
SEQ, MICRO, GAS = 16, 2, 2
CONFIG = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
          "steps_per_print": 10**9}
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _jax_params(model, seed):
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**model, dtype=jnp.float32))
    tree = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def problem():
    jmodel, params = _jax_params(MODEL, 0)
    _, kv_params = _jax_params(KVREP, 1)
    rng = np.random.default_rng(24)
    n = MICRO * DP * GAS
    batches = [rng.integers(0, 256, (n, SEQ)).astype(np.int64) for _ in range(3)]
    grad_batch = rng.integers(0, 256, (MICRO, SEQ)).astype(np.int64)
    return jmodel, params, kv_params, batches, grad_batch


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    _, params, kv_params, batches, grad_batch = problem
    inputs = {"model": MODEL, "params": params, "config": CONFIG, "batches": batches,
              "grad_batch": grad_batch,
              "kvrep": {"model": {"num_kv_heads": 1}, "params": kv_params}}
    return run_world("tp_train", WORLD, tmp_path_factory.mktemp("tp_train"), inputs,
                     timeout=400)


def _jax_run(problem, vocab_parallel=False):
    """The JAX engine at dp 2 x tp 2: its losses and its final params."""
    jmodel, params, _, batches, _ = problem
    if vocab_parallel:
        jmodel = jtf.TransformerLM(jtf.TransformerConfig(**MODEL, dtype=jnp.float32,
                                                         vocab_parallel_loss=True))
    eng, *_ = jds.initialize(
        model=jtf.make_loss_fn(jmodel), model_parameters=jax.tree.map(jnp.asarray, params),
        config=dict(CONFIG, tensor_parallel={"enabled": True, "tp_size": TP}),
        topology=Topology(TopologySpec(tp=TP), devices=jax.devices()[:WORLD]),
        param_specs=jtf.param_specs(params))
    losses = [float(eng.train_batch(jnp.asarray(b))) for b in batches]
    return losses, jax.tree.map(np.asarray, jax.device_get(eng.state.params))


@pytest.fixture(scope="module")
def jax_tp(problem):
    return {"dense": _jax_run(problem), "vocab_parallel": _jax_run(problem, True)}


@pytest.fixture(scope="module")
def one_process(problem):
    """The port at tp 1 in this process on the same global batches."""
    _, params, kv_params, batches, _ = problem
    out = {}
    for name, model, p in (("dense", MODEL, params), ("kvrep", KVREP, kv_params)):
        cfg = ttf.TransformerConfig(**model, dtype=torch.float32)
        full = convert.params_from_jax(p, cfg, device="cpu")
        eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, full)),
                                 model_parameters=full, device="cpu",
                                 config=dict(CONFIG, train_micro_batch_size_per_gpu=MICRO * DP))
        out[name] = [float(eng.train_batch(torch.from_numpy(b))) for b in batches]
        reset_fastpath()
    return out


def _losses(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=LATER_RTOL)


def _jax_leaves(ranks, tree):
    flat = {k: v for k, v in convert._flatten(tree).items()}
    return [flat[p] for p in ranks[0]["paths"]]


def test_world_is_dp2_by_tp2(ranks):
    assert [(r["dp_rank"], r["tp_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["topo"] == (DP, TP, DP) for r in ranks)
    dims = dict(zip(ranks[0]["paths"], ranks[0]["pack0/dims"]))
    # the generic pack: heads, columns, rows, the table's hidden, the head's vocab
    assert dims["layer_0/attn/q_proj/kernel"] == dims["layer_0/attn/k_proj/kernel"] == 1
    assert dims["layer_0/attn/o_proj/kernel"] == dims["layer_0/mlp/down_proj/kernel"] == 0
    assert dims["embed/embedding"] == dims["lm_head/kernel"] == 1
    assert dims["final_norm/scale"] is None


@pytest.mark.parametrize("name", ["pack0", "pack1", "auto", "rules", "tree", "overlap"])
def test_dense_loss_at_tp2_matches_jax_and_tp1(ranks, jax_tp, one_process, name):
    want_losses, want_params = jax_tp["dense"]
    for r in ranks:
        _losses(r[name], want_losses)
        _losses(r[name], one_process["dense"])
        assert r[name] == ranks[0][name]            # the rank mean is one value
    for got, want in zip(ranks[0][name + "/full"], _jax_leaves(ranks, want_params)):
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert ranks[0][name][-1] < ranks[0][name][0]


def test_layout_says_which_leaves_it_gathers(ranks):
    """The name rules (``"auto"``) split q / k / v on the head dim, which no
    Megatron block computes: the layout says so at initialize and gathers
    them; the packs and the tree split nothing so and say nothing."""
    for r in ranks:
        (said,) = r["auto/warned"]
        for n in ("q_proj", "k_proj", "v_proj"):
            assert f"layer_0/attn/{n}/kernel" in said
        assert "mlp" not in said and "embed" not in said
        for name in ("pack0", "pack1", "vp0", "rules", "tree", "overlap", "kvrep"):
            assert r[name + "/warned"] == []


@pytest.mark.parametrize("name", ["vp0", "vp1"])
def test_vocab_parallel_loss_matches_jax(ranks, jax_tp, one_process, name):
    want_losses, want_params = jax_tp["vocab_parallel"]
    for r in ranks:
        _losses(r[name], want_losses)
        _losses(r[name], one_process["dense"])
    for got, want in zip(ranks[0][name + "/full"], _jax_leaves(ranks, want_params)):
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_replicated_kv_heads_follow_the_jax_rule(ranks, one_process):
    dims = dict(zip(ranks[0]["paths"], ranks[0]["kvrep/dims"]))
    assert dims["layer_0/attn/k_proj/kernel"] is None        # 1 kv head: whole
    assert dims["layer_0/attn/q_proj/kernel"] == 1
    for r in ranks:
        _losses(r["kvrep"], one_process["kvrep"])


@pytest.mark.parametrize("name", ["pack0", "pack1", "vp1", "dropout", "kvrep"])
def test_replicated_leaves_bitwise_across_tp_ranks(ranks, name):
    dims = ranks[0][(name if name != "pack0" else "pack0") + "/dims"]
    for row in (ranks[:TP], ranks[TP:]):
        for i, d in enumerate(dims):
            if d is None:
                np.testing.assert_array_equal(row[0][name + "/local"][i],
                                              row[1][name + "/local"][i])
    # and across the dp replicas (the dp mean is one value)
    for i, d in enumerate(dims):
        if d is None:
            np.testing.assert_array_equal(ranks[0][name + "/local"][i],
                                          ranks[TP][name + "/local"][i])


def test_gradients_on_the_shards_match_jax(ranks, problem):
    jmodel, params, _, _, grad_batch = problem
    loss_fn = jtf.make_loss_fn(jmodel)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params),
                                                       jnp.asarray(grad_batch))
    want = _jax_leaves(ranks, jax.tree.map(np.asarray, grads))
    for r in ranks:
        np.testing.assert_allclose(r["grad_loss"], float(loss), rtol=FIRST_RTOL)
        for got, w in zip(r["grads"], want):
            np.testing.assert_allclose(got, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    dims = ranks[0]["pack0/dims"]
    for i, d in enumerate(dims):
        if d is None:
            np.testing.assert_array_equal(ranks[0]["grads/local"][i],
                                          ranks[1]["grads/local"][i])


def test_dropout_masks_equal_across_tp_ranks(ranks):
    seeds = [r["dropout/seed"] for r in ranks]
    assert seeds[0] == seeds[1] and seeds[2] == seeds[3] and seeds[0] != seeds[2]
    assert all(np.isfinite(ranks[0]["dropout"])) and ranks[0]["dropout"] != ranks[0]["pack0"]


def test_checkpoint_tp2_resumes_bitwise_and_loads_at_tp1(ranks):
    for r in ranks:
        assert r["resume"] == r["pack0"][2]
        for a, b in zip(r["resume/full"], r["pack0/full"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["tp1_load/full"], r["pack0/full2"]):
            np.testing.assert_array_equal(a, b)
        # the sharded restore: this rank's slice of the saved whole table
        paths = r["paths"]
        embed = r["pack0/full2"][paths.index("embed/embedding")]
        q = r["pack0/full2"][paths.index("layer_0/attn/q_proj/kernel")]
        t = r["tp_rank"]
        np.testing.assert_array_equal(r["restored/embed"], embed[:, 16 * t:16 * t + 16])
        np.testing.assert_array_equal(r["restored/q"], q[:, 2 * t:2 * t + 2])


def test_autotp_initialize_matches_the_one_process_port(ranks):
    """A raw HF-layout llama checkpoint (``sharding.audit_entry``'s fixture)
    through ``autotp_initialize`` at tp 2 and ZeRO 1 over dp 2, against
    ``params_from_hf`` + ``initialize`` at tp 1 in this process on the same
    global batch."""
    from deepspeed_tpu_torch.inference.hf import params_from_hf
    from deepspeed_tpu_torch.sharding import audit_entry

    sd, hf_cfg = audit_entry.toy_hf_checkpoint("llama")
    cfg, params = params_from_hf(sd, hf_cfg, device="cpu")
    eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, params)),
                             model_parameters=params, device="cpu",
                             config={"train_micro_batch_size_per_gpu": 2 * DP,
                                     "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                                     "steps_per_print": 10**9})
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, hf_cfg["vocab_size"], (2 * DP, 16), generator=gen)
    want = float(eng.train_batch(toks))
    reset_fastpath()
    for r in ranks:
        np.testing.assert_allclose(r["autotp"], want, rtol=FIRST_RTOL)
    dims = ranks[0]["autotp/dims"]
    assert dims["layer_0/attn/q_proj/kernel"] == 1 and dims["lm_head/kernel"] == 1


def test_gates(ranks):
    gates = ranks[0]["gates"]
    assert "param_specs" in gates["foreign"]
    assert "Queue A item 8" in gates["zero2"] and "stage=2" in gates["zero2"]
