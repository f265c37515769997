"""The port's mixture of experts against the JAX package's, on the CPU.

* ``moe.sharded_moe``: ``topk_gating`` at k 1, 2 and 4, with and without
  ``drop_tokens``, ``norm_topk`` and ``used_token``, at a capacity that
  drops tokens: dispatch bitwise, combine and aux within ``GATE_TOL``
  (float32; the softmax sums in another order). ``expert_ffn`` (swiglu, and
  gelu with biases) and ``dropless_moe`` (tokens that would overflow any
  capacity, with and without ``norm_topk``, biases) within ``TOL``.
* ``moe.layer``: the block on both branches, with the shared expert, the
  PR-MoE residual and ``used_token``: output and aux within ``TOL``, the
  pre-drop ``exp_counts`` exact. Where the draws differ between torch and
  JAX (Random Token Selection, Jitter, RSample) the invariants hold
  instead: capacity is respected, with no overflow the selection is the
  positional one, and a seed routes the same way twice.
* The model: ``make_loss_fn`` loss and gradients (aux loss included)
  against JAX's ``make_loss_fn`` within ``TOL`` on a tiny Mixtral (capacity
  and dropless) and a qwen2_moe shape (MoE on odd layers, a shared expert,
  no top-k renormalisation), plain, under remat and with the fused loss;
  the expert stacks' init scale against flax's ``lecun_normal``.
* ``initialize`` + ``train_batch`` losses and masters against the JAX
  engine over three steps (AdamW, and MuAdamW's stacked-expert rule);
  checkpoint save and resume bitwise; ZeRO stages 1 and 3 over two gloo
  ranks equal to stage 0 within ``STAGE_RTOL``.
* Serving: greedy streams of ``InferenceEngineV2`` and ``LLMServer``
  equal to the JAX v2 engine's, token for token.

Everything runs on one torch thread: the tensors are tiny.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.ops.fastpath import reset_fastpath as jreset_fastpath
from deepspeed_tpu.parallel import Topology, TopologySpec, set_topology
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
from deepspeed_tpu_torch.serving import LLMServer, Request
from tests.torch_dist_worker import run_world

TOL = 1e-5            # float32 outputs, losses and gradients: other summation orders
GATE_TOL = 1e-6       # float32 combine weights and aux loss
STAGE_RTOL = 1e-5     # ZeRO stages against stage 0: reductions in other orders
# masters after three AdamW steps at lr 1e-3 against the JAX engine's: Adam
# divides each gradient by its own running RMS, so an element whose gradient
# sits at rounding size (an expert few tokens reached) moves by up to a
# learning rate either way; a wrong update moves trained elements by ~1e-3
MASTER_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    yield
    reset_fastpath()
    jreset_fastpath()


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    if hasattr(tree, "items"):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


# ---------------------------------------------------------------------------
# gating, dispatch, experts
# ---------------------------------------------------------------------------


def test_compute_capacity_matches_jax():
    for args in [(1, 64, 8, 1.0), (2, 64, 8, 1.25), (1, 4, 8, 1.0), (4, 2048, 60, 1.25),
                 (2, 2048, 8, 1.25)]:
        assert tmoe.compute_capacity(*args) == jmoe.compute_capacity(*args)
    assert tmoe.compute_capacity(2, 2048, 8, 1.25) == 640


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("drop_tokens", [True, False])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("used", [False, True])
def test_topk_gating_matches_jax(k, drop_tokens, norm_topk, used):
    g, s, e = 2, 24, 8
    rng = np.random.default_rng(k * 8 + 4 * drop_tokens + 2 * norm_topk + used)
    logits = rng.normal(size=(g, s, e)).astype(np.float32)
    logits[:, :10, 3] += 3.0                        # one popular expert overflows
    used_token = (rng.random((g, s)) > 0.25).astype(np.float32) if used else None
    cap = tmoe.compute_capacity(k, s, e, 0.5) if drop_tokens else k * s
    kw = dict(drop_tokens=drop_tokens, norm_topk=norm_topk)
    jd, jc, ja = jmoe.topk_gating(jnp.asarray(logits), k, cap,
                                  used_token=None if used_token is None
                                  else jnp.asarray(used_token), **kw)
    td, tc, ta = tmoe.topk_gating(_t(logits), k, cap,
                                  used_token=None if used_token is None
                                  else _t(used_token), **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=GATE_TOL, atol=GATE_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=GATE_TOL)
    if drop_tokens:                                 # the capacity really bit
        assert td.sum().item() < k * (s * g if used_token is None else used_token.sum())


def test_load_balance_aux_with_selection_scores_matches_jax():
    rng = np.random.default_rng(5)
    gates = jax.nn.softmax(jnp.asarray(rng.normal(size=(2, 16, 4)), jnp.float32))
    sel = jax.nn.softmax(jnp.asarray(rng.normal(size=(2, 16, 4)), jnp.float32))
    used = jnp.asarray((rng.random((2, 16)) > 0.3).astype(np.float32))
    want = jmoe.load_balance_aux(gates, used, sel_gates=sel)
    got = tmoe.load_balance_aux(_t(gates), _t(used), sel_gates=_t(sel))
    np.testing.assert_allclose(got.item(), float(want), rtol=GATE_TOL)


def _expert_weights(rng, e, d, f, bias):
    w = {n: rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[1])
         for n, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    if bias:
        w.update(b_up=rng.normal(size=(e, f)).astype(np.float32),
                 b_gate=rng.normal(size=(e, f)).astype(np.float32),
                 b_down=rng.normal(size=(e, d)).astype(np.float32))
    return w


@pytest.mark.parametrize("activation,bias", [("swiglu", False), ("swiglu", True),
                                             ("gelu", True)])
def test_dispatch_expert_ffn_combine_match_jax(activation, bias):
    g, s, e, d, f, k = 2, 16, 4, 16, 24, 2
    rng = np.random.default_rng(7)
    x = rng.normal(size=(g, s, d)).astype(np.float32)
    logits = rng.normal(size=(g, s, e)).astype(np.float32)
    w = _expert_weights(rng, e, d, f, bias)
    if activation != "swiglu":
        w = {n: v for n, v in w.items() if n not in ("w_gate", "b_gate")}
    cap = tmoe.compute_capacity(k, s, e, 1.25)
    jd, jc, _ = jmoe.topk_gating(jnp.asarray(logits), k, cap)
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    jout = jmoe.expert_ffn(jmoe.moe_dispatch(jnp.asarray(x), jd), jw.pop("w_up"),
                           jw.pop("w_down"), activation=activation, **jw)
    want = jmoe.moe_combine(jout, jc)
    td, tc, _ = tmoe.topk_gating(_t(logits), k, cap)
    tw = {n: _t(v) for n, v in w.items()}
    tout = tmoe.expert_ffn(tmoe.moe_dispatch(_t(x), td), tw.pop("w_up"), tw.pop("w_down"),
                           activation=activation, **tw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tmoe.moe_combine(tout, tc).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("activation,norm_topk,bias", [("swiglu", True, False),
                                                       ("swiglu", False, True),
                                                       ("gelu", True, True)])
def test_dropless_moe_matches_jax(activation, norm_topk, bias):
    g, s, e, d, f, k = 2, 16, 6, 16, 24, 2
    rng = np.random.default_rng(8)
    x = rng.normal(size=(g, s, d)).astype(np.float32)
    logits = rng.normal(size=(g, s, e)).astype(np.float32)
    logits[..., 2] += 4.0                     # every token's first choice: expert 2
    logits[:, :4, 5] = -30.0                  # and some routing probabilities underflow
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits)), np.float32)
    w = _expert_weights(rng, e, d, f, bias)
    if activation != "swiglu":
        w["w_gate"] = None
        w.pop("b_gate", None)
    args = lambda conv: dict(w_gate=None if w["w_gate"] is None else conv(w["w_gate"]),
                             w_up=conv(w["w_up"]), w_down=conv(w["w_down"]),
                             **{n: conv(v) for n, v in w.items() if n.startswith("b_")})
    want = jmoe.dropless_moe(jnp.asarray(x), jnp.asarray(gates), k, activation=activation,
                             norm_topk=norm_topk, **args(jnp.asarray))
    got = tmoe.dropless_moe(_t(x), _t(gates), k, activation=activation,
                            norm_topk=norm_topk, **args(_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_expert_parallel_exchange_is_refused_by_name():
    assert not tmoe.quantized_ep_ready(8, 4, (8, 4, 16, 32), torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tmoe.quantized_ep_moe(None, None, None, None, None)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

BLOCK = dict(vocab_size=32, hidden_size=16, intermediate_size=32, num_layers=1,
             num_heads=2, max_seq_len=16, num_experts=4, moe_top_k=2)
VARIANTS = {
    "plain": {},
    "shared": dict(moe_shared_expert_size=24, moe_intermediate_size=20, moe_norm_topk=False),
    "residual": dict(moe_use_residual=True),
    "gelu_bias": dict(activation="gelu", mlp_bias=True, moe_use_residual=True),
    "used_token": {},
}


def _block_pair(variant, dropless, **over):
    base = dict(BLOCK, moe_dropless=dropless, moe_capacity_factor=1.0,
                **VARIANTS[variant], **over)
    jcfg = jtf.TransformerConfig(**base, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**base, dtype=torch.float32)
    x = np.random.default_rng(3).normal(size=(2, 12, 16)).astype(np.float32)
    x[:, :6] += np.linspace(0, 1, 16, dtype=np.float32)   # a skewed router input
    params = jlayer.MoEBlock(jcfg).init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    return jcfg, tcfg, x, _np_tree(params)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_moe_block_matches_jax(variant, dropless):
    jcfg, tcfg, x, params = _block_pair(variant, dropless)
    used = None
    if variant == "used_token":
        used = np.ones((2, 12), np.float32)
        used[:, 8:] = 0.0
    jargs = (jnp.asarray(x),) + (() if used is None else (jnp.asarray(used),))
    (jy, jaux), inter = jlayer.MoEBlock(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, *jargs, mutable=["intermediates"])
    want_counts = np.asarray(inter["intermediates"]["moe_exp_counts"][0])
    tparams = jax.tree.map(_t, params)
    y, aux, counts = tlayer.moe_block(tcfg, tparams, _t(x),
                                      None if used is None else _t(used), return_counts=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert set(convert._flatten(params)) == {
        p.split("/", 1)[1] for p in convert.moe_shapes(tcfg, "moe")}
    module = tlayer.MoEBlock(tcfg, tparams)
    my, maux = module(_t(x), None if used is None else _t(used))
    assert torch.equal(my, y) and torch.equal(maux, aux)
    if used is not None:                           # padding tokens get no expert output
        assert float(y[:, 8:].abs().sum()) == 0.0


def test_rts_respects_capacity_and_keeps_the_selection_without_overflow():
    logits = torch.zeros((1, 32, 4))
    logits[..., 0] = 5.0                           # one dominant expert overflows
    cap = 4
    d_pos, _, _ = tmoe.topk_gating(logits, 1, cap)
    d_rts, _, _ = tmoe.topk_gating(logits, 1, cap, rng=3, use_rts=True)
    assert int(d_pos[..., 0, :].sum()) == cap == int(d_rts[..., 0, :].sum())
    assert int(d_rts.sum(dim=1).max()) == 1        # no slot taken twice
    kept_pos = set(torch.nonzero(d_pos[0, :, 0].sum(-1)).flatten().tolist())
    kept_rts = set(torch.nonzero(d_rts[0, :, 0].sum(-1)).flatten().tolist())
    assert kept_pos == set(range(cap)) and kept_rts != kept_pos
    d_again, _, _ = tmoe.topk_gating(logits, 1, cap, rng=3, use_rts=True)
    assert torch.equal(d_again, d_rts)
    # ample capacity: RTS may permute slots, never the tokens an expert gets
    logits = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 16, 4)).astype(
        np.float32))
    d_pos, c_pos, _ = tmoe.topk_gating(logits, 2, 32)
    d_rts, c_rts, _ = tmoe.topk_gating(logits, 2, 32, rng=torch.Generator().manual_seed(7),
                                       use_rts=True)
    assert torch.equal(d_pos.sum(-1), d_rts.sum(-1))
    np.testing.assert_allclose(c_pos.sum(-1).numpy(), c_rts.sum(-1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("policy", ["RSample", "Jitter"])
def test_noisy_gating_draws_from_its_seed_only(policy):
    _, tcfg, x, params = _block_pair("plain", False, moe_top_k=1, moe_norm_topk=False,
                                     moe_noisy_gate_policy=policy)
    p, xt = jax.tree.map(_t, params), _t(x)
    y_det, aux_det = tlayer.moe_block(tcfg, p, xt)
    clean = dataclasses.replace(tcfg, moe_noisy_gate_policy=None)
    y_clean, aux_clean = tlayer.moe_block(clean, p, xt)
    assert torch.equal(y_det, y_clean) and torch.equal(aux_det, aux_clean)
    y_a, _ = tlayer.moe_block(tcfg, p, xt, seed=1)
    y_b, _ = tlayer.moe_block(tcfg, p, xt, seed=2)
    assert torch.equal(y_a, tlayer.moe_block(tcfg, p, xt, seed=1)[0])
    assert not torch.allclose(y_a, y_b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODELS = {
    "mixtral": dict(num_experts=4, moe_top_k=2),
    "mixtral_dropless": dict(num_experts=4, moe_top_k=2, moe_dropless=True),
    # Qwen1.5-MoE's shape: MoE on odd layers, a shared expert behind a
    # sigmoid gate, expert ffn narrower than the dense one, top-4 of 6
    # without renormalisation
    "qwen2_moe": dict(num_experts=6, moe_top_k=4, moe_every=2, moe_offset=1,
                      moe_intermediate_size=40, moe_shared_expert_size=48,
                      moe_norm_topk=False, attn_qkv_bias=True),
}


def tiny_moe(name, vocab=97, **over):
    """(flax model, JAX config, port config, numpy params): a tiny Mixtral
    (the JAX ``mixtral_config`` family, cut to width 64) or qwen2_moe."""
    base = {**jtf.mixtral_config("tiny").__dict__,
            **dict(vocab_size=vocab, hidden_size=64, intermediate_size=96, num_layers=2,
                   num_heads=4, num_kv_heads=2, max_seq_len=64),
            **MODELS[name], **over}
    base.pop("dtype")
    jcfg = jtf.TransformerConfig(**base, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**base, dtype=torch.float32)
    jmodel = jtf.TransformerLM(jcfg)
    # flax draws each leaf from its path and shape: configs with the same
    # leaves (remat, loss_impl, gating switches) share one initialization
    key = tuple(sorted(convert.param_shapes(tcfg).items()))
    if key not in _INITS:
        _INITS[key] = _np_tree(jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return jmodel, jcfg, tcfg, _INITS[key]


_INITS = {}


def _port_loss_and_grads(tcfg, params, batch, **kwargs):
    tparams = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), params)
    model = ttf.TransformerLM(tcfg, convert.params_from_jax(params, tcfg, device="cpu"))
    if kwargs:
        loss = model(_t(batch["tokens"]), **kwargs)
        loss = loss.float().square().mean()
    else:
        loss = ttf.make_loss_fn(model)(tparams, jax.tree.map(_t, batch))
    loss.backward()
    grads = (_leaves(jax.tree.map(lambda t: t.grad, tparams)) if not kwargs else
             [p.grad.numpy() for _, p in sorted(model.params.items())])
    return loss.item(), grads


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (2, 32)).astype(np.int32),
            "loss_mask": (rng.random((2, 32)) > 0.2).astype(np.float32)}


_JAX_LOSSES = {}


def _jax_loss_and_grads(name, vocab, fused, batch):
    """JAX ``make_loss_fn``'s value and gradients, without remat: the JAX
    model's remat recomputes the same float32 ops, so the port's remat is
    held to these (each JAX program compiled once for the file)."""
    key = (name, vocab, fused)
    if key not in _JAX_LOSSES:
        jmodel = tiny_moe(name, vocab=vocab, **({"loss_impl": "fused"} if fused else {}))[0]
        if fused:
            set_topology(Topology(TopologySpec()))
        _JAX_LOSSES[key] = jax.jit(jax.value_and_grad(jtf.make_loss_fn(jmodel)))(
            jax.tree.map(jnp.asarray, tiny_moe(name, vocab=vocab)[3]),
            jax.tree.map(jnp.asarray, batch))
    return _JAX_LOSSES[key]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("mode", ["plain", "remat", "fused"])
def test_model_loss_and_grads_match_jax(name, mode):
    vocab = 128 if mode == "fused" else 97          # the fused loss: vocab a multiple of 128
    over = {"plain": {}, "remat": dict(remat=True, remat_policy="dots_saveable"),
            "fused": dict(loss_impl="fused")}[mode]
    _, _, tcfg, params = tiny_moe(name, vocab=vocab, **over)
    batch = _batch(vocab)
    jloss, jgrads = _jax_loss_and_grads(name, vocab, mode == "fused", batch)
    loss, grads = _port_loss_and_grads(tcfg, params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=TOL)
    for g, w in zip(grads, _leaves(jgrads)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    # the aux loss is in: without it the loss is the cross entropy alone
    no_aux = dataclasses.replace(tcfg, moe_aux_loss_weight=0.0)
    assert _port_loss_and_grads(no_aux, params, batch)[0] < loss - 1e-4


def test_remat_with_a_gating_seed_routes_the_recompute_the_same_way():
    _, _, tcfg, params = tiny_moe("mixtral", moe_noisy_gate_policy="RSample",
                                  moe_capacity_factor=0.5)
    batch = _batch(97)
    kw = dict(gating_seed=11)
    plain = _port_loss_and_grads(tcfg, params, batch, **kw)
    remat = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True), params, batch, **kw)
    np.testing.assert_allclose(remat[0], plain[0], rtol=1e-6)
    for g, w in zip(remat[1], plain[1]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    other = _port_loss_and_grads(tcfg, params, batch, gating_seed=12)
    assert other[0] != plain[0]


def test_expert_init_scale_matches_flax():
    """``init_params`` draws an expert stack ``[E, in, out]`` with std
    1/sqrt(E * in), the fan-in of flax's ``lecun_normal`` on that shape."""
    from flax import linen as nn

    cfg = ttf.mixtral_config("tiny", hidden_size=256, intermediate_size=512, num_layers=1,
                             vocab_size=128, num_experts=8)
    params = convert.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    moe = params["layer_0"]["moe"]
    for name, shape in (("expert_up_proj", (8, 256, 512)), ("expert_down_proj",
                                                             (8, 512, 256))):
        flax_std = float(np.std(np.asarray(nn.initializers.lecun_normal()(
            jax.random.PRNGKey(0), shape, jnp.float32))))
        assert moe[name].shape == shape
        assert abs(moe[name].std().item() - flax_std) < 0.02 * flax_std, name
        assert abs(flax_std - 1 / np.sqrt(shape[0] * shape[1])) < 0.02 * flax_std
    router = moe["router"]["kernel"]
    assert abs(router.std().item() - 1 / 16) < 0.1 / 16


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
    "steps_per_print": 10**9,
}


def _train_batches(n, vocab=97):
    """One seeded batch, repeated: the model memorises it, so the loss
    falls."""
    return [np.random.default_rng(2).integers(0, vocab, (4, 32)).astype(np.int32)] * n


def _port_engine(tcfg, params, config):
    tparams = convert.params_from_jax(params, tcfg, device="cpu")
    return tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, tparams)),
                          model_parameters=tparams, config=config, device="cpu")[0]


@pytest.mark.parametrize("name,optimizer", [
    ("mixtral", None), ("qwen2_moe", None),
    ("mixtral_dropless", {"type": "MuAdamW", "params": {"lr": 1e-3}})])
def test_train_batch_matches_jax_engine(name, optimizer):
    jmodel, _, tcfg, params = tiny_moe(name)
    config = dict(TRAIN_CONFIG, moe={"enabled": True, "ep_size": 1})
    if optimizer:
        config["optimizer"] = optimizer
    jeng, *_ = jds.initialize(
        model=jtf.make_loss_fn(jmodel), model_parameters=jax.tree.map(jnp.asarray, params),
        config=config, topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    teng = _port_engine(tcfg, params, config)
    jl, tl = [], []
    for b in _train_batches(3):
        jl.append(float(jeng.train_batch(jnp.asarray(b))))
        tl.append(float(teng.train_batch(_t(b))))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    jflat = convert._flatten(_np_tree(jeng.state.params))
    for path, t in convert._flatten(teng.state.params).items():
        t = t.detach().numpy()
        if path.endswith("k_proj/bias"):
            # its true gradient is zero (softmax ignores a shift shared by
            # all keys), so Adam moves it by a learning rate either way
            assert np.abs(t - jflat[path]).max() <= 3 * 1e-3 * 1.01
            continue
        np.testing.assert_allclose(t, jflat[path], rtol=TOL, atol=MASTER_ATOL, err_msg=path)


def test_moe_section_with_expert_parallelism_is_refused_by_name():
    _, _, tcfg, params = tiny_moe("mixtral")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        _port_engine(tcfg, params, dict(TRAIN_CONFIG, moe={"enabled": True, "ep_size": 2}))


def test_checkpoint_resumes_bitwise(tmp_path):
    _, _, tcfg, params = tiny_moe("qwen2_moe")
    batches = _train_batches(3)
    straight = _port_engine(tcfg, params, TRAIN_CONFIG)
    want = [float(straight.train_batch(_t(b))) for b in batches]
    first = _port_engine(tcfg, params, TRAIN_CONFIG)
    for b in batches[:2]:
        first.train_batch(_t(b))
    first.save_checkpoint(str(tmp_path))
    resumed = _port_engine(tcfg, params, TRAIN_CONFIG)
    resumed.load_checkpoint(str(tmp_path))
    assert float(resumed.train_batch(_t(batches[2]))) == want[2]
    for a, b in zip(_leaves(resumed.state.params), _leaves(straight.state.params)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    _, _, tcfg, params = tiny_moe("qwen2_moe")
    model = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
             if f.name != "dtype"}
    inputs = {"model": model, "params": params, "batches": _train_batches(2, 97),
              "config": dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=1)}
    return run_world("moe", 2, tmp_path_factory.mktemp("moe_world"), inputs, timeout=240)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_stage_matches_stage_zero_over_two_ranks(zero_world, stage):
    for r in zero_world:
        np.testing.assert_allclose(r[f"stage{stage}"], r["stage0"], rtol=STAGE_RTOL)
        for a, b in zip(r[f"stage{stage}/masters"], r["stage0/masters"]):
            np.testing.assert_allclose(a, b, rtol=STAGE_RTOL, atol=MASTER_ATOL)
    assert zero_world[0]["stage0"] == zero_world[1]["stage0"]


def test_moe_section_keeps_the_exact_dp_reduction(zero_world):
    for r in zero_world:
        assert r["dp_grad_mode/moe=False"] == "int8"
        assert r["dp_grad_mode/moe=True"] is None
        assert r["stage3/peak_units"]["forward"] <= 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ENGINE = dict(token_budget=16, max_ragged_sequence_count=4, max_chunk_size=8,
              num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=12, dtype="float32")


def _serving_pair(name):
    # head dim 64: the port's engine takes the paged kernels' path (their
    # plain versions on the CPU)
    jmodel, _, tcfg, params = tiny_moe(name, hidden_size=128, num_heads=2, num_kv_heads=1)
    jeng = JEngine(jmodel, params, JEC(**ENGINE))
    teng = TEngine(tcfg, convert.params_from_jax(params, tcfg, device="cpu"), TEC(**ENGINE),
                   device="cpu")
    return jeng, teng


def _prompts(lens=(5, 3, 17, 11), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_greedy_streams_match_jax(name):
    jeng, teng = _serving_pair(name)
    assert (teng.attn_impl, teng.decode_attn_impl) == ("pallas", "pallas")
    prompts = _prompts()
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_server_streams_match_jax():
    jeng, teng = _serving_pair("qwen2_moe")
    prompts = _prompts((4, 9, 14, 6, 21), seed=3)
    want = [np.asarray(w) for w in jeng.generate(prompts, max_new_tokens=9)]
    srv = LLMServer(teng, fused_decode_chunk=4)
    resps = [srv.submit(Request(p, max_new_tokens=9), block=True) for p in prompts]
    for r, w in zip(resps, want):
        np.testing.assert_array_equal(r.result(timeout=120), w)
    assert srv.drain(timeout=60)
    teng.kv.assert_conservation([])
