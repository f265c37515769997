"""The port's activation checkpointing against the JAX package's, on the CPU.

* ``remat=True`` under each policy the port honours gives the same loss and
  gradients as ``remat=False`` (the recompute runs the same float32 ops, so
  they match within 1e-6) and as the JAX model with ``remat=True`` and the
  same policy (within 1e-5: the packages sum in different orders).
* ``activation_checkpointing.engine_wrap`` trains the same steps as the
  unwrapped engine, and as the JAX engine with the same block.
* The recompute really happens: a wrapped function runs twice under
  full recompute and once when everything is saved. The reference knob
  vocabulary (``configure``/``get_config``) is the JAX module's; what the
  port cannot honour raises, naming what it is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
from deepspeed_tpu_torch.runtime import activation_checkpointing as tac
from deepspeed_tpu_torch.runtime.engine import REMAT_LADDER

TOL = 1e-5
POLICIES = [None, "nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable"]
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}


@pytest.fixture(autouse=True)
def _fresh_state():
    saved = (dict(tac._config), tac._configured, dict(jac._config), jac._configured)
    yield
    tac._config.clear()
    tac._config.update(saved[0])
    tac._configured = saved[1]
    jac._config.clear()
    jac._config.update(saved[2])
    jac._configured = saved[3]
    reset_fastpath()


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree), np.float32)


def tiny(**over):
    base = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
                num_heads=4, num_kv_heads=2, max_seq_len=64, **over)
    jcfg = jtf.TransformerConfig(**base, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**base, dtype=torch.float32)
    params = jtf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, tcfg, _np_tree(params)


def _leaves(tree):
    if hasattr(tree, "items"):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def _port_loss_and_grads(tcfg, params, batch):
    tparams = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), params)
    model = ttf.TransformerLM(tcfg, convert.params_from_jax(params, tcfg, device="cpu"))
    loss = ttf.make_loss_fn(model)(tparams, jax.tree.map(torch.from_numpy, batch))
    loss.backward()
    return loss.item(), _leaves(jax.tree.map(lambda t: t.grad, tparams))


@pytest.mark.parametrize("policy", POLICIES, ids=[str(p) for p in POLICIES])
def test_remat_matches_no_remat_and_jax(policy):
    jcfg, tcfg, params = tiny()
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 97, (2, 32)).astype(np.int32),
             "loss_mask": (rng.random((2, 32)) > 0.2).astype(np.float32)}
    plain_loss, plain_grads = _port_loss_and_grads(tcfg, params, batch)
    loss, grads = _port_loss_and_grads(
        dataclasses.replace(tcfg, remat=True, remat_policy=policy), params, batch)
    np.testing.assert_allclose(loss, plain_loss, rtol=1e-6)
    for g, w in zip(grads, plain_grads):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    jmodel = jtf.TransformerLM(dataclasses.replace(jcfg, remat=True, remat_policy=policy))
    jloss, jgrads = jax.value_and_grad(jtf.make_loss_fn(jmodel))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(loss, float(jloss), rtol=TOL)
    for g, w in zip(grads, _leaves(jgrads)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_engine_wrap_trains_like_unwrapped_and_jax():
    jcfg, tcfg, params = tiny()
    wrap = dict(CONFIG, activation_checkpointing={"engine_wrap": True,
                                                  "policy": "nothing_saveable"})
    toks = np.random.default_rng(2).integers(0, 97, (4, 32)).astype(np.int32)
    losses = {}
    for name, config in (("plain", CONFIG), ("wrap", wrap)):
        p = convert.params_from_jax(params, tcfg, device="cpu")
        eng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, p)),
                                 model_parameters=p, config=config, device="cpu")
        assert eng._remat_policy == (None if name == "plain" else "nothing_saveable")
        losses[name] = [float(eng.train_batch(torch.from_numpy(toks))) for _ in range(3)]
    assert losses["wrap"] == losses["plain"]
    jeng, *_ = jds.initialize(model=jtf.make_loss_fn(jtf.TransformerLM(jcfg)),
                              model_parameters=jax.tree.map(jnp.asarray, params),
                              config=wrap,
                              topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    jl = [float(jeng.train_batch(jnp.asarray(toks))) for _ in range(3)]
    np.testing.assert_allclose(losses["wrap"], jl, rtol=TOL)
    assert losses["wrap"][-1] < losses["wrap"][0]


@pytest.mark.parametrize("policy,runs", [(None, 2), ("nothing_saveable", 2),
                                         ("dots_saveable", 2), ("everything_saveable", 1)])
def test_checkpoint_recomputes_in_backward(policy, runs):
    calls = []

    def f(x, w):
        calls.append(1)
        return torch.tanh(x @ w).sum()

    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    tac.checkpoint_wrapper(f, policy)(x, w).backward()
    assert len(calls) == runs
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    f(x, w).backward()
    torch.testing.assert_close(x.grad, gx, rtol=0, atol=0)
    torch.testing.assert_close(w.grad, gw, rtol=0, atol=0)


def test_configure_matches_jax_and_refusals():
    ds_config = {"activation_checkpointing": {"partition_activations": True,
                                              "number_checkpoints": 4,
                                              "policy": "dots_saveable"}}
    for mod in (jac, tac):
        mod.configure(deepspeed_config=ds_config, profile=True)
        assert mod.is_configured()
    assert tac.get_config() == jac.get_config()
    out = tac.checkpoint(lambda a: (a * 2).sum(), torch.ones(3, requires_grad=True))
    assert out.item() == 6.0
    assert REMAT_LADDER == jds.runtime.engine.REMAT_LADDER
    assert all(p in tac.POLICIES for p in REMAT_LADDER)
    gen = tac.model_parallel_reconfigure_tp_seed(1234)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 1234
    with pytest.raises(ValueError, match="offload_dot_with_no_batch_dims"):
        tac.checkpoint_wrapper(lambda a: a, "offload_dot_with_no_batch_dims")
    tac._config["policy"] = None        # configure() keeps a policy once set
    tac.configure(checkpoint_in_cpu=True)
    # cpu_checkpointing keeps dots_saveable's products in host memory
    # (tests/test_torch_offload.py holds its gradients bitwise)
    x = torch.ones(3, 3, requires_grad=True)
    out = tac.checkpoint(lambda a: (a @ a).sum(), x)
    out.backward()
    assert out.item() == 27.0 and torch.equal(x.grad, torch.full((3, 3), 6.0))
    _, tcfg, params = tiny()
    p = convert.params_from_jax(params, tcfg, device="cpu")
    loss_fn = ttf.make_loss_fn(ttf.TransformerLM(tcfg, p))
    engine, *_ = tds.initialize(
        model=loss_fn, model_parameters=p, device="cpu",
        config=dict(CONFIG, activation_checkpointing={"cpu_checkpointing": True}))
    assert engine.config.activation_checkpointing.cpu_checkpointing
    with pytest.raises(ValueError, match="save_from_both_policies"):
        tds.initialize(model=loss_fn, model_parameters=p, device="cpu",
                       config=dict(CONFIG, activation_checkpointing={
                           "engine_wrap": True, "policy": "save_from_both_policies"}))
