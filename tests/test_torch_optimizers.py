"""The port's optimizer library (``ops/optimizers.py``) and the ported part
of ``compression/onebit.py`` against the JAX package's.

Every transformation runs 5 steps over one seeded tree, with the same
numpy gradients each step, through the JAX function and through the port;
the parameters are updated as the engines update them (``p + u`` in fp32,
stored back in the parameters' dtype). The tree names the leaves the muP
rule reads: an input embedding, a row-parallel ``o_proj`` (3-D) and
``down_proj``, a column-parallel ``up_proj``, a stacked ``expert_up_proj``
and a norm scale. The learning rate is a schedule of the step, so a port
that counted SGD's steps from 1, as Adam's, would differ at every step.

Tolerances: fp32 parameters within ``RTOL_32`` / ``ATOL_32`` (the packages
round the same fp32 formulas in other orders, XLA contracting some
multiply-adds; ``ATOL_32`` is eight fp32 ulps of the unit-scale
parameters, where a small element's relative error is large); bf16 parameters within ``RTOL_16`` (two bf16 ulps), since
the port's state and updates are fp32 where optax keeps SGD's trace and
updates in the gradients' dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from deepspeed_tpu.compression import onebit as jonebit
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.compression import onebit as tonebit
from deepspeed_tpu_torch.ops import optimizers as topt

RTOL_32, ATOL_32 = 1e-5, 1e-6
RTOL_16 = 2 ** -7
STEPS = 5
SHAPES = {"embed_tokens": {"embedding": (11, 8)},
          "layer_0": {"o_proj": {"kernel": (2, 4, 8)},
                      "down_proj": {"kernel": (12, 8)},
                      "up_proj": {"kernel": (8, 12)},
                      "expert_up_proj": (3, 8, 12),
                      "norm": {"scale": (8,)}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def schedule(step):
    return 1e-2 / (1 + step)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32),
                          SHAPES, is_leaf=lambda x: isinstance(x, tuple))
             for _ in range(STEPS)]
    return params, grads


def _run_jax(tx, params, grads, dtype):
    p = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    state = tx.init(p)
    for g in grads:
        u, state = tx.update(jax.tree.map(lambda x: jnp.asarray(x, dtype), g), state, p)
        p = jax.tree.map(lambda a, b: (a.astype(jnp.float32)
                                       + b.astype(jnp.float32)).astype(dtype), p, u)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def _run_port(tx, params, grads, dtype, flat=False):
    """``flat``: the leaves given as 1-D fragments (each the whole leaf)
    under ``sharded_leaves``, as the engine gives them over ZeRO stages."""
    p = pytree.tree_map(lambda x: torch.from_numpy(np.array(x)).to(dtype), params)
    shapes = {topt.path_name(kp): tuple(x.shape)
              for kp, x in pytree.tree_flatten_with_path(p)[0]}
    if flat:
        p = pytree.tree_map(lambda x: x.reshape(-1), p)
    state = tx.init(p)
    for g in grads:
        g = pytree.tree_map(lambda x: torch.from_numpy(np.array(x)).to(dtype), g)
        if flat:
            g = pytree.tree_map(lambda x: x.reshape(-1), g)
            with topt.sharded_leaves(shapes, lambda v: v):
                u, state = tx.update(g, state, p)
        else:
            u, state = tx.update(g, state, p)
        p = pytree.tree_map(lambda a, b: (a.float() + b.float()).to(dtype), p, u)
    if flat:
        p = pytree.tree_map(lambda x, ref: x.reshape(np.shape(ref)), p, params)
    return pytree.tree_map(lambda x: x.float().numpy(), p)


def _close(got, want, dtype):
    rtol, atol = (RTOL_32, ATOL_32) if dtype == "float32" else (RTOL_16, 1e-3)
    for (path, a), b in zip(pytree.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=topt.path_name(path))


# (port factory, JAX factory) pairs, each with the same keyword arguments
CASES = {
    "lamb": (topt.fused_lamb, jopt.fused_lamb, dict(lr=schedule, weight_decay=0.01)),
    "lamb_clip": (topt.fused_lamb, jopt.fused_lamb,
                  dict(lr=1e-2, max_coeff=0.5, min_coeff=0.3)),
    "lion": (topt.fused_lion, jopt.fused_lion, dict(lr=schedule, weight_decay=0.1)),
    "adagrad": (topt.adagrad, jopt.adagrad, dict(lr=schedule, weight_decay=0.01)),
    "sgd": (topt.sgd, jopt.sgd, dict(lr=schedule)),
    "sgd_momentum": (topt.sgd, jopt.sgd, dict(lr=schedule, momentum=0.9,
                                              weight_decay=0.01)),
    "sgd_nesterov": (topt.sgd, jopt.sgd, dict(lr=schedule, momentum=0.9, nesterov=True)),
    "muadam": (topt.mu_optimizer, jopt.mu_optimizer,
               dict(base="adam", lr=1e-2, weight_decay=0.01, base_width=4)),
    "muadamw": (topt.mu_optimizer, jopt.mu_optimizer,
                dict(base="adamw", lr=1e-2, weight_decay=0.1, base_width=4)),
    "musgd": (topt.mu_optimizer, jopt.mu_optimizer,
              dict(base="sgd", lr=1e-2, base_width=4, momentum=0.9)),
    "musgd_width1": (topt.mu_optimizer, jopt.mu_optimizer, dict(base="sgd", lr=1e-2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_transformation_matches_jax(case, dtype):
    port, ref, kw = CASES[case]
    params, grads = _problem()
    want = _run_jax(ref(**kw), params, grads, getattr(jnp, dtype))
    got = _run_port(port(**kw), params, grads, getattr(torch, dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("case", ["lamb", "muadamw", "musgd"])
def test_fragments_under_sharded_leaves_match_whole_leaves(case):
    """A leaf given as a 1-D fragment takes the factor and the norms of its
    full shape (muP reads the shape by path, LAMB sums its norms through
    the reduction), so the result is the whole leaf's."""
    port, _, kw = CASES[case]
    params, grads = _problem(1)
    whole = _run_port(port(**kw), params, grads, torch.float32)
    frag = _run_port(port(**kw), params, grads, torch.float32, flat=True)
    for a, b in zip(pytree.tree_leaves(whole), pytree.tree_leaves(frag)):
        np.testing.assert_array_equal(a, b)


def test_state_is_fp32_and_lamb_reports_its_trust_ratios():
    params, grads = _problem()
    p = pytree.tree_map(lambda x: torch.from_numpy(x).bfloat16(), params)
    for tx in (topt.fused_lamb(), topt.fused_lion(), topt.adagrad(),
               topt.sgd(momentum=0.9), topt.mu_optimizer("adamw")):
        state = tx.init(p)
        assert all(t.dtype == torch.float32 for t in pytree.tree_leaves(state)
                   if isinstance(t, torch.Tensor))
    tx = topt.fused_lamb(weight_decay=0.01)
    state = tx.init(p)
    g = pytree.tree_map(lambda x: torch.from_numpy(x).bfloat16(), grads[0])
    u, state = tx.update(g, state, p)
    trust = tx.update.last_trust
    assert trust.shape == (len(pytree.tree_leaves(p)),)
    # the ratio scales the Adam step: ||u|| = lr * trust * ||adam_step||
    assert state.step == 1 and bool(((trust >= 0.01) & (trust <= 10.0)).all())
    zero = pytree.tree_map(torch.zeros_like, p)
    tx.update(g, tx.init(zero), zero)
    assert bool((tx.update.last_trust == 1.0).all())    # ||p|| = 0: ratio 1


# every name the JAX registry builds, with the parameters a config carries
NAMES = ["Adam", "AdamW", "FusedAdam", "CPUAdam", "DeepSpeedCPUAdam", "Lamb", "FusedLamb",
         "Lion", "FusedLion", "CPULion", "Adagrad", "CPUAdagrad", "SGD", "MuAdam", "MuAdamW",
         "MuSGD"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_every_jax_name(name):
    params = {"lr": 1e-2, "weight_decay": 0.01, "betas": [0.8, 0.9]}
    if name.lower().startswith("mu"):
        params["base_width"] = 4
    if "sgd" in name.lower():
        params = {"lr": 1e-2, "weight_decay": 0.01, "momentum": 0.5}
    p, grads = _problem(2)
    want = _run_jax(jopt.build_optimizer(name, dict(params)), p, grads[:2], jnp.float32)
    got = _run_port(topt.build_optimizer(name, dict(params)), p, grads[:2], torch.float32)
    _close(got, want, "float32")


@pytest.mark.parametrize("name", ["OneBitAdam", "OneBitLamb", "ZeroOneAdam", "one_bit_adam"])
def test_onebit_names_raise_naming_item_8(name):
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        topt.build_optimizer(name, {"lr": 1e-3})
    with pytest.raises(ValueError, match="Unknown optimizer type"):
        topt.build_optimizer("nonesuch", {})


def test_onebit_compress_and_server_error_shape_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    err = (0.1 * rng.standard_normal((5, 7))).astype(np.float32)
    jq, je = jonebit.onebit_compress(jnp.asarray(x), jnp.asarray(err))
    tq, te = tonebit.onebit_compress(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=1e-7)
    for shape in [(5, 7), (1,), (64,), (3, 8, 9)]:
        for world in (1, 2, 4, 8):
            assert (tonebit.server_error_shape(shape, world)
                    == jonebit.server_error_shape(shape, world))
    fb = tonebit.init_error_feedback({"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert fb.worker_error["a"].dtype == torch.float32 and fb.server_error["a"].shape == (3,)
    # one rank: the mean-reduced tensor is the compressed one
    red, new_err = tonebit.compressed_allreduce(torch.from_numpy(x), torch.from_numpy(err),
                                                None)
    np.testing.assert_array_equal(red.numpy(), tq.numpy())
    np.testing.assert_array_equal(new_err.numpy(), te.numpy())
