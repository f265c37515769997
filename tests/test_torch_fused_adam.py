"""The port's fused Adam against the JAX package's, on the CPU.

Three optimizer steps over a tree of odd-sized tensors go through the JAX
``fused_adam`` and the port's, with ``use_pallas`` True (JAX: the Pallas
kernel in interpret mode; port: the kernel's plain version
``adam_update_ref``, which a CPU tensor takes) and False (both: the plain
update), in AdamW and L2 modes, with weight decay 0 and 0.1 and bias
correction on and off. Updates, moments and parameters must agree within a
relative 1e-6 of each tensor's largest value: both compute in float32 in
the same order, but a division or square root may land one ulp apart, and
an element where ``p + u`` nearly cancels keeps that ulp of the update, not
a relative error of its own size.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.ops import fused_adam as tfa
from deepspeed_tpu_torch.ops import optimizers as topt

jpallas = importlib.import_module("deepspeed_tpu.ops.pallas.fused_adam")
RTOL = 1e-6
SHAPES = {"a": (7,), "b": {"c": (13, 5), "d": (3, 129)}}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _close(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_three_steps_match_jax(use_pallas, adam_w_mode, weight_decay, bias_correction):
    rng = np.random.default_rng(0)
    params = _tree(SHAPES, rng)
    grads = [_tree(SHAPES, rng, 0.1) for _ in range(3)]
    kw = dict(lr=lambda s: 1e-2 / s, betas=(0.9, 0.99), eps=1e-8,
              weight_decay=weight_decay, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, use_pallas=use_pallas)
    jtx, ttx = jopt.fused_adam(**kw), topt.fused_adam(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)          # update() path
    ap = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)  # apply()
    js, ts, as_ = jtx.init(jp), ttx.init(tp), ttx.init(ap)
    for g in grads:
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        _close(tu, ju)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
        as_ = ttx.apply(jax.tree.map(torch.from_numpy, g), as_, ap)
    assert ts.step == as_.step == int(js.step) == 3
    for state in (ts, as_):
        _close(state.exp_avg, js.exp_avg)
        _close(state.exp_avg_sq, js.exp_avg_sq)
    _close(tp, jp)
    _close(ap, jp)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_update_matches_pallas_kernel(adam_w_mode):
    """The single-tensor API (``adam_update``) against the Pallas kernel at
    an odd size and a late step (bias correction as exp(step * ln b))."""
    rng = np.random.default_rng(1)
    g, m, p = (rng.standard_normal(1000).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(1000)).astype(np.float32)
    args = (1e-3, 0.9, 0.999, 1e-8, 0.01, adam_w_mode, True, 37)
    want = jpallas.adam_update(*map(jnp.asarray, (g, m, v, p)), *args, interpret=True)
    got = tfa.adam_update(*map(torch.from_numpy, (g, m, v, p)), *args)
    _close([a.numpy() for a in got], [np.asarray(b) for b in want])


def test_multi_tensor_adam_checks_inputs():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="one entry per tensor"):
        tfa.multi_tensor_adam([x], [x], [], [x], lr=1e-3)
    assert tfa.bias_corrections(0.9, 0.999, 5, False) == (1.0, 1.0)


@pytest.mark.parametrize("name", ["lamb", "Lion", "sgd", "OneBitAdam"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer(name, {"lr": 1e-3})
    with pytest.raises(ValueError, match="Unknown"):
        topt.build_optimizer("nonesuch", {})
