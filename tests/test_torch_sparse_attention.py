"""The port's block-sparse attention against the JAX package's.

Every layout builder must give the JAX builder's array (bigbird and
variable draw their random blocks from the same numpy seed). The forward
and the ``q``/``k``/``v`` gradients of ``sparse_attention`` run on the same
numpy inputs in both packages (JAX: the Pallas kernel in interpret mode and
``jax.grad`` through its ``custom_vjp``; port: the plain version on CPU
tensors and autograd through its ``torch.autograd.Function``), at the cases
and sizes of ``tests/unit/test_sparse_attention.py`` (B 2, S 256, H 4, D 32,
block 64) and its tolerances: 2e-4 for the forward and 5e-4 for the
gradients (the packages sum in other orders; the JAX forward is an online
softmax over blocks, the port's plain forward a dense masked softmax).

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import attention_core
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.ops.sparse_attention import (
    _LAYOUT_CACHE, _compact_layout, bigbird_layout, bslongformer_layout,
    causal_layout, fixed_layout, launch_counts, local_sliding_window_layout,
    masked_dense_attention, sparse_attention, variable_layout)

# the module (the package exports its function under the module's name)
jsa = importlib.import_module("deepspeed_tpu.ops.pallas.sparse_attention")

B, S, H, D = 2, 256, 4, 32
BLOCK = 64
NB = S // BLOCK

BUILDERS = {
    "fixed": (fixed_layout, dict(num_local_blocks=2)),
    "fixed_default": (fixed_layout, {}),
    "bigbird": (bigbird_layout, dict(num_sliding_window_blocks=3,
                                     num_random_blocks=1)),
    "bigbird_seed3": (bigbird_layout, dict(num_random_blocks=2, seed=3)),
    "bslongformer": (bslongformer_layout, dict(num_sliding_window_blocks=3)),
    "variable": (variable_layout, dict(local_window_blocks=(2, 3),
                                       global_block_indices=(0,),
                                       horizontal_global_attention=True)),
    "variable_random": (variable_layout, dict(num_random_blocks=1, seed=5)),
    "local_window": (local_sliding_window_layout,
                     dict(num_sliding_window_blocks=3)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("heads,blocks", [(2, 8), (4, 16)])
def test_layout_builders_match_jax(name, heads, blocks):
    fn, kw = BUILDERS[name]
    got = fn(heads, blocks, **kw)
    want = getattr(jsa, fn.__name__)(heads, blocks, **kw)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(causal_layout(got), jsa.causal_layout(want))


def _qkv(seeds, b=B):
    return [np.random.default_rng(s).normal(size=(b, S, H, D)).astype(np.float32)
            for s in seeds]


def _jax_ref(q, k, v, layout, causal):
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    lo = jsa.causal_layout(layout) if causal else layout
    o = jsa.masked_dense_attention(qt, kt, vt, lo, causal=causal,
                                   sm_scale=1.0 / np.sqrt(D), block_q=BLOCK,
                                   block_k=BLOCK)
    return np.asarray(jnp.swapaxes(o, 1, 2))


@pytest.mark.parametrize("layout_fn,causal", [
    (lambda: fixed_layout(H, NB, num_local_blocks=2), True),
    (lambda: fixed_layout(H, NB, num_local_blocks=2), False),
    (lambda: bigbird_layout(H, NB, num_sliding_window_blocks=3,
                            num_random_blocks=1), True),
    (lambda: bigbird_layout(H, NB, num_sliding_window_blocks=3,
                            num_random_blocks=1), False),
    (lambda: bslongformer_layout(H, NB, num_sliding_window_blocks=3), True),
    (lambda: variable_layout(H, NB, local_window_blocks=(2, 3)), True),
    (lambda: local_sliding_window_layout(H, NB), False),
], ids=["fixed-causal", "fixed", "bigbird-causal", "bigbird",
        "bslongformer-causal", "variable-causal", "local_window"])
def test_forward_matches_jax(layout_fn, causal):
    layout = layout_fn()
    q, k, v = _qkv((0, 1, 2))
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), layout,
                                causal=causal, block=BLOCK, interpret=True)
    got = sparse_attention(*map(torch.from_numpy, (q, k, v)), layout,
                           causal=causal, block=BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, layout, causal),
                               rtol=2e-4, atol=2e-4)


def test_public_entry_point_and_all_ones_layout_is_dense_attention():
    """``ops.sparse_attention`` with an all-ones causal layout reproduces
    full causal attention (the JAX ``attention_core``)."""
    layout = np.ones((H, NB, NB), bool)
    q, k, v = _qkv((3, 4, 5))
    want = attention_core(*map(jnp.asarray, (q, k, v)), causal=True, impl="xla")
    got = ops.sparse_attention(*map(torch.from_numpy, (q, k, v)), layout,
                               causal=True, block=BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout_fn,causal", [
    (lambda: fixed_layout(H, NB, num_local_blocks=2), True),
    (lambda: bigbird_layout(H, NB), False),
], ids=["fixed-causal", "bigbird"])
def test_gradients_match_jax(layout_fn, causal):
    layout = layout_fn()
    q, k, v = _qkv((6, 7, 8), b=1)

    def jloss(q, k, v):
        return jnp.sum(jsa.sparse_attention(q, k, v, layout, causal=causal,
                                            block=BLOCK, interpret=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (sparse_attention(tq, tk, tv, layout, causal=causal, block=BLOCK) ** 2
     ).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


def test_empty_rows_bf16_and_checks():
    """A q-block with no live column (as a row whose only blocks lie above
    the diagonal has under causal) gives exact zeros; bf16 inputs keep
    their dtype; bad shapes raise; CPU tensors never launch the kernel."""
    layout = np.zeros((H, NB, NB), bool)
    layout[:, 1:, 0] = True                  # q-block 0 has no column at all
    q, k, v = (torch.from_numpy(x) for x in _qkv((9, 10, 11)))
    before = dict(launch_counts)
    out = sparse_attention(q, k, v, layout, causal=False, block=BLOCK)
    assert launch_counts == before
    assert not out[:, :BLOCK].any() and out[:, BLOCK:].abs().sum() > 0
    ob = sparse_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), layout,
                          causal=False, block=BLOCK)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(), out.numpy(), atol=5e-2)
    with pytest.raises(ValueError, match="multiple of block"):
        sparse_attention(q[:, :100], k[:, :100], v[:, :100], layout, block=BLOCK)
    with pytest.raises(ValueError, match="layout shape"):
        sparse_attention(q, k, v, layout[:2], block=BLOCK)


def test_compaction_is_memoised_and_matches_jax():
    layout = bigbird_layout(H, NB, num_random_blocks=1)
    for causal in (True, False):
        sl = _compact_layout(layout, causal, torch.device("cpu"))
        assert _compact_layout(layout, causal, torch.device("cpu")) is sl
        jsl = jsa._compact_layout(layout, causal)
        np.testing.assert_array_equal(sl.cols.numpy(), np.asarray(jsl.cols))
        np.testing.assert_array_equal(sl.cnt.numpy(), np.asarray(jsl.cnt))
        np.testing.assert_array_equal(sl.layout, jsl.layout)
        assert sl.cols.dtype == sl.cnt.dtype == torch.int32
    assert len(_LAYOUT_CACHE) <= 65
    # the plain version over the compacted layout is the masked-dense one
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in _qkv((12, 13, 14)))
    lo = causal_layout(layout)
    a = masked_dense_attention(q, k, v, lo, causal=True, sm_scale=0.2,
                               block_q=BLOCK, block_k=BLOCK)
    b = masked_dense_attention(q, k, v, layout, causal=True, sm_scale=0.2,
                               block_q=BLOCK, block_k=BLOCK)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
