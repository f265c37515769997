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
    _LAYOUT_CACHE, SM90_KEYS, SM90_ROWS, _compact_layout, bigbird_layout,
    bslongformer_layout, causal_layout, fixed_layout, item_lengths, launch_counts,
    local_sliding_window_layout, masked_dense_attention, sm90_plan, sparse_attention,
    sparse_route, variable_layout)

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


def test_public_function_ignores_input_strides():
    """``[B, H, S, D]`` tensors transposed to ``[B, S, H, D]`` (and a slice
    of a fused QKV tensor) give the public function the same output and
    gradients as their contiguous copies, bitwise."""
    layout = bigbird_layout(H, NB, num_random_blocks=1)
    q, k, v = _qkv((15, 16, 17))
    w = torch.from_numpy(_qkv((18,))[0])
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
             for x in (q, k)]
    views.append(torch.from_numpy(np.concatenate([v, q], axis=-1))[..., :D])
    assert not any(t.is_contiguous() for t in views)
    outs = []
    for make in (lambda t: t, lambda t: t.contiguous()):
        leaves = [make(t).detach().requires_grad_(True) for t in views]
        out = sparse_attention(*leaves, layout, causal=True, block=BLOCK)
        (out * w).sum().backward()
        outs.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case, route", [
    ("bf16 D64", "wgmma"), ("bf16 D128", "wgmma"), ("fp32 D128", "mma_sync"),
    ("fp16 D64", "mma_sync"), ("bf16 D32", "mma_sync"), ("bf16 D64 strided", "mma_sync"),
    ("bf16 D128 base 2 B off", "mma_sync"), ("bf16 D64 k fp32", "mma_sync")])
def test_sparse_route_choice(case, route):
    """The one rule picks the forward's route from q, k and v: wgmma for
    bf16 at D 64 or 128 on tensors TMA can describe, mma_sync otherwise."""
    D_ = int(case.split("D")[1].split()[0])
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[case[:4].strip()]
    q = k = torch.zeros(2, 128, 4, D_, dtype=dtype)
    if "strided" in case:
        k = torch.zeros(2, 4, 128, D_, dtype=dtype).transpose(1, 2)
    if "off" in case:
        k = torch.zeros(2 * 128 * 4 * D_ + 1, dtype=dtype)[1:].view(2, 128, 4, D_)
    v = k.float() if "k fp32" in case else k
    assert sparse_route(q, k, v) == route


def _walked_lengths(layout, B, block, causal):
    """Live key tiles per item, counted as the kernel's producer walks the
    compacted columns: every tile of each listed column, dropping from the
    end of the list the tiles whose first key lies past the item's last
    row (under causal)."""
    sl = _compact_layout(layout, causal, torch.device("cpu"))
    cols, cnt = sl.cols.numpy(), sl.cnt.numpy()
    H_, nq = cnt.shape
    per = block // SM90_KEYS
    out = []
    for _b in range(B):
        for h in range(H_):
            for t in range(nq * block // SM90_ROWS):
                q0 = t * SM90_ROWS
                iq = q0 // block
                tiles = [cols[h, iq, j // per] * block + (j % per) * SM90_KEYS
                         for j in range(cnt[h, iq] * per)]
                while causal and tiles and tiles[-1] > q0 + SM90_ROWS - 1:
                    tiles.pop()
                out.append(len(tiles))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("name", ["bigbird", "fixed", "variable_random", "empty rows"])
def test_item_lengths_match_the_kernels_tile_walk(name, block, causal):
    """The host's per-item tile counts (which order the wgmma kernel's
    schedule) equal the producer's walk of the column lists, item by item
    in the kernel's order ``(b H + h) T + t``; under causal no listed tile
    lies wholly above its item, and the diagonal column of a 128-block
    leaves its first item one tile fewer."""
    nb = 512 // block
    if name == "empty rows":
        layout = np.zeros((H, nb, nb), bool)
        layout[:, 2:, 1] = True
        layout[:, -1, -1] = True
    else:
        fn, kw = BUILDERS[name]
        layout = fn(H, nb, **kw)
    lo = causal_layout(layout) if causal else layout
    got = item_lengths(lo, 2, block, causal)
    assert got.shape == (2 * H * 512 // SM90_ROWS,)
    assert got.tolist() == _walked_lengths(layout, 2, block, causal)
    if name == "empty rows":
        assert got[0] == 0


@pytest.mark.parametrize("blocks", [10, 10_000])
def test_sm90_plan_deals_every_item_once(blocks):
    """Every item goes to exactly one block. With fewer blocks than items
    the blocks carry loads within one item's length of each other; with
    more (a small shape on a card with many SMs) the grid shrinks to one
    block per item, the longest items first."""
    lo = causal_layout(bigbird_layout(H, 16, num_random_blocks=2, seed=4))
    lengths = item_lengths(lo, 2, 64, True)
    plan, grid = sm90_plan(lengths, blocks)
    offsets, ids = plan[:grid + 1], plan[grid + 1:]
    assert offsets[0] == 0 and offsets[-1] == len(ids) == len(lengths)
    assert sorted(ids) == list(range(len(lengths)))
    loads = [sum(lengths[u] for u in ids[a:b]) for a, b in zip(offsets, offsets[1:])]
    if blocks < len(lengths):
        assert grid == blocks
        assert max(loads) - min(loads) <= max(lengths)
    else:
        assert grid == len(lengths) and offsets == list(range(grid + 1))
        assert ids == sorted(range(len(lengths)), key=lambda u: (-lengths[u], u))
