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

Blocks 16, 32 and 256 and head dims 80, 96 and 256 are held against the
JAX op the same way, at B 1, S 256-512, H 2. The kernels' walk of the
layout (``union_columns`` below block 64, ``item_lengths``) is held
against numpy models of what each kernel reads, and a torch model of that
walk (tiles of union columns, row masks, the online softmax that zeroes
masked logits) against the plain version.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import attention_core
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.ops.sparse_attention import (
    _BLOCKS, _HEAD_DIMS, _LAYOUT_CACHE, MMA_ROWS, SM90_KEYS, SM90_ROWS, _compact_layout,
    bigbird_layout, bslongformer_layout, causal_layout, fixed_layout, item_lengths,
    launch_counts, local_sliding_window_layout, masked_dense_attention, sm90_plan,
    sparse_attention, sparse_route, union_columns, variable_layout)

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
    ("bf16 D128 base 2 B off", "mma_sync"), ("bf16 D64 k fp32", "mma_sync"),
    ("bf16 D80", "wgmma"), ("bf16 D96", "wgmma"), ("bf16 D256", "wgmma"),
    ("bf16 D112", "mma_sync"), ("fp32 D256", "mma_sync")])
def test_sparse_route_choice(case, route):
    """The one rule picks the forward's route from q, k and v: wgmma for
    bf16 at a head dim both sources build on tensors TMA can describe,
    mma_sync otherwise (the block does not enter it)."""
    D_ = int(case.split("D")[1].split()[0])
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[case[:4].strip()]
    q = k = torch.zeros(2, 128, 4, D_, dtype=dtype)
    if "strided" in case:
        k = torch.zeros(2, 4, 128, D_, dtype=dtype).transpose(1, 2)
    if "off" in case:
        k = torch.zeros(2 * 128 * 4 * D_ + 1, dtype=dtype)[1:].view(2, 128, 4, D_)
    v = k.float() if "k fp32" in case else k
    assert sparse_route(q, k, v) == route


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


# ---------------------------------------------------------------------------
# blocks 16, 32 and 256 and head dims 80, 96 and 256
# ---------------------------------------------------------------------------


def _wide_qkv(seeds, S_, D_, b=1, h=2):
    return [np.random.default_rng(s).normal(size=(b, S_, h, D_)).astype(np.float32)
            for s in seeds]


@pytest.mark.parametrize("block,D_,S_,causal,name", [
    (16, 32, 256, True, "bigbird"),
    (16, 64, 256, False, "fixed"),
    (32, 32, 256, True, "variable_random"),
    (256, 32, 512, True, "bigbird"),
    (16, 80, 256, True, "bslongformer"),
    (32, 96, 256, False, "bigbird_seed3"),
    (16, 256, 256, True, "bigbird"),
], ids=lambda x: str(x))
def test_forward_matches_jax_at_other_blocks_and_head_dims(block, D_, S_, causal, name):
    """The blocks DeepSpeed's ``SparsityConfig`` uses by default (16) and
    beside it, and the head dims of phi-2 / Pythia-2.8B (80), phi-3-mini
    (96) and Pythia-1B (256): the port's op against the JAX op (Pallas in
    interpret mode) and the JAX masked-dense reference, within 2e-4."""
    fn, kw = BUILDERS[name]
    layout = fn(2, S_ // block, **kw)
    q, k, v = _wide_qkv((20, 21, 22), S_, D_)
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), layout, causal=causal,
                                block=block, interpret=True)
    got = sparse_attention(*map(torch.from_numpy, (q, k, v)), layout, causal=causal,
                           block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    ref = jsa.masked_dense_attention(qt, kt, vt, causal_layout(layout) if causal else layout,
                                     causal=causal, sm_scale=1.0 / np.sqrt(D_),
                                     block_q=block, block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.swapaxes(ref, 1, 2)),
                               rtol=2e-4, atol=2e-4)


def test_gradients_match_jax_at_block_16():
    """``q``/``k``/``v`` gradients at block 16 (bigbird, causal) against
    ``jax.grad`` through the JAX op, within 5e-4."""
    layout = bigbird_layout(2, 16, num_random_blocks=1)
    q, k, v = _wide_qkv((23, 24, 25), 256, 32)

    def jloss(q, k, v):
        return jnp.sum(jsa.sparse_attention(q, k, v, layout, causal=True, block=16,
                                            interpret=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (sparse_attention(tq, tk, tv, layout, causal=True, block=16) ** 2).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def _empty_rows_layout(h, nb):
    """Empty q-blocks inside live items: q-blocks 0 and 1 list nothing,
    q-block 2 on list column 1, the last also the last column."""
    lo = np.zeros((h, nb, nb), bool)
    lo[:, 2:, 1] = True
    lo[:, -1, -1] = True
    return lo


def _union_model(layout, r):
    """Item by item, the sorted union of its ``r`` q-blocks' columns and
    the mask of the q-blocks that list each (plain Python)."""
    out = {}
    h, nq, _ = layout.shape
    for hh in range(h):
        for t in range(-(-nq // r)):
            blocks = range(t * r, min(t * r + r, nq))
            cols = sorted({int(c) for i in blocks for c in np.nonzero(layout[hh, i])[0]})
            out[hh, t] = [(c, sum(1 << (i - t * r) for i in blocks if layout[hh, i, c]))
                          for c in cols]
    return out


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("name,nb", [("bigbird", 16), ("fixed", 16), ("variable", 18),
                                     ("empty rows", 16), ("bslongformer", 13)])
def test_union_columns_match_a_model(name, nb, r):
    """Each item's union is its q-blocks' columns, sorted, each with the
    bits of the q-blocks that list it; padding repeats the last column with
    no bit; the width holds whole tiles of 1, 2 or 4 columns; a ragged last
    item (NQ not a multiple of ``r``) unions the q-blocks it has."""
    layout = (_empty_rows_layout(H, nb) if name == "empty rows"
              else BUILDERS[name][0](H, nb, **BUILDERS[name][1]))
    lo = causal_layout(layout)
    cols, masks, cnt = union_columns(lo, r)
    assert cols.dtype == masks.dtype == cnt.dtype == np.int32
    assert cols.shape == masks.shape == (H, -(-nb // r), cols.shape[2])
    assert cols.shape[2] % 4 == 0 and cols.shape[2] >= cnt.max()
    for (hh, t), entries in _union_model(lo, r).items():
        n = len(entries)
        assert cnt[hh, t] == n
        assert list(zip(cols[hh, t, :n].tolist(), masks[hh, t, :n].tolist())) == entries
        assert (cols[hh, t, n:] == (entries[-1][0] if n else 0)).all()
        assert not masks[hh, t, n:].any()
    if name == "empty rows":
        assert masks[0, 0, 0] == (0b1100 if r == 4 else 0)   # q-blocks 2, 3 list column 1


def _walked_tiles(layout, B, block, causal, rows, keys):
    """Each item's key tiles as the kernels walk them, item by item in the
    wgmma kernel's order ``(b H + h) T + t``: per tile the first key of each
    of its entries and their row bits (4 g + r). At a block of ``keys`` or
    more, every tile of each listed column of the item's q-block, dropping
    from the end of the list the tiles whose first key lies past the item's
    last row (under causal); below it, ``keys / block`` columns of the
    union of the item's q-blocks' lists a tile (plain Python over the
    layout; the last tile padded with the last column and no bits)."""
    lo = causal_layout(layout) if causal else layout
    H_, nq, _ = lo.shape
    S_ = nq * block
    out = []
    for _b in range(B):
        for h in range(H_):
            for t in range(-(-S_ // rows)):
                q0 = t * rows
                if block >= keys:
                    iq = q0 // block
                    per = block // keys
                    tiles = [([c * block + j * keys], 1) for c in np.nonzero(lo[h, iq])[0]
                             for j in range(per)]
                    while causal and tiles and tiles[-1][0][0] > q0 + rows - 1:
                        tiles.pop()
                else:
                    r, g = rows // block, keys // block
                    entries = _union_model(lo[:, t * r:t * r + r], r)[h, 0]
                    tiles = []
                    for e in range(0, len(entries), g):
                        part = entries[e:e + g]
                        part += [(part[-1][0], 0)] * (g - len(part))
                        tiles.append(([c * block for c, _ in part],
                                      sum(m << (4 * i) for i, (_, m) in enumerate(part))))
                out.append(tiles)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("name", ["bigbird", "fixed", "variable_random", "empty rows"])
def test_item_lengths_match_the_kernels_tile_walk(name, block, causal):
    """The host's per-item tile counts (which order the wgmma kernel's
    schedule) equal the producer's walk, item by item in the kernel's order
    ``(b H + h) T + t``: of the column lists at block 64 and more (under
    causal no listed tile lies wholly above its item, and the diagonal
    column of a 128- or 256-block leaves its first items tiles fewer), of
    the union of the item's q-blocks' lists below it."""
    nb = 512 // block
    if name == "empty rows":
        layout = _empty_rows_layout(H, nb)
    else:
        fn, kw = BUILDERS[name]
        layout = fn(H, nb, **kw)
    lo = causal_layout(layout) if causal else layout
    got = item_lengths(lo, 2, block, causal)
    assert got.shape == (2 * H * 512 // SM90_ROWS,)
    walked = _walked_tiles(layout, 2, block, causal, SM90_ROWS, SM90_KEYS)
    assert got.tolist() == [len(t) for t in walked]
    if name == "empty rows" and block >= 64:
        assert got[0] == 0


def _walk_forward(q, k, v, layout, block, causal, sm_scale, rows, keys):
    """The kernels' arithmetic over their walk, in fp32 torch, on ``[S,
    D]`` rows of one (batch, head) per layout head: each item of ``rows``
    query rows over the tiles of :func:`_walked_tiles`, a key masked when
    its entry's bit for the row's q-block is clear or, under causal, when
    it lies past the row, the online softmax giving a masked logit an exact
    0 whatever the running max, and rows with no live key 0."""
    S_, D_ = q.shape[1:]
    out = torch.zeros_like(q)
    walked = _walked_tiles(layout, 1, block, causal, rows, keys)
    per_head = -(-S_ // rows)
    for h in range(layout.shape[0]):
        for t in range(per_head):
            q0 = t * rows
            qr = torch.zeros(rows, D_)
            n = min(rows, S_ - q0)
            qr[:n] = q[h, q0:q0 + n]
            m = torch.full((rows,), -1e30)
            l, acc = torch.zeros(rows), torch.zeros(rows, D_)
            row = q0 + torch.arange(rows)
            qblock = (torch.arange(rows) // block) if block < keys else torch.zeros(rows, dtype=torch.long)
            for k0s, bits in walked[h * per_head + t]:
                seg = min(block, keys)
                idx = torch.cat([torch.arange(k0, k0 + seg) for k0 in k0s])
                entry = torch.arange(keys) // seg
                listed = (bits >> (4 * entry[None] + qblock[:, None])) & 1 == 1
                live = listed & ~(causal & (idx[None] > row[:, None]))
                s = torch.where(live, (qr @ k[h, idx].T) * sm_scale, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.max(dim=1).values)
                p = torch.where(s > -5e29, torch.exp(s - m_new[:, None]), torch.zeros(()))
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=1)
                acc = alpha[:, None] * acc + p @ v[h, idx]
                m = m_new
            o = acc / torch.where(l == 0, torch.ones(()), l)[:, None]
            out[h, q0:q0 + n] = o[:n]
    return out


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("block,S_,causal,name", [
    (16, 512, True, "bigbird"), (16, 512, False, "variable_random"),
    (32, 512, True, "fixed"), (16, 256, True, "empty rows"), (16, 80, True, "bigbird"),
    (32, 96, False, "bigbird"), (64, 512, True, "bigbird"), (128, 512, True, "fixed"),
], ids=lambda x: str(x))
def test_the_kernels_walk_computes_the_plain_version(block, S_, causal, name, rows):
    """A torch model of what both kernels compute over their walk (64-row
    items and 64-key tiles, as on the wgmma route and the bf16 mma.sync
    tile; 32 and 32 as on the fp32 tile), including empty q-blocks inside
    live items and a ragged last item (S 80 and 96: not a multiple of 64),
    equals the masked-dense plain version within 1e-5."""
    nb = S_ // block
    layout = (_empty_rows_layout(H, nb) if name == "empty rows"
              else BUILDERS[name][0](H, nb, **BUILDERS[name][1]))
    g = torch.Generator().manual_seed(nb)
    q, k, v = (torch.randn(H, S_, 16, generator=g) for _ in range(3))
    want = masked_dense_attention(q[None], k[None], v[None], layout, causal=causal,
                                  sm_scale=0.25, block_q=block, block_k=block)[0]
    got = _walk_forward(q, k, v, layout, block, causal, 0.25, rows, rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if name == "empty rows":
        assert not got[:, :2 * block].any()


def test_head_dims_and_blocks_are_one_list_with_the_kernels():
    """``_HEAD_DIMS`` and ``_BLOCKS`` equal the C++ lists both sparse
    sources instantiate and accept (``csrc/sparse_tiles.cuh``), and both
    sources include it; the mma.sync route's item rows are its tiles'."""
    csrc = Path(__file__).resolve().parents[1] / "deepspeed_tpu_torch" / "ops" / "csrc"
    text = (csrc / "sparse_tiles.cuh").read_text()
    for macro, values in (("SPARSE_HEAD_DIMS", _HEAD_DIMS), ("SPARSE_BLOCKS", _BLOCKS)):
        listed = re.search(rf"#define {macro}\(X\)(.*)", text).group(1)
        assert tuple(int(x) for x in re.findall(r"X\((\d+)\)", listed)) == values
    for source in ("sparse_attention.cu", "sparse_attention_sm90.cu"):
        assert '#include "sparse_tiles.cuh"' in (csrc / source).read_text()
    mma = (csrc / "sparse_attention.cu").read_text()
    assert "LD = D + 8, BQ = 64, BK = 64" in mma and MMA_ROWS[torch.bfloat16] == 64
    assert MMA_ROWS[torch.float32] == 32   # Tiles<float>::BQ in attention_tiles.cuh


def _triangle(w, lane, shift):
    """``sparse_triangle`` (csrc/sparse_tiles.cuh) in Python."""
    seg = 1 << shift
    row, t = ((16 * w) & (seg - 1)) + (lane >> 2), lane & 3
    return sum(1 << (4 * j + e) for j in range(min(seg // 8, 8)) for e in range(4)
               if 8 * j + 2 * t + (e & 1) <= row + 8 * (e >> 1))


def _live_word(w, lane, q0, k0s, bits, crossing, shift):
    """``sparse_live_word`` (csrc/sparse_tiles.cuh) in Python."""
    per_entry = 1 << (shift - 1)
    full, r = (1 << per_entry) - 1, (16 * w) >> shift
    start = q0 + (r << shift)
    word = 0
    for g, k0 in enumerate(k0s):
        if (bits >> (4 * g + r)) & 1:
            part = (full if not crossing or k0 < start
                    else _triangle(w, lane, shift) if k0 == start else 0)
            word |= part << (g * per_entry)
    return word


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", ["bigbird", "empty rows"])
def test_live_words_are_the_tiles_masks(name, block, causal):
    """The kernels' per-thread live words (64-row items, 64-key tiles, the
    accumulator layout both tiles share) against the mask they stand for:
    bit 4 j + e of the thread at lane l of warp w is live exactly when the
    q-block of its row lists the key's entry and, under causal, the key lies
    at or before the row; and a tile the walk does not flag as masked has
    every key of every row live (the causal-intersected layout makes the
    diagonal entry the only one a row can see past itself)."""
    nb, h = 512 // block, 2
    layout = (_empty_rows_layout(h, nb) if name == "empty rows"
              else BUILDERS[name][0](h, nb, **BUILDERS[name][1]))
    shift = min(block, 64).bit_length() - 1
    g_n, r_n = 64 >> shift, 64 >> shift
    tiles = _walked_tiles(layout, 1, block, causal, 64, 64)
    per_head = 512 // 64
    for i, item in enumerate(tiles):
        q0 = (i % per_head) * 64
        for k0s, bits in item:
            last = k0s[-1] + min(block, 64) - 1
            crossing = causal and last > q0
            full = sum(((1 << r_n) - 1) << (4 * g) for g in range(g_n))
            masked = crossing or (block < 64 and bits != full)
            for w in range(4):
                for lane in range(32):
                    word = _live_word(w, lane, q0, k0s, bits, crossing, shift)
                    for j in range(8):
                        for e in range(4):
                            row = q0 + 16 * w + (lane >> 2) + 8 * (e >> 1)
                            col = 8 * j + 2 * (lane & 3) + (e & 1)
                            g = col >> shift
                            key = k0s[g] + (col & ((1 << shift) - 1))
                            live = bool((bits >> (4 * g + ((16 * w) >> shift))) & 1)
                            live &= not (causal and key > row)
                            assert bool((word >> (4 * j + e)) & 1) == live
                            assert masked or live
