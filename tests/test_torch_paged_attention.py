"""Parity of the port's paged-attention functions with the JAX package.

The same numpy inputs (from a seed) go through the JAX Pallas kernels
(``deepspeed_tpu/ops/pallas/paged_attention.py``, interpret mode on the CPU,
as the JAX package's own tests run them) and through the port's wrappers,
which take their plain PyTorch versions on CPU tensors. Tolerances: 2e-5 in
float32 (the two differ only in summation order), 2e-2 in bfloat16 (inputs
are rounded identically; outputs may land one bf16 ulp apart, 2^-8 relative
at magnitudes below ~2).

The hand-written CUDA kernels themselves are held against the same plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_flash_decode as jax_paged_flash_decode)
from deepspeed_tpu_torch.ops import paged_attention as port

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _tables(S, B, bs, kv_lens, first_block=1):
    """A block table that gives every sequence its own pages (block 0 is
    the trash block) and the number of pages used."""
    bt = np.zeros((S, B), np.int32)
    nxt = first_block
    for s in range(S):
        for b in range(-(-max(int(kv_lens[s]), 1) // bs)):
            bt[s, b] = nxt
            nxt += 1
    return bt, nxt


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _packed_case(rng, S, Q, Hq, Hk, D, bs, B, kv_lens, chunk_lens):
    bt, used = _tables(S, B, bs, kv_lens)
    N = used + 3
    q = rng.standard_normal((S, Q, Hq, D)).astype(np.float32)
    k = rng.standard_normal((N, Hk, bs, D)).astype(np.float32)
    v = rng.standard_normal((N, Hk, bs, D)).astype(np.float32)
    kv_len = np.asarray(kv_lens, np.int32)
    chunk_len = np.asarray(chunk_lens, np.int32)
    start = kv_len - chunk_len
    return q, k, v, bt, start, chunk_len, kv_len


def _run_packed(case, dtype, sm_scale, stats):
    q, k, v, bt, start, chunk, kvl = case
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (bt, start, chunk, kvl)]
    want = jax_paged_attention(jq, jk, jv, *[j for j, _ in ints],
                               sm_scale=sm_scale, interpret=True,
                               return_stats=stats)
    got = port.paged_attention(tq, tk, tv, *[t for _, t in ints],
                               sm_scale=sm_scale, return_stats=stats)
    return got, want


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 2), (6, 1)])
def test_packed_matches_jax_gqa(Hq, Hk, stats):
    """SplitFuse mix at three GQA ratios: a full prompt chunk, a partial
    chunk over a partially filled last page, decode rows, an empty slot."""
    rng = np.random.default_rng(0)
    case = _packed_case(rng, S=4, Q=8, Hq=Hq, Hk=Hk, D=32, bs=4, B=16,
                        kv_lens=[8, 13, 29, 0], chunk_lens=[8, 5, 1, 0])
    got, want = _run_packed(case, "float32", None, stats)
    if stats:
        for g, w in zip(got, want):
            _close(g, w, "float32")
        assert np.all(got[1][3].numpy() == np.float32(-1e30))  # empty slot m
        assert not got[2][3].numpy().any()                      # empty slot l
        got = got[0]
    else:
        _close(got, want, "float32")
    assert not got[3].numpy().any()       # the empty slot is exactly zero
    assert not got[1, 5:].numpy().any()   # padded queries are exactly zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_matches_jax_sm_scale_and_dtype(dtype):
    rng = np.random.default_rng(1)
    case = _packed_case(rng, S=3, Q=4, Hq=4, Hk=2, D=64, bs=8, B=8,
                        kv_lens=[12, 20, 1], chunk_lens=[4, 4, 1])
    for g, w in zip(*_run_packed(case, dtype, 0.37, True)):
        _close(g, w, dtype)


def _decode_case(rng, L, S, Hq, Hk, D, bs, B, kv_lens, pos):
    bt, used = _tables(S, B, bs, kv_lens)
    N = used + 2
    q = rng.standard_normal((S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((L, N, Hk, bs, D)).astype(np.float32)
    v = rng.standard_normal((L, N, Hk, bs, D)).astype(np.float32)
    return q, k, v, bt, np.asarray(pos, np.int32), np.asarray(kv_lens, np.int32)


def _run_decode(case, dtype, layer, sm_scale, stats):
    q, k, v, bt, pos, kvl = case
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (bt, pos, kvl)]
    want = jax_paged_flash_decode(jq, jk, jv, *[j for j, _ in ints],
                                  layer=layer, sm_scale=sm_scale,
                                  interpret=True, return_stats=stats)
    got = port.paged_flash_decode(tq, tk, tv, *[t for _, t in ints],
                                  layer=layer, sm_scale=sm_scale,
                                  return_stats=stats)
    return got, want


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 2), (6, 1)])
def test_decode_matches_jax_resident_pool(Hq, Hk, stats):
    """Layer 2 of a 3-layer resident pool; kv lengths with an empty slot, a
    partial last page, and query positions both past kv_len (the decode
    loop's frozen pool) and inside it (masking by position)."""
    rng = np.random.default_rng(2)
    case = _decode_case(rng, L=3, S=4, Hq=Hq, Hk=Hk, D=32, bs=8, B=8,
                        kv_lens=[0, 7, 23, 40], pos=[0, 9, 11, 45])
    got, want = _run_decode(case, "float32", 2, None, stats)
    if stats:
        for g, w in zip(got, want):
            _close(g, w, "float32")
        got = got[0]
    else:
        _close(got, want, "float32")
    assert not got[0].numpy().any()       # kv_len 0 -> exact zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_sm_scale_and_dtype(dtype):
    rng = np.random.default_rng(3)
    case = _decode_case(rng, L=2, S=3, Hq=8, Hk=2, D=64, bs=4, B=16,
                        kv_lens=[5, 33, 60], pos=[5, 40, 59])
    for g, w in zip(*_run_decode(case, dtype, 1, 0.21, True)):
        _close(g, w, dtype)


#: the head dims past 64 and 128 that both routes build: phi-2 and
#: Pythia-2.8B (80), phi-3-mini (96), Pythia-1B and GPT-J (256)
WIDE_DIMS = (80, 96, 256)


@pytest.mark.parametrize("dtype,stats", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_packed_matches_jax_at_wide_head_dims(D, dtype, stats):
    """The packed function at D 80, 96 and 256: a prompt chunk over a
    partial last page, a decode row, an empty slot, GQA 4/2."""
    rng = np.random.default_rng(30 + D)
    case = _packed_case(rng, S=3, Q=4, Hq=4, Hk=2, D=D, bs=8, B=4,
                        kv_lens=[13, 20, 0], chunk_lens=[4, 1, 0])
    got, want = _run_packed(case, dtype, None, stats)
    for g, w in zip(got, want) if stats else [(got, want)]:
        _close(g, w, dtype)
    out = got[0] if stats else got
    assert not out[2].float().numpy().any()     # the empty slot is exactly zero
    assert not out[1, 1:].float().numpy().any()  # padded queries are exactly zero


@pytest.mark.parametrize("dtype,stats", [("float32", True), ("bfloat16", False)])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_decode_matches_jax_at_wide_head_dims(D, dtype, stats):
    """The decode function at D 80, 96 and 256 over layer 1 of a resident
    pool: an empty slot, a position inside the context, GQA 4/2."""
    rng = np.random.default_rng(40 + D)
    case = _decode_case(rng, L=2, S=3, Hq=4, Hk=2, D=D, bs=8, B=4,
                        kv_lens=[0, 11, 30], pos=[0, 11, 20])
    got, want = _run_decode(case, dtype, 1, None, stats)
    for g, w in zip(got, want) if stats else [(got, want)]:
        _close(g, w, dtype)
    assert not (got[0] if stats else got)[0].float().numpy().any()   # kv_len 0


def test_decode_single_layer_view_and_layer_check():
    rng = np.random.default_rng(4)
    q, k, v, bt, pos, kvl = _decode_case(rng, L=1, S=2, Hq=4, Hk=2, D=32,
                                         bs=8, B=4, kv_lens=[3, 17],
                                         pos=[3, 17])
    args = [torch.from_numpy(a) for a in (q, k[0], v[0], bt, pos, kvl)]
    out = port.paged_flash_decode(*args)
    full = port.paged_flash_decode(*args[:1], torch.from_numpy(k),
                                   torch.from_numpy(v), *args[3:])
    assert torch.equal(out, full)
    with pytest.raises(ValueError):
        port.paged_flash_decode(*args, layer=1)
    with pytest.raises(ValueError):
        port.paged_flash_decode(args[0], torch.from_numpy(k),
                                torch.from_numpy(v), *args[3:], layer=1)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(5)
    q, k, v, bt, start, chunk, kvl = _packed_case(
        rng, S=2, Q=4, Hq=4, Hk=2, D=32, bs=4, B=8, kv_lens=[6, 9],
        chunk_lens=[4, 2])
    args = [torch.from_numpy(a) for a in (q, k, v, bt, start, chunk, kvl)]
    before = dict(port.launch_counts)
    out = port.paged_attention(*args)
    assert torch.equal(out, port.paged_attention_ref(*args))
    assert port.launch_counts == before


# ---------------------------------------------------------------------------
# the sm90 route: its rule, its work items and its split-KV merge
# ---------------------------------------------------------------------------


def _route_tensors(dtype=torch.bfloat16, D=128, bs=32, Hq=8, Hk=8, int8=False):
    q = torch.zeros((2, 4, Hq, D), dtype=dtype)
    shape = (6, Hk, bs, D)
    if int8:
        pool = lambda: (torch.zeros(shape, dtype=torch.int8),
                        torch.zeros(shape[:-1], dtype=torch.float32))
    else:
        pool = lambda: torch.zeros(shape, dtype=dtype)
    return q, pool(), pool()


def _misaligned(t):
    """``t``'s values in a contiguous view whose base is 2 bytes past a
    16-byte boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("case,want", [
    ("bf16 D128 bs32", "sm90"),
    ("bf16 D64 bs16", "sm90"),
    ("bf16 D128 bs64 gqa 32/4", "sm90"),
    ("int8 pools, bf16 queries", "sm90"),
    ("decode queries [S, Hq, D]", "sm90"),
    ("fp32", "cuda_core"),
    ("int8 pools, fp32 queries", "cuda_core"),
    ("D 32", "cuda_core"),
    ("D 96", "sm90"),
    ("D 80", "sm90"),
    ("D 256", "sm90"),
    ("int8 pools D 256", "sm90"),
    ("D 112", "cuda_core"),
    ("bs 8", "cuda_core"),
    ("bs 48", "cuda_core"),
    ("pools of another dtype", "cuda_core"),
    ("strided query", "cuda_core"),
    ("misaligned pool", "cuda_core"),
    ("misaligned scales", "cuda_core"),
])
def test_paged_route_chooses_sm90_for_what_tma_and_wgmma_take(case, want):
    q, k, v = {
        "bf16 D128 bs32": lambda: _route_tensors(),
        "bf16 D64 bs16": lambda: _route_tensors(D=64, bs=16),
        "bf16 D128 bs64 gqa 32/4": lambda: _route_tensors(bs=64, Hq=32, Hk=4),
        "int8 pools, bf16 queries": lambda: _route_tensors(int8=True),
        "decode queries [S, Hq, D]": lambda: (_route_tensors()[0][:, 0].contiguous(),
                                              *_route_tensors()[1:]),
        "fp32": lambda: _route_tensors(dtype=torch.float32),
        "int8 pools, fp32 queries": lambda: _route_tensors(dtype=torch.float32, int8=True),
        "D 32": lambda: _route_tensors(D=32),
        "D 96": lambda: _route_tensors(D=96),
        "D 80": lambda: _route_tensors(D=80, bs=16),
        "D 256": lambda: _route_tensors(D=256, Hq=8, Hk=2),
        "int8 pools D 256": lambda: _route_tensors(D=256, int8=True),
        "D 112": lambda: _route_tensors(D=112),
        "bs 8": lambda: _route_tensors(bs=8),
        "bs 48": lambda: _route_tensors(bs=48),
        "pools of another dtype": lambda: (_route_tensors()[0],
                                           *_route_tensors(dtype=torch.float16)[1:]),
        "strided query": lambda: (torch.zeros((2, 4, 16, 128), dtype=torch.bfloat16)[:, :, ::2],
                                  *_route_tensors()[1:]),
        "misaligned pool": lambda: (_route_tensors()[0], _misaligned(_route_tensors()[1]),
                                    _route_tensors()[2]),
        "misaligned scales": lambda: (_route_tensors(int8=True)[0],
                                      (_route_tensors(int8=True)[1][0],
                                       _misaligned(_route_tensors(int8=True)[1][1])),
                                      _route_tensors(int8=True)[2]),
    }[case]()
    assert port.paged_route(q, k, v) == want


def _sm90_item(block, S, Q, G, Hk, B, bs, start, chunk, kv_len, split_tiles):
    """What block ``block`` of an sm90 launch computes, as the kernel decodes
    it (``item_of`` and ``live_end`` in ``csrc/paged_attention_sm90.cuh``): its
    (sequence ``s``, kv head ``h``, row tile ``t``, split ``k``), its valid
    rows ``nrows`` and rows ``rows_here`` inside ``Q G``, the live pages its
    tiles read, whether it writes split partials, and whether it exits at
    once. ``start``, ``chunk`` (None: every query valid) and ``kv_len`` are
    per-sequence integers. The card tests hold the kernel to the same
    decomposition (``split_tiles`` swept through the launch helpers)."""
    _, row_tiles, n_splits = port.sm90_grid(S, Q, G, Hk, B, bs, split_tiles)
    heads = S * Hk
    first = heads * row_tiles
    if block < first:
        k, t, sh = 0, block // heads, block % heads
    else:
        k, t, sh = 1 + (block - first) // heads, 0, (block - first) % heads
    s, h = divmod(sh, Hk)
    r0 = t * port.SM90_ROWS
    c = Q if chunk is None else int(chunk[s])
    nrows = max(0, min(port.SM90_ROWS, c * G - r0))
    live = (max(0, min(int(kv_len[s]), int(start[s]) + (r0 + nrows - 1) // G + 1, B * bs))
            if nrows > 0 else 0)
    n_tiles = -(-live // port.SM90_TILE_SLOTS)
    partial = n_splits > 1 and c == 1
    if partial:
        t_begin = min(n_tiles, k * split_tiles)
        t_end = min(n_tiles, t_begin + split_tiles)
    else:
        t_begin, t_end = 0, n_tiles
    skip = k > 0 and (not partial or t_begin >= t_end)
    per_tile = port.SM90_TILE_SLOTS // bs
    pages = [] if skip else list(range(t_begin * per_tile,
                                       min(t_end * per_tile, -(-live // bs))))
    return dict(s=s, h=h, t=t, k=k, nrows=nrows, rows_here=min(port.SM90_ROWS, Q * G - r0),
                partial=partial, pages=pages, skip=skip)


def _item_case(name):
    """(S, Q, G, Hk, B, bs, start, chunk or None, kv_len) of a mirror case."""
    if name == "decode":
        kv = [0, 33, 1024, 1023, 64, 2]
        return 6, 1, 4, 2, 32, 32, kv, None, kv
    if name == "mixed, empty slot, partial pages":
        kv, ch = [200, 64, 17, 0, 1], [1, 8, 3, 0, 1]
        return 5, 8, 2, 2, 16, 16, [a - b for a, b in zip(kv, ch)], ch, kv
    if name == "three row tiles, bs 64":
        kv, ch = [300, 1000, 17, 64], [40, 1, 17, 0]
        return 4, 40, 4, 1, 16, 64, [a - b for a, b in zip(kv, ch)], ch, kv
    raise KeyError(name)


@pytest.mark.parametrize("split_tiles", [1, 2, 8])
@pytest.mark.parametrize("name", ["decode", "mixed, empty slot, partial pages",
                                  "three row tiles, bs 64"])
def test_sm90_items_read_each_live_page_once_and_write_each_row_once(name, split_tiles):
    """The mirror of the kernel's work-item decode (``_sm90_item``): over a
    launch's blocks, each (sequence, kv head, row tile with a valid row) reads
    each of its live pages exactly once and nothing else; each row inside
    ``Q G`` is written once (a split row by the merge of the splits that
    read its pages); blocks with nothing to do exit."""
    S, Q, G, Hk, B, bs, start, chunk, kv = _item_case(name)
    blocks, row_tiles, n_splits = port.sm90_grid(S, Q, G, Hk, B, bs, split_tiles)
    reads, direct, partial = {}, {}, {}
    for block in range(blocks):
        it = _sm90_item(block, S, Q, G, Hk, B, bs, start, chunk, kv, split_tiles)
        if it["skip"]:
            assert not it["pages"]
            continue
        for page in it["pages"]:
            key = (it["s"], it["h"], it["t"], page)
            reads[key] = reads.get(key, 0) + 1
        for r in range(it["rows_here"]):
            row = (it["s"], it["h"], it["t"] * port.SM90_ROWS + r)
            if r < it["nrows"] and it["partial"]:
                partial.setdefault(row, []).append(it["k"])
            elif r < it["nrows"] or it["k"] == 0:
                direct[row] = direct.get(row, 0) + 1
    want_reads = {}
    for s in range(S):
        c = Q if chunk is None else chunk[s]
        for h in range(Hk):
            for t in range(row_tiles):
                nrows = max(0, min(port.SM90_ROWS, c * G - t * port.SM90_ROWS))
                if nrows == 0:
                    continue
                last = (t * port.SM90_ROWS + nrows - 1) // G
                live = max(0, min(kv[s], start[s] + last + 1, B * bs))
                for page in range(-(-live // bs)):
                    want_reads[(s, h, t, page)] = 1
            for row in range(Q * G):
                split = (s, h, row) in partial
                assert direct.get((s, h, row), 0) == (0 if split else 1), (s, h, row)
                if split:
                    # the merge reads the splits with live tiles (at least split 0)
                    live = max(0, min(kv[s], start[s] + 1, B * bs))
                    n_used = -(-(-(-live // port.SM90_TILE_SLOTS)) // split_tiles)
                    assert partial[(s, h, row)] == list(range(max(1, n_used)))
                    assert n_splits > 1 and c == 1 and row < G
    assert reads == want_reads


def _merged_over_splits(q, k_pool, v_pool, bt, start, chunk, kv_len, split_tiles):
    """Each sequence's attention over the pages of each of its sm90 items
    (split k of a decode row; every page for the rest), merged in split
    order with ``merge_partial_attention``: ``(o, m, l)`` as the kernels
    return them."""
    from deepspeed_tpu_torch.models.transformer import merge_partial_attention

    S, Q, Hq, D = q.shape
    _, Hk, bs, _ = k_pool.shape
    B = bt.shape[1]
    G = Hq // Hk
    blocks, _, _ = port.sm90_grid(S, Q, G, Hk, B, bs, split_tiles)
    args = (S, Q, G, Hk, B, bs, start.tolist(), chunk.tolist(), kv_len.tolist(), split_tiles)
    items = [_sm90_item(b, *args) for b in range(blocks)]
    outs = []
    for s in range(S):
        # the kv head 0, row tile 0 items of sequence s, in split order
        own = sorted((it for it in items if it["s"] == s and it["h"] == 0 and it["t"] == 0
                      and not it["skip"]), key=lambda it: it["k"])
        qi = torch.arange(Q)
        q_valid = (qi < chunk[s])[None]
        pos = (start[s] + qi)[None]
        o = m = l = None
        for it in own:
            pages = it["pages"] or [0]
            slot0 = pages[0] * bs
            sub = bt[s:s + 1, pages[0]:pages[-1] + 1]
            lim = kv_len[s:s + 1] - slot0 if it["pages"] else torch.zeros_like(kv_len[:1])
            part = port.attention_over_pages(
                q[s:s + 1], port.gather_pages(k_pool, sub, q.dtype),
                port.gather_pages(v_pool, sub, q.dtype), pos - slot0, q_valid,
                lim.clamp(min=0), return_stats=True)
            if o is None:
                o, m, l = part[0].float(), part[1], part[2]
                continue
            o2, m2, l2 = part
            mx = torch.maximum(m, m2)
            new_l = l * torch.exp(m - mx) + l2 * torch.exp(m2 - mx)
            o = merge_partial_attention(o, m, l, o2, m2, l2)
            m, l = mx, new_l
        outs.append((o.to(q.dtype), torch.where(l == 0, torch.full_like(m, -1e30), m), l))
    return tuple(torch.cat([x[i] for x in outs]) for i in range(3))


@pytest.mark.parametrize("split_tiles", [1, 3])
def test_packed_splits_merged_in_order_match_plain_version(split_tiles):
    """The packed kernel's sm90 decomposition in float32: decode rows over
    contexts of one to many tiles split into runs of ``split_tiles`` tiles,
    a prompt chunk and an empty slot unsplit; merged in split order it
    equals ``paged_attention_ref`` within the float32 tolerance."""
    rng = np.random.default_rng(11)
    case = _packed_case(rng, S=5, Q=8, Hq=4, Hk=2, D=16, bs=16, B=16,
                        kv_lens=[250, 64, 30, 0, 129], chunk_lens=[1, 1, 8, 0, 1])
    q, k, v, bt, start, chunk, kvl = (torch.from_numpy(a) for a in case)
    got = _merged_over_splits(q, k, v, bt, start, chunk, kvl, split_tiles)
    want = port.paged_attention_ref(q, k, v, bt, start, chunk, kvl, return_stats=True)
    for g, w in zip(got, want):
        _close(g, w.numpy(), "float32")


@pytest.mark.parametrize("split_tiles", [1, 2])
def test_decode_splits_merged_in_order_match_plain_version(split_tiles):
    """The decode kernel's sm90 decomposition (every sequence a decode row),
    merged in split order, equals ``paged_flash_decode_ref`` in float32,
    positions both at and inside the context."""
    rng = np.random.default_rng(12)
    q, k, v, bt, pos, kvl = _decode_case(rng, L=1, S=4, Hq=8, Hk=2, D=16, bs=32, B=8,
                                         kv_lens=[256, 0, 100, 65], pos=[256, 0, 50, 65])
    q, k, v, bt, pos, kvl = (torch.from_numpy(a) for a in (q, k, v, bt, pos, kvl))
    got = _merged_over_splits(q[:, None], k[0], v[0], bt, pos, torch.ones_like(kvl), kvl,
                              split_tiles)
    want = port.paged_flash_decode_ref(q, k, v, bt, pos, kvl, return_stats=True)
    for g, w in zip(got, want):
        _close(g[:, 0], w.numpy(), "float32")


def test_sm90_split_rule_fills_the_card_from_host_shapes():
    """Splits give the (sequence, kv head) pairs of a one-query launch one
    wave of the launch's instantiation's blocks per SM (at most two); none
    where the pairs alone fill it (the serving shape), nor for a launch that
    may hold prompt chunks; no device value is read."""
    assert port.split_tiles_for(16, 1, 32, 64, 32, 132, 2) == 32    # 512 pairs
    assert port.sm90_grid(16, 1, 1, 32, 64, 32, 32) == (512, 1, 1)
    assert port.split_tiles_for(4, 1, 8, 64, 32, 132, 2) == 4       # 32 pairs: 8 splits
    assert port.sm90_grid(4, 1, 4, 8, 64, 32, 4) == (32 * 8, 1, 8)
    assert port.split_tiles_for(1, 1, 1, 64, 32, 132, 2) == 1
    assert port.split_tiles_for(4, 128, 8, 64, 32, 132, 2) == 32    # prompt chunks: none
    assert port.sm90_grid(4, 128, 4, 8, 64, 32, 32) == (4 * 8 * 8, 8, 1)
    blocks, row_tiles, n_splits = port.sm90_grid(16, 128, 1, 32, 64, 32, 8)
    assert (row_tiles, n_splits) == (2, 4) and blocks == 16 * 32 * 5
    # the blocks per SM are the instantiation's, at most two counted
    assert port.split_tiles_for(4, 1, 8, 64, 32, 132, 3) == 4       # a wave counts two an SM
    assert port.split_tiles_for(16, 1, 8, 64, 32, 132, 1) == 32     # Pythia-1B: none


@pytest.mark.parametrize("S,Hk,per_sm,splits", [
    (16, 8, 1, 1),      # Pythia-1B's decode batch: 128 pairs, 132 blocks a wave
    (4, 8, 2, 8),       # 32 pairs at two blocks per SM: 264 // 32
    (4, 8, 3, 8),       # ... at three: a wave counts two an SM
    (16, 8, 2, 2),      # 128 pairs at two: 264 // 128
    (16, 32, 3, 1),     # Llama-2-7B's serving shape: 512 pairs
    (1, 1, 1, 32),      # one pair: a run for each tile
])
def test_sm90_split_rule_takes_the_splits_one_wave_holds(S, Hk, per_sm, splits):
    """A one-query launch splits each (sequence, kv head) pair's context
    into ``min(per_sm, 2) * sms // pairs`` runs (at most one a tile), so
    that its items still fit one wave of at most two of the instantiation's
    blocks an SM: a split never turns one wave into two."""
    tiles = port.split_tiles_for(S, 1, Hk, 64, 32, 132, per_sm)
    blocks, _, n_splits = port.sm90_grid(S, 1, 1, Hk, 64, 32, tiles)
    assert n_splits == splits
    assert blocks <= max(min(per_sm, 2) * 132, S * Hk)


def test_every_source_builds_the_listed_head_dims():
    """One C++ list of head dims (``csrc/paged_head_dims.cuh``), included by
    the four paged sources through their headers, names ``_HEAD_DIMS`` in
    order; each entry dispatches over that list and nothing else."""
    import pathlib
    import re

    csrc = pathlib.Path(port.__file__).parent / "csrc"
    macro = re.search(r"#define PAGED_HEAD_DIMS\(X\)(.*)",
                      (csrc / "paged_head_dims.cuh").read_text()).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", macro)) == port._HEAD_DIMS
    for header in ("paged_attention.cuh", "paged_attention_sm90.cuh"):
        assert '#include "paged_head_dims.cuh"' in (csrc / header).read_text()
    for source in set(port._SOURCES.values()):
        text = (csrc / source).read_text()
        assert "#define PAGED_HEAD_DIMS" not in text
        assert not re.search(r"D == (64|128) \?", text)   # no two-way dispatch


@pytest.mark.parametrize("kernel", ["packed", "decode"])
def test_public_functions_take_q_sliced_from_fused_qkv(kernel):
    """q sliced from a fused QKV projection (heads [0, Hq) of Hq + 2 Hk) is
    a strided view: the public functions give the JAX result on it (they
    make it contiguous), and the launch helpers, which read q in place,
    refuse it before any launch."""
    rng = np.random.default_rng(21)
    Hq, Hk, D = 4, 2, 32
    if kernel == "packed":
        case = _packed_case(rng, S=3, Q=4, Hq=Hq, Hk=Hk, D=D, bs=4, B=8,
                            kv_lens=[9, 4, 14], chunk_lens=[4, 4, 1])
        qkv = rng.standard_normal((3, 4, Hq + 2 * Hk, D)).astype(np.float32)
    else:
        case = _decode_case(rng, L=2, S=3, Hq=Hq, Hk=Hk, D=D, bs=4, B=8,
                            kv_lens=[9, 4, 14], pos=[8, 3, 13])
        qkv = rng.standard_normal((3, Hq + 2 * Hk, D)).astype(np.float32)
    q_view = torch.from_numpy(qkv)[..., :Hq, :]
    assert not q_view.is_contiguous()
    case = (np.ascontiguousarray(qkv[..., :Hq, :]),) + case[1:]
    run = _run_packed if kernel == "packed" else (
        lambda c, dt, sm, st: _run_decode(c, dt, 1, sm, st))
    want = run(case, "float32", None, False)[1]
    _, k, v, *ints = (torch.from_numpy(np.asarray(a)) for a in case)
    if kernel == "packed":
        got = port.paged_attention(q_view, k, v, *ints)
        launch = lambda: port.launch_paged_attention(
            q_view, k, v, *ints, torch.empty(q_view.shape), None, None, sm_scale=1.0)
    else:
        got = port.paged_flash_decode(q_view, k, v, *ints, layer=1)
        launch = lambda: port.launch_paged_flash_decode(
            q_view, k, v, *ints, torch.empty(q_view.shape), None, None, layer=1,
            sm_scale=1.0)
    _close(got, want, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        launch()
