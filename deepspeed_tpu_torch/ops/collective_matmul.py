"""Latency-hiding collective matmul: ring-overlapped gather/scatter + matmul.

Port of ``deepspeed_tpu/ops/collective_matmul.py``. Each collective is
decomposed into ``p - 1`` point-to-point hops over one mesh axis
(``comm.ppermute_start``) and each hop is issued BEFORE the resident
chunk's product runs, so the transfer rides behind the matmul (T3, arxiv
2401.16677; fused computation-collective ops, arxiv 2305.06942). The JAX
package runs them inside ``shard_map``; here every rank is a process and
the functions take this rank's shards, with the same calling convention
and the same chunk orders.

* :func:`all_gather_matmul` — ``all_gather(x) @ w``; :func:`matmul_reduce_scatter`
  — ``psum_scatter(x @ w)``. Each one's backward is the other (the
  transpose duality of the JAX ``custom_vjp``), the weight gradient a
  chunked ring accumulation.
* :func:`ring_all_gather` / :func:`ring_reduce_scatter` — the matmul-free
  rings; :func:`fused_ring_all_gather` / :func:`fused_ring_reduce_scatter`
  — the same rings over flat fp32 buffers with an optional int8 wire.
* :func:`ring_embedding_gather` / :func:`ring_tied_lm_head` — the vocab-
  sharded table circulating behind the row lookups / the tied head's
  column blocks.

``wire_dtype="int8"`` quantizes each hop's payload with the port's block
int8 kernels (``ops/quant.py``: ``quant_int8`` / ``quant_int8_sr`` /
``dequant_int8`` on the card, their plain versions on the CPU), the int8
payload and one fp32 scale per block riding the wire. The local products
are plain matrix products (``torch.matmul``), as the JAX package computes
them outside Pallas.

Gradients follow the port's tensor-parallel convention
(``parallel/tensor_parallel.py``): a result that is replicated over the
axis gets the full cotangent on every rank, so the JAX backward's
``psum`` of a ``1/p`` cotangent is not needed, and a replicated input's
gradient is summed in rank order so that it is bitwise equal on every rank.
Ring traffic goes into the comms ledger (``comm.log_chunked``; a fused
phase as one entry with its wire bytes and one flight record a hop).
"""

from typing import Optional

import torch

from .. import comm

__all__ = [
    "all_gather_matmul", "matmul_reduce_scatter",
    "ring_all_gather", "ring_reduce_scatter",
    "fused_ring_all_gather", "fused_ring_reduce_scatter",
    "ring_embedding_gather", "ring_tied_lm_head",
    "embedding_overlap_ready",
    "overlap_ready", "overlap_enabled", "set_overlap_enabled",
]

# Config-knob default (TensorParallelConfig.overlap_collective_matmul):
# initialize() sets this so a model built from a DeepSpeed JSON config picks
# the overlapped path up without a model-config edit.
_OVERLAP_DEFAULT = False

_WIRE_BLOCK = 2048  # default quant block, ops/quant.BLOCK


def set_overlap_enabled(on: bool) -> None:
    global _OVERLAP_DEFAULT
    _OVERLAP_DEFAULT = bool(on)


def overlap_enabled() -> bool:
    return _OVERLAP_DEFAULT


def overlap_ready(axis_size: int, *dims: int) -> bool:
    """True when the ring path applies: a real axis and every ``dim`` chunks
    evenly over it. Callers fall back to the unfused composition otherwise."""
    return axis_size > 1 and all(d % axis_size == 0 for d in dims)


def embedding_overlap_ready(axis_size: int, vocab: int) -> bool:
    """True when the ring embedding paths apply: a real axis and a vocab
    that shards evenly over it (Megatron VocabParallelEmbedding layout)."""
    return axis_size > 1 and vocab % axis_size == 0


def _fwd_perm(p: int):
    return [(i, (i + 1) % p) for i in range(p)]


def _bwd_perm(p: int):
    return [(i, (i - 1) % p) for i in range(p)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _log_ring(op: str, nbytes: int, axis, wire_bytes: Optional[int] = None) -> None:
    comm.log_chunked(op, int(nbytes), wire_bytes=wire_bytes, axes=(axis,))


def _mm(x, w):
    """The partial product: contract x's last dim with w's first, in the
    promoted dtype (``jnp.result_type``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _size_idx(axis):
    return comm.get_world_size(axis), comm.axis_index(axis)


def _hop(x, axis, p, backward=False):
    """Start one ring hop of ``x`` (forward: rank i -> i + 1)."""
    return comm.ppermute_start(x, axis, _bwd_perm(p) if backward else _fwd_perm(p))


def _rows(x, j, m, dim=-2):
    return x.narrow(dim, j * m, m)


# ---------------------------------------------------------------------------
# quantized wire: int8 payload + one scale per block
# ---------------------------------------------------------------------------


def _wire_quant(flat, block, stochastic=False, key=None):
    """Flat fp32 -> (int8 ``[nb, block]``, fp32 scales ``[nb, 1]``), the
    pair a quantized hop carries (the block int8 kernels)."""
    from .quant import quantize_int8

    q, s, _ = quantize_int8(flat, block, stochastic=stochastic, key=key)
    return q, s.reshape(-1, 1)


def _wire_dequant(q, s1, n):
    """Inverse of :func:`_wire_quant`: -> flat fp32 ``[n]``."""
    from .quant import dequantize_int8

    return dequantize_int8(q, s1, (int(n),))


def _wire_nbytes(n: int, block: int) -> int:
    """On-wire bytes of one quantized hop of an ``n``-element chunk: int8
    payload padded to whole blocks + one fp32 scale per block."""
    nb = -(-int(n) // int(block))
    return nb * int(block) + 4 * nb


def _walk(bufs, axis, bidirectional, visit):
    """Visit every rank's chunk of a ring: ``visit(chunk, j)`` with ``j``
    the chunk's owner, this rank's own first. ``bufs`` is a tuple of
    tensors that travel together (an int8 payload and its scales); each
    hop is issued before the chunk in hand is visited, so the transfer
    rides behind the visit's product. A ``bidirectional`` walk sends the
    chunks both ways round and takes half the steps."""
    p, idx = _size_idx(axis)

    def start(b, backward=False):
        return [_hop(t, axis, p, backward) for t in b]

    def wait(pending):
        return tuple(w.wait() for w in pending)

    bufs = tuple(t.contiguous() for t in bufs)
    if not bidirectional:
        for s in range(p):
            nxt = start(bufs) if s < p - 1 else None
            visit(bufs, (idx - s) % p)
            if nxt is not None:
                bufs = wait(nxt)
        return
    # chunks idx-1..idx-ceil((p-1)/2) arrive over the forward ring,
    # idx+1..idx+floor((p-1)/2) over the backward ring
    n_f, n_b = p // 2, (p - 1) // 2
    pf, pb = start(bufs), (start(bufs, True) if n_b else None)
    visit(bufs, idx)
    for s in range(1, n_f + 1):
        got_f = wait(pf)
        pf = start(got_f) if s < n_f else None
        got_b = None
        if s <= n_b:
            got_b = wait(pb)
            pb = start(got_b, True) if s < n_b else None
        visit(got_f, (idx - s) % p)
        if got_b is not None:
            visit(got_b, (idx + s) % p)


def _hop_generator(seed: int, idx: int, s: int) -> torch.Generator:
    from .quant import fold_in, seeded_generator

    return seeded_generator(fold_in(fold_in(seed, idx), s))


# ---------------------------------------------------------------------------
# all_gather_matmul / matmul_reduce_scatter
# ---------------------------------------------------------------------------


def _agmm_impl(x, w, axis, bidirectional: bool):
    p = comm.get_world_size(axis)
    m = x.shape[-2]
    _log_ring("all_gather_matmul", (p - 1) * _nbytes(x), axis)
    dt = torch.promote_types(x.dtype, w.dtype)
    out = torch.empty(x.shape[:-2] + (p * m, w.shape[-1]), dtype=dt, device=x.device)
    _walk((x,), axis, bidirectional,
          lambda c, j: _rows(out, j, m).copy_(_mm(c[0], w)))
    return out


def _agmm_impl_quant(x, w, axis, block: int):
    """Quantized-wire :func:`_agmm_impl`: this rank's chunk quantizes once,
    the (payload, scales) pair circulates, every rank (this one included)
    consumes the decoded chunks, so the product is rank-invariant."""
    p = comm.get_world_size(axis)
    m = x.shape[-2]
    n_el = x.numel()
    _log_ring("all_gather_matmul_int8", (p - 1) * _nbytes(x), axis,
              wire_bytes=(p - 1) * _wire_nbytes(n_el, block))
    dt = torch.promote_types(torch.float32, w.dtype)
    out = torch.empty(x.shape[:-2] + (p * m, w.shape[-1]), dtype=dt, device=x.device)

    def visit(c, j):
        dec = _wire_dequant(c[0], c[1], n_el).reshape(x.shape)
        _rows(out, j, m).copy_(_mm(dec, w))

    _walk(_wire_quant(x.float().reshape(-1), block), axis, False, visit)
    return out


def _ring_weight_grad(rot, full, axis):
    """``sum_j rot_j^T @ full[chunk j]`` with ``rot`` circulating the ring:
    the weight gradient of both primitives."""
    p = comm.get_world_size(axis)
    m = rot.shape[-2]
    _log_ring("collective_matmul_wgrad", (p - 1) * _nbytes(rot), axis)
    dt = torch.promote_types(rot.dtype, full.dtype)
    acc = []

    def visit(c, j):
        acc.append(torch.einsum("...ma,...mb->ab", c[0].to(dt), _rows(full, j, m).to(dt)))

    _walk((rot,), axis, False, visit)
    total = acc[0]
    for term in acc[1:]:
        total = total + term
    return total


def _mmrs_impl(x, w, axis):
    p, idx = _size_idx(axis)
    m = x.shape[-2] // p

    def part(s):
        # the chunk resident here at step s entered the ring at rank j + 1
        # and lands fully reduced at rank j after p - 1 hops
        return _mm(_rows(x, (idx - s - 1) % p, m), w)

    acc = part(0)
    _log_ring("matmul_reduce_scatter", (p - 1) * _nbytes(acc), axis)
    for s in range(1, p):
        nxt = _hop(acc, axis, p)
        nxt_part = part(s)
        acc = nxt.wait() + nxt_part
    return acc


def _mmrs_impl_quant(x, w, axis, block: int, stochastic: bool, key):
    """Quantized-wire :func:`_mmrs_impl`: each hop's partial sum quantizes
    for the wire and dequant-adds into the next tile's product on arrival
    (``stochastic`` dithers each round, from ``key``, per rank and hop)."""
    p, idx = _size_idx(axis)
    m = x.shape[-2] // p

    def part(s):
        return _mm(_rows(x, (idx - s - 1) % p, m), w).float()

    acc = part(0)
    n_el = acc.numel()
    _log_ring("matmul_reduce_scatter_int8", (p - 1) * _nbytes(acc), axis,
              wire_bytes=(p - 1) * _wire_nbytes(n_el, block))
    seed = None
    if stochastic:
        if key is None:
            raise ValueError("stochastic matmul_reduce_scatter needs a key (a torch.Generator)")
        from .quant import draw_seed

        seed = draw_seed(key)
    for s in range(1, p):
        gen = _hop_generator(seed, idx, s) if stochastic else None
        q, s1 = _wire_quant(acc.reshape(-1), block, stochastic=stochastic, key=gen)
        nxt = (_hop(q, axis, p), _hop(s1, axis, p))
        nxt_part = part(s)
        acc = (_wire_dequant(nxt[0].wait(), nxt[1].wait(), n_el).reshape(acc.shape)
               + nxt_part)
    return acc


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, bidirectional, quant, block):
        ctx.axis = axis
        ctx.save_for_backward(x, w)
        return (_agmm_impl_quant(x, w, axis, block) if quant
                else _agmm_impl(x, w, axis, bidirectional))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _MatmulReduceScatter.apply(dy, w.transpose(0, 1), ctx.axis, False,
                                            _WIRE_BLOCK, False, None).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ring_weight_grad(x, dy, ctx.axis).to(w.dtype)
        return dx, dw, None, None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, quant, block, stochastic, key):
        ctx.axis = axis
        ctx.save_for_backward(x, w)
        return (_mmrs_impl_quant(x, w, axis, block, stochastic, key) if quant
                else _mmrs_impl(x, w, axis))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _AllGatherMatmul.apply(dy, w.transpose(0, 1), ctx.axis, False, False,
                                        _WIRE_BLOCK).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ring_weight_grad(dy, x, ctx.axis).transpose(0, 1).to(w.dtype)
        return dx, dw, None, None, None, None, None


def all_gather_matmul(x, w, axis, *, bidirectional: bool = False,
                      wire_dtype: str = "exact", block: int = _WIRE_BLOCK):
    """``all_gather(x, axis) @ w`` with the gather hidden behind the matmul.

    ``x: [..., m, k]`` (this rank's row chunk of the gathered operand),
    ``w: [k, n]`` (this rank's column shard) -> ``[..., p*m, n]``. The ring
    rotates ``x`` chunks while each resident chunk's partial product lands
    in its output rows. ``wire_dtype="int8"`` narrows each hop to int8 +
    scales (transport only: the products run on the decoded chunks);
    ``bidirectional`` applies to the exact wire. Differentiable: ``dx``
    through :func:`matmul_reduce_scatter`, ``dw`` through a ring
    accumulation, both exact whatever the wire. At axis size 1 it is
    ``x @ w``."""
    p = comm.get_world_size(axis)
    if p == 1:
        return _mm(x, w)
    quant = wire_dtype in ("int8", "int8_sr")
    return _AllGatherMatmul.apply(x, w, axis, bidirectional, quant, block)


def fused_qkv_all_gather_matmul(x, wq, wk, wv, biases, head_dim, axis,
                                *, bidirectional: bool = False):
    """Fused qkv projection: the three local kernels ``[D, h_l, dh]``
    concatenated, ONE ring :func:`all_gather_matmul`, split back into
    ``[b, S, heads, dh]``. ``biases``: empty, or the three ``[h_l, dh]``
    bias shards."""
    dmodel, dh = wq.shape[0], head_dim
    hl, hkl = wq.shape[1], wk.shape[1]
    wcat = torch.cat([w.reshape(dmodel, -1) for w in (wq, wk, wv)], dim=-1)
    qkv = all_gather_matmul(x, wcat, axis, bidirectional=bidirectional)
    if biases:
        qkv = qkv + torch.cat([b.reshape(-1) for b in biases]).to(qkv.dtype)
    q, k, v = torch.split(qkv, [hl * dh, hkl * dh, hkl * dh], dim=-1)
    b_, s_ = q.shape[:2]
    return (q.reshape(b_, s_, hl, dh), k.reshape(b_, s_, hkl, dh),
            v.reshape(b_, s_, hkl, dh))


def matmul_reduce_scatter(x, w, axis, *, wire_dtype: str = "exact",
                          block: int = _WIRE_BLOCK, stochastic: bool = False,
                          key=None):
    """``psum_scatter(x @ w, axis)`` over the row dim with the reduction ring
    hidden behind the chunked matmul. ``x: [..., M, k]`` (this rank's
    contraction shard), ``w: [k, n]`` -> ``[..., M/p, n]``, this rank's row
    chunk of the summed product. ``M % p == 0`` (check
    :func:`overlap_ready`). ``wire_dtype="int8"`` quantizes each hop's
    partial sum (``stochastic`` with ``key``, a ``torch.Generator``,
    dithers it). Differentiable: ``dx`` through :func:`all_gather_matmul`,
    exact whatever the wire. At axis size 1 it is ``x @ w``."""
    p = comm.get_world_size(axis)
    if p == 1:
        return _mm(x, w)
    if x.shape[-2] % p:
        raise ValueError(f"matmul_reduce_scatter: rows {x.shape[-2]} don't chunk over "
                         f"axis {axis!r} of size {p}; use overlap_ready() and fall back")
    quant = wire_dtype in ("int8", "int8_sr")
    sr = stochastic or wire_dtype == "int8_sr"
    return _MatmulReduceScatter.apply(x, w, axis, quant, block, sr, key)


# ---------------------------------------------------------------------------
# exact rings without a matmul
# ---------------------------------------------------------------------------


def _ring_gather_impl(x, axis, bidirectional=False, op="ring_all_gather"):
    """The gather ring; ``op`` names its ledger entry (None: the caller
    logs the phase)."""
    p = comm.get_world_size(axis)
    m = x.shape[0]
    if op is not None:
        _log_ring(op, (p - 1) * _nbytes(x), axis)
    out = torch.empty((p * m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _walk((x,), axis, bidirectional, lambda c, j: _rows(out, j, m, 0).copy_(c[0]))
    return out


def _ring_rs_impl(x, axis, op="ring_reduce_scatter"):
    """The reduce-scatter ring; ``op`` as in :func:`_ring_gather_impl`."""
    p, idx = _size_idx(axis)
    m = x.shape[0] // p

    def chunk(s):
        return _rows(x, (idx - s - 1) % p, m, 0)

    if op is not None:
        _log_ring(op, (p - 1) * _nbytes(chunk(0)), axis)
    acc = chunk(0).contiguous()
    for s in range(1, p):
        acc = _hop(acc, axis, p).wait() + chunk(s)
    return acc


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, bidirectional):
        ctx.axis = axis
        return _ring_gather_impl(x, axis, bidirectional)

    @staticmethod
    def backward(ctx, g):
        return _RingReduceScatter.apply(g, ctx.axis), None, None


class _RingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _ring_rs_impl(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _RingAllGather.apply(g, ctx.axis, False), None


def ring_all_gather(x, axis, *, bidirectional: bool = False):
    """Tiled all-gather along dim 0 as ``p - 1`` ring hops: numerically
    ``all_gather(tiled=True)``. Differentiable (the backward is
    :func:`ring_reduce_scatter`). At axis size 1 it is ``x``."""
    if comm.get_world_size(axis) == 1:
        return x
    return _RingAllGather.apply(x, axis, bidirectional)


def ring_reduce_scatter(x, axis):
    """Tiled sum reduce-scatter along dim 0 as ring hops: ``[p*m, ...] ->
    [m, ...]``, the ring ``psum_scatter``'s reduction order.
    Differentiable (the backward is :func:`ring_all_gather`)."""
    p = comm.get_world_size(axis)
    if p == 1:
        return x
    if x.shape[0] % p:
        raise ValueError(f"ring_reduce_scatter: {x.shape[0]} rows don't chunk over "
                         f"axis {axis!r} of size {p}")
    return _RingReduceScatter.apply(x, axis)


# ---------------------------------------------------------------------------
# vocab-sharded embedding ring and the tied head
# ---------------------------------------------------------------------------


def _chunk_lookup(chunk, j, tok):
    """Rows of ``chunk`` (vocab block ``j``) for the tokens that live in it;
    zeros elsewhere: the sum over all ring steps resolves every token."""
    vloc = chunk.shape[0]
    rel = tok.long() - j * vloc
    hit = (rel >= 0) & (rel < vloc)
    rows = chunk[rel.clamp(0, vloc - 1)]
    return torch.where(hit[..., None], rows, torch.zeros((), dtype=chunk.dtype,
                                                          device=chunk.device))


class _RingEmbeddingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tok, tab, axis, bidirectional):
        p = comm.get_world_size(axis)
        ctx.axis, ctx.vloc = axis, tab.shape[0]
        ctx.save_for_backward(tok)
        _log_ring("ring_embed_gather", (p - 1) * _nbytes(tab), axis)
        # each token's row lies in exactly one chunk: the sum of the
        # chunks' lookups is exact in any order
        out = []
        _walk((tab,), axis, bidirectional,
              lambda c, j: out.append(_chunk_lookup(c[0], j, tok)))
        total = out[0]
        for rows in out[1:]:
            total = total + rows
        return total

    @staticmethod
    def backward(ctx, dy):
        # the output is replicated over the axis and its cotangent is the
        # full one on every rank: each rank scatter-adds its own rows
        (tok,) = ctx.saved_tensors
        vloc = ctx.vloc
        rel = tok.reshape(-1).long() - comm.axis_index(ctx.axis) * vloc
        hit = (rel >= 0) & (rel < vloc)
        e = dy.shape[-1]
        contrib = torch.where(hit[:, None], dy.reshape(-1, e).float(),
                              torch.zeros((), device=dy.device))
        dtab = torch.zeros((vloc, e), dtype=torch.float32, device=dy.device)
        dtab.index_add_(0, rel.clamp(0, vloc - 1), contrib)
        return None, dtab.to(dy.dtype), None, None


def ring_embedding_gather(tokens, table, axis, *, bidirectional: bool = False):
    """Sharded embedding lookup with the table ring hidden behind the row
    gathers. ``tokens [...]`` global ids (the same on every rank of
    ``axis``), ``table [V/p, E]`` this rank's contiguous vocab shard ->
    ``[..., E]``, replicated over ``axis``. Differentiable in ``table``:
    each rank adds the cotangent rows of its own ids into its shard's
    gradient. At axis size 1 it is ``table[tokens]``."""
    if comm.get_world_size(axis) == 1:
        return table[tokens.long()]
    return _RingEmbeddingGather.apply(tokens, table, axis, bidirectional)


class _RingTiedLMHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tab, axis, bidirectional):
        p = comm.get_world_size(axis)
        vloc = tab.shape[0]
        ctx.axis = axis
        ctx.save_for_backward(x, tab)
        _log_ring("ring_tied_lm_head", (p - 1) * _nbytes(tab), axis)
        dt = torch.promote_types(x.dtype, tab.dtype)
        out = torch.empty(x.shape[:-1] + (p * vloc,), dtype=dt, device=x.device)
        _walk((tab,), axis, bidirectional,
              lambda c, j: _rows(out, j, vloc, -1).copy_(_mm(x, c[0].transpose(0, 1))))
        return out

    @staticmethod
    def backward(ctx, dy):
        x, tab = ctx.saved_tensors
        axis = ctx.axis
        p, idx = _size_idx(axis)
        vloc = tab.shape[0]
        _log_ring("ring_tied_lm_head_bwd", (p - 1) * _nbytes(tab), axis)
        # dx walks the ring; the chunks' terms are summed in rank order so
        # the replicated dx is bitwise equal on every rank
        terms = [None] * p

        def visit(c, j):
            terms[j] = _mm(_rows(dy, j, vloc, -1), c[0])

        _walk((tab,), axis, False, visit)
        dx = terms[0]
        for t in terms[1:]:
            dx = dx + t
        dtab = torch.einsum("...v,...e->ve", _rows(dy, idx, vloc, -1).float(), x.float())
        return dx.to(x.dtype), dtab.to(tab.dtype), None, None


def ring_tied_lm_head(x, table, axis, *, bidirectional: bool = False):
    """``x @ all_gather(table).T`` with the table ring hidden behind the
    per-chunk matmuls (the tied lm head). ``x [..., E]`` (replicated over
    ``axis``), ``table [V/p, E]`` this rank's vocab shard -> logits
    ``[..., V]``, replicated. Differentiable: ``dx`` re-walks the ring,
    ``dtable`` is the local column block's outer product. At axis size 1
    it is ``x @ table.T``."""
    if comm.get_world_size(axis) == 1:
        return _mm(x, table.transpose(0, 1))
    return _RingTiedLMHead.apply(x, table, axis, bidirectional)


# ---------------------------------------------------------------------------
# fused-phase rings over flat fp32 buffers, optional int8 wire
# ---------------------------------------------------------------------------


def _log_fused_phase(op, logical, wire, link, axis, hops, chunk_shape, wire_dtype,
                     tag) -> None:
    """One ledger entry for the phase (logical and wire bytes) and, as in
    the JAX package, one flight record a hop whose ``detail`` names the
    caller's ``tag``, the wire and the hop, so a cross-rank comparison of
    the records lines the hops up one by one."""
    from ..telemetry.collective import record_launch

    comm.get_comms_logger().append(op, int(logical), wire_bytes=int(wire), hop_class=link)
    for h in range(hops):
        record_launch(op, shape=chunk_shape, axes=(axis,), impl="fused_matmul", link=link,
                      detail=f"{tag}:{wire_dtype}:hop{h + 1}/{hops}")


def _fused_gather_impl(v, axis, quant, block):
    p = comm.get_world_size(axis)
    m = v.shape[0]
    v = v.float().reshape(-1)
    if not quant:
        return _ring_gather_impl(v, axis, op=None)
    out = torch.empty((p * m,), dtype=torch.float32, device=v.device)
    _walk(_wire_quant(v, block), axis, False,
          lambda c, j: _rows(out, j, m, 0).copy_(_wire_dequant(c[0], c[1], m)))
    return out


def _fused_rs_impl(v, axis, quant, block, sr, key):
    p, idx = _size_idx(axis)
    m = v.shape[0] // p
    v = v.float().reshape(-1)
    if not quant:
        return _ring_rs_impl(v, axis, op=None)

    def chunk(s):
        return _rows(v, (idx - s - 1) % p, m, 0)

    seed = None
    if sr:
        from .quant import draw_seed

        seed = draw_seed(key)
    acc = chunk(0).contiguous()
    for s in range(1, p):
        gen = _hop_generator(seed, idx, s) if sr else None
        q, s1 = _wire_quant(acc, block, stochastic=sr, key=gen)
        q, s1 = _hop(q, axis, p), _hop(s1, axis, p)
        acc = _wire_dequant(q.wait(), s1.wait(), m) + chunk(s)
    return acc


class _FusedRingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, quant, block):
        ctx.axis = axis
        return _fused_gather_impl(x, axis, quant, block)

    @staticmethod
    def backward(ctx, ct):
        return ring_reduce_scatter(ct, ctx.axis), None, None, None


class _FusedRingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, quant, block, sr, key):
        ctx.axis = axis
        return _fused_rs_impl(x, axis, quant, block, sr, key)

    @staticmethod
    def backward(ctx, ct):
        return ring_all_gather(ct, ctx.axis), None, None, None, None, None


def fused_ring_all_gather(x, axis, *, wire_dtype: str = "exact",
                          block: int = _WIRE_BLOCK, link=None, tag: str = "fused"):
    """Tiled all-gather of a flat buffer, ``[m] -> [p*m]`` fp32, along a
    ring of ``p - 1`` hops, each hop's payload in ``wire_dtype``
    (``exact`` | ``int8``: this rank's chunk quantizes once and every rank,
    this one included, consumes the decoded value). Differentiable
    straight through: the backward is the exact :func:`ring_reduce_scatter`.
    One ledger entry (logical and wire bytes), one flight record a hop
    tagged ``tag``."""
    p = comm.get_world_size(axis)
    if p == 1:
        return x.float().reshape(-1)
    m = int(x.shape[0])
    quant = wire_dtype in ("int8", "int8_sr")
    wire = (p - 1) * (_wire_nbytes(m, block) if quant else 4 * m)
    _log_fused_phase("fused_ring_all_gather", (p - 1) * 4 * m, wire, link, axis, p - 1,
                     (m,), wire_dtype, tag)
    return _FusedRingAllGather.apply(x, axis, quant, block)


def fused_ring_reduce_scatter(x, axis, *, wire_dtype: str = "exact",
                              block: int = _WIRE_BLOCK, stochastic: bool = False,
                              key=None, link=None, tag: str = "fused"):
    """Tiled SUM reduce-scatter of a flat buffer, ``[p*m] -> [m]`` fp32,
    along the ring, each hop's partial sum re-quantized for an int8 wire
    (``stochastic`` with ``key``, a ``torch.Generator``, dithers each round
    per rank and hop). ``exact`` is :func:`ring_reduce_scatter`'s
    reduction order. Differentiable straight through: the backward is the
    exact :func:`ring_all_gather`."""
    p = comm.get_world_size(axis)
    if p == 1:
        return x.float().reshape(-1)
    if x.shape[0] % p:
        raise ValueError(f"fused_ring_reduce_scatter: {x.shape[0]} elements don't chunk "
                         f"over axis {axis!r} of size {p}")
    m = int(x.shape[0]) // p
    quant = wire_dtype in ("int8", "int8_sr")
    sr = stochastic or wire_dtype == "int8_sr"
    if quant and sr and key is None:
        raise ValueError("stochastic fused_ring_reduce_scatter needs a key (a torch.Generator)")
    wire = (p - 1) * (_wire_nbytes(m, block) if quant else 4 * m)
    _log_fused_phase("fused_ring_reduce_scatter", (p - 1) * 4 * m, wire, link, axis, p - 1,
                     (m,), wire_dtype, tag)
    return _FusedRingReduceScatter.apply(x, axis, quant, block, sr, key)
