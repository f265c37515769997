"""Ragged-batch transformer forward over a paged KV cache.

Port of ``deepspeed_tpu/inference/v2/model.py``. The same functions over the
same packed metadata: dense projections run over the flat ``[T]`` token
buffer (every scheduled token, prompt chunk or decode, shares the same
matmuls — the Dynamic SplitFuse property); per-sequence grouping is a
static-shape gather ``[S, Q]``; KV pages are scattered with the trash-block
convention (pad writes land in block 0, never read).

Where the JAX functions are jitted with the pools donated, these run eagerly
and write the pools IN PLACE (``index_put_``); they still return the pools
so the engine reads the same. Attention takes one of two paths per call:
``"pallas"`` — the name of the kernel path, kept from the JAX package — runs
the paged kernels of ``ops/paged_attention.py`` (hand-written Hopper
kernels on a CUDA device, their plain versions on the CPU), ``"einsum"``
runs the gathered-page reference path. The paged kernels compute plain
scaled causal attention, so ALiBi and windowed families (bloom, mpt,
falcon-rw, gpt-neo, starcoder2) run the einsum path, which adds the bias
and the window mask (:func:`paged_attention`). ``verify_step`` is the
packed forward with a greedy token at every row, for speculative decoding.

KV pool forms: a pool argument is a tensor ``[L, N, Hk, bs, D]`` (compute
dtype, or a storage dtype such as ``torch.float8_e4m3fn`` that rows are
cast to and from) or, for int8 storage, a ``(values int8, scales fp32
[L, N, Hk, bs])`` tuple: rows are quantized on scatter (``quantize_rows``)
and dequantized on the gather, or by the decode kernel's int8 mode. The
packed kernel takes compute-dtype pools only, as in the JAX package.

Parameters are the flax tree as nested dicts of tensors
(``models/convert.py``). Float32 matmuls run in full fp32 (TF32 off) so the
fp32 path matches the JAX package's.
"""

import math
from typing import Tuple

import torch

from ... import comm
from ...models.transformer import (TransformerConfig, _block_out, _dense,
                                   _dense_multi_in, _embed, _lm_logits, _mlp, _norm,
                                   _rope_tables, alibi_slopes, apply_rope,
                                   check_parallel_fields, merge_partial_attention)
from ...moe.sharded_moe import dropless_moe
from ...ops.paged_attention import (NEG_INF, attention_over_pages,
                                    gather_pages, paged_flash_decode,
                                    pool_layer, pool_values, storage_bits)
from ...ops.paged_attention import paged_attention as paged_attention_kernel
from ...ops.quant import quantize_rows

_LEFT_OUT = "is not ported yet: ROADMAP.md Queue A item {}"


def exact_fp32() -> None:
    """Full-precision fp32 matmuls and convolutions (no TF32): the fp32
    serving path is held against the JAX package at fp32 tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for the model families this slice does not serve."""
    if cfg.no_lm_head:
        raise NotImplementedError(
            "serving a model without an LM head (no_lm_head) is refused on purpose: "
            "the ragged engine samples from the head's logits, and the JAX package's "
            "ragged model reads params['lm_head'] as well (ROADMAP.md, deliberate "
            "differences)")
    check_parallel_fields(cfg)


def special_attention(cfg: TransformerConfig) -> bool:
    """The families whose attention needs a per-head logit bias (ALiBi) or
    a key window: the paged kernels compute plain scaled causal attention,
    so these run on the einsum path (JAX ``engine_v2._special_attn``)."""
    return cfg.position == "alibi" or cfg.layer_windows is not None


def _check_kernel_family(cfg: TransformerConfig, attn_impl: str) -> None:
    if attn_impl == "pallas" and special_attention(cfg):
        raise ValueError("attn_impl='pallas' runs the paged kernels, which compute "
                         "plain scaled causal attention; ALiBi / layer_windows "
                         "families run attn_impl='einsum'")


def _alibi(cfg: TransformerConfig, device):
    """The per-head ALiBi slopes ``[Hq]`` fp32 on ``device``, or None."""
    if cfg.position != "alibi":
        return None
    return torch.as_tensor(alibi_slopes(cfg.num_heads,
                                        bf16_round=not cfg.alibi_post_scale),
                           dtype=torch.float32, device=device)


def _window(cfg: TransformerConfig, i: int):
    return cfg.layer_windows[i] if cfg.layer_windows is not None else None


# the JAX module's names for the pool-form helpers
_pool_values, _kv_layer = pool_values, pool_layer


def _log_pool(op: str, nbytes: int) -> None:
    """Ledger entry for the pool bytes an attention path touches per layer
    and step: ``paged_pool_gather`` is the einsum path's gathered copy,
    ``paged_pool_read`` the kernels' in-place page-read upper bound (every
    block-table page at storage width, scales included)."""
    comm.log_local(op, int(nbytes))


def _storage_cast(vals, dtype):
    """``vals.to(dtype)`` as the JAX ``astype`` gives it on every device.
    A value that rounds past a one-byte float format's largest finite value
    becomes inf where the format has one (``float8_e5m2``) and NaN where it
    has none (the "fn" formats, e.g. ``float8_e4m3fn``: |x| > 464, since
    464 rounds to even, 448), with the value's sign; NaN stays NaN. torch's own cast agrees on the
    card but saturates ``float8_e4m3fn`` to +-448 on the CPU. Wider formats
    cast as IEEE on every device, unchanged."""
    if not (dtype.is_floating_point and dtype.itemsize == 1):
        return vals.to(dtype)
    top = torch.tensor(torch.finfo(dtype).max, dtype=dtype)
    below = (top.view(torch.uint8) - 1).view(dtype)          # the next value down
    ulp = float(top.float() - below.float())
    edge = float(top.float()) + ulp / 2                       # the rounding midpoint
    ties_up = round(float(top.float()) / ulp) % 2 == 1        # ties go to the even neighbour
    a = vals.float().abs()
    over = (a > edge) | (a == edge) if ties_up else a > edge
    finite_only = str(dtype).endswith(("fn", "fnuz"))
    fill = torch.full_like(vals, float("nan") if finite_only else float("inf"))
    return torch.where(over, torch.copysign(fill, vals), vals).to(dtype)


def _kv_write(pool, i, tgt_block, tgt_slot, vals):
    """Scatter new KV rows ``vals`` [T', Hk, D] into layer ``i``'s pages
    (in place; advanced indices around the head slice put the token axis
    first, as in the JAX ``.at[i, block, :, slot]``). Quantized pools get
    the rows' int8 values and scales (``quantize_rows``); float pools the
    JAX ``astype`` (:func:`_storage_cast`), one-byte ones written through
    their uint8 view."""
    if isinstance(pool, tuple):
        q, s = pool
        qv, sv = quantize_rows(vals)
        q[i][tgt_block, :, tgt_slot] = qv
        s[i][tgt_block, :, tgt_slot] = sv
        return pool
    storage_bits(pool[i])[tgt_block, :, tgt_slot] = storage_bits(_storage_cast(vals, pool.dtype))
    return pool


def _gather_pages(pool, block_table, dtype):
    """Gather a layer's pages ``[S, B, Hk, bs, D]`` in ``dtype``: quantized
    pools dequantize on the gather, storage-cast pools are cast back. Logs
    the gathered copy's bytes (the JAX package's count: storage width for
    plain pools, ``dtype`` for dequantized ones)."""
    out = gather_pages(pool, block_table, dtype)
    width = (out.element_size() if isinstance(pool, tuple)
             else pool.element_size())
    _log_pool("paged_pool_gather", out.numel() * width)
    return out


def _pool_read_bytes(pool, block_table) -> int:
    """Per-step upper bound on the bytes a paged kernel can read from one
    pool: every block-table page at storage width (and the fp32 scale rows
    of int8 pools) — never a materialized copy."""
    vals = _pool_values(pool)
    hk, bs, d = vals.shape[-3:]
    pages = block_table.numel()
    n = pages * hk * bs * d * vals.element_size()
    if isinstance(pool, tuple):
        n += pages * hk * bs * 4
    return n


def _rope(x, cos, sin, positions, interleaved=False):
    """x: [T, H, D]; positions: [T] — the shared rotary over a flat token
    buffer, batch of one."""
    return apply_rope(x[None], cos, sin, positions[None],
                      interleaved=interleaved)[0]


def _qkv(cfg, ap, y, rope_cs, positions):
    """Shared q/k/v projection + rotary for the packed and decode paths."""
    qt = _dense(ap["q_proj"], y)                # [T, Hq, D]
    kt = _dense(ap["k_proj"], y)                # [T, Hk, D]
    vt = _dense(ap["v_proj"], y)
    if cfg.position == "rope":
        cos, sin = rope_cs
        il = cfg.rotary_interleaved
        qt = _rope(qt, cos, sin, positions, il)
        kt = _rope(kt, cos, sin, positions, il)
    return qt, kt, vt


def _moe_mlp(cfg, lp, y):
    """The MoE block over a flat token buffer ``[T, D]``: always the
    dropless grouped GEMM (exact routing, no capacity drops), whatever
    ``moe_dropless`` says, and the qwen2_moe shared expert; no aux loss."""
    logits = y.float() @ lp["router"]["kernel"].float()
    gates = torch.softmax(logits, dim=-1)                       # [T, E]
    out = dropless_moe(y[None], gates[None], cfg.moe_top_k,
                       lp.get("expert_gate_proj"), lp["expert_up_proj"],
                       lp["expert_down_proj"], activation=cfg.activation,
                       norm_topk=cfg.moe_norm_topk, b_up=lp.get("expert_up_bias"),
                       b_down=lp.get("expert_down_bias"),
                       b_gate=lp.get("expert_gate_bias"))[0]
    out = out.to(y.dtype)
    if "shared_gate_proj" in lp:                                # qwen2_moe shared expert
        h = (torch.nn.functional.silu(y @ lp["shared_gate_proj"].to(y.dtype))
             * (y @ lp["shared_up_proj"].to(y.dtype)))
        mod = torch.sigmoid(y.float() @ lp["shared_router"].float())
        out = out + (h @ lp["shared_down_proj"].to(y.dtype)) * mod.to(y.dtype)
    return out


def _ffn(cfg, lp, y):
    """Dense MLP or MoE, by the layer's parameters."""
    if "moe" in lp:
        return _moe_mlp(cfg, lp["moe"], y)
    return _mlp(cfg, lp["mlp"], y)


def _sample(logits, generator, temperature, greedy):
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / max(float(temperature), 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def paged_attention(qg, k_pool, v_pool, block_table, positions_g, q_valid,
                    kv_len, return_stats: bool = False, alibi=None,
                    alibi_post_scale: bool = False, scale=None, window=None):
    """Grouped paged attention over gathered pages — the ``"einsum"`` path.

    qg: [S, Q, Hq, D] grouped queries; k/v_pool: [N, Hk, bs, D] this layer's
    pages, or its ``(int8 values, scales)`` tuple (dequantized on the
    gather); block_table: [S, B]; positions_g: [S, Q] absolute positions;
    q_valid: [S, Q] bool; kv_len: [S]. Returns [S, Q, Hq, D] (and the
    softmax ``(m, l)`` per row with ``return_stats``). ``scale`` overrides
    1/sqrt(d).

    Family knobs (JAX ``model.paged_attention``): ``alibi`` per-head slopes
    [Hq] subtract ``slope * (q_pos - k_pos)`` from the logits — a gathered
    slot's index is the key's absolute position, so the distance is exact
    under paging; falcon / bloom fold ``scale`` into the slope, mpt
    (``alibi_post_scale``) adds the raw slope; ``window`` masks keys at
    distance ``>= window``. Without them this is
    ``ops.paged_attention.attention_over_pages``, the kernels' plain
    version."""
    kg = _gather_pages(k_pool, block_table, qg.dtype)
    vg = _gather_pages(v_pool, block_table, qg.dtype)
    if alibi is None and window is None:
        return attention_over_pages(qg, kg, vg, positions_g, q_valid, kv_len,
                                    sm_scale=scale, return_stats=return_stats)
    S, Q, Hq, D = qg.shape
    _, B, Hk, bs, _ = kg.shape
    G = Hq // Hk
    kg = kg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    vg = vg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    qq = qg.reshape(S, Q, Hk, G, D).permute(0, 2, 3, 1, 4)
    sm = (1.0 / math.sqrt(D)) if scale is None else float(scale)
    logits = torch.einsum("shgqd,shkd->shgqk", qq.float(), kg.float()) * sm
    slot = torch.arange(B * bs, device=qg.device)
    dist = positions_g.long()[..., None] - slot                     # [S, Q, K]
    if alibi is not None:
        sl = ((1.0 if alibi_post_scale else sm)
              * torch.as_tensor(alibi, dtype=torch.float32, device=qg.device))
        logits = logits - sl.reshape(Hk, G)[None, :, :, None, None] * dist.float()[:, None, None]
    valid = ((dist >= 0) & q_valid[..., None]
             & (slot < kv_len.long()[:, None, None]))
    if window is not None:
        valid = valid & (dist < window)
    valid = valid[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                                         # [S,Hk,G,Q]
    p = torch.where(valid, torch.exp(logits - m[..., None]), torch.zeros_like(logits))
    l = p.sum(dim=-1)
    acc = torch.einsum("shgqk,shkd->shgqd", p.to(qg.dtype).float(), vg.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).to(qg.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(S, Q, Hq, D)
    if return_stats:
        stats = lambda a: a.permute(0, 3, 1, 2).reshape(S, Q, Hq)
        return out, stats(m), stats(l)
    return out


def _ragged_hidden(params, cfg: TransformerConfig, kv_k, kv_v, tokens,
                   positions, gather_idx, block_table, kv_len, start_pos,
                   chunk_len, attn_impl: str):
    """The packed ragged forward up to the final norm: final-norm hidden
    states for EVERY packed token (``x [T, H]``). Writes this step's KV rows
    into the pools in place. ``attn_impl``: "einsum" or "pallas" (plain
    scaled causal families only: ALiBi and windows ride the einsum)."""
    check_supported(cfg)
    _check_kernel_family(cfg, attn_impl)
    T = tokens.shape[0]
    bs = _pool_values(kv_k).shape[3]
    tokens, positions = tokens.long(), positions.long()
    gidx = gather_idx.long()
    x = _embed(cfg, params, tokens, positions)                      # [T, H]
    rope_cs = _rope_tables(cfg, tokens.device)
    alibi = _alibi(cfg, tokens.device)

    q_valid = gidx < T                                              # [S, Q]
    safe_gather = torch.clamp(gidx, max=T - 1)
    pos_g = torch.where(q_valid, positions[safe_gather],
                        torch.zeros_like(safe_gather))              # [S, Q]
    # scatter targets for new KV: pad/invalid -> trash block 0, slot 0
    blk_of_pos = torch.take_along_dim(block_table.long(), pos_g // bs, dim=1)
    zero = torch.zeros_like(pos_g)
    tgt_block = torch.where(q_valid, blk_of_pos, zero).reshape(-1)
    tgt_slot = torch.where(q_valid, pos_g % bs, zero).reshape(-1)

    h, hk, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    flat_idx = gidx.reshape(-1)
    for i in range(cfg.num_layers):
        lp = params[f"layer_{i}"]
        y = _norm(cfg, lp["attn_norm"], x)
        ap = lp["attn"]
        qt, kt, vt = _qkv(cfg, ap, y, rope_cs, positions)
        # group per sequence (extra zero pad row at index T)
        grouped = lambda a: torch.cat([a, torch.zeros_like(a[:1])])[gidx]
        qg, kg, vg = grouped(qt), grouped(kt), grouped(vt)
        _kv_write(kv_k, i, tgt_block, tgt_slot, kg.reshape(-1, hk, d))
        _kv_write(kv_v, i, tgt_block, tgt_slot, vg.reshape(-1, hk, d))
        if attn_impl == "pallas":
            if isinstance(kv_k, tuple):
                raise ValueError(
                    "the packed-step pallas kernel takes compute-dtype "
                    "pools; quantized pools run the einsum gather here "
                    "(the fused-dequant kernel serves decode_loop)")
            _log_pool("paged_pool_read",
                      _pool_read_bytes(kv_k, block_table)
                      + _pool_read_bytes(kv_v, block_table))
            out = paged_attention_kernel(qg, kv_k[i], kv_v[i], block_table,
                                         start_pos, chunk_len, kv_len,
                                         sm_scale=cfg.attn_scale)
        else:
            out = paged_attention(qg, _kv_layer(kv_k, i), _kv_layer(kv_v, i),
                                  block_table, pos_g, q_valid, kv_len, alibi=alibi,
                                  alibi_post_scale=cfg.alibi_post_scale,
                                  scale=cfg.attn_scale, window=_window(cfg, i))
        # ungroup back to the flat token buffer ([T+1] with pad row dropped)
        flat = torch.zeros((T + 1, h, d), dtype=out.dtype, device=out.device)
        flat[flat_idx] = out.reshape(-1, h, d)
        attn_out = _dense_multi_in(ap["o_proj"], flat[:T])          # [T, H]
        x = _block_out(cfg, lp, x, y, attn_out, _ffn)
    return _norm(cfg, params["final_norm"], x)


def _ragged_forward_impl(params, cfg, kv_k, kv_v, tokens, positions,
                         gather_idx, block_table, kv_len, logits_idx,
                         start_pos, chunk_len, attn_impl):
    x = _ragged_hidden(params, cfg, kv_k, kv_v, tokens, positions, gather_idx,
                       block_table, kv_len, start_pos, chunk_len, attn_impl)
    # logits only at the sample positions; logits_idx == T selects the zero
    # pad row for non-sampling slots
    h_sel = torch.cat([x, torch.zeros_like(x[:1])])[logits_idx.long()]
    return _lm_logits(cfg, params, h_sel)


@torch.inference_mode()
def ragged_forward(params, cfg: TransformerConfig, kv_k, kv_v, tokens,
                   positions, gather_idx, block_table, kv_len, logits_idx,
                   start_pos=None, chunk_len=None, attn_impl: str = "einsum"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One engine step over a packed ragged batch. Returns (logits [S, V]
    fp32 at each sequence's logits_idx token, kv_k, kv_v) — the pools are
    the arguments, updated in place."""
    exact_fp32()
    if start_pos is None:
        if attn_impl == "pallas":
            raise ValueError("attn_impl='pallas' requires start_pos/chunk_len "
                             "(the contiguous-chunk invariant); only the "
                             "einsum path can derive masks from gather_idx")
        start_pos = chunk_len = kv_len  # unused by the einsum path
    logits = _ragged_forward_impl(params, cfg, kv_k, kv_v, tokens, positions,
                                  gather_idx, block_table, kv_len, logits_idx,
                                  start_pos, chunk_len, attn_impl)
    return logits, kv_k, kv_v


@torch.inference_mode()
def ragged_step(params, cfg: TransformerConfig, kv_k, kv_v, tokens, positions,
                gather_idx, block_table, kv_len, logits_idx, start_pos,
                chunk_len, generator, temperature, attn_impl: str = "einsum",
                greedy: bool = True):
    """Ragged step with on-device sampling: only ``[S]`` int32 tokens need
    to cross to the host. ``generator`` (a ``torch.Generator`` on the
    device) draws the samples when ``greedy`` is False."""
    exact_fp32()
    logits = _ragged_forward_impl(params, cfg, kv_k, kv_v, tokens, positions,
                                  gather_idx, block_table, kv_len, logits_idx,
                                  start_pos, chunk_len, attn_impl)
    return _sample(logits, generator, temperature, greedy), kv_k, kv_v


@torch.inference_mode()
def verify_step(params, cfg: TransformerConfig, kv_k, kv_v, tokens, positions,
                gather_idx, block_table, kv_len, start_pos, chunk_len,
                attn_impl: str = "einsum"):
    """Speculative-decode verification: the packed ragged forward with a
    greedy argmax at EVERY packed token, not just ``logits_idx``. Each
    sequence's chunk is ``[last committed token, draft_1..draft_k]``; row
    ``t`` of the returned ``[T] int32`` is the model's next token after
    input token ``t``. KV rows for every input are written (in place); the
    engine rewinds ``seen_tokens`` past a rejected suffix, whose rows are
    masked by ``kv_len`` and rewritten when their positions are reached.
    Returns (next tokens, kv_k, kv_v)."""
    exact_fp32()
    x = _ragged_hidden(params, cfg, kv_k, kv_v, tokens, positions, gather_idx,
                       block_table, kv_len, start_pos, chunk_len, attn_impl)
    return torch.argmax(_lm_logits(cfg, params, x), dim=-1).to(torch.int32), kv_k, kv_v


@torch.inference_mode()
def decode_step(params, cfg: TransformerConfig, kv_k, kv_v, wk, wv, toks, pos,
                pool_len, block_table, active, t: int, attn_impl: str):
    """One iteration of :func:`decode_loop` (the JAX scan body): logits
    ``[S, V]`` for the tokens ``toks`` at positions ``pos``; writes their KV
    rows into the in-window buffers ``wk``/``wv`` ``[L, W, S, Hk, D]`` at
    step ``t``. Attention is over the FROZEN pool (``pool_len`` tokens per
    sequence, paged kernel with stats) merged with the window (dense,
    masked to steps ``<= t``) by the flash combine. ALiBi and the layer's
    window apply to both halves: in-window token ``w`` sits at ``pool_len +
    w``, so the query is at distance ``t - w`` from it in every sequence."""
    check_supported(cfg)
    _check_kernel_family(cfg, attn_impl)
    S = toks.shape[0]
    Hq, Hk, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    G = Hq // Hk
    W = wk.shape[1]
    sm = (1.0 / math.sqrt(D)) if cfg.attn_scale is None else float(cfg.attn_scale)
    toks, pos = toks.long(), pos.long()
    rope_cs = _rope_tables(cfg, toks.device)
    x = _embed(cfg, params, toks, pos)                              # [S, H]
    alibi = _alibi(cfg, toks.device)
    widx = torch.arange(W, device=toks.device)
    wdist = (t - widx).float()                                      # [W]
    for i in range(cfg.num_layers):
        lp = params[f"layer_{i}"]
        y = _norm(cfg, lp["attn_norm"], x)
        ap = lp["attn"]
        qt, kt, vt = _qkv(cfg, ap, y, rope_cs, pos)                 # [S, H*, D]
        wk[i, t] = kt.to(wk.dtype)
        wv[i, t] = vt.to(wv.dtype)
        if attn_impl == "pallas":
            # resident-pool flash decode: the kernel resolves (layer, page)
            # through the block table — no layer slice or gathered copy;
            # int8 pools ride as (values, scales), dequantized in the kernel
            _log_pool("paged_pool_read",
                      _pool_read_bytes(kv_k, block_table)
                      + _pool_read_bytes(kv_v, block_table))
            o1, m1, l1 = paged_flash_decode(
                qt, kv_k, kv_v, block_table, pos.to(torch.int32), pool_len,
                layer=i, sm_scale=sm, return_stats=True)            # [S, Hq, *]
        else:
            o1, m1, l1 = paged_attention(
                qt[:, None], _kv_layer(kv_k, i), _kv_layer(kv_v, i),
                block_table, pos[:, None], active[:, None], pool_len,
                return_stats=True, alibi=alibi,
                alibi_post_scale=cfg.alibi_post_scale, scale=cfg.attn_scale,
                window=_window(cfg, i))
            o1, m1, l1 = o1[:, 0], m1[:, 0], l1[:, 0]
        # dense attention over the in-window tokens (incl. this one)
        qr = qt.reshape(S, Hk, G, D)
        lg2 = torch.einsum("shgd,wshd->shgw", qr.float(),
                           wk[i].to(qt.dtype).float()) * sm
        if alibi is not None:
            sl = (1.0 if cfg.alibi_post_scale else sm) * alibi
            lg2 = lg2 - sl.reshape(Hk, G)[None, :, :, None] * wdist
        wmask = widx <= t                                           # [W]
        if _window(cfg, i) is not None:
            wmask = wmask & (t - widx < _window(cfg, i))
        lg2 = torch.where(wmask, lg2, torch.full_like(lg2, NEG_INF))
        m2 = lg2.amax(dim=-1)                                       # [S,Hk,G]
        p2 = torch.where(wmask, torch.exp(lg2 - m2[..., None]),
                         torch.zeros_like(lg2))
        l2 = p2.sum(dim=-1)
        acc2 = torch.einsum("shgw,wshd->shgd", p2.to(qt.dtype).float(),
                            wv[i].to(qt.dtype).float())
        o2 = acc2 / torch.where(l2 == 0, torch.ones_like(l2), l2)[..., None]
        merged = merge_partial_attention(o1.reshape(S, Hk, G, D),
                                         m1.reshape(S, Hk, G),
                                         l1.reshape(S, Hk, G), o2, m2, l2)
        attn_tok = merged.reshape(S, Hq, D).to(cfg.dtype)
        attn_out = _dense_multi_in(ap["o_proj"], attn_tok)
        x = _block_out(cfg, lp, x, y, attn_out, _ffn)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_logits(cfg, params, x)


@torch.inference_mode()
def decode_loop(params, cfg: TransformerConfig, kv_k, kv_v, tokens0, pos0,
                block_table, active, generator, temperature, n_steps: int = 16,
                attn_impl: str = "einsum", greedy: bool = True):
    """``n_steps`` fused decode iterations with the frozen-pool-plus-window
    algorithm of the JAX ``decode_loop``: the pool stays frozen during the
    run, each step attends to it (paged kernel with ``(m, l)`` stats) and to
    a small in-window buffer ``[L, n_steps, S, Hk, D]`` (dense, masked),
    merged with the flash combine; the window is scattered into the pool
    ONCE after the run, in place.

    tokens0: [S] last sampled token per sequence; pos0: [S] its absolute
    position (== tokens cached so far); block_table [S, B] must already cover
    ``pos0 + n_steps``; active: [S] bool (inactive slots write to the trash
    block). The window buffer stays in the compute dtype; the final scatter
    quantizes or casts into the pool's storage. Returns (tokens
    [S, n_steps] int32, kv_k, kv_v)."""
    exact_fp32()
    S = tokens0.shape[0]
    bs = _pool_values(kv_k).shape[3]
    L, Hk, D = cfg.num_layers, cfg.kv_heads, cfg.head_dim
    W = n_steps
    dev = tokens0.device
    wk = torch.zeros((L, W, S, Hk, D), dtype=cfg.dtype, device=dev)
    wv = torch.zeros_like(wk)
    pool_len = pos0  # tokens cached before this call — frozen for the run
    toks, pos, out = tokens0, pos0, []
    for t in range(n_steps):
        logits = decode_step(params, cfg, kv_k, kv_v, wk, wv, toks, pos,
                             pool_len, block_table, active, t, attn_impl)
        toks = _sample(logits, generator, temperature, greedy)
        out.append(toks)
        pos = pos + 1

    # one batched scatter of the whole window into the pool
    tpos = pos0.long()[:, None] + torch.arange(W, device=dev)[None]  # [S, W]
    blk = torch.take_along_dim(block_table.long(), tpos // bs, dim=1)
    zero = torch.zeros_like(tpos)
    blk = torch.where(active[:, None], blk, zero).reshape(-1)
    slot = torch.where(active[:, None], tpos % bs, zero).reshape(-1)
    wkt = wk.permute(0, 2, 1, 3, 4).reshape(L, S * W, Hk, D)        # [L,S*W,..]
    wvt = wv.permute(0, 2, 1, 3, 4).reshape(L, S * W, Hk, D)
    for i in range(L):
        _kv_write(kv_k, i, blk, slot, wkt[i])
        _kv_write(kv_v, i, blk, slot, wvt[i])
    return torch.stack(out, dim=1), kv_k, kv_v


# ---------------------------------------------------------------------------
# TP-sharded decode projections (JAX model.py:612-707) wait for the comm
# substrate of a later slice.
# ---------------------------------------------------------------------------


def _tp_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "tensor-parallel decode " + _LEFT_OUT.format("4 (TP decode)"))


resolve_decode_tp_impl = tp_decode_matmul = tp_decode_out_proj = \
    tp_decode_logits = tp_greedy_token = _tp_not_ported
