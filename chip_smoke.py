#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --cards N    # only: data-parallel training over NCCL on N cards

Phases (any failure exits non-zero; nothing is caught and passed over):

1. environment — device name and count, torch/CUDA versions, the card's
   name and power limit from ``nvidia-smi``;
2. build — compiles the port's CUDA sources (``nvcc`` for sm_90a, into
   ``build/``), one ``nvcc`` per source, all started together;
3. kernel parity — each hand-written kernel against its plain PyTorch
   version on the card, and timed with CUDA events beside its bound, its
   plain version and one library call computing the same function:
   the two paged-attention kernels at the serving slice's shapes (Llama-2-7B
   heads, a GQA shape, ragged kv lengths incl. 0 and a partial page, stats
   on and off, bf16 and fp32), and the decode kernel's int8 mode on the main
   decode case's pools quantized by ``quantize_rows`` (layer 2, stats, bf16
   and fp32 compute; library composite: gather + ``dequantize_rows`` +
   SDPA); the block-sparse forward at Llama-2-7B's attention widths (B 1,
   S 4096, H 32, D 128, block 64) over the bigbird (seed 0), fixed,
   bslongformer, variable and local-window layouts, causal and not, at D 64,
   block 128 and fp32, and an all-ones causal layout against the port's
   flash forward (library: SDPA with the layout as a dense mask); the flash-attention forward and its two
   backward kernels at TinyLlama's shape (B 4, S 2048, 32/4 heads, D 64,
   causal, bf16), a Llama-2-7B head shape (32/32, D 128), a non-causal
   case and an fp32 case; fused Adam over odd tensor sizes in AdamW and L2
   modes, bias correction on and off, and timed over TinyLlama's 201
   tensors; the fused LM loss (forward, dl, dh, dK) at TinyLlama's head
   (T 8192, E 2048, V 32000, bf16) and a ragged shape (T 3007, E 1000,
   V 50257, z_loss, half the rows at zero cotangent, untied and tied heads,
   bf16 and fp32), each case reporting the route its backward took
   (``wgmma`` or ``mma_sync``; the main shape must take ``wgmma``), timed
   beside its plain version and the library composite (bf16 matmul +
   F.cross_entropy), the backward's dl, dh and dK kernels on both routes at
   the main shape, and its peak extra memory against the composite's;
4. serving slice — Llama-2-7B at full width (bf16, seeded random weights
   made on the card) served by ``LLMServer`` over ``InferenceEngineV2``: 16
   requests with seeded prompt lengths in [128, 1024], 128 new tokens each.
   Kernel launch counts are reset just before and read just after;
5. serving path parity — a full-width 4-layer model runs one packed step
   and one fused decode step/chunk through the kernel path and the einsum
   path in bf16, and the einsum path in float32, on identical pools; the
   kernel path must agree with the einsum path within twice the einsum
   path's own distance from float32; greedy-token agreement is printed;
6. training slice — TinyLlama-1.1B at full width and depth (bf16 over fp32
   masters, seeded random weights made on the card) trained through
   ``initialize`` + ``train_batch`` (micro-batch 4 x 2048 tokens, gas 2,
   AdamW from the config through the fused Adam kernel, WarmupLR, ZeRO
   stage 3, clipping 1.0, ``loss_impl: auto``, i.e. the fused loss) on one
   repeated seeded batch: 2 warm-up and 8 timed steps; step time,
   tokens/s, MFU and peak memory; the losses must be finite and fall, and
   every kernel must launch exactly as often as the path runs it (flash
   22 x gas x steps, fused loss forward gas x steps and each backward
   kernel once per vocab chunk, Adam once per step);
7. training path parity — TinyLlama widths at 2 layers: two ``train_batch``
   steps through the kernel path (flash kernels, Adam kernel, bf16), the
   plain path (plain attention, dense loss and Adam, bf16) and the plain
   path in float32; loss, gradient norm and weight updates of the kernel
   path (flash, fused loss, Adam) must sit within twice the plain path's
   distance from float32;
8. remat — TinyLlama widths at 4 layers, one step without remat, with
   per-layer remat ("nothing_saveable", "dots_saveable") and with the
   engine-level wrap: loss and grad norm agree, per-layer remat lowers the
   peak memory, the flash forward launches twice as often;
9. checkpoint — TinyLlama widths at 2 layers: 3 steps, save, a fresh
   engine, load, 2 steps, against 5 uninterrupted steps: the state is
   bitwise equal after the load, the losses are bitwise equal, and
   ``zero_to_fp32`` returns the saved masters;
10. block-quant kernels — quantize (nearest), quantize with stochastic
   rounding and dequantize against their plain versions at a ragged size
   (blocks 2048, 512, 128) and at TinyLlama-1.1B's flat gradient (n =
   1,100,048,384, block 2048): nearest, dequantize and stochastic rounding
   bitwise (the same Philox words), stochastic rounding also in
   distribution; timed beside the bound, the plain version and the eager
   torch composite;
11. data-parallel training — two ranks (this script started with
   ``--dp-child``) share cuda:0 over gloo and train TinyLlama widths at 4
   layers (micro 2 x 2048 per rank, gas 2, ZeRO stage 0, bf16, fused loss)
   for 5 steps in each of ``compressed_collectives`` none, int8 and
   int8_sr from one seed and one global batch: the compressed first loss
   bitwise equal to none's, every loss within 0.02 |ref| + 1e-3 of none's,
   losses falling, masters bitwise equal across ranks, 2 quantize and 2
   dequantize launches per rank per step, the ledger's logical and wire
   bytes equal to the JAX package's formula; the none run against one
   process on the same global batch; ``init_distributed`` on NCCL at world
   size 1 with one all-reduce. Its step time is two ranks sharing one card,
   not a scaling number;
12. int8 KV serving — phase 4's run with ``kv_cache_dtype="int8"``: every
   request finishes, KV conservation, the decode kernel's int8 mode launches
   (``paged_flash_decode_int8``) and no bf16-pool kernel does, the engine
   resolves ``attn_impl`` einsum and ``decode_attn_impl`` pallas (the JAX
   resolution), ``pool_nbytes`` equals 8 GiB of int8 + 256 MiB of scales,
   the peak memory is below phase 4's; tok/s, TTFT and how many first
   tokens equal phase 4's are printed. Then a float8_e4m3fn run at 2 layers
   (4 requests x 32 tokens): the pool dtype, both paths einsum with
   ``decode_attn_source`` fallback, pool bytes half of bf16's;
13. int8 path parity — Llama-2-7B widths at 2 layers on seeded int8 pools:
   ``decode_step`` and a 16-step ``decode_loop`` through the kernel path,
   the einsum path (bf16) and the einsum path in float32; the kernel path's
   logits within twice the einsum path's distance from float32;
14. sparse attention path — forward and backward of
   ``deepspeed_tpu_torch.ops.sparse_attention`` at phase 3's bigbird shape:
   one kernel launch, the gradients finite and equal to autograd through
   ``masked_dense_attention`` within 1e-3 of their largest value.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores
# kernel vs plain version on the card: fp32 outputs differ only in summation
# order; bf16 outputs are rounded once from fp32 values that agree to ~1e-6,
# so they may land one bf16 ulp apart (2^-8 relative at magnitudes < 2)
OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
M_TOL = 1e-3                          # running max of fp32 logits, absolute
L_RTOL = 1e-3                         # softmax denominator, relative
# kernel path vs einsum path through 4 full-width bf16 layers: both round
# every activation to bf16 (unit roundoff 2^-9) at different places, so
# their logits differ by bf16 noise. The noise is measured in the same run
# as the einsum path's own distance from a float32 run of the same model
# (bf16 weights cast up): the kernel path must sit within twice that
# distance of the einsum path. A wrong kernel moves logits by O(1).
NOISE_FACTOR = 2.0
SLICE = dict(token_budget=256, max_ragged_sequence_count=16,
             max_chunk_size=128, kv_block_size=32, max_blocks_per_seq=64,
             num_kv_blocks=1024, dtype="bfloat16")


def _cast(tree, dtype, copy=False):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, copy) for k, v in tree.items()}
    return tree.to(dtype, copy=copy)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def page_tables(S, B, bs, kv_len, first=1):
    bt = np.zeros((S, B), np.int32)
    nxt = first
    for s in range(S):
        for b in range(-(-max(int(kv_len[s]), 1) // bs)):
            bt[s, b] = nxt
            nxt += 1
    return bt, nxt


def packed_case(rng, dtype, S, Q, Hq, Hk, D, bs, B, kv_len, chunk):
    kv_len = np.asarray(kv_len, np.int32)
    chunk = np.asarray(chunk, np.int32)
    bt, used = page_tables(S, B, bs, kv_len)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (rand(S, Q, Hq, D), rand(used + 1, Hk, bs, D),
            rand(used + 1, Hk, bs, D), t(bt), t(kv_len - chunk), t(chunk),
            t(kv_len))


def decode_case(rng, dtype, S, Hq, Hk, D, bs, B, L, kv_len, pos):
    kv_len = np.asarray(kv_len, np.int32)
    bt, used = page_tables(S, B, bs, kv_len)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return (rand(S, Hq, D), rand(L, used + 1, Hk, bs, D),
            rand(L, used + 1, Hk, bs, D), t(bt), t(pos), t(kv_len))


def compare(got, want, dtype):
    """max |o - o_ref|, and whether o, m, l are within their tolerances."""
    o, m, l = got
    o_ref, m_ref, l_ref = want
    err = (o.float() - o_ref.float()).abs().max().item()
    m_err = (m - m_ref).abs().max().item()
    l_err = ((l - l_ref).abs() / l_ref.abs().clamp(min=1.0)).max().item()
    ok = err <= OUT_TOL[dtype] and m_err <= M_TOL and l_err <= L_RTOL
    return err, m_err, l_err, ok


def packed_work(q, k_pool, bt, start, chunk, kv_len, stats):
    """(bytes, flops) the packed function needs on these inputs: each live
    K/V row read once per (sequence, kv head), valid query rows read, the
    whole output (and stats) written; 4*D flops per (query row, live slot)."""
    S, Q, Hq, D = q.shape
    Hk = k_pool.shape[1]
    it = q.element_size()
    start, chunk, kv_len = (a.cpu().numpy().astype(np.int64)
                            for a in (start, chunk, kv_len))
    live = np.where(chunk > 0, np.minimum(kv_len, start + chunk), 0)
    nbytes = int(live.sum()) * Hk * D * 2 * it + int(chunk.sum()) * Hq * D * it
    nbytes += S * Q * Hq * (D * it + (8 if stats else 0)) + bt.numel() * 4
    slots = sum(int(np.minimum(start[s] + np.arange(1, chunk[s] + 1),
                               kv_len[s]).sum()) for s in range(S))
    return nbytes, slots * Hq * 4 * D


def decode_work(q, k_pool, bt, pos, kv_len, stats):
    S, Hq, D = q.shape
    Hk = k_pool.shape[2]
    it = q.element_size()
    live = np.minimum(kv_len.cpu().numpy().astype(np.int64),
                      pos.cpu().numpy().astype(np.int64) + 1)
    nbytes = int(live.sum()) * Hk * D * 2 * it
    nbytes += S * Hq * (2 * D * it + (8 if stats else 0)) + bt.numel() * 4
    return nbytes, int(live.sum()) * Hq * 4 * D


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_packed(q, k_pool, v_pool, bt, start, chunk, kv_len, sm_scale):
    """Gathered pages + torch SDPA computing the packed function (timed as
    the library yardstick only; padded rows come out NaN, never compared)."""
    return sdpa_gathered(q, k_pool[bt.long()], v_pool[bt.long()], start, chunk,
                         kv_len, sm_scale)


def sdpa_gathered(q, kg, vg, start, chunk, kv_len, sm_scale):
    """torch SDPA over gathered pages ``[S, B, Hk, bs, D]``."""
    S, Q, Hq, D = q.shape
    _, B, Hk, bs, _ = kg.shape
    kg = kg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    vg = vg.permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    if Hq != Hk:
        kg = kg.repeat_interleave(Hq // Hk, dim=1)
        vg = vg.repeat_interleave(Hq // Hk, dim=1)
    slot = torch.arange(B * bs, device=q.device)
    pos = start.long()[:, None] + torch.arange(Q, device=q.device)[None]
    mask = ((slot[None, None] <= pos[..., None])
            & (slot[None, None] < kv_len.long()[:, None, None])
            & (torch.arange(Q, device=q.device)[None, :, None]
               < chunk.long()[:, None, None]))
    return F.scaled_dot_product_attention(q.transpose(1, 2), kg, vg,
                                          attn_mask=mask[:, None],
                                          scale=sm_scale)


def sdpa_decode(q, k_pool, v_pool, bt, pos, kv_len, layer, sm_scale):
    S, Hq, D = q.shape
    ones = torch.ones_like(kv_len)
    return sdpa_packed(q[:, None], k_pool[layer], v_pool[layer], bt, pos,
                       ones, kv_len, sm_scale)


def int8_pools(k, v):
    """``(int8 values, fp32 scales)`` pools quantized from fp pools by the
    port's ``quantize_rows`` (the engine's quantize-on-scatter)."""
    from deepspeed_tpu_torch.ops.quant import quantize_rows

    return quantize_rows(k), quantize_rows(v)


def decode_int8_work(q, k_vals, bt, pos, kv_len):
    """(bytes, flops) of the decode function on int8 pools: each live K/V
    row's D int8 values and fp32 scale read once, q read, o and the stats
    written; 4*D flops per (query row, live slot)."""
    S, Hq, D = q.shape
    Hk = k_vals.shape[2]
    it = q.element_size()
    live = int(np.minimum(kv_len.cpu().numpy().astype(np.int64),
                          pos.cpu().numpy().astype(np.int64) + 1).sum())
    nbytes = live * Hk * (D + 4) * 2 + S * Hq * (2 * D * it + 8) + bt.numel() * 4
    return nbytes, live * Hq * 4 * D


def sdpa_decode_int8(q, kp, vp, bt, pos, kv_len, layer, sm_scale):
    """The library composite of the int8 decode: gather the pages, dequantize
    them (``dequantize_rows``), SDPA."""
    from deepspeed_tpu_torch.ops.quant import dequantize_rows

    btl = bt.long()
    kg = dequantize_rows(kp[0][layer][btl], kp[1][layer][btl], q.dtype)
    vg = dequantize_rows(vp[0][layer][btl], vp[1][layer][btl], q.dtype)
    return sdpa_gathered(q[:, None], kg, vg, pos, torch.ones_like(kv_len),
                         kv_len, sm_scale)


def kernel_phase(pa):
    """Parity of both kernels with their plain versions over the slice's
    cases; returns the timing rows at the main path's shapes."""
    rng = np.random.default_rng(2024)
    ok = True
    errs = {"paged_attention": 0.0, "paged_flash_decode": 0.0,
            "paged_flash_decode_int8": 0.0}
    S, Q, D, bs, B = 16, 128, 128, 32, 64
    # a steady-state SplitFuse step of the slice: 14 decode rows over
    # contexts of 130..1150 tokens, two 121-token prompt chunks (one at the
    # start of its prompt, one continuing it), T = 256
    kv_dec = rng.integers(130, 1151, 14)
    main_packed = dict(S=S, Q=Q, Hq=32, Hk=32, D=D, bs=bs, B=B,
                       kv_len=list(kv_dec) + [121, 800],
                       chunk=[1] * 14 + [121, 121])
    packed_cases = [
        ("7b mixed step", main_packed),
        ("7b prefill chunks + empty slot + partial page",
         dict(S=4, Q=Q, Hq=32, Hk=32, D=D, bs=bs, B=B,
              kv_len=[128, 300, 45, 0], chunk=[128, 77, 1, 0])),
        ("gqa 32/8", dict(S=4, Q=Q, Hq=32, Hk=8, D=D, bs=bs, B=B,
                          kv_len=[128, 301, 17, 0], chunk=[128, 128, 17, 0])),
    ]
    kv_main = rng.integers(128, 1153, S)
    kv_main[3], kv_main[7] = 0, 33       # an empty slot, a partial page
    main_decode = dict(S=S, Hq=32, Hk=32, D=D, bs=bs, B=B, L=4,
                       kv_len=list(kv_main), pos=list(kv_main))
    decode_cases = [
        ("7b decode, frozen pool (pos = kv_len)", main_decode),
        ("gqa 32/8, pos inside the context",
         dict(S=4, Hq=32, Hk=8, D=D, bs=bs, B=B, L=4,
              kv_len=[0, 31, 400, 1000], pos=[0, 20, 402, 500])),
    ]
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, spec in packed_cases:
            args = packed_case(rng, dtype, **spec)
            for stats in (True, False):
                got = pa.paged_attention(*args, return_stats=stats)
                want = pa.paged_attention_ref(*args, return_stats=True)
                if stats:
                    err, m_err, l_err, good = compare(got, want, dtype)
                else:
                    err = (got.float() - want[0].float()).abs().max().item()
                    m_err = l_err = 0.0
                    good = err <= OUT_TOL[dtype]
                ok &= good
                log(f"parity paged_attention   {name} {str(dtype)[6:]} "
                    f"stats={stats}: max|o|err={err:.3e} m={m_err:.2e} "
                    f"l={l_err:.2e} (tol {OUT_TOL[dtype]:g}) "
                    f"{'ok' if good else 'FAIL'}")
            if spec is main_packed and dtype == torch.bfloat16:
                errs["paged_attention"] = err
                timed["paged_attention"] = ("packed", args)
        for name, spec in decode_cases:
            q, k, v, bt, pos, kvl = decode_case(rng, dtype, **spec)
            for stats in (True, False):
                got = pa.paged_flash_decode(q, k, v, bt, pos, kvl, layer=2,
                                            return_stats=stats)
                want = pa.paged_flash_decode_ref(q, k, v, bt, pos, kvl,
                                                 layer=2, return_stats=True)
                if stats:
                    err, m_err, l_err, good = compare(got, want, dtype)
                else:
                    err = (got.float() - want[0].float()).abs().max().item()
                    m_err = l_err = 0.0
                    good = err <= OUT_TOL[dtype]
                ok &= good
                log(f"parity paged_flash_decode {name} {str(dtype)[6:]} "
                    f"stats={stats}: max|o|err={err:.3e} m={m_err:.2e} "
                    f"l={l_err:.2e} (tol {OUT_TOL[dtype]:g}) "
                    f"{'ok' if good else 'FAIL'}")
            if spec is main_decode and dtype == torch.bfloat16:
                errs["paged_flash_decode"] = err
                timed["paged_flash_decode"] = ("decode", (q, k, v, bt, pos, kvl))
            if spec is main_decode:
                # the int8 mode on this case's pools, quantized by quantize_rows
                kp, vp = int8_pools(k, v)
                got = pa.paged_flash_decode(q, kp, vp, bt, pos, kvl, layer=2,
                                            return_stats=True)
                want = pa.paged_flash_decode_ref(q, kp, vp, bt, pos, kvl,
                                                 layer=2, return_stats=True)
                err, m_err, l_err, good = compare(got, want, dtype)
                ok &= good
                log(f"parity paged_flash_decode_int8 {name} {str(dtype)[6:]} "
                    f"stats=True: max|o|err={err:.3e} m={m_err:.2e} "
                    f"l={l_err:.2e} (tol {OUT_TOL[dtype]:g}) "
                    f"{'ok' if good else 'FAIL'}")
                if dtype == torch.bfloat16:
                    errs["paged_flash_decode_int8"] = err
                    timed["paged_flash_decode_int8"] = (q, kp, vp, bt, pos, kvl)
    if not ok:
        raise SystemExit("kernel parity FAILED (see lines above)")

    rows = {}
    sm = 1.0 / math.sqrt(D)
    _, args = timed["paged_attention"]
    q, k, v, bt, start, chunk, kvl = args
    nbytes, flops = packed_work(q, k, bt, start, chunk, kvl, stats=False)
    b_ms, b_by = bound(nbytes, flops, q.dtype)
    rows["paged_attention"] = dict(
        ms=cuda_ms(lambda: pa.paged_attention(*args)),
        plain_ms=cuda_ms(lambda: pa.paged_attention_ref(*args), iters=5),
        library_ms=cuda_ms(lambda: sdpa_packed(*args, sm), iters=5),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=errs["paged_attention"],
        bytes=nbytes, flops=flops)
    _, (q, k, v, bt, pos, kvl) = timed["paged_flash_decode"]
    nbytes, flops = decode_work(q, k, bt, pos, kvl, stats=True)
    b_ms, b_by = bound(nbytes, flops, q.dtype)
    dargs = (q, k, v, bt, pos, kvl)
    rows["paged_flash_decode"] = dict(
        ms=cuda_ms(lambda: pa.paged_flash_decode(*dargs, layer=2,
                                                 return_stats=True)),
        plain_ms=cuda_ms(lambda: pa.paged_flash_decode_ref(
            *dargs, layer=2, return_stats=True), iters=5),
        library_ms=cuda_ms(lambda: sdpa_decode(*dargs, 2, sm), iters=5),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=errs["paged_flash_decode"],
        bytes=nbytes, flops=flops)
    q, kp, vp, bt, pos, kvl = iargs = timed["paged_flash_decode_int8"]
    nbytes, flops = decode_int8_work(q, kp[0], bt, pos, kvl)
    b_ms, b_by = bound(nbytes, flops, q.dtype)
    rows["paged_flash_decode_int8"] = dict(
        ms=cuda_ms(lambda: pa.paged_flash_decode(*iargs, layer=2,
                                                 return_stats=True)),
        plain_ms=cuda_ms(lambda: pa.paged_flash_decode_ref(
            *iargs, layer=2, return_stats=True), iters=5),
        library_ms=cuda_ms(lambda: sdpa_decode_int8(*iargs, 2, sm), iters=5),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=errs["paged_flash_decode_int8"],
        bytes=nbytes, flops=flops)
    for name, r in rows.items():
        log(f"timing {name} (bf16, main-path shape): kernel {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes']} B, {r['flops']} flop), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms")
    return rows



def flash_work(q, k, causal, passes):
    """(bytes, flops) of one flash pass on these inputs: q, k, v, O (and dO,
    dQ/dK/dV in the backward) moved once, L and delta once; 2*D flops per
    visible (query, key) pair and head for each product the pass does:
    QK^T and PV forward; QK^T, dO V^T, P^T dO and dS^T Q for dK/dV;
    QK^T, dO V^T and dS K for dQ."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    it = q.element_size()
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    q_bytes, kv_bytes, row_bytes = B * S * H * D * it, B * S * Hk * D * it, B * H * S * 4
    if passes == "fwd":      # read q, k, v; write O, L
        return 2 * q_bytes + 2 * kv_bytes + row_bytes, 2 * 2 * D * pairs
    if passes == "dkdv":     # read q, k, v, dO, L, delta; write dK, dV
        return 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 4 * 2 * D * pairs
    return 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 3 * 2 * D * pairs   # dq


def flash_case(dtype, B, S, H, Hk, D, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return r(B, S, H, D), r(B, S, Hk, D), r(B, S, Hk, D), r(B, S, H, D)


def scaled_err(got, want):
    """max |got - want| and that over max |want| (the backward's sums grow
    with S, so its tolerance is relative to the reference's scale)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def sdpa_fwd_bwd(q, k, v, do, causal):
    """F.scaled_dot_product_attention on expanded heads (the library
    yardstick; the port never calls it): forward ms and autograd-backward
    ms, the backward computing dQ, dK and dV together."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    return fwd, bwd


def flash_phase(fa):
    """Flash forward and both backward kernels against their plain versions,
    then timed at TinyLlama's training shape (bf16)."""
    # the kernels' fp32 products differ from the plain version's only in
    # summation order; in bf16 O, P and dS round to bf16, so a value may
    # land one ulp (2^-8 relative) apart, and dQ/dK/dV sum such terms over S
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    main = dict(B=4, S=2048, H=32, Hk=4, D=64)
    cases = [("tinyllama 32/4 D64 causal", torch.bfloat16, main, True),
             ("llama-2-7b heads 32/32 D128 causal", torch.bfloat16,
              dict(B=1, S=2048, H=32, Hk=32, D=128), True),
             ("gqa 8/2 D128 non-causal, ragged S", torch.bfloat16,
              dict(B=2, S=1000, H=8, Hk=2, D=128), False),
             ("fp32 gqa 16/4 D64 causal", torch.float32,
              dict(B=2, S=1024, H=16, Hk=4, D=64), True)]
    ok, errs, timed = True, {}, None
    for i, (name, dtype, shape, causal) in enumerate(cases):
        q, k, v, do = flash_case(dtype, seed=100 + i, **shape)
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        dq, dk, dv = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=causal)
        dq_r, dk_r, dv_r = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                                      causal=causal)
        torch.cuda.synchronize()
        e = {"fwd": scaled_err(o, o_ref), "lse": scaled_err(lse, lse_ref),
             "dq": scaled_err(dq, dq_r), "dk": scaled_err(dk, dk_r),
             "dv": scaled_err(dv, dv_r)}
        good = all(rel <= tol[dtype] for key, (_, rel) in e.items() if key != "lse")
        good &= e["lse"][0] <= 1e-3
        ok &= good
        log(f"parity flash {name} {str(dtype)[6:]}: " + ", ".join(
            f"{key} max|err|={a:.3e} (rel {r:.2e})" for key, (a, r) in e.items())
            + f" (tol rel {tol[dtype]:g}, L abs 1e-3) {'ok' if good else 'FAIL'}")
        if shape is main:
            errs = {"flash_attention_fwd": e["fwd"][0],
                    "flash_attention_bwd_dkdv": max(e["dk"][0], e["dv"][0]),
                    "flash_attention_bwd_dq": e["dq"][0]}
            timed = (q, k, v, do, o_ref, lse_ref)
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("flash kernel parity FAILED (see lines above)")

    q, k, v, do, o, lse = timed
    lib_fwd, lib_bwd = sdpa_fwd_bwd(q, k, v, do, True)
    plain_fwd = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, return_lse=True), iters=3)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), iters=3)
    # the backward wrapper launches dK/dV then dQ; each is timed on its own
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sm = 1.0 / math.sqrt(q.shape[-1])
    dkdv = lambda: fa.launch_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, causal=True,
                                      sm_scale=sm)
    dqk = lambda: fa.launch_bwd_dq(q, k, v, do, lse, delta, dq, causal=True, sm_scale=sm)
    rows = {}
    for name, fn, passes, plain, lib in (
            ("flash_attention_fwd", lambda: fa.flash_attention_forward(q, k, v), "fwd",
             plain_fwd, lib_fwd),
            ("flash_attention_bwd_dkdv", dkdv, "dkdv", plain_bwd, lib_bwd),
            ("flash_attention_bwd_dq", dqk, "dq", plain_bwd, lib_bwd)):
        nbytes, flops = flash_work(q, k, True, passes)
        b_ms, b_by = bound(nbytes, flops, q.dtype)
        rows[name] = dict(ms=cuda_ms(fn), plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=errs[name], bytes=nbytes, flops=flops)
        log(f"timing {name} (bf16, B4 S2048 32/4 D64 causal): kernel "
            f"{rows[name]['ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B, "
            f"{flops} flop), plain {plain:.4f} ms, library {lib:.4f} ms")
    log("timing note: plain and library backward times compute dQ, dK and dV "
        "together; compare them with dK/dV + dQ")
    return rows


SPARSE_MAIN = dict(B=1, S=4096, H=32, D=128, block=64)   # Llama-2-7B heads


def sparse_case(dtype, B, S, H, D, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    r = lambda: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    return r(), r(), r()


def sparse_work(live, B, S, H, D, block, it):
    """(bytes, flops) of the sparse forward on these inputs: q, k, v read
    once, o written once, the column lists read; 4*D*block^2 flops per live
    (q-block, column) pair of the compacted layout (``live`` = its
    ``cnt.sum()``), per batch."""
    return 4 * B * S * H * D * it, 4 * D * block * block * live * B


def sdpa_sparse(q, k, v, mask, sm_scale):
    """torch SDPA with the layout expanded to a dense boolean mask (causal
    folded in): one library call computing the same function (rows with no
    live key come out NaN there; only timed)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask[None],
                                          scale=sm_scale)


def sparse_phase(sa, fa):
    """The sparse forward kernel against its plain version (the masked-dense
    attention) at Llama-2-7B's attention widths (B 1, S 4096, H 32, D 128,
    block 64) over every layout builder, causal and not; D 64; block 128;
    fp32; an all-ones causal layout against the port's flash forward.
    Timed at bigbird (seed 0), causal, bf16."""
    tol = OUT_TOL   # summation order (fp32), one bf16 ulp (bf16)
    B, S, H = SPARSE_MAIN["B"], SPARSE_MAIN["S"], SPARSE_MAIN["H"]
    builders = {
        "bigbird": lambda nb: sa.bigbird_layout(H, nb, seed=0),
        "fixed": lambda nb: sa.fixed_layout(H, nb),
        "bslongformer": lambda nb: sa.bslongformer_layout(H, nb),
        "variable": lambda nb: sa.variable_layout(H, nb, num_random_blocks=1),
        "local_window": lambda nb: sa.local_sliding_window_layout(H, nb),
    }
    cases = [(f"{n} causal={c}", n, c, 128, 64, torch.bfloat16)
             for n in builders for c in (True, False)]
    cases += [("bigbird D64", "bigbird", True, 64, 64, torch.bfloat16),
              ("bigbird block128", "bigbird", True, 128, 128, torch.bfloat16),
              ("bigbird fp32", "bigbird", True, 128, 64, torch.float32)]
    ok, timed = True, None
    for i, (name, lname, causal, D, block, dtype) in enumerate(cases):
        layout = builders[lname](S // block)
        q, k, v = sparse_case(dtype, B, S, H, D, seed=300 + i)
        got = sa.sparse_attention(q, k, v, layout, causal=causal, block=block)
        sl = sa._compact_layout(layout, causal, q.device)
        want = sa.masked_dense_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), sl.layout, causal=causal,
            sm_scale=D ** -0.5, block_q=block, block_k=block).transpose(1, 2)
        err = (got.float() - want.float()).abs().max().item()
        good = err <= tol[dtype] and bool(torch.isfinite(got).all())
        ok &= good
        empty = int((sl.cnt == 0).sum())
        log(f"parity sparse_attention_fwd {name} D{D} block{block} "
            f"{str(dtype)[6:]}: live pairs {int(sl.cnt.sum())} of "
            f"{H * (S // block) ** 2}, empty q-blocks {empty}, max|o|err={err:.3e} "
            f"(tol {tol[dtype]:g}) {'ok' if good else 'FAIL'}")
        if i == 0:
            timed = (q, k, v, layout, sl, err)
        del got, want
    # an all-ones causal layout is causal attention: the port's flash forward
    q, k, v = sparse_case(torch.bfloat16, B, S, H, 128, seed=399)
    ones = np.ones((H, S // 64, S // 64), bool)
    err = (sa.sparse_attention(q, k, v, ones, causal=True, block=64).float()
           - fa.flash_attention_forward(q, k, v, causal=True)[0].float()).abs().max().item()
    good = err <= tol[torch.bfloat16]
    ok &= good
    log(f"parity sparse_attention_fwd all-ones causal vs flash forward bf16: "
        f"max|o|err={err:.3e} (tol {tol[torch.bfloat16]:g}) {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("sparse kernel parity FAILED (see lines above)")

    q, k, v, layout, sl, err = timed
    D, block = SPARSE_MAIN["D"], SPARSE_MAIN["block"]
    lo = torch.as_tensor(sl.layout, device="cuda")
    mask = lo.repeat_interleave(block, 1).repeat_interleave(block, 2)
    mask &= torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None]
    nbytes, flops = sparse_work(int(sl.cnt.sum()), B, S, H, D, block, q.element_size())
    nbytes += sl.cols.numel() * 4 + sl.cnt.numel() * 4
    b_ms, b_by = bound(nbytes, flops, q.dtype)
    plain = lambda: sa.masked_dense_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), sl.layout, causal=True,
        sm_scale=D ** -0.5, block_q=block, block_k=block)
    row = dict(ms=cuda_ms(lambda: sa.sparse_attention(q, k, v, layout, causal=True,
                                                      block=block)),
               plain_ms=cuda_ms(plain, iters=3),
               library_ms=cuda_ms(lambda: sdpa_sparse(q, k, v, mask, D ** -0.5), iters=5),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"timing sparse_attention_fwd (bf16, B1 S4096 H32 D128 block64 bigbird "
        f"causal, {int(sl.cnt.sum())} live pairs): kernel {row['ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop), plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms")
    del mask
    torch.cuda.empty_cache()
    return {"sparse_attention_fwd": row}


def sparse_path_phase(sa, sparse_op):
    """Phase 14: forward and backward through the public entry point
    (``deepspeed_tpu_torch.ops.sparse_attention``) at the full-width bigbird
    shape. The forward launches the kernel once per call; the backward
    recomputes through the plain version, so with the same cotangent the
    gradients equal autograd through ``masked_dense_attention`` to rounding
    (tolerance: 1e-3 of the largest gradient). Returns the launches."""
    B, S, H, D, block = (SPARSE_MAIN[k] for k in ("B", "S", "H", "D", "block"))
    layout = sa.bigbird_layout(H, S // block, seed=0)
    q, k, v = (x.requires_grad_(True) for x in sparse_case(torch.bfloat16, B, S, H, D, 401))
    w = sparse_case(torch.float32, B, S, H, D, 402)[0]
    sa.reset_launch_counts()
    out = sparse_op(q, k, v, layout, causal=True, block=block)
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    launches = dict(sa.launch_counts)
    ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    sl = sa._compact_layout(layout, True, q.device)
    o_ref = sa.masked_dense_attention(*(x.transpose(1, 2) for x in ref), sl.layout,
                                      causal=True, sm_scale=D ** -0.5, block_q=block,
                                      block_k=block).transpose(1, 2)
    (o_ref.float() * w).sum().backward()
    errs = [(a.grad.float() - b.grad.float()).abs().max().item()
            / max(b.grad.float().abs().max().item(), 1e-30) for a, b in zip((q, k, v), ref)]
    finite = all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
    o_err = (out.float() - o_ref.float()).abs().max().item()
    good = (finite and max(errs) <= 1e-3 and o_err <= OUT_TOL[torch.bfloat16]
            and launches["sparse_attention_fwd"] == 1)
    log(f"sparse path (B1 S4096 H32 D128 block64 bigbird causal, bf16): forward "
        f"launches {launches['sparse_attention_fwd']}, max|o|err {o_err:.3e}, grads "
        f"finite {finite}, rel err dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
        f"(tol 1e-3) {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("sparse path FAILED")
    del q, k, v, w, out, ref, o_ref
    torch.cuda.empty_cache()
    return launches


def adam_phase(adam):
    """Fused Adam against its plain version over odd sizes, both modes and
    bias correction on and off; then timed over TinyLlama-1.1B's 201
    tensors (fp32 g, p, m, v), beside torch's fused AdamW."""
    from deepspeed_tpu_torch.models import llama_config, param_shapes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    r = lambda n, sc=1.0: sc * torch.randn(n, generator=gen, device="cuda")
    ok = True
    for adam_w_mode in (True, False):
        for bc in (True, False):
            sizes = [1, 3, 4097, adam.CHUNK - 1, 2 * adam.CHUNK + 7]
            g, p = [r(n, 0.1) for n in sizes], [r(n) for n in sizes]
            m, v = [r(n, 0.01) for n in sizes], [r(n, 1e-3).abs() for n in sizes]
            u = [torch.empty_like(x) for x in g]
            mk, vk = [x.clone() for x in m], [x.clone() for x in v]
            adam.multi_tensor_adam(g, mk, vk, p, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                   weight_decay=0.1, adam_w_mode=adam_w_mode,
                                   bias_correction=bc, step=7, updates=u)
            err = 0.0
            for i in range(len(sizes)):
                want = adam.adam_update_ref(g[i], m[i], v[i], p[i], 3e-4, 0.9, 0.95, 1e-8,
                                            0.1, adam_w_mode, bc, 7)
                for got, w in zip((u[i], mk[i], vk[i]), want):
                    err = max(err, scaled_err(got, w)[1])
            good = err <= 1e-6
            ok &= good
            log(f"parity fused_adam adam_w_mode={adam_w_mode} bias_correction={bc} "
                f"sizes {sizes}: max rel err {err:.3e} (tol 1e-6) "
                f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("fused_adam parity FAILED")

    shapes = list(param_shapes(llama_config("1b")).values())
    n = sum(math.prod(s) for s in shapes)
    g = [r(math.prod(s), 1e-3) for s in shapes]
    p = [r(math.prod(s), 0.02) for s in shapes]
    m = [torch.zeros_like(x) for x in g]
    v = [torch.zeros_like(x) for x in g]
    kw = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1, adam_w_mode=True,
              bias_correction=True, step=1)
    u = [torch.empty_like(x) for x in g]
    adam.multi_tensor_adam(g, m, v, p, updates=u, **kw)
    err = rel = 0.0
    for i in range(len(g)):
        want = adam.adam_update_ref(g[i], torch.zeros_like(g[i]), torch.zeros_like(g[i]),
                                    p[i], 3e-4, 0.9, 0.999, 1e-8, 0.1, True, True, 1)
        for got, w in zip((u[i], m[i], v[i]), want):
            a, r_ = scaled_err(got, w)
            err, rel = max(err, a), max(rel, r_)
    del u, want
    good = rel <= 1e-6
    log(f"parity fused_adam TinyLlama-1.1B ({len(g)} tensors, {n} elements, one launch): "
        f"max|err| {err:.3e}, max rel err {rel:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("fused_adam parity FAILED at TinyLlama-1.1B's shape")
    for x in m + v:
        x.zero_()
    ms = cuda_ms(lambda: adam.multi_tensor_adam(g, m, v, p, **kw))
    plain = cuda_ms(lambda: [adam.adam_update_ref(*a, 3e-4, 0.9, 0.999, 1e-8, 0.1, True,
                                                  True, 1) for a in zip(g, m, v, p)],
                    iters=2, warmup=1)
    steps = [torch.ones((), device="cuda") for _ in g]
    lib = (cuda_ms(lambda: torch._fused_adamw_(
        p, g, m, v, [], steps, lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.1,
        eps=1e-8, amsgrad=False, maximize=False)) if hasattr(torch, "_fused_adamw_")
        else None)
    nbytes = 28 * n          # read g, p, m, v; write p, m, v (fp32)
    b_ms, b_by = bound(nbytes, 15 * n, torch.float32)
    log(f"timing fused_adam (fp32, TinyLlama-1.1B: {len(g)} tensors, {n} elements, one "
        f"launch): kernel {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B), "
        f"plain {plain:.4f} ms, library (torch._fused_adamw_) "
        f"{'n/a' if lib is None else f'{lib:.4f}'} ms")
    del g, p, m, v, steps
    torch.cuda.empty_cache()
    return {"fused_adam": dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                               bound_by=b_by, max_abs_err=err)}


def loss_case(dtype, T, E, V, seed, tied=False):
    """Seeded fused-loss inputs on the card: final-norm-like hidden states
    (unit scale), a head at init scale (K [E, V], or the transpose of a
    [V, E] embedding when tied) and target ids."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    h = torch.randn(T, E, generator=gen, device="cuda").to(dtype)
    k = 0.02 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(dtype)
    t = torch.randint(0, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    return h, (k.T if tied else k), t


def loss_cotangents(lse, T, z_loss, masked, seed):
    """(g_lse, g_tgt) of the masked mean of ``lse - tgt + z_loss lse^2``
    (half the rows at zero weight when ``masked``): the cotangents the loss
    hands the kernels' (lse, tgt) boundary."""
    w = torch.ones(T, device="cuda")
    if masked:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        w = (torch.rand(T, generator=gen, device="cuda") < 0.5).float()
    w = w / w.sum().clamp(min=1.0)
    return w * (1 + 2 * z_loss * lse), -w


def fused_loss_phase(fl):
    """The fused-loss kernels (forward, dl, dh, dK) against their plain
    versions at TinyLlama's head (T 8192, E 2048, V 32000, bf16) and at a
    ragged shape (T 3007, E 1000, V 50257, z_loss 1e-2, half the rows at
    zero cotangent; untied and tied layouts; bf16 and fp32), one dl
    workspace chunk against the plain dl, and at the main shape also with
    the target term's cotangent at 0; then timed at
    the main shape beside the plain versions and the library composite, and
    the peak extra memory of one forward + backward against the dense
    composite's."""
    # lse and the target logit are fp32 sums of exact products that differ
    # from the plain version's only in order; dl is rounded to the operand
    # dtype from fp32 values that agree to ~1e-6, so a bf16 dl may land one
    # ulp (2^-8) apart, and dh/dK sum thousands of such terms: their
    # tolerance is relative to the reference's largest magnitude
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    main = dict(T=8192, E=2048, V=32000)
    ragged = dict(T=3 * 1000 + 7, E=1000, V=50257)
    # with a mean-loss cotangent the one-hot target term dominates dl, dh and
    # dK; the softmax term g_lse exp(s - lse) is ~1e-3 of it at the main
    # shape, under the bf16 tolerance. The "softmax term only" case sets
    # g_tgt to 0 so that the exp term alone is compared
    cases = [("tinyllama head", torch.bfloat16, main, False, 0.0, False, False),
             ("tinyllama head, softmax term only", torch.bfloat16, main, False, 0.0, False,
              True),
             ("ragged untied, z_loss, masked", torch.bfloat16, ragged, False, 1e-2, True, False),
             ("ragged tied, z_loss, masked", torch.bfloat16, ragged, True, 1e-2, True, False),
             ("ragged untied, z_loss, masked", torch.float32, ragged, False, 1e-2, True, False),
             ("ragged tied, z_loss, masked", torch.float32, ragged, True, 1e-2, True, False)]
    ok, errs, timed = True, {}, None
    for i, (name, dtype, shape, tied, z, masked, no_tgt) in enumerate(cases):
        h, k, t = loss_case(dtype, seed=200 + i, tied=tied, **shape)
        lse, tgt = fl.fused_nll_forward(h, k, t)
        lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, t)
        g_lse, g_tgt = loss_cotangents(lse_r, shape["T"], z, masked, seed=300 + i)
        if no_tgt:
            g_tgt = torch.zeros_like(g_tgt)
        kvt, base = fl._layout(k)
        route = fl.backward_route(h, base)
        vc = fl.chunk_width(shape["T"], shape["V"], h.element_size())
        n_chunks = -(-shape["V"] // vc)
        fl.reset_launch_counts()
        dh, dk = fl.fused_nll_backward(h, k, t, lse_r, g_lse, g_tgt)
        routed = dict(fl.route_counts)
        dh_r, dk_r = fl.fused_nll_bwd_ref(h, k, t, lse_r, g_lse, g_tgt)
        # one workspace chunk of the dl kernel (the last, ragged where V is)
        # against the plain dl over the same columns
        v0 = (shape["V"] - 1) // vc * vc
        width = shape["V"] - v0
        ws = torch.empty((shape["T"], vc), dtype=h.dtype, device="cuda")
        fl.launch_dlogits(h, base, t, lse_r, g_lse, g_tgt, ws, v0, width, kvt, route)
        dl_r = fl.fused_dlogits_ref(h, k, t, lse_r, g_lse, g_tgt, v0, width)
        torch.cuda.synchronize()
        e = {"lse": scaled_err(lse, lse_r), "tgt": scaled_err(tgt, tgt_r),
             "dl": scaled_err(ws[:, :width], dl_r),
             "dh": scaled_err(dh, dh_r), "dk": scaled_err(dk, dk_r)}
        good = all(rel <= (1e-4 if key in ("lse", "tgt") else tol[dtype])
                   for key, (_, rel) in e.items())
        good &= dh.dtype == h.dtype and dk.dtype == k.dtype and dk.shape == k.shape
        # every backward launch took the route the wrapper chose
        good &= routed[route] == 3 * n_chunks and sum(routed.values()) == 3 * n_chunks
        ok &= good
        log(f"parity fused_loss {name} {str(dtype)[6:]} T{shape['T']} E{shape['E']} "
            f"V{shape['V']} (route {route}, {routed}; dl chunk {v0}+{width}): "
            + ", ".join(f"{key} max|err|={a:.3e} (rel {r:.2e})" for key, (a, r) in e.items())
            + f" (tol rel lse/tgt 1e-4, dl/dh/dK {tol[dtype]:g}) {'ok' if good else 'FAIL'}")
        if shape is main and route != "wgmma":
            raise SystemExit(f"fused loss: the main shape took the {route} route, not wgmma")
        if shape is main:
            for kname, key in (("fused_loss_fwd", "lse"), ("fused_loss_fwd", "tgt"),
                               ("fused_loss_dlogits", "dl"), ("fused_loss_dh", "dh"),
                               ("fused_loss_dk", "dk")):
                errs[kname] = max(errs.get(kname, 0.0), e[key][0])
            if timed is None:
                timed = (h, k, t, lse_r, g_lse, g_tgt)
        del h, k, t, lse, tgt, lse_r, tgt_r, g_lse, g_tgt, dh, dk, dh_r, dk_r, ws, dl_r, base
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("fused loss kernel parity FAILED (see lines above)")

    h, k, t, lse, g_lse, g_tgt = timed
    T, E = h.shape
    V = k.shape[1]
    vc = fl.chunk_width(T, V, h.element_size())
    chunks = [(v0, min(vc, V - v0)) for v0 in range(0, V, vc)]
    ws = torch.empty((T, vc), dtype=h.dtype, device="cuda")
    dh, dk = torch.empty_like(h), torch.empty_like(k)
    dh_acc = torch.empty((T, E), dtype=torch.float32, device="cuda")
    n = len(chunks)

    def backward_passes(route):
        return {
            "fused_loss_dlogits": lambda: [fl.launch_dlogits(h, k, t, lse, g_lse, g_tgt, ws,
                                                             v0, w, 0, route)
                                           for v0, w in chunks],
            "fused_loss_dh": lambda: [fl.launch_dh(ws, k, dh_acc, dh, v0, w, c == 0,
                                                   c == n - 1, 0, route)
                                      for c, (v0, w) in enumerate(chunks)],
            "fused_loss_dk": lambda: [fl.launch_dk(h, ws, dk, v0, w, 0, route)
                                      for v0, w in chunks],
        }

    passes = {"fused_loss_fwd": lambda: fl.fused_nll_forward(h, k, t),
              **backward_passes("wgmma")}
    # the backward's other route at the same shape, in the same run
    mma_sync_ms = {name: cuda_ms(fn, iters=10)
                   for name, fn in backward_passes("mma_sync").items()}
    plain_fwd = cuda_ms(lambda: fl.fused_nll_fwd_ref(h, k, t), iters=3)
    plain_bwd = cuda_ms(lambda: fl.fused_nll_bwd_ref(h, k, t, lse, g_lse, g_tgt), iters=3)
    # the library composite: no single PyTorch call computes this function
    hl = h.detach().clone().requires_grad_(True)
    kl = k.detach().clone().requires_grad_(True)
    tl = t.long()
    lib_fwd = cuda_ms(lambda: F.cross_entropy(torch.matmul(hl, kl), tl), iters=5)
    lib_loss = F.cross_entropy(torch.matmul(hl, kl), tl)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_loss, (hl, kl), retain_graph=True),
                      iters=5)
    del lib_loss
    torch.cuda.empty_cache()
    gemm = 2 * T * E * V
    io = {"fused_loss_fwd": (T * E + E * V) * 2 + T * 4 + 2 * T * 4,
          "fused_loss_dlogits": (T * E + E * V) * 2 + 4 * T * 4 + T * V * 2,
          "fused_loss_dh": T * V * 2 + E * V * 2 + T * E * 2,
          "fused_loss_dk": T * V * 2 + T * E * 2 + E * V * 2}
    rows = {}
    for name, fn in passes.items():
        b_ms, b_by = bound(io[name], gemm, torch.bfloat16)
        fwd = name == "fused_loss_fwd"
        rows[name] = dict(ms=cuda_ms(fn, iters=10), plain_ms=plain_fwd if fwd else plain_bwd,
                          library_ms=lib_fwd if fwd else lib_bwd, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=errs[name])
        r = rows[name]
        route = "" if fwd else " on the wgmma route"
        log(f"timing {name} (bf16, T{T} E{E} V{V}{'' if fwd else f', {n} chunks of {vc}'}): "
            f"kernel{route} {r['ms']:.4f} ms ({gemm / r['ms'] / 1e9:.1f} TFLOP/s), bound "
            f"{b_ms:.4f} ms by {b_by} ({io[name]} B, {gemm} flop), plain "
            f"{r['plain_ms']:.4f} ms, library composite {r['library_ms']:.4f} ms")
        if not fwd:
            ms = mma_sync_ms[name]
            log(f"timing {name} on the mma_sync route: {ms:.4f} ms "
                f"({gemm / ms / 1e9:.1f} TFLOP/s); wgmma / mma_sync {r['ms'] / ms:.3f}")
    wg_sum = sum(rows[name]["ms"] for name in mma_sync_ms)
    ms_sum = sum(mma_sync_ms.values())
    log(f"timing fused-loss backward (dl + dh + dK): wgmma {wg_sum:.4f} ms, mma_sync "
        f"{ms_sum:.4f} ms, ratio {wg_sum / ms_sum:.3f}")
    log("timing note: the library composite is torch.matmul (bf16) + F.cross_entropy "
        "(forward) and its autograd backward (dh and dK together); the plain backward "
        "also computes dh and dK together: compare them with dlogits + dh + dK")
    del ws, dh, dk, dh_acc

    # peak extra memory of one forward + backward, fused vs dense composite
    def extra(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    hf = h.detach().clone().requires_grad_(True)
    kf = k.detach().clone().requires_grad_(True)
    fused_b = extra(lambda: torch.autograd.grad(
        fl.fused_vocab_nll(hf, kf, t).mean(), (hf, kf)))
    dense_b = extra(lambda: torch.autograd.grad(
        F.cross_entropy(torch.matmul(hl, kl), tl), (hl, kl)))
    log(f"memory fused_loss (T{T} E{E} V{V} bf16, one forward + backward incl. the "
        f"dh/dK outputs): fused {fused_b / 2**20:.1f} MiB extra, dense composite "
        f"{dense_b / 2**20:.1f} MiB extra (the [T, V] logits alone are "
        f"{T * V * 4 / 2**20:.0f} MiB in fp32)")
    if not fused_b < dense_b / 2:
        raise SystemExit("fused loss: peak extra memory not far below the dense composite's")
    del hf, kf, hl, kl, h, k, t
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full width
# ---------------------------------------------------------------------------


def device_time_breakdown(prof, wall_s: float, top: int = 15) -> None:
    """Device time by kernel over a traced run, and the device's busy share
    of the wall time (the trace itself slows the host side). Only device
    events count: a host op (an autograd node, ``aten::mm``) also carries the
    device time of the kernels it launched, which would count them twice."""
    avgs = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted((e for e in avgs if getattr(e, attr) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: getattr(e, attr), reverse=True)
    busy_ms = sum(getattr(e, attr) for e in rows) / 1e3
    log(f"profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"({busy_ms / (wall_s * 1e3):.3f}); top kernels by device time:")
    for e in rows[:top]:
        ms = getattr(e, attr) / 1e3
        log(f"profile:   {ms:9.2f} ms {ms / busy_ms:6.3f}  x{e.count:<6d} "
            f"{e.key[:90]}")


def slice_phase(pa, card, profile=False, kv=None, num_layers=None,
                n_requests=16, new_tokens=128):
    """Serve ``n_requests`` seeded prompts (lengths 128..1024) for
    ``new_tokens`` each through ``LLMServer`` at Llama-2-7B widths with the
    KV storage ``kv`` (``kv_cache_dtype``). Kernel launch counts are reset
    just before and read just after the run. Gates: every request finishes
    by length with in-vocabulary tokens, the server drains, KV conservation
    holds. Returns what the run measured."""
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, LLMServer, Request

    acc = get_accelerator()
    over = {} if num_layers is None else {"num_layers": num_layers}
    cfg = llama_config("7b", dtype=torch.bfloat16, **over)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = InferenceEngineV2(
        cfg, params, RaggedInferenceEngineConfig(**SLICE, kv_cache_dtype=kv),
        device="cuda")
    acc.synchronize()
    tag = f"slice[kv {kv or 'bf16'}]"
    log(f"{tag}: Llama-2-7B widths (hidden {cfg.hidden_size}, {cfg.num_layers} "
        f"layers, {cfg.num_heads} heads, ffn {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}), bf16 seeded weights, KV pool {engine.kv.k.dtype} "
        f"{engine.kv.pool_nbytes() / 2**30:.4f} GiB ({engine.kv.pool_nbytes()} B), "
        f"attn_impl {engine.attn_impl}, decode_attn {engine.decode_attn_impl} "
        f"({engine.decode_attn_source}), set-up {time.perf_counter() - t0:.1f} s")
    server = LLMServer(engine, fused_decode_chunk=16)
    rng = np.random.default_rng(7)
    lens = rng.integers(128, 1025, 16)[:n_requests]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    acc.reset_peak_memory_stats()
    acc.synchronize()
    trace = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        if profile else contextlib.nullcontext())
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    with trace:
        resps = [server.submit(Request(p, max_new_tokens=new_tokens), block=True)
                 for p in prompts]
        for r in resps:
            r.wait(timeout=900)
        acc.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.launch_counts)
    drained = server.drain(timeout=60)
    if server.error is not None:
        raise server.error

    finished = [r.done and r.finish_reason == FINISH_LENGTH
                and len(r.tokens) == new_tokens for r in resps]
    in_vocab = all(0 <= t < cfg.vocab_size for r in resps for t in r.tokens)
    engine.kv.assert_conservation([s.blocks for s in engine.state_manager.all()])
    conserved = (not engine.state_manager.all()
                 and engine.kv.free_blocks == engine.kv.num_blocks - 1)
    snap = server.metrics.snapshot()
    tokens = sum(len(r.tokens) for r in resps)
    ttft = sorted(r.ttft_s for r in resps)
    peak = acc.max_memory_allocated()
    log(f"{tag}: {sum(finished)}/{n_requests} requests finished by length, drain "
        f"{drained}, tokens in vocab {in_vocab}, KV conservation "
        f"{'holds' if conserved else 'BROKEN'} ({engine.kv.free_blocks} free "
        f"of {engine.kv.num_blocks - 1})")
    log(f"{tag}: prompt tokens {int(lens.sum())}, generated {tokens}, engine "
        f"steps {engine.steps}, kernel launches {launches} "
        f"(packed steps x {cfg.num_layers} layers; fused chunks x 16 steps x "
        f"{cfg.num_layers} layers)")
    log(f"{tag} [{card}]: {tokens / wall:.1f} generated tok/s over {wall:.2f} s, "
        f"TTFT p50 {snap['ttft']['p50_ms']:.1f} ms p99 "
        f"{snap['ttft']['p99_ms']:.1f} ms (mean {np.mean(ttft) * 1e3:.1f} ms), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if profile:
        device_time_breakdown(trace, wall)
    if not (all(finished) and drained and in_vocab and conserved):
        raise SystemExit(f"{tag} FAILED")
    out = dict(launches=launches, peak=peak, first=[r.tokens[0] for r in resps],
               pool_nbytes=engine.kv.pool_nbytes(), pool_dtype=engine.kv.k.dtype,
               resolution=(engine.attn_impl, engine.decode_attn_impl,
                           engine.decode_attn_source), cfg=cfg)
    del server, engine, params
    torch.cuda.empty_cache()
    return out


def kv_quant_phase(pa, card, bf16_run, profile=False):
    """Phase 12: the serving slice with int8 KV storage (16 requests, 128
    new tokens, Llama-2-7B at full width and depth), then a short float8
    run (2 layers at full width). Returns the int8 run's launches."""
    run = slice_phase(pa, card, kv="int8", profile=profile)
    cfg, c = run["cfg"], SLICE
    rows = cfg.num_layers * c["num_kv_blocks"] * cfg.kv_heads * c["kv_block_size"]
    want_bytes = 2 * rows * cfg.head_dim + 2 * rows * 4    # int8 values + fp32 scales
    launches = run["launches"]
    same_first = sum(a == b for a, b in zip(run["first"], bf16_run["first"]))
    checks = {
        "int8 decode kernel launched": launches["paged_flash_decode_int8"] > 0,
        "no bf16-pool kernel launched": (launches["paged_attention"] == 0
                                         and launches["paged_flash_decode"] == 0),
        "attn_impl einsum, decode_attn_impl pallas": run["resolution"][:2]
        == ("einsum", "pallas"),
        f"pool_nbytes == {want_bytes}": run["pool_nbytes"] == want_bytes,
        "peak below the bf16 run's": run["peak"] < bf16_run["peak"],
    }
    log(f"kv int8: pool {run['pool_nbytes'] / 2**30:.4f} GiB against bf16 "
        f"{bf16_run['pool_nbytes'] / 2**30:.4f} GiB; peak "
        f"{run['peak'] / 2**30:.2f} GiB against {bf16_run['peak'] / 2**30:.2f} GiB; "
        f"first tokens equal to the bf16 run's: {same_first}/{len(run['first'])}; "
        + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    fp8 = slice_phase(pa, card, kv="float8_e4m3fn", num_layers=2, n_requests=4,
                      new_tokens=32)
    fcfg = fp8["cfg"]
    bf16_bytes = (2 * fcfg.num_layers * c["num_kv_blocks"] * fcfg.kv_heads
                  * c["kv_block_size"] * fcfg.head_dim * 2)
    fchecks = {
        "pool float8_e4m3fn": fp8["pool_dtype"] == torch.float8_e4m3fn,
        "both paths einsum (fallback)": fp8["resolution"] == ("einsum", "einsum",
                                                             "fallback"),
        "pool bytes half of bf16's": 2 * fp8["pool_nbytes"] == bf16_bytes,
        "no kernel launched": not any(fp8["launches"].values()),
    }
    log("kv float8 (2 layers): " + ", ".join(
        f"{k}: {'ok' if v else 'FAIL'}" for k, v in fchecks.items()))
    if not (all(checks.values()) and all(fchecks.values())):
        raise SystemExit("kv quant phase FAILED")
    return {"paged_flash_decode_int8": launches["paged_flash_decode_int8"]}


# ---------------------------------------------------------------------------
# phase 5: kernel path vs einsum path through the model functions
# ---------------------------------------------------------------------------


def path_phase():
    from deepspeed_tpu_torch.inference.v2 import model
    from deepspeed_tpu_torch.inference.v2.ragged import RaggedBatchWrapper
    from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
        DSSequenceDescriptor
    from deepspeed_tpu_torch.models import init_params, llama_config

    dev = torch.device("cuda")
    cfg = llama_config("7b", num_layers=4, dtype=torch.bfloat16)
    params = init_params(cfg, seed=1, device=dev, dtype=torch.bfloat16)
    S, bs, B = 8, 32, 64
    rng = np.random.default_rng(11)
    ctx = rng.integers(100, 900, S)            # tokens already in the pool
    new = [128, 97, 1, 1, 64, 1, 128, 33]      # this step's chunk per sequence
    seqs, nxt = [], 1
    for s in range(S):
        total = int(ctx[s]) + new[s] + 16
        seq = DSSequenceDescriptor(
            uid=s, prompt_tokens=rng.integers(0, cfg.vocab_size,
                                              int(ctx[s]) + new[s]).astype(np.int32))
        seq.seen_tokens = int(ctx[s])
        seq.blocks = list(range(nxt, nxt + -(-total // bs)))
        nxt += len(seq.blocks)
        seqs.append(seq)
    shape = (cfg.num_layers, nxt, cfg.kv_heads, bs, cfg.head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    k0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    wrapper = RaggedBatchWrapper(token_budget=512, max_seqs=S, max_chunk=128,
                                 max_blocks_per_seq=B)
    batch = wrapper.pack([(s, s.next_tokens(n)) for s, n in zip(seqs, new)], bs)
    t = lambda a: torch.from_numpy(a).to(dev)
    fields = ("tokens", "positions", "gather_idx", "block_table", "kv_len",
              "logits_idx", "start_pos", "chunk_len")
    # three runs on identical inputs: kernel path (bf16), einsum path
    # (bf16), einsum path in float32 — the bf16 noise yardstick
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _cast(params, torch.float32)
    runs = {"kernel": ("pallas", cfg, params), "einsum": ("einsum", cfg, params),
            "fp32": ("einsum", cfg32, params32)}
    pools, packed = {}, {}
    for name, (impl, c, p) in runs.items():
        kk, vv = k0.to(c.dtype, copy=True), v0.to(c.dtype, copy=True)
        packed[name], _, _ = model.ragged_forward(
            p, c, kk, vv, *[t(getattr(batch, f)) for f in fields],
            attn_impl=impl)
        pools[name] = (kk, vv)
    dist = lambda a, b: (packed[a] - packed[b]).abs().max().item()
    d_logits, noise = dist("kernel", "einsum"), dist("einsum", "fp32")
    agree = (packed["kernel"].argmax(-1) == packed["einsum"].argmax(-1)
             ).float().mean().item()
    log(f"path parity packed step (4 layers, 8 seqs, ctx 100..900): "
        f"max|dlogits| kernel-einsum={d_logits:.3e}, einsum-fp32={noise:.3e}, "
        f"kernel-fp32={dist('kernel', 'fp32'):.3e} (need kernel-einsum <= "
        f"{NOISE_FACTOR:g} x einsum-fp32; logits max "
        f"{packed['fp32'].abs().max().item():.2f}), greedy agreement {agree:.3f}")

    # the fused decode path from each run's own pools, same first tokens
    first = packed["fp32"].argmax(-1).to(torch.int32)
    pos0 = t(np.asarray([s.seen_tokens + n for s, n in zip(seqs, new)], np.int32))
    bt = t(batch.block_table)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    W = 16
    step_logits, toks = {}, {}
    for name, (impl, c, p) in runs.items():
        kk, vv = pools[name]
        wk = torch.zeros((c.num_layers, W, S, c.kv_heads, c.head_dim),
                         dtype=c.dtype, device=dev)
        wv = torch.zeros_like(wk)
        step_logits[name] = model.decode_step(p, c, kk, vv, wk, wv, first,
                                              pos0, pos0, bt, active, 0, impl)
        toks[name], _, _ = model.decode_loop(p, c, kk, vv, first, pos0, bt,
                                             active, None, 1.0, n_steps=W,
                                             attn_impl=impl)
    sdist = lambda a, b: (step_logits[a] - step_logits[b]).abs().max().item()
    d_step, step_noise = sdist("kernel", "einsum"), sdist("einsum", "fp32")
    tok_agree = lambda a, b: (toks[a] == toks[b]).float().mean().item()
    log(f"path parity decode step: max|dlogits| kernel-einsum={d_step:.3e}, "
        f"einsum-fp32={step_noise:.3e}, kernel-fp32={sdist('kernel', 'fp32'):.3e}; "
        f"decode_loop {W} greedy steps, token agreement kernel-einsum "
        f"{tok_agree('kernel', 'einsum'):.3f}, kernel-fp32 "
        f"{tok_agree('kernel', 'fp32'):.3f}, einsum-fp32 "
        f"{tok_agree('einsum', 'fp32'):.3f}")
    if d_logits > NOISE_FACTOR * noise or d_step > NOISE_FACTOR * step_noise:
        raise SystemExit("path parity FAILED")


def int8_path_phase():
    """Phase 13: the int8 pools' decode through the model functions at
    Llama-2-7B widths (2 layers, seeded weights): ``decode_step`` and a
    16-step ``decode_loop`` on the kernel path (the decode kernel's int8
    mode), the einsum path (gather + dequantize) in bf16, and the einsum
    path in float32, each on its own copy of the same int8 pools. The kernel
    path's logits must sit within twice the einsum path's distance from
    float32."""
    from deepspeed_tpu_torch.inference.v2 import model
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    cfg = llama_config("7b", num_layers=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=2, device=dev, dtype=torch.bfloat16)
    S, bs, B, W = 8, 32, 64, 16
    rng = np.random.default_rng(13)
    pos0 = torch.from_numpy(rng.integers(100, 1900, S).astype(np.int32)).to(dev)
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, S).astype(np.int32)).to(dev)
    bt = (1 + torch.arange(S * B, dtype=torch.int32, device=dev)).reshape(S, B)
    shape = (cfg.num_layers, 1 + S * B, cfg.kv_heads, bs, cfg.head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    kp, vp = int8_pools(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
                        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16))
    active = torch.ones(S, dtype=torch.bool, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    runs = {"kernel": ("pallas", cfg, params), "einsum": ("einsum", cfg, params),
            "fp32": ("einsum", cfg32, _cast(params, torch.float32))}
    copy = lambda p: tuple(t.clone() for t in p)
    step_logits, toks = {}, {}
    pa_counts = {}
    for name, (impl, c, p) in runs.items():
        wk = torch.zeros((c.num_layers, W, S, c.kv_heads, c.head_dim), dtype=c.dtype,
                         device=dev)
        step_logits[name] = model.decode_step(p, c, copy(kp), copy(vp), wk,
                                              torch.zeros_like(wk), first, pos0, pos0,
                                              bt, active, 0, impl)
        pa.reset_launch_counts()
        toks[name], _, _ = model.decode_loop(p, c, copy(kp), copy(vp), first, pos0, bt,
                                             active, None, 1.0, n_steps=W,
                                             attn_impl=impl)
        pa_counts[name] = pa.launch_counts["paged_flash_decode_int8"]
    sdist = lambda a, b: (step_logits[a] - step_logits[b]).abs().max().item()
    d_step, noise = sdist("kernel", "einsum"), sdist("einsum", "fp32")
    agree = lambda a, b: (toks[a] == toks[b]).float().mean().item()
    good = d_step <= NOISE_FACTOR * noise and pa_counts["kernel"] == W * cfg.num_layers
    log(f"int8 path parity decode step (2 layers, 8 seqs, ctx 100..1900): "
        f"max|dlogits| kernel-einsum={d_step:.3e}, einsum-fp32={noise:.3e}, "
        f"kernel-fp32={sdist('kernel', 'fp32'):.3e} (need kernel-einsum <= "
        f"{NOISE_FACTOR:g} x einsum-fp32); decode_loop {W} greedy steps: int8 kernel "
        f"launches {pa_counts['kernel']}, token agreement kernel-einsum "
        f"{agree('kernel', 'einsum'):.3f}, kernel-fp32 {agree('kernel', 'fp32'):.3f}, "
        f"einsum-fp32 {agree('einsum', 'fp32'):.3f} {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("int8 path parity FAILED")
    del kp, vp, params, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the training slice at full width and depth
# ---------------------------------------------------------------------------

TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                 "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 4}},
    "zero_optimization": {"stage": 3}, "bf16": {"enabled": True},
    "gradient_clipping": 1.0, "training_fastpath": {"loss_impl": "auto"},
    "steps_per_print": 10**9,
}
TRAIN_SEQ, WARMUP_STEPS, TIMED_STEPS = 2048, 2, 8


def train_flops(cfg, n_matmul, tokens, seq):
    """Model flops of one step: 6 * N_matmul * tokens (the LM head counted
    in N once: the fused loss's recompute of the logits is not model flop;
    the embedding gather not counted), plus causal attention:
    QK^T and PV are 4 * D flops per visible (query, key) pair and head in
    the forward, 3x that forward and backward."""
    pairs_per_seq = seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.head_dim * cfg.num_heads * cfg.num_layers * pairs_per_seq
    return 6 * n_matmul * tokens + attn * (tokens // seq)


def train_phase(kernels, card, profile=False):
    """TinyLlama-1.1B through initialize + train_batch, the optimizer and
    schedule from the config (AdamW takes the fused Adam kernel on the
    card), ``loss_impl: auto`` (the fused loss kernels on the card)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)

    cfg = llama_config("1b", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    model = TransformerLM(cfg, params)
    engine, *_ = dst.initialize(model=make_loss_fn(model), model_parameters=params,
                                config=TRAIN_CONFIG)
    n_params = sum(p.numel() for p in engine._masters)
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size      # no embedding gather
    gas, micro = engine.gas, engine.micro_batch_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = torch.randint(0, cfg.vocab_size, (gas, micro, TRAIN_SEQ), generator=gen,
                          device="cuda")
    torch.cuda.synchronize()
    log(f"train: TinyLlama-1.1B (hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.kv_heads} heads, D {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), {n_params} parameters, bf16 "
        f"over fp32 masters, micro {micro} x {TRAIN_SEQ} tokens, gas {gas}; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset_launch_counts()
    losses, times = [], []
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        losses.append(float(loss))          # waits for the step's device work
        times.append(time.perf_counter() - t0)
    launches = {}
    for k in kernels:
        launches.update(k.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = gas * micro * TRAIN_SEQ
    step_s = float(np.mean(times[WARMUP_STEPS:]))
    flops = train_flops(cfg, n_matmul, tokens, TRAIN_SEQ)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: step times (s) {[round(x, 4) for x in times]}")
    log(f"train [{card}]: {step_s * 1e3:.1f} ms/step over {TIMED_STEPS} timed steps, "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} ({flops:.4e} model flop/step: "
        f"6 x {n_matmul} matmul params x {tokens} tokens + causal attention; over "
        f"989 TFLOP/s bf16), max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"train: kernel launches {launches}")
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width

    loss_chunks = -(-cfg.vocab_size // chunk_width(micro * TRAIN_SEQ, cfg.vocab_size, 2))
    steps = WARMUP_STEPS + TIMED_STEPS
    want = {n: cfg.num_layers * gas * steps for n in
            ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    want["fused_adam"] = steps
    want["fused_loss_fwd"] = gas * steps
    for n in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[n] = gas * steps * loss_chunks
    bad = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if bad:
        raise SystemExit(f"train: launch counts off (got, want): {bad}; flash: {cfg.num_layers} "
                         f"layers x gas {gas} x {steps} steps; fused loss: gas x steps "
                         f"(x {loss_chunks} vocab chunks in the backward); Adam: one per step")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("train: a loss is not finite")
    if not losses[-1] < losses[WARMUP_STEPS]:
        raise SystemExit("train: the loss did not fall over the timed steps")
    if profile:
        trace = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        with trace:
            float(engine.train_batch(batch))
        device_time_breakdown(trace, time.perf_counter() - t0, top=30)
    del engine, model, params, batch
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: training kernel path vs plain path
# ---------------------------------------------------------------------------


def plain_adamw(lr, weight_decay):
    """AdamW through the fused kernel's plain version, one tensor at a time:
    the plain path's optimizer on the card (fused_adam itself launches the
    kernel for tensors there)."""
    from torch.utils import _pytree as pytree

    from deepspeed_tpu_torch.ops.fused_adam import adam_update_ref
    from deepspeed_tpu_torch.ops.optimizers import GradientTransformation, fused_adam

    def update(grads, state, params):
        step = state.step + 1
        leaves = [pytree.tree_leaves(t) for t in (grads, state.exp_avg,
                                                  state.exp_avg_sq, params)]
        out = [adam_update_ref(g, m, v, p, lr, 0.9, 0.999, 1e-8, weight_decay, True,
                               True, step) for g, m, v, p in zip(*leaves)]
        spec = pytree.tree_structure(grads)
        u, m, v = (pytree.tree_unflatten(list(x), spec) for x in zip(*out))
        return u, state._replace(step=step, exp_avg=m, exp_avg_sq=v)

    return GradientTransformation(fused_adam().init, update)


def train_parity_phase():
    """Two train_batch steps on TinyLlama widths at 2 layers through the
    kernel path (flash, fused loss and Adam kernels, bf16), the plain path
    (plain attention, dense loss and Adam, bf16) and the plain path in
    float32 (TF32 off), from
    the same weights and batch. The kernel path's loss, gradient norm and
    weight updates must sit within NOISE_FACTOR x the plain path's own
    distance from float32 (updates by their L2 norm over all weights)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.models.convert import _flatten
    from deepspeed_tpu_torch.ops.optimizers import fused_adam

    base = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    init = init_params(base, seed=3, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    batches = [torch.randint(0, base.vocab_size, (2, 2, TRAIN_SEQ), generator=gen,
                             device="cuda") for _ in range(2)]
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0, "steps_per_print": 10**9,
              "zero_optimization": {"stage": 3}}
    runs = {"kernel": ("flash", True, torch.bfloat16),
            "plain": ("xla", False, torch.bfloat16),
            "fp32": ("xla", False, torch.float32)}
    out = {}
    p0 = _flatten(init)
    for name, (attn, use_kernel, dtype) in runs.items():
        cfg = dataclasses.replace(base, attn_impl=attn, dtype=dtype,
                                  loss_impl="fused" if use_kernel else "xla")
        params = _cast(init, torch.float32, copy=True)   # each run trains its own
        engine, *_ = dst.initialize(
            model=make_loss_fn(TransformerLM(cfg, params)), model_parameters=params,
            optimizer=(fused_adam(lr=3e-4, weight_decay=0.1, use_pallas=True) if use_kernel
                       else plain_adamw(3e-4, 0.1)),
            config=dict(config, bf16={"enabled": dtype == torch.bfloat16}))
        losses, norms = [], []
        for b in batches:
            losses.append(float(engine.train_batch(b)))
            norms.append(engine.get_global_grad_norm())
        delta = torch.cat([(v - p0[k]).flatten() for k, v in
                           _flatten(engine.state.params).items()])
        out[name] = (np.array(losses), np.array(norms), delta)
        del engine, params
        torch.cuda.empty_cache()
    dl = lambda a, b: np.abs(out[a][0] - out[b][0]).max()
    dn = lambda a, b: np.abs(out[a][1] - out[b][1]).max()
    du = lambda a, b: (out[a][2] - out[b][2]).norm().item()
    log(f"train path parity (TinyLlama widths, 2 layers, 2 steps): "
        f"losses kernel {out['kernel'][0]}, plain {out['plain'][0]}, fp32 {out['fp32'][0]}; "
        f"|dloss| kernel-plain={dl('kernel', 'plain'):.3e} plain-fp32={dl('plain', 'fp32'):.3e}; "
        f"|dgrad_norm| kernel-plain={dn('kernel', 'plain'):.3e} "
        f"plain-fp32={dn('plain', 'fp32'):.3e}; ||dupdate|| kernel-plain="
        f"{du('kernel', 'plain'):.3e} plain-fp32={du('plain', 'fp32'):.3e} "
        f"(||update|| {out['fp32'][2].norm().item():.3e}); need kernel-plain <= "
        f"{NOISE_FACTOR:g} x plain-fp32 on each")
    for d in (dl, dn, du):
        if d("kernel", "plain") > NOISE_FACTOR * d("plain", "fp32"):
            raise SystemExit("train path parity FAILED")


# ---------------------------------------------------------------------------
# phase 8: activation checkpointing
# ---------------------------------------------------------------------------

REMAT_RTOL = 1e-3


def remat_phase(fa):
    """TinyLlama widths at 4 layers, one train_batch step (micro 4 x 2048,
    gas 2) from the same weights and batch without remat, with per-layer
    remat under "nothing_saveable" and "dots_saveable", and with the
    engine-level wrap. The recompute runs the same kernels on the same
    inputs, so loss and grad norm must agree within REMAT_RTOL (relative);
    per-layer remat must lower the step's peak memory; the flash forward
    must launch twice as often (its kernel is no dot under either policy,
    as a pallas_call is none in JAX)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)

    base = llama_config("1b", num_layers=4, dtype=torch.bfloat16)
    init = init_params(base, seed=5, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    batch = torch.randint(0, base.vocab_size, (2, 4, TRAIN_SEQ), generator=gen, device="cuda")
    runs = {"none": ({}, {}),
            "remat nothing_saveable": (dict(remat=True, remat_policy="nothing_saveable"), {}),
            "remat dots_saveable": (dict(remat=True, remat_policy="dots_saveable"), {}),
            "engine_wrap nothing_saveable": ({}, {"activation_checkpointing": {
                "engine_wrap": True, "policy": "nothing_saveable"}})}
    out = {}
    for name, (model_over, config_over) in runs.items():
        cfg = dataclasses.replace(base, **model_over)
        params = _cast(init, torch.float32, copy=True)
        engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                    model_parameters=params,
                                    config=dict(TRAIN_CONFIG, **config_over))
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        loss = float(engine.train_batch(batch))
        peak = torch.cuda.max_memory_allocated() - base_mem
        out[name] = (loss, engine.get_global_grad_norm(), peak,
                     fa.launch_counts["flash_attention_fwd"])
        log(f"remat {name}: loss {loss:.6f}, grad norm {out[name][1]:.6f}, step peak "
            f"{peak / 2**30:.2f} GiB above the resident state, flash fwd launches "
            f"{out[name][3]}")
        del engine, params
        torch.cuda.empty_cache()
    ref_loss, ref_norm, ref_peak, ref_fwd = out["none"]
    for name, (loss, norm, peak, fwd) in out.items():
        if name == "none":
            continue
        bad = (abs(loss - ref_loss) > REMAT_RTOL * abs(ref_loss)
               or abs(norm - ref_norm) > REMAT_RTOL * abs(ref_norm) or fwd != 2 * ref_fwd
               or (name.startswith("remat") and not peak < ref_peak))
        log(f"remat {name} vs none: |dloss| {abs(loss - ref_loss):.3e}, |dgrad_norm| "
            f"{abs(norm - ref_norm):.3e} (tol rel {REMAT_RTOL:g}), peak "
            f"{peak / 2**30:.2f} vs {ref_peak / 2**30:.2f} GiB, flash fwd {fwd} vs "
            f"{ref_fwd} {'FAIL' if bad else 'ok'}")
        if bad:
            raise SystemExit(f"remat {name} FAILED")


# ---------------------------------------------------------------------------
# phase 9: checkpoint save and resume
# ---------------------------------------------------------------------------


def checkpoint_phase():
    """TinyLlama widths at 2 layers (micro 2 x 2048, gas 2): 3 steps,
    save_checkpoint into build/, a fresh engine, load_checkpoint, 2 more
    steps, against 5 uninterrupted steps. Right after the load every
    master, Adam moment, the step, the LR and the loss scale must equal the
    saved engine's bitwise; the resumed losses must equal the uninterrupted
    ones bitwise (the same kernels on the same state); zero_to_fp32 must
    return the saved masters."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.models.convert import _flatten
    from torch.utils import _pytree as pytree

    cfg = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    init = init_params(cfg, seed=7, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    batches = [torch.randint(0, cfg.vocab_size, (2, 2, TRAIN_SEQ), generator=gen,
                             device="cuda") for _ in range(5)]
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2)
    ckpt_dir = REPO / "build" / "checkpoint_smoke"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def engine():
        params = _cast(init, torch.float32, copy=True)
        return dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                              model_parameters=params, config=config)[0]

    def state(e):
        return (list(e._masters) + pytree.tree_leaves(e.state.opt_state)
                + [e.state.step, e.get_lr()[0], tuple(e.state.loss_scale)])

    def same(a, b):
        return len(a) == len(b) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(a, b))

    whole = engine()
    want = [float(whole.train_batch(b)) for b in batches]
    del whole
    first = engine()
    got = [float(first.train_batch(b)) for b in batches[:3]]
    t0 = time.perf_counter()
    first.save_checkpoint(str(ckpt_dir), client_state={"phase": "smoke"})
    save_s = time.perf_counter() - t0
    saved = [x.clone() if isinstance(x, torch.Tensor) else x for x in state(first)]
    masters = {k: v.detach().float().cpu().numpy() for k, v in
               _flatten(first.state.params).items()}
    del first
    torch.cuda.empty_cache()
    resumed = engine()
    t0 = time.perf_counter()
    _, client = resumed.load_checkpoint(str(ckpt_dir))
    load_s = time.perf_counter() - t0
    state_equal = same(state(resumed), saved) and client == {"phase": "smoke"}
    got += [float(resumed.train_batch(b)) for b in batches[3:]]
    flat = zero_to_fp32(str(ckpt_dir))
    fp32_equal = set(flat) == set(masters) and all(
        np.array_equal(flat[k], masters[k]) for k in masters)
    n_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    log(f"checkpoint (TinyLlama widths, 2 layers): save {save_s:.2f} s, load {load_s:.2f} s, "
        f"{n_bytes / 2**30:.2f} GiB on disk; state bitwise equal after load: "
        f"{state_equal}; zero_to_fp32 = masters: {fp32_equal}")
    log(f"checkpoint losses resumed {got}, uninterrupted {want}; bitwise equal: {got == want}")
    del resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    if not (state_equal and fp32_equal and got == want):
        raise SystemExit("checkpoint resume FAILED")


# ---------------------------------------------------------------------------
# phase 10: the block-quant kernels against their plain versions
# ---------------------------------------------------------------------------

QUANT_N = 1_100_048_384        # TinyLlama-1.1B's flat fp32 gradient
QUANT_RAGGED_N = 2048 * 1000 + 37


def sr_check(x, n, block, q_sr, s_sr, s_near):
    """Stochastic rounding in distribution, chunked over blocks to bound
    memory: the scales equal the nearest kernel's, every payload is
    clamp(floor(x / s)) or clamp(floor(x / s) + 1), pad lanes are 0, and
    |mean(q - x / s)| over the n elements is below 3 / sqrt(n). Returns
    (ok, mean error)."""
    nb = q_sr.shape[0]
    ok = torch.equal(s_sr, s_near) and bool((q_sr.view(-1)[n:] == 0).all())
    rows = max(1, (1 << 25) // block)
    err = 0.0
    for r0 in range(0, nb, rows):
        r1 = min(nb, r0 + rows)
        lo, hi = r0 * block, min(n, r1 * block)
        xx = torch.zeros((r1 - r0) * block, device=x.device)
        xx[:hi - lo] = x[lo:hi]
        y = xx.view(-1, block) / s_near[r0:r1, None]
        fl = torch.floor(y)
        qf = q_sr[r0:r1].float()
        ok &= bool(((qf == fl.clamp(-127, 127)) | (qf == (fl + 1).clamp(-127, 127))).all())
        err += float((qf - y).reshape(-1)[:hi - lo].double().sum())
    mean_err = err / n
    return ok and abs(mean_err) < 3 / math.sqrt(n), mean_err


def quant_phase(qk):
    """The three block-quant kernels against their plain versions: a ragged
    n = 2048 k + 37 at blocks 2048, 512 and 128, then TinyLlama-1.1B's flat
    gradient (n = 1,100,048,384, block 2048, nb = 537,133). Round to nearest
    and dequantize must equal the plain versions bitwise; stochastic
    rounding must equal its plain version bitwise (the same Philox words)
    and hold in distribution (sr_check). Timed at the main shape beside the
    bound, the plain version and the eager torch composite."""
    from deepspeed_tpu_torch.models import llama_config, param_shapes

    n_model = sum(math.prod(s) for s in param_shapes(llama_config("1b")).values())
    if n_model != QUANT_N:
        raise SystemExit(f"quant: TinyLlama-1.1B has {n_model} parameters, not {QUANT_N}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    ok = True
    errs = {"quantize_int8": 0.0, "quantize_int8_sr": 0.0, "dequantize_int8": 0.0}
    cases = [(QUANT_RAGGED_N, b) for b in (2048, 512, 128)] + [(QUANT_N, 2048)]
    rows = {}
    for n, block in cases:
        x = 1e-3 * torch.randn(n, generator=gen, device="cuda")
        x[::1009] = 0.0
        nb = -(-n // block)
        q, s, shape = qk.quantize_int8(x, block)
        q_ref, s_ref = qk.quantize_ref(x, n, nb, block)
        near = torch.equal(q, q_ref) and torch.equal(s, s_ref)
        del q_ref, s_ref
        d = qk.dequantize_int8(q, s, shape)
        d_err = (d - qk.dequantize_ref(q, s, n)).abs().max().item()
        del d
        sr_gen = torch.Generator().manual_seed(n + block)
        seed = qk.draw_seed(torch.Generator().manual_seed(n + block))
        q_sr, s_sr, _ = qk.quantize_int8(x, block, stochastic=True, key=sr_gen)
        q_sr_ref, _ = qk.quantize_ref(x, n, nb, block, seed)
        sr_bitwise = torch.equal(q_sr, q_sr_ref)
        sr_err = (q_sr.int() - q_sr_ref.int()).abs().max().item()
        del q_sr_ref
        sr_ok, mean_err = sr_check(x, n, block, q_sr, s_sr, s)
        good = near and d_err == 0.0 and sr_bitwise and sr_ok
        ok &= good
        errs["quantize_int8"] = max(errs["quantize_int8"], 0.0 if near else float("inf"))
        errs["quantize_int8_sr"] = max(errs["quantize_int8_sr"], float(sr_err))
        errs["dequantize_int8"] = max(errs["dequantize_int8"], d_err)
        log(f"parity quant n={n} block={block} (nb {nb}): nearest bitwise {near}, dequant "
            f"max|err| {d_err:.3e}, sr bitwise {sr_bitwise} (max|dq| {sr_err}), sr in "
            f"distribution {sr_ok} (mean(q - x/s) {mean_err:.3e}, bound "
            f"{3 / math.sqrt(n):.3e}) {'ok' if good else 'FAIL'}")
        if n != QUANT_N:
            del x, q, s, q_sr, s_sr
            continue
        # timings at the main shape
        xv = x.view(nb, block)

        def composite():
            a = xv.abs().amax(dim=1, keepdim=True)
            sc = torch.where(a == 0, torch.ones_like(a), a / 127.0)
            return torch.clamp(torch.round(xv / sc), -127, 127).to(torch.int8), sc

        def composite_sr():
            a = xv.abs().amax(dim=1, keepdim=True)
            sc = torch.where(a == 0, torch.ones_like(a), a / 127.0)
            u = torch.rand(xv.shape, device=xv.device)
            return torch.clamp(torch.floor(xv / sc + u), -127, 127).to(torch.int8), sc

        sr_seed = torch.Generator().manual_seed(1)
        nbytes = 4 * n + n + 4 * nb      # read x (fp32), write q (int8) and scales
        timings = {
            "quantize_int8": (
                lambda: qk.quantize_int8(x, block),
                lambda: qk.quantize_ref(x, n, nb, block), composite, 6),
            "quantize_int8_sr": (
                lambda: qk.quantize_int8(x, block, stochastic=True, key=sr_seed),
                lambda: qk.quantize_ref(x, n, nb, block, seed), composite_sr, 30),
            "dequantize_int8": (
                lambda: qk.dequantize_int8(q, s, shape),
                lambda: qk.dequantize_ref(q, s, n),
                lambda: q.float() * s[:, None], 1),
        }
        for name, (kern, plain, lib, ops_per_elem) in timings.items():
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=2, warmup=1)
            lib_ms = cuda_ms(lib, iters=5, warmup=1)
            # ops: fp32 and int32 arithmetic per element, counted at the fp32
            # rate outside the tensor cores (Philox: ~25 int32 ops per element)
            b_ms, b_by = bound(nbytes, ops_per_elem * n, torch.float32)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=errs[name])
            log(f"timing {name} (n {n}, block {block}, nb {nb}): kernel {ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes} B), plain {plain_ms:.4f} ms, library "
                f"(eager torch composite) {lib_ms:.4f} ms")
        del x, xv, q, s, q_sr, s_sr
        torch.cuda.empty_cache()
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    if not ok:
        raise SystemExit("quant kernel parity FAILED")
    return rows


# ---------------------------------------------------------------------------
# phase 11: data-parallel training, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# phase 11's world: two ranks on cuda:0 over gloo (NCCL refuses two ranks on
# one device), TinyLlama widths at 4 layers. --cards N runs the same world
# over NCCL with one rank per card at full depth instead.
DP_SPEC = {"world": 2, "backend": "gloo", "layers": 4, "micro": 2, "steps": 5,
           "modes": ["none", "int8", "int8_sr"]}
DP_CONFIG = {
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "zero_optimization": {"stage": 0}, "bf16": {"enabled": True},
    "gradient_clipping": 1.0, "training_fastpath": {"loss_impl": "auto"},
    "comms_logger": {"enabled": True}, "steps_per_print": 10**9,
}


def dp_batch(cfg, micro_total):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    return torch.randint(0, cfg.vocab_size, (DP_CONFIG["gradient_accumulation_steps"],
                                             micro_total, TRAIN_SEQ), generator=gen,
                         device="cuda")


def dp_child(rank: int, workdir: Path) -> int:
    """One rank of a data-parallel world (workdir/spec.json): each mode
    trains ``steps`` steps from the same seeded weights on the same global
    batch; writes losses, step times, peak memory, quant-kernel launches,
    the ledger and whether the masters equal rank 0's bitwise to
    workdir/out_<rank>.json."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import quant

    spec = json.loads((workdir / "spec.json").read_text())
    comm.init_distributed(dist_backend=spec["backend"], init_method=f"file://{workdir}/store",
                          rank=rank, world_size=spec["world"], timeout=600)
    cfg = llama_config("1b", num_layers=spec["layers"], dtype=torch.bfloat16)
    batch = dp_batch(cfg, spec["micro"] * spec["world"])
    out = {}
    for mode in spec["modes"]:
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
        config = dict(DP_CONFIG, train_micro_batch_size_per_gpu=spec["micro"],
                      compressed_collectives={"mode": mode, "block": 2048})
        engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                    model_parameters=params, config=config)
        ledger = comm.get_comms_logger()
        ledger.reset()
        quant.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(spec["steps"]):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t0)
        launches = dict(quant.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        totals = ledger.totals().get("quantized_all_reduce")
        flat = torch.cat([p.detach().reshape(-1) for p in engine._masters])
        theirs = comm.broadcast(flat.clone(), src=0)
        same = torch.tensor([int(torch.equal(flat, theirs))], device="cuda")
        comm.all_reduce(same, op="min")
        out[mode] = dict(losses=losses, times=times, launches=launches, peak=peak,
                         ledger=totals, masters_equal=bool(same.item()),
                         n=flat.numel(), reduce=engine._dp_grad_mode)
        del engine, params, flat, theirs
        torch.cuda.empty_cache()
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    comm.barrier()
    comm.destroy_process_group()
    return 0


def run_dp_world(spec, workdir: Path):
    """Start spec["world"] ranks (this script with --dp-child), one card each
    over NCCL or all on cuda:0 over gloo; returns their results."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    (workdir / "spec.json").write_text(json.dumps(spec))
    world = spec["world"]
    logs = [open(workdir / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-child", str(r), str(workdir)],
        env=dict(os.environ, LOCAL_RANK=str(r if spec["backend"] == "nccl" else 0)),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for r, f in enumerate(logs):
            f.seek(0)
            log(f"--- dp rank {r} (exit {codes[r]}) ---\n{f.read()[-6000:]}")
        raise SystemExit(f"dp: a rank failed (exit codes {codes})")
    for f in logs:
        f.close()
    return [json.loads((workdir / f"out_{r}.json").read_text()) for r in range(world)]


def check_dp(spec, ranks, card):
    """The checks of a data-parallel world: one loss across ranks, masters
    bitwise equal, losses finite and falling; in each compressed mode the
    first loss bitwise equal to none's, every loss within 0.02 |ref| + 1e-3
    of it, 2 + 2 quant launches per rank per step, the ledger equal to the
    JAX package's formula. Returns (ok, rank 0's results)."""
    from deepspeed_tpu_torch.ops.quant import shard_layout

    world, steps = spec["world"], spec["steps"]
    r0 = ranks[0]
    ref = r0["none"]["losses"]
    n = r0["none"]["n"]
    shard, shard_p, b1 = shard_layout(n, world, 2048)
    wire = (world * shard_p + 4 * world * (shard_p // b1)) + (shard_p + 4 * (shard_p // b1))
    tokens = DP_CONFIG["gradient_accumulation_steps"] * spec["micro"] * world * TRAIN_SEQ
    where = (f"{world} ranks on cuda:0 over gloo: a correctness run, not a scaling number"
             if spec["backend"] == "gloo" else f"{world} cards, one rank each, over NCCL")
    ok = True
    for mode in spec["modes"]:
        a = r0[mode]
        checks = {
            "ranks report one loss": all(r[mode]["losses"] == a["losses"] for r in ranks),
            "masters bitwise equal across ranks": all(r[mode]["masters_equal"]
                                                      for r in ranks),
            "losses finite and falling": (all(math.isfinite(x) for x in a["losses"])
                                          and a["losses"][-1] < a["losses"][0]),
            "reduction": a["reduce"] == (None if mode == "none" or world == 1 else mode),
        }
        if mode != "none":
            kq = "quantize_int8" if mode == "int8" else "quantize_int8_sr"
            want = {"quantize_int8": 0, "quantize_int8_sr": 0, "dequantize_int8": 2 * steps}
            want[kq] = 2 * steps
            checks.update({
                "first loss bitwise equal to none's": a["losses"][0] == ref[0],
                "losses within 0.02|ref| + 1e-3 of none": all(
                    abs(x - y) < 0.02 * abs(y) + 1e-3 for x, y in zip(a["losses"], ref)),
                "quant launches 2 + 2 per rank per step": all(
                    r[mode]["launches"] == want for r in ranks),
                "ledger bytes = the JAX formula": a["ledger"] is not None and (
                    a["ledger"]["count"], a["ledger"]["bytes"], a["ledger"]["wire_bytes"]) == (
                    steps, steps * 4 * n, steps * wire),
            })
        elif any(a["launches"].values()):
            checks["no quant launches"] = False
        good = all(checks.values())
        ok &= good
        step_s = float(np.mean(a["times"][1:]))
        log(f"dp {mode} (world {world}): losses {a['losses']}; {step_s * 1e3:.1f} ms/step "
            f"(steps 2-{steps}; {where}), {tokens / step_s:.0f} tokens/s, peak memory per "
            f"rank {[round(r[mode]['peak'] / 2**30, 2) for r in ranks]} GiB; launches "
            f"{a['launches']}; ledger {a['ledger']}; "
            f"{'ok' if good else 'FAIL ' + str([k for k, v in checks.items() if not v])}")
    log(f"dp [{card}]: TinyLlama widths, {spec['layers']} layers ({n} parameters), micro "
        f"{spec['micro']} x {TRAIN_SEQ} per rank, gas "
        f"{DP_CONFIG['gradient_accumulation_steps']}, {steps} steps per mode, {where}; "
        f"wire bytes per reduction {wire} vs logical {4 * n} ({4 * n / wire:.2f}x)")
    return ok, r0


def dp_phase(card):
    """Phase 11: DP_SPEC's world (dp_child), its checks, the none run against
    one process on the same global batch, and NCCL at world size 1. Returns
    the quant kernels' launches in the compressed runs."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)

    spec = DP_SPEC
    workdir = REPO / "build" / "dp_smoke"
    t0 = time.perf_counter()
    ok, r0 = check_dp(spec, run_dp_world(spec, workdir), card)
    log(f"dp: phase wall {time.perf_counter() - t0:.1f} s")

    # the none run against one process on the same global batch
    micro_total = spec["micro"] * spec["world"]
    cfg = llama_config("1b", num_layers=spec["layers"], dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                model_parameters=params,
                                config=dict(DP_CONFIG, comms_logger={"enabled": False},
                                            train_micro_batch_size_per_gpu=micro_total))
    batch = dp_batch(cfg, micro_total)
    single = [float(engine.train_batch(batch)) for _ in range(spec["steps"])]
    del engine, params, batch
    torch.cuda.empty_cache()
    ref = r0["none"]["losses"]
    one = (abs(ref[0] - single[0]) <= 1e-3 * abs(single[0]) and all(
        abs(x - y) < 0.02 * abs(y) + 1e-3 for x, y in zip(ref[1:], single[1:])))
    log(f"dp none vs one process (micro {micro_total}, gas "
        f"{DP_CONFIG['gradient_accumulation_steps']}) on the same global batch: {single}; "
        f"first within 1e-3 relative, later within 0.02|ref| + 1e-3: {one}")
    ok &= one

    # NCCL at world size 1
    comm.init_distributed(dist_backend="nccl", init_method=f"file://{workdir}/nccl_store",
                          rank=0, world_size=1)
    x = torch.full((1024,), 2.0, device="cuda")
    comm.all_reduce(x)
    nccl_ok = comm.is_initialized() and bool((x == 2.0).all())
    comm.destroy_process_group()
    log(f"dp: init_distributed(nccl) at world size 1 + all_reduce of a CUDA tensor: {nccl_ok}")
    ok &= nccl_ok
    shutil.rmtree(workdir, ignore_errors=True)
    if not ok:
        raise SystemExit("dp phase FAILED")
    return {"quantize_int8": r0["int8"]["launches"]["quantize_int8"],
            "quantize_int8_sr": r0["int8_sr"]["launches"]["quantize_int8_sr"],
            "dequantize_int8": (r0["int8"]["launches"]["dequantize_int8"]
                                + r0["int8_sr"]["launches"]["dequantize_int8"])}


def cards_run(n_cards: int, card: str) -> int:
    """--cards N: data-parallel training over NCCL, one rank per card, at
    TinyLlama-1.1B's full depth (micro 4 x 2048 per rank, gas 2): one card
    with the exact reduction as the baseline, then N cards in every mode,
    each held to check_dp. Prints tokens/s and the scaling over one card."""
    import shutil

    base = dict(DP_SPEC, backend="nccl", layers=22, micro=4, steps=6)
    workdir = REPO / "build" / "dp_cards"
    ok1, one = check_dp(dict(base, world=1, modes=["none"]),
                        run_dp_world(dict(base, world=1, modes=["none"]), workdir), card)
    spec = dict(base, world=n_cards)
    okn, many = check_dp(spec, run_dp_world(spec, workdir), card)
    shutil.rmtree(workdir, ignore_errors=True)
    t1 = float(np.mean(one["none"]["times"][1:]))
    for mode in spec["modes"]:
        tn = float(np.mean(many[mode]["times"][1:]))
        log(f"dp cards {mode}: {n_cards} cards {tn * 1e3:.1f} ms/step vs one card "
            f"{t1 * 1e3:.1f} ms/step: {n_cards * t1 / tn:.2f}x the tokens/s of one card "
            f"({t1 / tn:.3f} scaling efficiency)")
    return 0 if ok1 and okn else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving runs (bf16 and int8 KV) and one extra "
                         "training step with torch.profiler and print device time "
                         "by kernel (slows the runs it traces)")
    ap.add_argument("--cards", type=int, default=0,
                    help="instead of the phases: data-parallel training over NCCL on "
                         "this many cards, one rank each, at full depth")
    ap.add_argument("--dp-child", nargs=2, metavar=("RANK", "WORKDIR"),
                    help=argparse.SUPPRESS)   # one rank of a dp world, started by it
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "deepspeed_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              "(deepspeed_tpu_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.dp_child:
        return dp_child(int(args.dp_child[0]), Path(args.dp_child[1]))
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as adam
    from deepspeed_tpu_torch.ops import fused_loss as fl
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant as qk
    from deepspeed_tpu_torch.ops import sparse_attention as sparse_op
    # the module (the package exports the op under the module's name)
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

    t_start = time.perf_counter()
    # phase 1
    device_name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {device_name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 parity: no TF32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    libs = _build.build(sorted(p.name for p in _build.CSRC.glob("*.cu")))
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    if args.cards:
        if args.cards > count:
            raise SystemExit(f"--cards {args.cards}: only {count} cards")
        return cards_run(args.cards, card)

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        log(f"phase time: {label} {time.perf_counter() - t:.1f} s")
        return out

    # phase 3
    rows = timed("3 paged", kernel_phase, pa)
    rows.update(timed("3 flash", flash_phase, fa))
    rows.update(timed("3 sparse", sparse_phase, sa, fa))
    rows.update(timed("3 adam", adam_phase, adam))
    rows.update(timed("3 fused loss", fused_loss_phase, fl))
    # phase 10: the block-quant kernels
    rows.update(timed("10 quant", quant_phase, qk))
    # phase 4, 5: the serving path
    bf16_run = timed("4 serving", slice_phase, pa, card, profile=args.profile)
    launches = {n: bf16_run["launches"][n]
                for n in ("paged_attention", "paged_flash_decode")}
    for kernel, n in launches.items():
        if n <= 0:
            raise SystemExit(f"slice did not launch the {kernel} kernel")
    timed("5 serving parity", path_phase)
    # phase 12, 13: int8 and float8 KV serving, int8 path parity
    launches.update(timed("12 int8/fp8 KV serving", kv_quant_phase, pa, card, bf16_run,
                          profile=args.profile))
    timed("13 int8 path parity", int8_path_phase)
    # phase 14: sparse attention through its entry point
    launches.update(timed("14 sparse path", sparse_path_phase, sa, sparse_op))
    # phase 6, 7: the training path
    launches.update(timed("6 training", train_phase, (fa, adam, fl), card,
                          profile=args.profile))
    timed("7 training parity", train_parity_phase)
    # phase 8, 9: activation checkpointing, checkpoint save and resume
    timed("8 remat", remat_phase, fa)
    timed("9 checkpoint", checkpoint_phase)
    # phase 11: data-parallel training, the compressed gradient all-reduce
    launches.update(timed("11 data parallel", dp_phase, card))

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/pallas/"
    origin = {
        "paged_attention": ("paged_attention.cu", "paged_attention.py:53"),
        "paged_flash_decode": ("paged_attention.cu", "paged_attention.py:224"),
        "paged_flash_decode_int8": ("paged_attention_int8.cu", "paged_attention.py:224"),
        "sparse_attention_fwd": ("sparse_attention.cu", "sparse_attention.py:151"),
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:52"),
        "flash_attention_bwd_dkdv": ("flash_attention.cu", "flash_attention.py:149"),
        "flash_attention_bwd_dq": ("flash_attention.cu", "flash_attention.py:199"),
        "fused_adam": ("fused_adam.cu", "fused_adam.py:27"),
        "fused_loss_fwd": ("fused_loss.cu", "fused_loss.py:73"),
        "fused_loss_dlogits": ("fused_loss_sm90.cu", "fused_loss.py:152"),
        "fused_loss_dh": ("fused_loss_sm90.cu", "fused_loss.py:164"),
        "fused_loss_dk": ("fused_loss_sm90.cu", "fused_loss.py:185"),
        "quantize_int8": ("quant.cu", "quant.py:32"),
        "quantize_int8_sr": ("quant.cu", "quant.py:41"),
        "dequantize_int8": ("quant.cu", "quant.py:55"),
    }
    kernels = [dict(name=n, route="cuda", source=csrc + origin[n][0],
                    replaces=pallas + origin[n][1], launches=launches[n],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])
               for n, r in rows.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
