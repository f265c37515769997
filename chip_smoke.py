#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

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
   on and off, bf16 and fp32); the flash-attention forward and its two
   backward kernels at TinyLlama's shape (B 4, S 2048, 32/4 heads, D 64,
   causal, bf16), a Llama-2-7B head shape (32/32, D 128), a non-causal
   case and an fp32 case; fused Adam over odd tensor sizes in AdamW and L2
   modes, bias correction on and off, and timed over TinyLlama's 201
   tensors;
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
   AdamW through the fused Adam kernel, WarmupLR, ZeRO stage 3, clipping
   1.0) on one repeated seeded batch: 2 warm-up and 8 timed steps; step
   time, tokens/s, MFU and peak memory; the losses must be finite and fall,
   and the flash kernels must launch exactly 22 x gas x steps times;
7. training path parity — TinyLlama widths at 2 layers: two ``train_batch``
   steps through the kernel path (flash kernels, Adam kernel, bf16), the
   plain path (plain attention and Adam, bf16) and the plain path in
   float32; loss, gradient norm and weight updates of the kernel path must
   sit within twice the plain path's distance from float32.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
import json
import math
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
    S, Q, Hq, D = q.shape
    _, Hk, bs, _ = k_pool.shape
    B = bt.shape[1]
    kg = k_pool[bt.long()].permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
    vg = v_pool[bt.long()].permute(0, 2, 1, 3, 4).reshape(S, Hk, B * bs, D)
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


def kernel_phase(pa):
    """Parity of both kernels with their plain versions over the slice's
    cases; returns the timing rows at the main path's shapes."""
    rng = np.random.default_rng(2024)
    ok = True
    errs = {"paged_attention": 0.0, "paged_flash_decode": 0.0}
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


def slice_phase(pa, card, profile=False):
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, LLMServer, Request

    acc = get_accelerator()
    cfg = llama_config("7b", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(**SLICE),
                               device="cuda")
    acc.synchronize()
    log(f"slice: Llama-2-7B widths (hidden {cfg.hidden_size}, {cfg.num_layers} "
        f"layers, {cfg.num_heads} heads, ffn {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}), bf16 seeded weights, KV pool "
        f"{engine.kv.pool_nbytes() / 2**30:.2f} GiB, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    server = LLMServer(engine, fused_decode_chunk=16)
    rng = np.random.default_rng(7)
    lens = rng.integers(128, 1025, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    acc.reset_peak_memory_stats()
    acc.synchronize()
    trace = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        if profile else contextlib.nullcontext())
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    with trace:
        resps = [server.submit(Request(p, max_new_tokens=128), block=True)
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
                and len(r.tokens) == 128 for r in resps]
    in_vocab = all(0 <= t < cfg.vocab_size for r in resps for t in r.tokens)
    engine.kv.assert_conservation([s.blocks for s in engine.state_manager.all()])
    conserved = (not engine.state_manager.all()
                 and engine.kv.free_blocks == engine.kv.num_blocks - 1)
    snap = server.metrics.snapshot()
    tokens = sum(len(r.tokens) for r in resps)
    ttft = sorted(r.ttft_s for r in resps)
    peak = acc.max_memory_allocated()
    log(f"slice: {sum(finished)}/16 requests finished by length, drain "
        f"{drained}, tokens in vocab {in_vocab}, KV conservation "
        f"{'holds' if conserved else 'BROKEN'} ({engine.kv.free_blocks} free "
        f"of {engine.kv.num_blocks - 1})")
    log(f"slice: prompt tokens {int(lens.sum())}, generated {tokens}, engine "
        f"steps {engine.steps}, kernel launches {launches} "
        f"(packed steps x {cfg.num_layers} layers; fused chunks x 16 steps x "
        f"{cfg.num_layers} layers)")
    log(f"slice [{card}]: {tokens / wall:.1f} generated tok/s over {wall:.2f} s, "
        f"TTFT p50 {snap['ttft']['p50_ms']:.1f} ms p99 "
        f"{snap['ttft']['p99_ms']:.1f} ms (mean {np.mean(ttft) * 1e3:.1f} ms), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if profile:
        device_time_breakdown(trace, wall)
    if not (all(finished) and drained and in_vocab and conserved):
        raise SystemExit("slice FAILED")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"slice did not launch the {name} kernel")
    del server, engine, params
    torch.cuda.empty_cache()
    return launches


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
    "gradient_clipping": 1.0, "training_fastpath": {"loss_impl": "xla"},
    "steps_per_print": 10**9,
}
TRAIN_SEQ, WARMUP_STEPS, TIMED_STEPS = 2048, 2, 8


def train_flops(cfg, n_matmul, tokens, seq):
    """Model flops of one step: 6 * N_matmul * tokens (the fp32 LM head
    counted in N, the embedding gather not), plus causal attention:
    QK^T and PV are 4 * D flops per visible (query, key) pair and head in
    the forward, 3x that forward and backward."""
    pairs_per_seq = seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.head_dim * cfg.num_heads * cfg.num_layers * pairs_per_seq
    return 6 * n_matmul * tokens + attn * (tokens // seq)


def train_phase(kernels, card, profile=False):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops.optimizers import fused_adam
    from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule

    cfg = llama_config("1b", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    model = TransformerLM(cfg, params)
    sched = build_lr_schedule("WarmupLR", TRAIN_CONFIG["scheduler"]["params"], 3e-4)
    engine, *_ = dst.initialize(model=make_loss_fn(model), model_parameters=params,
                                config=TRAIN_CONFIG, lr_scheduler=sched,
                                optimizer=fused_adam(lr=sched, use_pallas=True))
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
    want = cfg.num_layers * gas * (WARMUP_STEPS + TIMED_STEPS)
    bad = [n for n in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                       "flash_attention_bwd_dq") if launches[n] != want]
    if bad or launches["fused_adam"] <= 0:
        raise SystemExit(f"train: launch counts off ({bad} != {want} = {cfg.num_layers} "
                         f"layers x gas {gas} x {WARMUP_STEPS + TIMED_STEPS} steps, or "
                         f"fused_adam {launches['fused_adam']})")
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
        device_time_breakdown(trace, time.perf_counter() - t0, top=25)
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
    kernel path (flash + Adam kernels, bf16), the plain path (plain
    attention and Adam, bf16) and the plain path in float32 (TF32 off), from
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
        cfg = dataclasses.replace(base, attn_impl=attn, dtype=dtype)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving run and one extra training step with "
                         "torch.profiler and print device time by kernel (slows "
                         "the runs it traces)")
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
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as adam
    from deepspeed_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()
    # phase 1
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {name} (count {count}), torch {torch.__version__}, "
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

    # phase 3
    rows = kernel_phase(pa)
    rows.update(flash_phase(fa))
    rows.update(adam_phase(adam))
    # phase 4, 5: the serving path
    launches = slice_phase(pa, card, profile=args.profile)
    path_phase()
    # phase 6, 7: the training path
    launches.update(train_phase((fa, adam), card, profile=args.profile))
    train_parity_phase()

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/pallas/"
    origin = {
        "paged_attention": ("paged_attention.cu", "paged_attention.py:53"),
        "paged_flash_decode": ("paged_attention.cu", "paged_attention.py:224"),
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:52"),
        "flash_attention_bwd_dkdv": ("flash_attention.cu", "flash_attention.py:149"),
        "flash_attention_bwd_dq": ("flash_attention.cu", "flash_attention.py:199"),
        "fused_adam": ("fused_adam.cu", "fused_adam.py:27"),
    }
    kernels = [dict(name=n, route="cuda", source=csrc + origin[n][0],
                    replaces=pallas + origin[n][1], launches=launches[n],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])
               for n, r in rows.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
