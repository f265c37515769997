#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --cards N    # only: data-parallel training over NCCL on N cards
                                       # (ZeRO stages 0-3; on 4: Llama-2-7B at stage 3)

Phases (any failure exits non-zero; nothing is caught and passed over):

1. environment — device name and count, torch/CUDA versions, the card's
   name and power limit from ``nvidia-smi``, the host's MemAvailable and
   CPU model (``lscpu``);
2. build — compiles the port's CUDA sources (``nvcc`` for sm_90a, into
   ``build/``), one ``nvcc`` per source, all started together, then the
   two host libraries of the offload tier (``g++``);
3. kernel parity — each hand-written kernel against its plain PyTorch
   version on the card, and timed with CUDA events beside its bound, its
   plain version and one library call computing the same function:
   the two paged-attention kernels at the serving slice's shapes (Llama-2-7B
   heads, a GQA shape, ragged kv lengths incl. 0 and a partial page, decode
   rows over all 64 table pages (split across blocks by the decode kernel),
   stats on and off, bf16 and fp32), and the decode kernel's int8 mode on
   each decode case's pools quantized by ``quantize_rows`` (layer 2, stats,
   bf16 and fp32 compute;
   library composite: gather + ``dequantize_rows`` + SDPA), each case
   reporting its route (bf16 and the int8 mode must take ``sm90``, fp32
   ``cuda_core``), two launches of each kernel bitwise equal, each kernel
   timed on both routes at the main shape, the split rule's KV splits
   against runs of 4 and 8 tiles there and against the other side of its
   choice at the GQA full-table shape, where it splits the decode kernel
   and not the packed one (back to back and replayed from a CUDA graph),
   and the main packed step's 14 decode rows and two prompt chunks timed
   alone on both routes; the same parity (routes, tolerances, bitwise
   repeats; packed, decode, the int8 mode, bf16 and fp32) at the attention
   widths of phi-3-mini (32/32, D 96), Pythia-1B (8/8, D 256) and
   Pythia-2.8B (32/32, D 80), a GQA 16/4 case at D 256 and pages of 16
   slots at D 80, each kernel timed on both routes at each width's serving
   shapes beside its bound, its plain version and the library composite;
   the
   block-sparse forward at Llama-2-7B's attention widths (B 1,
   S 4096, H 32, D 128) over the bigbird (seed 0), fixed, bslongformer,
   variable and local-window layouts, causal and not at blocks 64 and 16
   (DeepSpeed's SparsityConfig default), causal at blocks 32 and 256, at D
   64, block 128, D 64 at block 128, fp32 at blocks 64 and 16, empty
   q-blocks inside live items at block 16, at the widths of phi-3-mini
   (H 32, D 96), Pythia-1B (H 8, D 256, S 2048) and Pythia-2.8B (H 32,
   D 80, S 2048) at blocks 16 and 64, and an all-ones causal layout at
   blocks 64 and 16 against the port's flash forward, each case through the
   public op reporting its route (bf16 must take ``wgmma``, fp32
   ``mma_sync``) and forced onto each route it takes, within OUT_TOL or
   one bf16 ulp of each reference element; two ``wgmma`` launches bitwise
   equal at each timed shape; timed on both routes through the launch
   helper, back to back and from a CUDA graph, at the main shape at blocks
   64, 16, 32 and 256 (with the public op) and at the three other widths at
   block 16 (library: SDPA with the layout as a dense mask); the
   flash-attention forward and its two
   backward kernels at TinyLlama's shape (B 4, S 2048, 32/4 heads, D 64,
   causal, bf16), a Llama-2-7B head shape (32/32, D 128), a non-causal
   case and an fp32 case, and at B 4, S 2048, causal, the attention widths
   of Pythia-1B (8/8, D 256), Pythia-2.8B (32/32, D 80) and phi-3-mini
   (32/32, D 96), a non-causal GQA case at D 256 and an fp32 case at D 80,
   each reporting the route its three kernels took
   (``wgmma`` or ``mma_sync``; every bf16 case must take ``wgmma`` for all
   three), each kernel timed on both routes at TinyLlama's shape and at
   the three new head dims' shapes beside SDPA's forward and backward, and
   two of each kernel's ``wgmma`` launches bitwise equal there; fused Adam over odd
   tensor sizes in
   AdamW and L2 modes, bias correction on and off, and timed over TinyLlama's 201
   tensors; the fused LM loss (forward, dl, dh, dK) at TinyLlama's head
   (T 8192, E 2048, V 32000, bf16) and a ragged shape (T 3007, E 1000,
   V 50257, z_loss, half the rows at zero cotangent, untied and tied heads,
   bf16 and fp32), each case reporting the route its forward and backward
   took (``wgmma`` or ``mma_sync``; the main shape must take ``wgmma``),
   timed beside its plain version and the library composite (bf16 matmul +
   F.cross_entropy), the forward and the backward's dl, dh and dK kernels
   on both routes at the main shape, and its peak extra memory against the
   composite's; the host Adam of ZeRO-Offload, each route the host runs
   (``avx512``, ``avx2``, ``scalar``) bitwise its plain version (every tail
   length of 8 and 16 lanes, denormal masters, inf and NaN gradients, AdamW
   and L2, bias correction on and off, bf16 out, a bf16 gradient step) and
   one library call over many slices bitwise a call a slice, each route
   timed over TinyLlama-1.1B's 201 leaves with fp32 and bf16 gradients
   beside ``torch._fused_adamw_`` on CPU tensors and the bound (a measured
   read-modify-write stream, an in-place ``add_``), and over one layer
   beside its plain version; the aio pool's write and read split by
   workers and block size, and its 256 MiB write and read back beside one
   thread's ``os.pwrite`` / ``os.preadv`` and ``torch.save`` +
   ``torch.load``;
4. serving slice — Llama-2-7B at full width (bf16, seeded random weights
   made on the card) served by ``LLMServer`` over ``InferenceEngineV2``: 16
   requests with seeded prompt lengths in [128, 1024], 128 new tokens each.
   Kernel launch counts are reset just before and read just after; every
   packed and decode launch on the ``sm90`` route, a whole number per layer;
5. serving path parity — a full-width 4-layer model runs one packed step
   and one fused decode step/chunk through the kernel path and the einsum
   path in bf16, and the einsum path in float32, on identical pools; the
   kernel path must agree with the einsum path within twice the einsum
   path's own distance from float32; greedy-token agreement is printed;
6. training slice — TinyLlama-1.1B at full width and depth (bf16 over fp32
   masters, seeded random weights made on the card) trained through
   ``initialize`` + ``train_batch`` (micro-batch 4 x 2048 tokens, gas 2,
   AdamW from the config through the fused Adam kernel, WarmupLR, ZeRO
   stage 3, which at world size 1 is the same math as every other stage,
   clipping 1.0, ``loss_impl: auto``, i.e. the fused loss) on one
   repeated seeded batch: 2 warm-up and 8 timed steps; step time,
   tokens/s, MFU and peak memory; the losses must be finite and fall, and
   every kernel must launch exactly as often as the path runs it (flash
   22 x gas x steps, fused loss forward and its combine gas x steps, each
   backward kernel once per vocab chunk, Adam once per step), every flash
   and fused-loss launch on the ``wgmma`` route; the optimizer step is
   timed with CUDA events around the engine's ``_update``;
7. training path parity — at 2 layers, at the widths of TinyLlama,
   Pythia-1B (D 256), Pythia-2.8B (D 80) and phi-3-mini (D 96): two ``train_batch``
   steps through the kernel path (flash kernels, Adam kernel, bf16), the
   plain path (plain attention, dense loss and Adam, bf16) and the plain
   path in float32; loss, gradient norm and weight updates of the kernel
   path (flash, fused loss, Adam) must sit within twice the plain path's
   distance from float32; at 2 layers of TinyLlama widths the host-Adam
   tier (fp32 and bf16 transport) within twice the device path's distance
   from float32 of it, the storage tier (a caller's Adam) bitwise it;
8. remat — TinyLlama widths at 4 layers, one step without remat, with
   per-layer remat ("nothing_saveable", "dots_saveable") and with the
   engine-level wrap: loss and grad norm agree, per-layer remat lowers the
   peak memory, the flash forward launches twice as often; per-layer remat
   under ``cpu_checkpointing`` (the products in pinned host memory): loss
   and grad norm bitwise "dots_saveable"'s, at a lower peak;
9. checkpoint — TinyLlama widths at 2 layers: 3 steps, save, a fresh
   engine, load, 2 steps, against 5 uninterrupted steps: the state is
   bitwise equal after the load, the losses are bitwise equal, and
   ``zero_to_fp32`` returns the saved masters; the same for the host-Adam
   tier (host masters, moments and compute leaves); ``offload_states`` of
   the optimizer state and of the params to host memory and through the
   aio swapper to files under ``build/`` and back mid-run: the card's
   memory drops by the optimizer state's bytes and by exactly the
   allocator blocks holding the params, the state comes back bitwise (the
   params the same tensors) and training goes on bitwise;
10. block-quant kernels — quantize (nearest), quantize with stochastic
   rounding and dequantize against their plain versions at a ragged size
   (blocks 2048, 512, 128) and at TinyLlama-1.1B's flat gradient (n =
   1,100,048,384, block 2048): nearest, dequantize and stochastic rounding
   bitwise (the same Philox words), stochastic rounding also in
   distribution; timed beside the bound, the plain version and the eager
   torch composite;
11. data-parallel training — two ranks (this script started with
   ``--dp-child``) share cuda:0 over gloo and train TinyLlama widths at 4
   layers (micro 2 x 2048 per rank, gas 2, bf16, fused loss) for 5 steps
   in each of ``compressed_collectives`` none, int8 and int8_sr at ZeRO
   stage 0, at ZeRO stages 1, 2 and 3 with the exact reduction and at
   stage 1 with ``offload_optimizer`` cpu (the storage tier at world size
   2: losses bitwise stage 1's), from one
   seed (an init closure) and one global batch: each mode's first loss
   bitwise equal to none's, every loss within 0.02 |ref| + 1e-3 of none's,
   losses falling, the full masters (``safe_get_full_fp32_param``) bitwise
   equal across ranks; int8 modes: 2 quantize and 2 dequantize launches per
   rank per step, the ledger's logical and wire bytes equal to the JAX
   package's formula; stages 1-3: one Adam launch per rank per step over
   ceil(n / 2) elements and no quant launch; each mode's peak memory per
   rank printed beside ``estimate_zero_model_states_mem_needs``; the none
   run against one process on the same global batch; ``init_distributed``
   on NCCL at world size 1 with one all-reduce. Its step time is two ranks
   sharing one card, not a scaling number. Phase 20 (d) runs in the same
   world after these modes;
12. int8 KV serving — phase 4's run with ``kv_cache_dtype="int8"``: every
   request finishes, KV conservation, the decode kernel's int8 mode launches
   (``paged_flash_decode_int8``), every launch on the ``sm90`` route, and no
   bf16-pool kernel does, the engine
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
   ``deepspeed_tpu_torch.ops.sparse_attention`` (bigbird, seed 0, causal,
   bf16) at phase 3's main shape at blocks 64, 16, 32 and 256 and at block
   16 at the widths of phi-3-mini, Pythia-1B and Pythia-2.8B: one kernel
   launch each,
   on the ``wgmma`` route, o within OUT_TOL or one bf16 ulp, the gradients
   finite and equal to autograd through ``masked_dense_attention`` within
   1e-3 of their largest value;
15. Pythia-1B training — phase 6's run at Pythia-1B's published size
   (EleutherAI/pythia-1b: hidden 2048, 16 layers, 8 heads of D 256, ffn
   8192, vocab 50304, a quarter of each head rotated, parallel residual,
   biased LayerNorm, gelu, untied head), the same gates: losses finite and
   falling, every kernel's launches exact (flash 16 x gas x steps, all on
   ``wgmma`` at D 256; the fused loss and Adam as in phase 6);
16. serving at the new head dims — phase 4's run with phi-3-mini-4k
   (hidden 3072, 32 layers, 32/32 heads of D 96, ffn 8192 swiglu, vocab
   32064) and Pythia-1B (phase 15's config, D 256) at their published
   sizes, nothing cut (KV pools of 1024 blocks of 32 slots: 12 GiB and 4
   GiB): phase 4's gates, every packed and decode launch on ``sm90``, a
   whole number per layer, and the engine resolving ``pallas`` for both
   paths by its heuristic;
17. serving path parity at the new head dims — phases 5 and 13 at 2
   layers of the widths of phi-3-mini, Pythia-1B and Pythia-2.8B (D 80):
   the kernel path's packed-step and decode-step logits (and the int8
   decode step's) within twice the einsum path's distance from float32,
   each paged launch of the kernel path on ``sm90``;
18. full-depth ZeRO-3 — phase 11's world at TinyLlama-1.1B's 22 layers, 3
   steps at stage 0 and 3 at stage 3 from the same seed and batch:
   phase 11's gates, every flash, fused-loss and Adam launch exact per
   rank, stage 3's peak memory per rank at least three quarters of the
   estimator's predicted saving (18P against 9P bytes) below stage 0's,
   and at most two units gathered at once; both peaks, the estimator's
   figures, the units gathered at once and the step times (two ranks
   sharing one card, not a scaling number) are printed;
19. ZeRO-Offload at full size — Llama-2-7B (or phi-3-mini-4k when the
   host's MemAvailable stays below the 7B's host need, 12P, the transfer
   ring and HOST_REST_BYTES, for HOST_MEMORY_WAIT_S) trained on one card with the optimizer on the
   host: seq 4096, micro 1, gas 2, per-layer remat, bf16, bf16 gradient
   transport, clipping 1.0, WarmupLR, 1 warm-up and 3 timed steps: losses
   finite and falling, no fused-Adam launch and one host step a step (a
   host launch a slice of the ring's walk), flash and fused-loss launches
   exact and on ``wgmma``, the compute leaves on the card bitwise the bf16
   of the host masters, peak device memory below 9P; step time, tokens/s,
   MFU, the D2H / host Adam / H2D seconds and the walk's wall, peak memory
   and the host's resident bytes by stage printed;
20. the engine's remainder — (a) phase 6's TinyLlama-1.1B run with LAMB
   (lr warmed up to 1e-2), dropout 0.1 and ``frozen_params=["embed"]`` (the
   embedding table), its batches fed through ``PrefetchLoader``, 2 warm-up
   and 5 timed steps: step time, tokens/s, MFU, peak memory and the
   optimizer step (CUDA events) beside phase 6's AdamW; losses finite and
   falling, the embedding bitwise unchanged, flash launches 22 x gas x
   steps on ``wgmma``, the fused loss's exact, no fused-Adam launch, a
   second engine's 3 steps from the same seed bitwise the first 3 losses,
   layer 0's dropout mask keeping 0.9 of its elements within 4 sigma; (b)
   Lion, Adagrad, SGD (momentum 0.9, nesterov) and MuAdamW (base_width
   256) at TinyLlama's width and 2 layers, 3 steps each: losses finite and
   falling, the third step's update of layer 0 and the final norm within
   UPDATE_RTOL of the same step in float64 on the CPU from the same state,
   fused Adam launched by MuAdamW only; (c) phase 8's per-layer remat at 2
   layers with dropout 0.1: loss and gradient norm those of the run without
   remat within REMAT_RTOL, at a lower peak; (d) in phase 11's world, LAMB
   with the embedding frozen at 2 layers at ZeRO stages 0, 2 and 3: phase
   11's loss rule against stage 0, the masters bitwise equal across ranks,
   the frozen leaf bitwise its initial value, every step's trust ratios
   within TRUST_RTOL of stage 0's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
import gc
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


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: what the card takes without the host's cost of
    each launch, which sets ``cuda_ms`` for kernels shorter than it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def routed(pa, name):
    """The route a paged wrapper's last launches took, as a count per route."""
    return {r: n for r, n in pa.route_counts[name].items() if n}


def both_routes(launch):
    """A launch's time on each route, in turns (cuda_core, sm90, sm90,
    cuda_core), the least of the two timings of each."""
    t = {"sm90": [], "cuda_core": []}
    for route in ("cuda_core", "sm90", "sm90", "cuda_core"):
        t[route].append(cuda_ms(lambda: launch(route), iters=50))
    return {r: min(v) for r, v in t.items()}


def packed_launch(pa, args, sm):
    """A launch of the packed kernel on ``args`` (stats off) by route and
    split, through its launch helper."""
    return lambda route, split_tiles=None: pa.launch_paged_attention(
        *args, torch.empty_like(args[0]), None, None, sm_scale=sm, route=route,
        split_tiles=split_tiles)


def decode_launch(pa, args, sm):
    """A launch of the decode kernel (its int8 mode on ``(values, scales)``
    pools) on ``args`` (layer 2, stats on) by route and split."""
    q = args[0]
    o, mo, lo = torch.empty_like(q), *(torch.empty(q.shape[:2], device=q.device)
                                       for _ in range(2))
    return lambda route, split_tiles=None: pa.launch_paged_flash_decode(
        *args, o, mo, lo, layer=2, sm_scale=sm, route=route, split_tiles=split_tiles)


def paged_rows(pa, pargs, dargs, iargs, errs):
    """The three paged kernels timed at one shape through their launch
    helpers on both routes (the sm90 time is the row's ``ms``), beside the
    bound, the plain version and the library composite (gathered pages +
    SDPA; int8: + ``dequantize_rows``): the packed kernel on ``pargs``
    (stats off), the decode kernel on ``dargs`` and its int8 mode on
    ``iargs`` (layer 2, stats on)."""
    D = pargs[0].shape[-1]
    sm = 1.0 / math.sqrt(D)
    q, k, v, bt, start, chunk, kvl = pargs
    nbytes, flops = packed_work(q, k, bt, start, chunk, kvl, stats=False)
    cases = [("paged_attention", packed_launch(pa, pargs, sm), (nbytes, flops),
              lambda: pa.paged_attention_ref(*pargs),
              lambda: sdpa_packed(*pargs, sm))]
    q, k, v, bt, pos, kvl = dargs
    cases.append(("paged_flash_decode", decode_launch(pa, dargs, sm),
                  decode_work(q, k, bt, pos, kvl, stats=True),
                  lambda: pa.paged_flash_decode_ref(*dargs, layer=2, return_stats=True),
                  lambda: sdpa_decode(*dargs, 2, sm)))
    q, kp, vp, bt, pos, kvl = iargs
    cases.append(("paged_flash_decode_int8", decode_launch(pa, iargs, sm),
                  decode_int8_work(q, kp[0], bt, pos, kvl),
                  lambda: pa.paged_flash_decode_ref(*iargs, layer=2, return_stats=True),
                  lambda: sdpa_decode_int8(*iargs, 2, sm)))
    rows = {}
    for name, launch, (nbytes, flops), plain, library in cases:
        routes = both_routes(launch)
        b_ms, b_by = bound(nbytes, flops, q.dtype)
        rows[name] = dict(ms=routes["sm90"], cuda_core_ms=routes["cuda_core"],
                          plain_ms=cuda_ms(plain, iters=5), library_ms=cuda_ms(library, iters=5),
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[name],
                          bytes=nbytes, flops=flops)
    return rows


def paged_parity(pa, rng, packed_cases, decode_cases, main_packed, main_decode, tag):
    """Both kernels and the int8 mode against their plain versions over
    ``packed_cases`` and ``decode_cases`` (``(label, spec)``), bf16 and
    fp32, each case reporting its route (bf16 and the int8 mode with bf16
    queries on ``sm90``, fp32 on ``cuda_core``); at the main cases two
    bf16 launches bitwise equal. Raises on a failure; returns each kernel's
    error at the main case and its inputs there (bf16)."""
    ok = True
    errs = {"paged_attention": 0.0, "paged_flash_decode": 0.0,
            "paged_flash_decode_int8": 0.0}

    def check(label, name, route_want, got, want, dtype, stats):
        nonlocal ok
        if stats:
            err, m_err, l_err, good = compare(got, want, dtype)
        else:
            err = (got.float() - want[0].float()).abs().max().item()
            m_err = l_err = 0.0
            good = err <= OUT_TOL[dtype]
        route = routed(pa, name)
        good &= route == {route_want: 1}
        ok &= good
        log(f"parity {name} {label} {str(dtype)[6:]} stats={stats} (route {route}): "
            f"max|o|err={err:.3e} m={m_err:.2e} l={l_err:.2e} (tol {OUT_TOL[dtype]:g}) "
            f"{'ok' if good else 'FAIL'}")
        return err

    def bitwise(name, fn):
        """Two launches of the chosen route, (o, m, l) bitwise equal."""
        nonlocal ok
        a, b = fn(), fn()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        ok &= same
        log(f"bitwise {name}: two launches {'equal' if same else 'DIFFER'}")

    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        want_route = "sm90" if dtype == torch.bfloat16 else "cuda_core"
        for name, spec in packed_cases:
            args = packed_case(rng, dtype, **spec)
            for stats in (True, False):
                pa.reset_launch_counts()
                got = pa.paged_attention(*args, return_stats=stats)
                want = pa.paged_attention_ref(*args, return_stats=True)
                err = check(name, "paged_attention", want_route, got, want, dtype, stats)
            if spec is main_packed and dtype == torch.bfloat16:
                errs["paged_attention"] = err
                timed["paged_attention"] = ("packed", args)
                bitwise(f"paged_attention ({tag} mixed step)",
                        lambda: pa.paged_attention(*args, return_stats=True))
        for name, spec in decode_cases:
            q, k, v, bt, pos, kvl = decode_case(rng, dtype, **spec)
            for stats in (True, False):
                pa.reset_launch_counts()
                got = pa.paged_flash_decode(q, k, v, bt, pos, kvl, layer=2,
                                            return_stats=stats)
                want = pa.paged_flash_decode_ref(q, k, v, bt, pos, kvl,
                                                 layer=2, return_stats=True)
                err = check(name, "paged_flash_decode", want_route, got, want, dtype, stats)
            if spec is main_decode and dtype == torch.bfloat16:
                errs["paged_flash_decode"] = err
                timed["paged_flash_decode"] = ("decode", (q, k, v, bt, pos, kvl))
                bitwise(f"paged_flash_decode ({tag} decode)",
                        lambda: pa.paged_flash_decode(q, k, v, bt, pos, kvl, layer=2,
                                                      return_stats=True))
            # the int8 mode on this case's pools, quantized by quantize_rows
            kp, vp = int8_pools(k, v)
            pa.reset_launch_counts()
            got = pa.paged_flash_decode(q, kp, vp, bt, pos, kvl, layer=2,
                                        return_stats=True)
            want = pa.paged_flash_decode_ref(q, kp, vp, bt, pos, kvl,
                                             layer=2, return_stats=True)
            err = check(name, "paged_flash_decode_int8", want_route, got, want, dtype, True)
            if spec is main_decode and dtype == torch.bfloat16:
                errs["paged_flash_decode_int8"] = err
                timed["paged_flash_decode_int8"] = (q, kp, vp, bt, pos, kvl)
                bitwise(f"paged_flash_decode_int8 ({tag} decode)",
                        lambda: pa.paged_flash_decode(q, kp, vp, bt, pos, kvl, layer=2,
                                                      return_stats=True))
    if not ok:
        raise SystemExit(f"kernel parity FAILED at {tag} (see lines above)")
    return errs, timed


def kernel_phase(pa):
    """Parity of both kernels with their plain versions over the slice's
    cases, each case reporting its route (bf16 and the int8 mode on sm90,
    fp32 on the CUDA-core tile); two launches bitwise equal; returns the
    timing rows at the main path's shapes, with both routes timed."""
    rng = np.random.default_rng(2024)
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
        # decode rows over all 64 table pages beside a prompt chunk over a
        # full table (the rule splits none of a launch with prompt chunks;
        # the decode case of this shape splits)
        ("full 64-page table, decode rows and a prompt chunk",
         dict(S=4, Q=Q, Hq=32, Hk=8, D=D, bs=bs, B=B,
              kv_len=[2048, 2048, 1900, 33], chunk=[1, 128, 1, 1])),
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
        ("gqa 32/8, all 64 table pages, split across blocks",
         dict(S=4, Hq=32, Hk=8, D=D, bs=bs, B=B, L=4,
              kv_len=[2048, 2048, 1999, 64], pos=[2047, 2048, 1999, 64])),
    ]

    errs, timed = paged_parity(pa, rng, packed_cases, decode_cases, main_packed, main_decode,
                               "7b")

    rows = paged_rows(pa, timed["paged_attention"][1], timed["paged_flash_decode"][1],
                      timed["paged_flash_decode_int8"], errs)
    sm = 1.0 / math.sqrt(D)
    args = timed["paged_attention"][1]
    q = args[0]
    packed = lambda a: packed_launch(pa, a, sm)
    decode = lambda *a: decode_launch(pa, a, sm)
    # the main step's halves: its 14 decode rows alone, its two prompt chunks
    for half, part in (("14 decode rows", slice(0, 14)), ("2 prompt chunks", slice(14, 16))):
        sub = tuple(t[part].contiguous() if i not in (1, 2) else t
                    for i, t in enumerate(args))
        hb, hf = packed_work(sub[0], sub[1], sub[3], sub[4], sub[5], sub[6], stats=False)
        hr = both_routes(packed(sub))
        log(f"timing paged_attention, the main step's {half} alone: sm90 {hr['sm90']:.4f} ms, "
            f"cuda_core {hr['cuda_core']:.4f} ms, bound {bound(hb, hf, q.dtype)[0]:.4f} ms")
    dargs = timed["paged_flash_decode"][1]
    iargs = timed["paged_flash_decode_int8"]
    launches = {"paged_attention": packed(args),
                "paged_flash_decode": decode(*dargs),
                "paged_flash_decode_int8": decode(*iargs)}

    # the split rule's choice against runs of 4 and 8 tiles (256 and 512
    # slots) at the main shapes, where the rule takes no split
    for name, c in in_turns((None, 4, 8), {n: (lambda f: lambda st: f("sm90", st))(f)
                                           for n, f in launches.items()}).items():
        log(f"timing {name} by KV split: the rule's (split_tiles_for) {times(c[None])}, "
            f"4 tiles {times(c[4])}, 8 tiles {times(c[8])}")
    # ... and at the GQA 32/8 full-table shapes, where the rule splits the
    # decode kernel's contexts (4 sequences: 32 (sequence, kv head) pairs) and
    # not the packed kernel's (a 128-token prompt chunk beside the decode
    # rows): the rule's choice against the other side, one split or the
    # splits one wave of the launch's blocks holds
    sargs = decode_case(rng, torch.bfloat16, **decode_cases[2][1])
    fargs = packed_case(rng, torch.bfloat16, **packed_cases[3][1])
    q, k, v = sargs[:3]
    for name, Qn, launch in (
            ("paged_attention", fargs[0].shape[1], packed(fargs)),
            ("paged_flash_decode", 1, decode(*sargs)),
            ("paged_flash_decode_int8", 1, decode(q, *int8_pools(k, v), *sargs[3:]))):
        # the decode kernel against one split and against runs of 3 tiles
        # (11 splits: a wave of its instantiation's three blocks an SM)
        split_choices(pa, name, launch, sargs[0], sargs[1], sargs[3], Qn,
                      "gqa 32/8, all 64 table pages", others=(3,))
    log_paged_rows(rows, "main-path shape")
    return rows


def in_turns(choices, launch_of):
    """Each kernel's time under each choice, back to back (``cuda_ms``)
    and replayed from a CUDA graph (``graph_ms``), the choices in turns
    (a b .. b a), the least of the two timings of each."""
    t = {n: {} for n in launch_of}
    for c in tuple(choices) + tuple(reversed(choices)):
        for name, launch in launch_of.items():
            ms = (cuda_ms(lambda: launch(c), iters=50), graph_ms(lambda: launch(c)))
            t[name][c] = tuple(map(min, zip(ms, t[name].get(c, ms))))
    return t


def times(t):
    return f"{t[0]:.4f} ms (graph {t[1]:.4f})"


def split_choices(pa, name, launch, q, k_pool, block_table, Qn, label, others=()):
    """One sm90 launch of ``name`` timed by KV split (``in_turns``): the
    split rule's choice against the other side of it (one split where the
    rule splits, else the splits of a one-query launch) and against runs of
    each count of tiles in ``others``."""
    Hq, (Hk, bs), B = q.shape[-2], k_pool.shape[-3:-1], block_table.shape[1]
    S, D = q.shape[0], q.shape[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    whole = -(-B * bs // pa.SM90_TILE_SLOTS)
    per_sm = pa.sm90_blocks_per_sm(D, Hq // Hk, decode=Qn == 1, int8=name.endswith("int8"))
    rule = pa.split_tiles_for(S, Qn, Hk, B, bs, sms, per_sm)
    choices = [rule, whole if rule < whole else
               pa.split_tiles_for(S, 1, Hk, B, bs, sms, per_sm)]
    choices += list(others)
    choices = list(dict.fromkeys(choices))
    if len(choices) == 1:
        choices.append(-(-whole // 2))     # where the rule and one split agree: two splits
    c = in_turns(choices, {name: lambda st: launch("sm90", st)})[name]
    n = {st: pa.sm90_grid(S, Qn, Hq // Hk, Hk, B, bs, st)[2] for st in choices}
    against = ", ".join(f"{st} tiles x {n[st]} splits {times(c[st])} (rule / this "
                        f"{c[rule][0] / c[st][0]:.3f}, graph {c[rule][1] / c[st][1]:.3f})"
                        for st in choices[1:])
    log(f"timing {name} by KV split ({label}, {S * Hk} pairs, {per_sm} blocks per SM): "
        f"the rule's {rule} tiles x {n[rule]} splits {times(c[rule])}, against {against}")


def log_paged_rows(rows, label):
    for name, r in rows.items():
        log(f"timing {name} (bf16, {label}): kernel on the sm90 route {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes']} B, {r['flops']} flop), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms (kernel / library "
            f"{r['ms'] / r['library_ms']:.3f})")
        log(f"timing {name} on the cuda_core route at {label}: {r['cuda_core_ms']:.4f} ms "
            f"(sm90 / cuda_core {r['ms'] / r['cuda_core_ms']:.3f})")


#: the paged kernels' head dims past 64 and 128 at published attention
#: widths (phase 3): phi-3-mini and Pythia-1B (phase 16 serves them), and
#: Pythia-2.8B
PAGED_WIDE = {"phi-3-mini 32/32 D96": dict(Hq=32, Hk=32, D=96),
              "pythia-1b 8/8 D256": dict(Hq=8, Hk=8, D=256),
              "pythia-2.8b 32/32 D80": dict(Hq=32, Hk=32, D=80)}


def wide_paged_phase(pa):
    """Phase 3 at the head dims 96, 256 and 80: at each width a serving
    step (16 sequences: 14 decode rows, two 121-token prompt chunks) and a
    decode batch (16 sequences, an empty slot, a partial page), plus a GQA
    16/4 case at D 256 and pages of 16 slots at D 80, each through
    ``paged_parity`` (routes, tolerances, bitwise repeats); at each width
    each kernel timed on both routes at the serving step and decode batch
    (``paged_rows``). Returns the timing rows by width."""
    rng = np.random.default_rng(2025)
    S, Q, bs, B = 16, 128, 32, 64
    by_width = {}
    for label, heads in PAGED_WIDE.items():
        kv_dec = rng.integers(130, 1151, 14)
        main_packed = dict(S=S, Q=Q, bs=bs, B=B, kv_len=list(kv_dec) + [121, 800],
                           chunk=[1] * 14 + [121, 121], **heads)
        kv_main = rng.integers(128, 1153, S)
        kv_main[3], kv_main[7] = 0, 33       # an empty slot, a partial page
        main_decode = dict(S=S, bs=bs, B=B, L=4, kv_len=list(kv_main), pos=list(kv_main),
                           **heads)
        packed_cases = [(f"{label} mixed step", main_packed)]
        decode_cases = [(f"{label} decode, frozen pool (pos = kv_len)", main_decode)]
        if heads["D"] == 256:
            gqa = dict(Hq=16, Hk=4, D=256)
            packed_cases.append(("gqa 16/4 D256", dict(
                S=4, Q=Q, bs=bs, B=B, kv_len=[128, 301, 17, 0], chunk=[128, 128, 17, 0], **gqa)))
            decode_cases.append(("gqa 16/4 D256, pos inside the context, split across blocks",
                                 dict(S=4, bs=bs, B=B, L=4, kv_len=[0, 31, 400, 2048],
                                      pos=[0, 20, 402, 2047], **gqa)))
        if heads["D"] == 80:
            packed_cases.append(("pages of 16 slots D80", dict(
                S=4, Q=Q, bs=16, B=128, kv_len=[128, 300, 45, 0], chunk=[128, 77, 1, 0],
                **heads)))
            decode_cases.append(("pages of 16 slots D80, all 128 table pages, split across "
                                 "blocks", dict(S=4, bs=16, B=128, L=4, kv_len=[2048, 0, 33, 700],
                                                pos=[2047, 0, 33, 500], **heads)))
        errs, timed = paged_parity(pa, rng, packed_cases, decode_cases, main_packed,
                                   main_decode, label)
        by_width[label] = paged_rows(pa, timed["paged_attention"][1],
                                     timed["paged_flash_decode"][1],
                                     timed["paged_flash_decode_int8"], errs)
        log_paged_rows(by_width[label], f"{label} serving shape")
        if heads["D"] == 256:
            # the decode batch's 128 pairs nearly fill a wave of one block
            # per SM: the rule's single split against two
            dargs = timed["paged_flash_decode"][1]
            sm = 1.0 / math.sqrt(heads["D"])
            for name, args in (("paged_flash_decode", dargs),
                               ("paged_flash_decode_int8", timed["paged_flash_decode_int8"])):
                split_choices(pa, name, decode_launch(pa, args, sm), args[0],
                              pa.pool_values(args[1]), args[3], 1, f"{label} decode batch")
        del timed
        torch.cuda.empty_cache()
    return by_width


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


# phase 3's flash shapes: TinyLlama's training shape (the main one, in the
# kernels line) and, at B 4 and S 2048, the attention widths of the head dims
# 256, 80 and 96: Pythia-1B (D 256, the training path of phase 15),
# Pythia-2.8B (D 80) and phi-3-mini (D 96)
FLASH_MAIN = dict(B=4, S=2048, H=32, Hk=4, D=64)
FLASH_WIDE = {"pythia-1b 8/8 D256": dict(B=4, S=2048, H=8, Hk=8, D=256),
              "pythia-2.8b 32/32 D80": dict(B=4, S=2048, H=32, Hk=32, D=80),
              "phi-3-mini 32/32 D96": dict(B=4, S=2048, H=32, Hk=32, D=96)}
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def flash_timings(fa, label, q, k, v, do, o, lse, errs):
    """Each flash kernel at one causal shape: two ``wgmma`` launches bitwise
    equal, its time on both routes through its launch helper, beside its
    bound, its plain version and SDPA's forward or backward at the same
    shape. Returns a row per kernel."""
    lib_fwd, lib_bwd = sdpa_fwd_bwd(q, k, v, do, True)
    plain_fwd = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, return_lse=True), iters=3)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), iters=3)
    # each kernel is timed on its own through its launch helper, on both routes
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    o_k, lse_k = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sm = 1.0 / math.sqrt(q.shape[-1])
    launch = {
        "flash_attention_fwd": lambda route="wgmma": fa.launch_fwd(
            q, k, v, o_k, lse_k, causal=True, sm_scale=sm, route=route),
        "flash_attention_bwd_dkdv": lambda route="wgmma": fa.launch_bwd_dkdv(
            q, k, v, do, lse, delta, dk, dv, causal=True, sm_scale=sm, route=route),
        "flash_attention_bwd_dq": lambda route="wgmma": fa.launch_bwd_dq(
            q, k, v, do, lse, delta, dq, causal=True, sm_scale=sm, route=route)}
    # the wgmma kernels repeat bitwise: one block sums each unit in a fixed order
    outputs = {"flash_attention_fwd": (o_k, lse_k), "flash_attention_bwd_dkdv": (dk, dv),
               "flash_attention_bwd_dq": (dq,)}
    for n in FLASH_NAMES:
        launch[n]()
        first = [t.clone() for t in outputs[n]]
        launch[n]()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(first, outputs[n]))
        log(f"flash {n} (wgmma) two launches at {label}: bitwise equal {bitwise}")
        if not bitwise:
            raise SystemExit(f"flash: two launches of the wgmma {n} differ at {label}")
    del first
    # the other route at the same shape, in the same run
    other = {n: cuda_ms(lambda: launch[n]("mma_sync")) for n in FLASH_NAMES}
    rows = {}
    for name, passes, plain, lib in (
            ("flash_attention_fwd", "fwd", plain_fwd, lib_fwd),
            ("flash_attention_bwd_dkdv", "dkdv", plain_bwd, lib_bwd),
            ("flash_attention_bwd_dq", "dq", plain_bwd, lib_bwd)):
        nbytes, flops = flash_work(q, k, True, passes)
        b_ms, b_by = bound(nbytes, flops, q.dtype)
        rows[name] = dict(ms=cuda_ms(launch[name]), plain_ms=plain, library_ms=lib,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[name],
                          bytes=nbytes, flops=flops, mma_sync_ms=other[name])
        ms = rows[name]["ms"]
        log(f"timing {name} (bf16, {label} causal): kernel on the wgmma route "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop), plain {plain:.4f} ms, "
            f"library {lib:.4f} ms")
        log(f"timing {name} on the mma_sync route at {label}: {other[name]:.4f} ms "
            f"({flops / other[name] / 1e9:.1f} TFLOP/s); wgmma / mma_sync "
            f"{ms / other[name]:.3f}")
    fwd = rows["flash_attention_fwd"]
    log(f"timing flash_attention_fwd on the wgmma route / SDPA's forward at {label} "
        f"{fwd['ms'] / lib_fwd:.3f}")
    bwd = rows["flash_attention_bwd_dkdv"]["ms"] + rows["flash_attention_bwd_dq"]["ms"]
    log(f"timing flash backward dK/dV + dQ on the wgmma route at {label} {bwd:.4f} ms, "
        f"SDPA's backward {lib_bwd:.4f} ms, ratio {bwd / lib_bwd:.3f}")
    return rows


def flash_phase(fa):
    """Flash forward and both backward kernels against their plain versions
    at every head dim the kernels build, then timed at TinyLlama's training
    shape (the kernels line) and at the attention widths of D 256, 80 and 96
    (bf16)."""
    # the kernels' fp32 products differ from the plain version's only in
    # summation order; in bf16 O, P and dS round to bf16, so a value may
    # land one ulp (2^-8 relative) apart, and dQ/dK/dV sum such terms over S
    tol = OUT_TOL
    cases = [("tinyllama 32/4 D64 causal", torch.bfloat16, FLASH_MAIN, True),
             ("llama-2-7b heads 32/32 D128 causal", torch.bfloat16,
              dict(B=1, S=2048, H=32, Hk=32, D=128), True),
             ("gqa 8/2 D128 non-causal, ragged S", torch.bfloat16,
              dict(B=2, S=1000, H=8, Hk=2, D=128), False),
             ("fp32 gqa 16/4 D64 causal", torch.float32,
              dict(B=2, S=1024, H=16, Hk=4, D=64), True)]
    cases += [(f"{name} causal", torch.bfloat16, shape, True)
              for name, shape in FLASH_WIDE.items()]
    cases += [("gqa 8/2 D256 non-causal, ragged S", torch.bfloat16,
               dict(B=2, S=1000, H=8, Hk=2, D=256), False),
              ("fp32 gqa 8/2 D80 causal", torch.float32,
               dict(B=1, S=1024, H=8, Hk=2, D=80), True)]
    ok, timed = True, {}
    for i, (name, dtype, shape, causal) in enumerate(cases):
        q, k, v, do = flash_case(dtype, seed=100 + i, **shape)
        route = fa.flash_route(q, k, v, do)
        fa.reset_launch_counts()
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        dq, dk, dv = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=causal)
        routed = {n: dict(fa.route_counts[n]) for n in FLASH_NAMES}
        dq_r, dk_r, dv_r = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                                      causal=causal)
        torch.cuda.synchronize()
        e = {"fwd": scaled_err(o, o_ref), "lse": scaled_err(lse, lse_ref),
             "dq": scaled_err(dq, dq_r), "dk": scaled_err(dk, dk_r),
             "dv": scaled_err(dv, dv_r)}
        good = all(rel <= tol[dtype] for key, (_, rel) in e.items() if key != "lse")
        good &= e["lse"][0] <= 1e-3
        # each kernel launched once, on the route flash_route chose
        good &= all(r[route] == 1 and sum(r.values()) == 1 for r in routed.values())
        ok &= good
        log(f"parity flash {name} {str(dtype)[6:]} (route {route} for the forward, dK/dV "
            f"and dQ): " + ", ".join(
                f"{key} max|err|={a:.3e} (rel {r:.2e})" for key, (a, r) in e.items())
            + f" (tol rel {tol[dtype]:g}, L abs 1e-3) {'ok' if good else 'FAIL'}")
        if dtype == torch.bfloat16 and route != "wgmma":
            raise SystemExit(f"flash: the {name} case took the {route} route, not wgmma")
        if shape is FLASH_MAIN or any(shape is w for w in FLASH_WIDE.values()):
            errs = {"flash_attention_fwd": max(e["fwd"][0], e["lse"][0]),
                    "flash_attention_bwd_dkdv": max(e["dk"][0], e["dv"][0]),
                    "flash_attention_bwd_dq": e["dq"][0]}
            timed[name] = (shape, errs, 100 + i)
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("flash kernel parity FAILED (see lines above)")

    rows = None
    for name, (shape, errs, seed) in timed.items():
        q, k, v, do = flash_case(torch.bfloat16, seed=seed, **shape)
        o, lse = fa.flash_attention_ref(q, k, v, return_lse=True)
        label = (f"B{shape['B']} S{shape['S']} {shape['H']}/{shape['Hk']} "
                 f"D{shape['D']}")
        got = flash_timings(fa, label, q, k, v, do, o, lse, errs)
        if shape is FLASH_MAIN:
            rows = got
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    log("timing note: plain and library backward times compute dQ, dK and dV "
        "together; compare them with dK/dV + dQ")
    return rows


SPARSE_MAIN = dict(B=1, S=4096, H=32, D=128, block=64)   # Llama-2-7B heads
#: the other attention widths phases 3 and 14 drive, at block 16 (DeepSpeed's
#: SparsityConfig default) and 64; the main shape's is Llama-2-7B's
SPARSE_WIDE = {"phi-3-mini H32 D96": dict(B=1, S=4096, H=32, D=96),
               "Pythia-1B H8 D256": dict(B=1, S=2048, H=8, D=256),
               "Pythia-2.8B H32 D80": dict(B=1, S=2048, H=32, D=80)}


def sparse_case(dtype, B, S, H, D, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    r = lambda: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    return r(), r(), r()


def sparse_work(sl, B, S, H, D, block, it, causal):
    """(bytes, flops) of the sparse forward on these inputs: q, k, v read
    once, o written once (the column lists are added by the caller); 4*D
    flops per (query, key) pair the layout leaves live, per batch: block^2
    per live (q-block, column) pair of the compacted layout, and under
    causal block (block + 1) / 2 for a pair on the diagonal."""
    live = int(sl.cnt.sum())
    diag = int(np.trace(sl.layout, axis1=1, axis2=2).sum()) if causal else 0
    pairs = (live - diag) * block * block + diag * block * (block + 1) // 2
    return 4 * B * S * H * D * it, 4 * D * pairs * B


def sdpa_sparse(q, k, v, mask, sm_scale):
    """torch SDPA with the layout expanded to a dense boolean mask (causal
    folded in): one library call computing the same function (rows with no
    live key come out NaN there; only timed)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask[None],
                                          scale=sm_scale)


def sparse_err(got, want, dtype):
    """max |got - want|, |want| where it is largest, and whether every
    element lies within OUT_TOL or, in bf16, one bf16 ulp of
    its reference element (OUT_TOL's one-ulp allowance, which its absolute
    2e-2 covers only below |o| = 4: a row that attends to few keys can have
    |o| of 4 or more, where one ulp is 2^-5)."""
    err = (got.float() - want.float()).abs()
    allowed = torch.full_like(err, OUT_TOL[dtype])
    if dtype == torch.bfloat16:
        ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want.float()).exponent - 8)
        allowed = torch.maximum(allowed, ulp)
    at = int(err.argmax())
    return (err.reshape(-1)[at].item(), want.float().reshape(-1)[at].abs().item(),
            bool((err <= allowed).all()) and bool(torch.isfinite(got).all()))


def sparse_builders(sa, H):
    """Layouts of H heads over nb blocks by name: the five builders, and one
    whose q-blocks 0 and 1 list nothing and every later one column 1 and
    itself (below block 64 the first item's live rows sit beside empty
    ones)."""
    return {
        "bigbird": lambda nb: sa.bigbird_layout(H, nb, seed=0),
        "fixed": lambda nb: sa.fixed_layout(H, nb),
        "bslongformer": lambda nb: sa.bslongformer_layout(H, nb),
        "variable": lambda nb: sa.variable_layout(H, nb, num_random_blocks=1),
        "local_window": lambda nb: sa.local_sliding_window_layout(H, nb),
        "empty q-blocks": lambda nb: np.repeat(
            ((np.eye(nb, dtype=bool) | (np.arange(nb)[None] == 1))
             & (np.arange(nb)[:, None] >= 2))[None], H, axis=0),
    }


def sparse_timing(sa, q, k, v, layout, sl, block, label, err, public=False):
    """The kernel on both routes through the launch helper, in turns (a b b
    a), back to back (cuda_ms) and replayed from a CUDA graph (graph_ms),
    the least of each route's two timings; its bound from this layout's
    live pairs; the plain version; SDPA with the layout as a dense mask;
    and with ``public`` the public op (what a user pays per call: the
    layout's bytes hashed for the compaction cache, the autograd function
    and the launch). Causal."""
    B, S, H, D = q.shape
    sm = D ** -0.5
    out = torch.empty_like(q)
    launch = {r: (lambda route: lambda: sa.launch_sparse_fwd(
        q, k, v, out, sl, causal=True, sm_scale=sm, block=block, route=route))(r)
        for r in ("wgmma", "mma_sync")}
    t = {}
    for c in tuple(launch) + tuple(reversed(tuple(launch))):
        ms = (cuda_ms(launch[c], iters=50), graph_ms(launch[c]))
        t[c] = tuple(map(min, zip(ms, t.get(c, ms))))
    lo = torch.as_tensor(sl.layout, device="cuda")
    mask = lo.repeat_interleave(block, 1).repeat_interleave(block, 2)
    mask &= torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None]
    live = int(sl.cnt.sum())
    nbytes, flops = sparse_work(sl, B, S, H, D, block, q.element_size(), causal=True)
    nbytes += sl.cols.numel() * 4 + sl.cnt.numel() * 4
    b_ms, b_by = bound(nbytes, flops, q.dtype)
    plain = lambda: sa.masked_dense_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), sl.layout, causal=True,
        sm_scale=sm, block_q=block, block_k=block)
    chosen, m = t["wgmma"], t["mma_sync"]
    row = dict(ms=chosen[0], graph_ms=chosen[1], mma_sync_ms=m[0], mma_sync_graph_ms=m[1],
               plain_ms=cuda_ms(plain, iters=3),
               library_ms=cuda_ms(lambda: sdpa_sparse(q, k, v, mask, sm), iters=5),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bytes=nbytes, flops=flops)
    if public:
        row["public_ms"] = cuda_ms(
            lambda: sa.sparse_attention(q, k, v, layout, causal=True, block=block), iters=50)
    log(f"timing sparse_attention_fwd ({label}, bf16, B{B} S{S} H{H} D{D} block{block} "
        f"bigbird causal, {live} live pairs): wgmma {chosen[0]:.4f} ms (graph "
        f"{chosen[1]:.4f}), mma_sync {m[0]:.4f} ms (graph {m[1]:.4f}), bound {b_ms:.4f} ms "
        f"by {b_by} ({nbytes} B, {flops} flop), plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms"
        + (f", public op (host work included) {row['public_ms']:.4f} ms" if public else ""))
    log(f"timing sparse_attention_fwd ({label}) wgmma / mma_sync {chosen[0] / m[0]:.3f} "
        f"(graph {chosen[1] / m[1]:.3f}); wgmma share of its bound {b_ms / chosen[0]:.3f}; "
        f"wgmma / library {chosen[0] / row['library_ms']:.3f}")
    del mask, out
    torch.cuda.empty_cache()
    return row


def sparse_phase(sa, fa):
    """The sparse forward kernel against its plain version (the masked-dense
    attention) at Llama-2-7B's attention widths (B 1, S 4096, H 32, D 128)
    over every layout builder: at block 64 and 16 causal and not, at blocks
    32 and 256 causal; D 64; block 128; D 64 at block 128; fp32 at blocks 64
    and 16; empty q-blocks inside live items at block 16; the widths of
    phi-3-mini (D 96), Pythia-1B (D 256) and Pythia-2.8B (D 80) at blocks
    16 and 64; an all-ones causal layout against the port's flash forward.
    Each case through the public op (one launch, on the route sparse_route
    picks) and forced onto each route through the launch helper (fp32: a
    forced wgmma raises). Timed at bigbird (seed 0), causal, bf16: the main
    shape at blocks 64, 16, 32 and 256, the other widths at block 16."""
    tol = OUT_TOL   # summation order (fp32), one bf16 ulp (bf16; see sparse_err)
    main = {k: SPARSE_MAIN[k] for k in ("B", "S", "H", "D")}
    builders = list(sparse_builders(sa, 1))[:5]
    cases = [(f"{n} causal={c}", n, c, main, 64, torch.bfloat16)
             for n in builders for c in (True, False)]
    cases += [("bigbird D64", "bigbird", True, dict(main, D=64), 64, torch.bfloat16),
              ("bigbird block128", "bigbird", True, main, 128, torch.bfloat16),
              ("bigbird D64 block128", "bigbird", True, dict(main, D=64), 128, torch.bfloat16),
              ("bigbird fp32", "bigbird", True, main, 64, torch.float32)]
    cases += [(f"{n} causal={c}", n, c, main, 16, torch.bfloat16)
              for n in builders for c in (True, False)]
    cases += [(f"{n} causal=True", n, True, main, blk, torch.bfloat16)
              for blk in (32, 256) for n in builders]
    cases += [("bigbird fp32", "bigbird", True, main, 16, torch.float32),
              ("empty q-blocks", "empty q-blocks", True, main, 16, torch.bfloat16)]
    cases += [(f"{w} bigbird", "bigbird", True, shape, blk, torch.bfloat16)
              for w, shape in SPARSE_WIDE.items() for blk in (16, 64)]
    ok, timed = True, {}

    def run(q, k, v, layout, causal, block):
        """The public op, launched once on the route sparse_route picks."""
        nonlocal ok
        sa.reset_launch_counts()
        got = sa.sparse_attention(q, k, v, layout, causal=causal, block=block)
        route = {r: n for r, n in sa.route_counts["sparse_attention_fwd"].items() if n}
        want = "wgmma" if q.dtype == torch.bfloat16 else "mma_sync"
        routed = route == {want: 1} and sa.launch_counts["sparse_attention_fwd"] == 1
        ok &= routed
        return got, f"route {route}{'' if routed else ' (want ' + want + ': FAIL)'}"

    for i, (name, lname, causal, shape, block, dtype) in enumerate(cases):
        B, S, H, D = (shape[x] for x in ("B", "S", "H", "D"))
        layout = sparse_builders(sa, H)[lname](S // block)
        q, k, v = sparse_case(dtype, B, S, H, D, seed=300 + i)
        got, route = run(q, k, v, layout, causal, block)
        sl = sa._compact_layout(layout, causal, q.device)
        want = sa.masked_dense_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), sl.layout, causal=causal,
            sm_scale=D ** -0.5, block_q=block, block_k=block).transpose(1, 2)
        err, ref, good = sparse_err(got, want, dtype)
        forced = []
        # a forced wgmma on fp32 raises (tests/test_torch_cuda.py); not run here
        for r in ("wgmma", "mma_sync") if dtype == torch.bfloat16 else ("mma_sync",):
            out = torch.full_like(q, float("nan"))
            kw = dict(causal=causal, sm_scale=D ** -0.5, block=block, route=r)
            sa.launch_sparse_fwd(q, k, v, out, sl, **kw)
            e, _, within = sparse_err(out, want, dtype)
            good &= within
            forced.append(f"{r} {e:.3e}")
        ok &= good
        empty = int((sl.cnt == 0).sum())
        log(f"parity sparse_attention_fwd {name} H{H} S{S} D{D} block{block} "
            f"{str(dtype)[6:]} ({route}): live pairs {int(sl.cnt.sum())} of "
            f"{H * (S // block) ** 2}, empty q-blocks {empty}, max|o|err={err:.3e} (at |o| {ref:.3f}), "
            f"forced {', '.join(forced)} (tol {tol[dtype]:g} or one bf16 ulp) "
            f"{'ok' if good else 'FAIL'}")
        key = (block, D, H)
        if (lname == "bigbird" and causal and dtype == torch.bfloat16 and key not in timed
                and (block == 16 or shape is main)):
            timed[key] = (q, k, v, layout, sl, err, shape is main)
        del got, want
    # an all-ones causal layout is causal attention: the port's flash forward
    B, S, H = main["B"], main["S"], main["H"]
    q, k, v = sparse_case(torch.bfloat16, B, S, H, 128, seed=399)
    for block in (64, 16):
        ones = np.ones((H, S // block, S // block), bool)
        got, route = run(q, k, v, ones, True, block)
        err, _, good = sparse_err(got, fa.flash_attention_forward(q, k, v, causal=True)[0],
                                  torch.bfloat16)
        ok &= good
        log(f"parity sparse_attention_fwd all-ones causal block{block} vs flash forward "
            f"bf16 ({route}): max|o|err={err:.3e} (tol {tol[torch.bfloat16]:g} or one bf16 "
            f"ulp) {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("sparse kernel parity FAILED (see lines above)")

    rows = {}
    for (block, D, H), (q, k, v, layout, sl, err, is_main) in timed.items():
        label = ("main shape" if is_main else
                 next(w for w, s in SPARSE_WIDE.items() if (s["D"], s["H"]) == (D, H)))
        # the wgmma kernel repeats bitwise (over union tiles below block 64)
        firsts = []
        for _ in range(2):
            out = torch.empty_like(q)
            sa.launch_sparse_fwd(q, k, v, out, sl, causal=True, sm_scale=D ** -0.5,
                                 block=block, route="wgmma")
            torch.cuda.synchronize()
            firsts.append(out)
        bitwise = torch.equal(*firsts)
        log(f"sparse_attention_fwd (wgmma) two launches ({label}, block {block}): "
            f"bitwise equal {bitwise}")
        if not bitwise:
            raise SystemExit("sparse: launches of the wgmma kernel differ")
        del firsts
        rows[block, D, H] = sparse_timing(sa, q, k, v, layout, sl, block, label, err,
                                          public=is_main)
    del timed
    torch.cuda.empty_cache()
    main_row = rows[SPARSE_MAIN["block"], SPARSE_MAIN["D"], SPARSE_MAIN["H"]]
    return {"sparse_attention_fwd": main_row}


def sparse_path_phase(sa, sparse_op):
    """Phase 14: forward and backward through the public entry point
    (``deepspeed_tpu_torch.ops.sparse_attention``), bigbird (seed 0),
    causal, bf16: at the main shape at blocks 64, 16, 32 and 256, and at
    block 16 at the other three widths. The forward launches the kernel
    once per call, on the wgmma route; the backward recomputes through the
    plain version, so with the same cotangent the gradients equal autograd
    through ``masked_dense_attention`` to rounding (tolerance: 1e-3 of the
    largest gradient). Returns the launches, summed over the runs (each
    counted from 0)."""
    main = {k: SPARSE_MAIN[k] for k in ("B", "S", "H", "D")}
    runs = [("Llama-2-7B H32 D128", main, block) for block in (64, 16, 32, 256)]
    runs += [(w, shape, 16) for w, shape in SPARSE_WIDE.items()]
    total = {"sparse_attention_fwd": 0}
    for label, shape, block in runs:
        B, S, H, D = (shape[x] for x in ("B", "S", "H", "D"))
        layout = sa.bigbird_layout(H, S // block, seed=0)
        q, k, v = (x.requires_grad_(True)
                   for x in sparse_case(torch.bfloat16, B, S, H, D, 401))
        w = sparse_case(torch.float32, B, S, H, D, 402)[0]
        sa.reset_launch_counts()
        out = sparse_op(q, k, v, layout, causal=True, block=block)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        launches = dict(sa.launch_counts)
        routes = dict(sa.route_counts["sparse_attention_fwd"])
        ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        sl = sa._compact_layout(layout, True, q.device)
        o_ref = sa.masked_dense_attention(*(x.transpose(1, 2) for x in ref), sl.layout,
                                          causal=True, sm_scale=D ** -0.5, block_q=block,
                                          block_k=block).transpose(1, 2)
        (o_ref.float() * w).sum().backward()
        errs = [(a.grad.float() - b.grad.float()).abs().max().item()
                / max(b.grad.float().abs().max().item(), 1e-30)
                for a, b in zip((q, k, v), ref)]
        finite = all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
        o_err, _, o_ok = sparse_err(out, o_ref, torch.bfloat16)
        good = (finite and max(errs) <= 1e-3 and o_ok
                and launches["sparse_attention_fwd"] == 1
                and routes == {"wgmma": 1, "mma_sync": 0})
        log(f"sparse path ({label}, B{B} S{S} H{H} D{D} block{block} bigbird causal, bf16): "
            f"forward launches {launches['sparse_attention_fwd']} (routes {routes}), "
            f"max|o|err {o_err:.3e}, grads finite {finite}, rel err dq/dk/dv "
            f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol 1e-3) {'ok' if good else 'FAIL'}")
        if not good:
            raise SystemExit("sparse path FAILED")
        total["sparse_attention_fwd"] += launches["sparse_attention_fwd"]
        del q, k, v, w, out, ref, o_ref
        torch.cuda.empty_cache()
    return total


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

    # ZeRO stages 1-3 over two ranks: one launch over a rank's ceil(n / 2)
    # elements, rank 1's shard a view into the flat masters at offset
    # ceil(n / 2), against the plain version and timed
    half = -(-n // 2)
    flat = r(2 * half, 0.02)
    shard, g_s = flat[half:], r(half, 1e-3)
    m_s, v_s, u_s = (torch.zeros_like(g_s) for _ in range(3))
    want = adam.adam_update_ref(g_s, m_s, v_s, shard, 3e-4, 0.9, 0.999, 1e-8, 0.1, True,
                                True, 1)
    adam.multi_tensor_adam([g_s], [m_s], [v_s], [shard], updates=[u_s], **kw)
    shard_rel = max(scaled_err(got, w)[1] for got, w in zip((u_s, m_s, v_s), want))
    del want, u_s
    m_s.zero_()
    v_s.zero_()
    shard_ms = cuda_ms(lambda: adam.multi_tensor_adam([g_s], [m_s], [v_s], [shard], **kw))
    shard_plain = cuda_ms(lambda: adam.adam_update_ref(g_s, m_s, v_s, shard, 3e-4, 0.9, 0.999,
                                                       1e-8, 0.1, True, True, 1),
                          iters=2, warmup=1)
    one = [torch.ones((), device="cuda")]
    shard_lib = (cuda_ms(lambda: torch._fused_adamw_(
        [shard], [g_s], [m_s], [v_s], [], one, lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
        if hasattr(torch, "_fused_adamw_") else None)
    s_bound, s_by = bound(28 * half, 15 * half, torch.float32)
    good = shard_rel <= 1e-6
    log(f"timing fused_adam on a ZeRO shard (rank 1 of 2: {half} elements at offset {half} "
        f"of TinyLlama-1.1B's flat masters, one launch): kernel {shard_ms:.4f} ms, bound "
        f"{s_bound:.4f} ms by {s_by}, plain {shard_plain:.4f} ms, library "
        f"(torch._fused_adamw_) {'n/a' if shard_lib is None else f'{shard_lib:.4f}'} ms; "
        f"max rel err {shard_rel:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
    del flat, shard, g_s, m_s, v_s
    torch.cuda.empty_cache()
    if not good:
        raise SystemExit("fused_adam parity FAILED on a ZeRO shard")
    return {"fused_adam": dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                               bound_by=b_by, max_abs_err=err)}


def host_copy_rate(nbytes: int = 2 << 30) -> float:
    """Bytes per second of one large torch copy in host memory (each byte
    read once and written once, both counted), one of host_ceiling's
    rates. Best of three, after a warm-up."""
    src = torch.ones(nbytes, dtype=torch.uint8)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        dst.copy_(src)
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best


def host_rmw_rate(nbytes: int = 2 << 30) -> float:
    """Bytes per second of an in-place ``a.add_(b)`` over two fp32 tensors of
    ``nbytes`` each on all of torch's host threads, 12 B an element (a and b
    read, a written): a read-modify-write stream, as the host Adam's are
    (its outputs overwrite its inputs, so no write costs the extra read for
    ownership that a copy's destination does). One of host_ceiling's
    rates. Best of three, after a warm-up."""
    a = torch.ones(nbytes // 4)
    b = torch.ones(nbytes // 4)
    a.add_(b)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        a.add_(b)
        best = min(best, time.perf_counter() - t0)
    return 12 * a.numel() / best


#: dstpu_host_stream's kinds: (name, bytes an element)
HOST_STREAMS = (("read", 4), ("a += b", 12), ("host Adam traffic", 30), ("streamed copy", 8))


def host_stream_pass(kind: int, n: int = 1 << 27):
    """A function that runs one pass of ``dstpu_host_stream`` ``kind`` (the
    host Adam library's pool moving bytes with no Adam arithmetic) over
    arrays of ``n`` elements made once, and returns that pass's bytes per
    second."""
    from deepspeed_tpu_torch.ops import adam as host_adam

    lib = host_adam.CPUAdamBuilder().load()
    arrays = [torch.ones(n) for _ in range(4)] + [torch.empty(n, dtype=torch.bfloat16)]

    def run(arrays=arrays) -> float:
        secs = lib.dstpu_host_stream(kind, *(t.data_ptr() for t in arrays), n, 0)
        if secs <= 0:
            raise SystemExit(f"dstpu_host_stream refused kind {kind}")
        return HOST_STREAMS[kind][1] * n / secs

    return run


def host_ceiling() -> tuple:
    """(rate, text): the host's memory ceiling in bytes per second, the
    fastest of the library pool's streams (host_stream_pass: a read, an
    in-place add, the host Adam's own traffic of 30 B an element with its
    bf16 output streamed, a streamed copy; arrays of 512 MiB, the best of
    ten passes after a warm-up each) and torch's in-place ``add_`` and copy.
    None of them is a host kernel of the port, so a kernel is never held to
    a bound it set; a host without avx512 keeps torch's two. Phase 3 times
    the host Adam traffic stream again beside each kernel call."""
    from deepspeed_tpu_torch.ops import adam as host_adam

    rates = {"torch add_ (12 B)": host_rmw_rate(), "torch copy (2 x B)": host_copy_rate()}
    if "avx512" in host_adam.supported_routes():
        for kind, (name, width) in enumerate(HOST_STREAMS):
            run = host_stream_pass(kind)
            rates[f"pool {name} ({width} B)"] = max(run() for _ in range(11))
            del run
    best = max(rates, key=rates.get)
    text = ", ".join(f"{k} {v / 1e9:.1f}" for k, v in rates.items())
    return rates[best], f"{text} GB/s; the ceiling is the {best}'s"


def host_bound(nbytes: float, rate: float, calls) -> tuple:
    """(ms, note): the least time of ``nbytes`` of host memory traffic over
    ``rate`` (host_ceiling's), or over the byte rate of the fastest of
    ``calls`` (``(name, bytes, ms)``: calls that are not the kernel's own,
    the library's and the plain version's) where one ran faster than
    ``rate`` allows; the note then names it."""
    best, note = rate, ""
    for name, b, ms in calls:
        if ms and b / ms * 1e3 > best:
            best = b / ms * 1e3
            note = (f"; {name} ran at {best / 1e9:.1f} GB/s, above the ceiling: the "
                    f"bound is taken from its byte rate")
    return nbytes / best * 1e3, note


def host_ms(fn, iters: int = 2, warmup: int = 1) -> float:
    """Mean host-clock milliseconds of ``fn`` (a host computation)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def host_rounds(calls: dict, rounds: int = 5) -> dict:
    """Host-clock milliseconds of each of ``calls`` (name -> fn), one a
    round, over ``rounds`` rounds that take the calls in turns, the order
    reversed every other round, after one warm-up call each: the host's
    memory is shared with its neighbours, so calls compared are timed side
    by side. The rows take the median."""
    for fn in calls.values():
        fn()
    times = {name: [] for name in calls}
    for r in range(rounds):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            t0 = time.perf_counter()
            calls[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times


#: phase 3's host-Adam parity sizes: every tail length of 8 and 16 lanes,
#: and leaves the pool splits over its threads
HOST_ADAM_SIZES = list(range(1, 33)) + [4097, (1 << 16) + 1, 3 * (1 << 18) + 7]


def host_adam_parity(route: str) -> bool:
    """One route of the host Adam against its plain version bitwise (the
    bits, NaNs included): HOST_ADAM_SIZES, denormal masters, AdamW and L2,
    bias correction on and off, three steps with the bf16 emission, bf16
    gradients in the second and infinite and NaN ones in the third; then
    one library call over a plan of slices at odd offsets against the same
    plan one call a slice, over two steps (fp32, then bf16 gradients)."""
    from deepspeed_tpu_torch.ops import adam as host_adam
    from deepspeed_tpu_torch.ops.adam import (DeepSpeedCPUAdam, bf16_reference,
                                              cpu_adam_reference)

    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    same = lambda x, y: torch.equal(bits(x), bits(y))
    sizes = HOST_ADAM_SIZES
    ok = True
    for adamw in (True, False):
        for bc in (True, False):
            gen = torch.Generator().manual_seed(11)
            ps = [torch.randn(n, generator=gen) for n in sizes]
            for p in ps:
                p[::5], p[1::7] = 1e-40, -3e-39          # denormal masters
            opt = DeepSpeedCPUAdam(ps, lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1,
                                   adamw_mode=adamw, bias_correction=bc, route=route)
            ref = [(p.clone(), torch.zeros_like(p), torch.zeros_like(p)) for p in ps]
            for step in (1, 2, 3):
                gs = [0.1 * torch.randn(n, generator=gen) for n in sizes]
                if step == 3:
                    for g in gs:
                        g[1::9], g[2::13], g[3::17] = math.inf, math.nan, -math.inf
                if step == 2:
                    gs = [g.to(torch.bfloat16) for g in gs]
                out = opt.step(gs, emit_bf16=True)
                ref = [cpu_adam_reference(*r, g, 3e-4, (0.9, 0.95), 1e-8, 0.1, adamw, bc,
                                          step) for r, g in zip(ref, gs)]
            good = all(same(x, y) for got, want in zip(zip(*opt.leaves()), ref)
                       for x, y in zip(got, want))
            good &= all(same(o, bf16_reference(r[0])) for o, r in zip(out, ref))
            ok &= good
            log(f"parity cpu_adam route {route} adamw_mode={adamw} bias_correction={bc}: "
                f"{len(sizes)} leaves of 1-32, 4097, 65537 and 786439 elements, denormal "
                f"masters, 3 steps (bf16 gradients in the second, inf and NaN ones in the "
                f"third), bf16 out: masters, moments and bf16 bitwise the plain version: "
                f"{'ok' if good else 'FAIL'}")
    gen = torch.Generator().manual_seed(12)
    ps = [torch.randn(n, generator=gen) for n in sizes]
    plan = [(i, a, b) for i, n in enumerate(sizes)
            for a, b in zip([0, n // 3 | 1, 2 * n // 3 | 1], [n // 3 | 1, 2 * n // 3 | 1, n])
            if a < b <= n]
    batched, single = (DeepSpeedCPUAdam(ps, lr=3e-4, weight_decay=0.1, route=route)
                       for _ in range(2))
    calls = []
    good = True
    for dtype in (torch.float32, torch.bfloat16):
        gs = [torch.randn(n, generator=gen).to(dtype) for n in sizes]
        outs = [[torch.empty(n, dtype=torch.bfloat16) for n in sizes] for _ in range(2)]
        for opt, o, per_slice in ((batched, outs[0], False), (single, outs[1], True)):
            host_adam.reset_launch_counts()
            opt.begin_step()
            work = [(i, a, b, gs[i][a:b], o[i][a:b]) for i, a, b in plan]
            for chunk in ([[w] for w in work] if per_slice else [work]):
                opt.step_slices(chunk, emit_bf16=True)
            calls.append((host_adam.call_counts["cpu_adam"], host_adam.launch_counts["cpu_adam"]))
        good &= all(same(x, y) for x, y in zip(*outs))
    good &= all(same(x, y) for a, b in zip(batched.leaves(), single.leaves())
                for x, y in zip(a, b))
    good &= calls == [(1, len(plan)), (len(plan), len(plan))] * 2
    log(f"parity cpu_adam route {route}: one library call over {len(plan)} slices at odd "
        f"offsets bitwise {len(plan)} calls of one slice each, 2 steps (fp32, bf16 "
        f"gradients), (calls, launches) {calls}: {'ok' if good else 'FAIL'}")
    return ok and good


def host_adam_phase(rate):
    """The host Adam (ops/csrc/host/cpu_adam.cpp, built with g++ on this
    machine): every route this host runs bitwise its plain version
    (host_adam_parity). Then each route timed over TinyLlama-1.1B's 201
    leaves with fp32 and with bf16 gradients (bf16 out, all of the pool's
    threads) beside torch._fused_adamw_ on the same CPU tensors and the
    bound (30 B an element with fp32 gradients, 28 B with bf16 ones, over
    host_ceiling's ``rate``); on an avx512 host that route against itself
    without its streamed bf16 stores and without its prefetch too. Then the
    widest route over one
    decoder layer's 9 leaves beside the plain version (its float64 fused
    multiply-adds are too slow for the whole tree): the kernels line's
    row. Kernel and library times are medians of host_rounds."""
    from deepspeed_tpu_torch.models import llama_config, param_shapes
    from deepspeed_tpu_torch.ops import adam as host_adam
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, cpu_adam_reference

    routes = host_adam.supported_routes()
    threads = host_adam.CPUAdamBuilder().load().dstpu_cpu_adam_threads()
    log(f"host adam: this host runs the routes {routes}, widest {host_adam.best_route()}; "
        f"a pool of {threads} threads (the CPUs this process may use; os.cpu_count() "
        f"{os.cpu_count()})")
    if not all([host_adam_parity(r) for r in routes]):
        raise SystemExit("cpu_adam parity FAILED")

    def timed(shapes, label, routes, plain, rounds, stores=False):
        sizes = [math.prod(s) for s in shapes]
        n = sum(sizes)
        flat = torch.full((n,), 0.02)
        opt = DeepSpeedCPUAdam(list(torch.split(flat, sizes)), lr=3e-4, weight_decay=0.1)
        del flat
        grads = {torch.float32: list(torch.split(torch.full((n,), 1e-3), sizes))}
        grads[torch.bfloat16] = list(torch.split(torch.full((n,), 1e-3, dtype=torch.bfloat16),
                                                 sizes))
        outs = list(torch.split(torch.empty(n, dtype=torch.bfloat16), sizes))
        p, m, v = opt.leaves()
        steps = [torch.tensor(1.0) for _ in p]

        clib = opt.lib
        ahead = clib.dstpu_cpu_adam_set_prefetch(0)       # the library's distance
        clib.dstpu_cpu_adam_set_prefetch(ahead)

        def kernel(route, dt, stream=1, prefetch=ahead):
            opt.route = route
            clib.dstpu_cpu_adam_set_stream(stream)
            clib.dstpu_cpu_adam_set_prefetch(prefetch)
            try:
                opt.step(grads[dt], emit_bf16=True, out=outs)
            finally:
                clib.dstpu_cpu_adam_set_stream(1)
                clib.dstpu_cpu_adam_set_prefetch(ahead)

        calls = {"library": lambda: torch._fused_adamw_(
            p, grads[torch.float32], m, v, [], steps, lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)}
        calls.update({(r, dt): (lambda r=r, dt=dt: kernel(r, dt)) for r in routes
                      for dt in grads})
        # the avx512 route without each of its two tunings
        variants = {"plain bf16 stores": dict(stream=0), "no prefetch": dict(prefetch=0)}
        if stores:
            calls.update({(f"avx512 {name}", dt): (lambda dt=dt, kw=kw: kernel("avx512", dt, **kw))
                          for name, kw in variants.items() for dt in grads})
        # the host Adam's traffic alone, in the same rounds: the ceiling
        # where it runs faster than it did before the phase
        ceiling = []
        if "avx512" in host_adam.supported_routes():
            traffic = host_stream_pass(2)
            calls["ceiling"] = lambda: ceiling.append(traffic())
        each = host_rounds(calls, rounds)
        each.pop("ceiling", None)
        row_rate = max([rate] + ceiling)
        times = {k: float(np.median(t)) for k, t in each.items()}
        lib = times.pop("library")
        plain_ms = (host_ms(lambda: [cpu_adam_reference(*a, 3e-4, weight_decay=0.1)
                                     for a in zip(p, m, v, grads[torch.float32])],
                            iters=1, warmup=0) if plain else None)
        width = {torch.float32: 30, torch.bfloat16: 28}   # B an element: p m v g in, p m v out
        others = [("torch._fused_adamw_", 28 * n, lib)]
        if plain:
            others.append(("the plain version", 30 * n, plain_ms))
        rows = {}
        for (route, dt), ms in times.items():
            if route not in routes:
                continue
            nbytes = width[dt] * n
            b_ms, note = host_bound(nbytes, row_rate, others)
            log(f"timing cpu_adam route {route} ({label}: {len(shapes)} leaves, {n} elements, "
                f"{str(dt)[6:]} gradients, bf16 out, {threads} threads): kernel {ms:.2f} ms "
                f"({nbytes / ms / 1e6:.1f} GB/s), bound {b_ms:.2f} ms by bytes ({nbytes} B at "
                f"the measured {row_rate / 1e9:.1f} GB/s, the faster of the ceiling before "
                f"the phase and the host Adam traffic stream's best in these rounds "
                f"{max(ceiling, default=0) / 1e9:.1f}{note}), {b_ms / ms:.2f} of the bound"
                + (" (the kernel ran ABOVE the host's measured ceiling)" if ms < b_ms else "")
                + f"; library (torch._fused_adamw_, CPU, fp32 gradients, no bf16 out) "
                f"{lib:.2f} ms, kernel / library {ms / lib:.2f}"
                + (f", plain {plain_ms:.2f} ms" if plain else ""))
            rows[route, dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                                   bound_by="bytes", max_abs_err=0.0)
        for name in variants if stores else ():
            for dt in grads:
                kept, other = each["avx512", dt], each[f"avx512 {name}", dt]
                log(f"timing cpu_adam avx512 against {name} ({label}, {str(dt)[6:]} "
                    f"gradients, {rounds} rounds side by side; streamed stores and a prefetch "
                    f"{ahead} elements ahead kept): kept {np.median(kept):.2f} ms (range "
                    f"{min(kept):.2f}-{max(kept):.2f}), {name} {np.median(other):.2f} ms "
                    f"(range {min(other):.2f}-{max(other):.2f}), kept / {name} "
                    f"{np.median(kept) / np.median(other):.3f}, kept faster in "
                    f"{sum(x < y for x, y in zip(kept, other))} of {rounds} rounds")
        return rows

    shapes = param_shapes(llama_config("1b"))
    timed(list(shapes.values()), "TinyLlama-1.1B", routes, plain=False, rounds=7,
          stores="avx512" in routes)
    layer = [s for k, s in shapes.items() if k.startswith("layer_0/")]
    best = host_adam.best_route()
    rows = timed(layer, "one TinyLlama-1.1B layer", [best], plain=True, rounds=15)
    return {"cpu_adam": rows[best, torch.float32]}


def aio_phase(rate):
    """The aio pool (ops/csrc/host/aio.cpp) on 256 MiB under build/, page
    cache warm: first the split, write-only and read-only at 1, 2, 4 and 8
    workers and at 1 MiB and 8 MiB blocks beside the plain version's write
    and read (one thread of os.pwrite / os.preadv); then the kernels line's
    row, a write and a read back on 8 workers and 1 MiB blocks, bitwise,
    beside the plain version's, torch.save then torch.load of the same
    tensor in the same directory (the library call), and the bound: the
    round trip's two copies read and write every byte once each (4 x 256
    MiB) over ``rate``. The row's three times are medians of host_rounds."""
    import shutil

    from deepspeed_tpu_torch.ops import aio

    workdir = REPO / "build" / "aio_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    nbytes = 256 << 20
    src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(12))
    dst = torch.empty_like(src)
    path = str(workdir / "x.bin")

    def write(h):
        assert h.pwrite(src, path) == nbytes

    def read(h):
        assert h.pread(dst, path) == nbytes

    plain_w = host_ms(lambda: aio.plain_pwrite(src, path), iters=3)
    plain_r = host_ms(lambda: aio.plain_pread(dst, path), iters=3)
    good = torch.equal(dst, src)
    split = []
    for block in (1 << 20, 8 << 20):
        for workers in (1, 2, 4, 8):
            h = aio.AsyncIOHandle(num_threads=workers, block_size=block)
            split.append((workers, block >> 20, host_ms(lambda: write(h), iters=3),
                          host_ms(lambda: read(h), iters=3)))
            h.close()
    log("timing aio split (256 MiB, page cache warm; ms written / read): plain (one thread) "
        f"{plain_w:.2f} / {plain_r:.2f}; "
        + "; ".join(f"{w} workers {b} MiB blocks {wr:.2f} / {rd:.2f}"
                    for w, b, wr, rd in split))
    h = aio.AsyncIOHandle(num_threads=8, block_size=1 << 20)
    dst.zero_()
    write(h)
    read(h)
    good &= torch.equal(dst, src)
    dst.zero_()
    lib_path = str(workdir / "x.pt")
    loaded = []
    times = host_rounds({
        "aio": lambda: (write(h), read(h)),
        "plain": lambda: (aio.plain_pwrite(src, path), aio.plain_pread(dst, path)),
        "library": lambda: (torch.save(src, lib_path), loaded.append(torch.load(lib_path)))})
    ms, plain_ms, lib_ms = (float(np.median(times[k])) for k in ("aio", "plain", "library"))
    good &= torch.equal(dst, src) and torch.equal(loaded[-1], src)
    h.close()
    del loaded
    shutil.rmtree(workdir, ignore_errors=True)
    traffic = 4 * nbytes
    b_ms, note = host_bound(traffic, rate, [("the plain version", traffic, plain_ms),
                                            ("torch.save + torch.load", traffic, lib_ms)])
    log(f"timing aio (256 MiB written then read back, 8 workers, 1 MiB blocks, page cache "
        f"warm): kernel {ms:.2f} ms, plain (one thread) {plain_ms:.2f} ms, kernel / plain "
        f"{ms / plain_ms:.2f} (8 workers no slower than one thread: "
        f"{'yes' if ms <= plain_ms else 'NO'}), library (torch.save + torch.load) "
        f"{lib_ms:.2f} ms, bound {b_ms:.2f} ms by bytes (1 GiB at {rate / 1e9:.1f} GB/s"
        f"{note}); read back bitwise: {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("aio round trip FAILED")
    return {"aio": dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by="bytes", max_abs_err=0.0)}


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
        kvt, base = fl._layout(k)
        route = fl.loss_route(h, base)       # the forward's and the backward's
        fl.reset_launch_counts()
        lse, tgt = fl.fused_nll_forward(h, k, t)
        fwd_routed = dict(fl.fwd_route_counts)
        lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, t)
        g_lse, g_tgt = loss_cotangents(lse_r, shape["T"], z, masked, seed=300 + i)
        if no_tgt:
            g_tgt = torch.zeros_like(g_tgt)
        vc = fl.chunk_width(shape["T"], shape["V"], h.element_size())
        n_chunks = -(-shape["V"] // vc)
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
        # every launch took the route the wrapper chose
        good &= routed[route] == 3 * n_chunks and sum(routed.values()) == 3 * n_chunks
        good &= fwd_routed[route] == 1 and sum(fwd_routed.values()) == 1
        ok &= good
        log(f"parity fused_loss {name} {str(dtype)[6:]} T{shape['T']} E{shape['E']} "
            f"V{shape['V']} (route {route}: forward {fwd_routed}, backward {routed}; "
            f"dl chunk {v0}+{width}): "
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

    forward = lambda route: (lambda: fl.fused_nll_forward(h, k, t, route=route))
    passes = {"fused_loss_fwd": forward("wgmma"), **backward_passes("wgmma")}
    # the other route of every kernel at the same shape, in the same run
    mma_sync_ms = {name: cuda_ms(fn, iters=10)
                   for name, fn in {"fused_loss_fwd": forward("mma_sync"),
                                    **backward_passes("mma_sync")}.items()}
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
        log(f"timing {name} (bf16, T{T} E{E} V{V}{'' if fwd else f', {n} chunks of {vc}'}): "
            f"kernel on the wgmma route {r['ms']:.4f} ms ({gemm / r['ms'] / 1e9:.1f} "
            f"TFLOP/s), bound {b_ms:.4f} ms by {b_by} ({io[name]} B, {gemm} flop), plain "
            f"{r['plain_ms']:.4f} ms, library composite {r['library_ms']:.4f} ms")
        ms = mma_sync_ms[name]
        log(f"timing {name} on the mma_sync route: {ms:.4f} ms "
            f"({gemm / ms / 1e9:.1f} TFLOP/s); wgmma / mma_sync {r['ms'] / ms:.3f}")
    bwd_names = [name for name in mma_sync_ms if name != "fused_loss_fwd"]
    wg_sum = sum(rows[name]["ms"] for name in bwd_names)
    ms_sum = sum(mma_sync_ms[name] for name in bwd_names)
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
                n_requests=16, new_tokens=128, name="Llama-2-7B", cfg=None):
    """Serve ``n_requests`` seeded prompts (lengths 128..1024) for
    ``new_tokens`` each through ``LLMServer`` at the widths of ``name``
    (``cfg``; default Llama-2-7B) with the KV storage ``kv``
    (``kv_cache_dtype``). Kernel launch counts are reset just before and
    read just after the run. Gates: every request finishes by length with
    in-vocabulary tokens, the server drains, KV conservation holds. Returns
    what the run measured."""
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, LLMServer, Request

    acc = get_accelerator()
    over = {} if num_layers is None else {"num_layers": num_layers}
    cfg = (llama_config("7b", dtype=torch.bfloat16, **over) if cfg is None
           else dataclasses.replace(cfg, **over))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = InferenceEngineV2(
        cfg, params, RaggedInferenceEngineConfig(**SLICE, kv_cache_dtype=kv),
        device="cuda")
    acc.synchronize()
    tag = f"slice[{name}, kv {kv or 'bf16'}]"
    log(f"{tag}: {name} widths (hidden {cfg.hidden_size}, {cfg.num_layers} "
        f"layers, {cfg.num_heads}/{cfg.kv_heads} heads of D {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), bf16 seeded weights, "
        f"KV pool {engine.kv.k.dtype} "
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
    routes = {n: dict(r) for n, r in pa.route_counts.items()}
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
        f"{cfg.num_layers} layers), routes {routes}")
    log(f"{tag} [{card}]: {tokens / wall:.1f} generated tok/s over {wall:.2f} s, "
        f"TTFT p50 {snap['ttft']['p50_ms']:.1f} ms p99 "
        f"{snap['ttft']['p99_ms']:.1f} ms (mean {np.mean(ttft) * 1e3:.1f} ms), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if profile:
        device_time_breakdown(trace, wall)
    if not (all(finished) and drained and in_vocab and conserved):
        raise SystemExit(f"{tag} FAILED")
    out = dict(launches=launches, routes=routes, peak=peak, first=[r.tokens[0] for r in resps],
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
    int8_routes = run["routes"]["paged_flash_decode_int8"]
    checks = {
        "int8 decode kernel launched": launches["paged_flash_decode_int8"] > 0,
        "every int8 decode launch on sm90, a whole number per layer":
            (int8_routes == {"sm90": launches["paged_flash_decode_int8"], "cuda_core": 0}
             and launches["paged_flash_decode_int8"] % cfg.num_layers == 0),
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


def wide_serving_phase(pa, card, models, profile=False):
    """Phase 16: phi-3-mini-4k (head dim 96) and Pythia-1B (256) served at
    their published sizes through ``slice_phase`` (16 requests, 128 new
    tokens each, 1024 KV blocks of 32 slots), with phase 4's gates and
    theirs: both paged kernels launch, every launch on ``sm90``, a whole
    number per layer, and the engine resolves the kernels on both paths by
    its heuristic. Returns each model's launches."""
    out = {}
    for name in ("phi-3-mini", "Pythia-1B"):
        run = slice_phase(pa, card, profile=profile, name=name, cfg=models[name])
        layers = run["cfg"].num_layers
        checks = {"engine resolves pallas / pallas (heuristic)":
                  run["resolution"] == ("pallas", "pallas", "heuristic")}
        for kernel in ("paged_attention", "paged_flash_decode"):
            n = run["launches"][kernel]
            checks[f"{kernel} launched {n} times, all on sm90, a whole number per layer"] = (
                n > 0 and n % layers == 0
                and run["routes"][kernel] == {"sm90": n, "cuda_core": 0})
        log(f"serving {name} (D {run['cfg'].head_dim}): " + ", ".join(
            f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        if not all(checks.values()):
            raise SystemExit(f"serving {name} FAILED")
        out[name] = run["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 5: kernel path vs einsum path through the model functions
# ---------------------------------------------------------------------------


def path_phase(cfg=None, name="Llama-2-7B"):
    """Phase 5 (Llama-2-7B widths at 4 layers) and 17 (``cfg``): one packed
    step and one fused decode step / chunk through the kernel path (every
    paged launch on ``sm90``, once per layer), the einsum path in bf16 and
    the einsum path in float32 on identical pools; the kernel path's logits
    within ``NOISE_FACTOR`` x the einsum path's distance from float32."""
    from deepspeed_tpu_torch.inference.v2 import model
    from deepspeed_tpu_torch.inference.v2.ragged import RaggedBatchWrapper
    from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
        DSSequenceDescriptor
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    if cfg is None:
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
    pools, packed, sm90 = {}, {}, {}
    for run, (impl, c, p) in runs.items():
        kk, vv = k0.to(c.dtype, copy=True), v0.to(c.dtype, copy=True)
        pa.reset_launch_counts()
        packed[run], _, _ = model.ragged_forward(
            p, c, kk, vv, *[t(getattr(batch, f)) for f in fields],
            attn_impl=impl)
        sm90[run] = pa.route_counts["paged_attention"]["sm90"]
        pools[run] = (kk, vv)
    dist = lambda a, b: (packed[a] - packed[b]).abs().max().item()
    d_logits, noise = dist("kernel", "einsum"), dist("einsum", "fp32")
    agree = (packed["kernel"].argmax(-1) == packed["einsum"].argmax(-1)
             ).float().mean().item()
    tag = f"{name} widths, {cfg.num_layers} layers, D {cfg.head_dim}"
    log(f"path parity packed step ({tag}, 8 seqs, ctx 100..900): "
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
    for run, (impl, c, p) in runs.items():
        kk, vv = pools[run]
        wk = torch.zeros((c.num_layers, W, S, c.kv_heads, c.head_dim),
                         dtype=c.dtype, device=dev)
        wv = torch.zeros_like(wk)
        pa.reset_launch_counts()
        step_logits[run] = model.decode_step(p, c, kk, vv, wk, wv, first,
                                             pos0, pos0, bt, active, 0, impl)
        sm90[run] = (sm90[run], pa.route_counts["paged_flash_decode"]["sm90"])
        toks[run], _, _ = model.decode_loop(p, c, kk, vv, first, pos0, bt,
                                            active, None, 1.0, n_steps=W,
                                            attn_impl=impl)
    sdist = lambda a, b: (step_logits[a] - step_logits[b]).abs().max().item()
    d_step, step_noise = sdist("kernel", "einsum"), sdist("einsum", "fp32")
    tok_agree = lambda a, b: (toks[a] == toks[b]).float().mean().item()
    log(f"path parity decode step ({tag}): max|dlogits| kernel-einsum={d_step:.3e}, "
        f"einsum-fp32={step_noise:.3e}, kernel-fp32={sdist('kernel', 'fp32'):.3e}; "
        f"decode_loop {W} greedy steps, token agreement kernel-einsum "
        f"{tok_agree('kernel', 'einsum'):.3f}, kernel-fp32 "
        f"{tok_agree('kernel', 'fp32'):.3f}, einsum-fp32 "
        f"{tok_agree('einsum', 'fp32'):.3f}")
    # the kernel path ran each kernel once per layer on sm90; the others none
    launched = sm90 == {"kernel": (cfg.num_layers, cfg.num_layers), "einsum": (0, 0),
                        "fp32": (0, 0)}
    log(f"path parity ({tag}): sm90 launches of the packed and decode kernel by run "
        f"{sm90} {'ok' if launched else 'FAIL'}")
    if d_logits > NOISE_FACTOR * noise or d_step > NOISE_FACTOR * step_noise or not launched:
        raise SystemExit(f"path parity FAILED ({tag})")
    del pools, runs, params
    torch.cuda.empty_cache()


def int8_path_phase(cfg=None, name="Llama-2-7B"):
    """Phase 13 (Llama-2-7B widths) and 17 (``cfg``): the int8 pools'
    decode through the model functions at 2 layers, seeded weights:
    ``decode_step`` and a 16-step ``decode_loop`` on the kernel path (the
    decode kernel's int8 mode, every launch on ``sm90``), the einsum path
    (gather + dequantize) in bf16, and the einsum path in float32, each on
    its own copy of the same int8 pools. The kernel path's logits must sit
    within twice the einsum path's distance from float32."""
    from deepspeed_tpu_torch.inference.v2 import model
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    cfg = (llama_config("7b", num_layers=2, dtype=torch.bfloat16) if cfg is None
           else dataclasses.replace(cfg, num_layers=2))
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
    for run, (impl, c, p) in runs.items():
        wk = torch.zeros((c.num_layers, W, S, c.kv_heads, c.head_dim), dtype=c.dtype,
                         device=dev)
        step_logits[run] = model.decode_step(p, c, copy(kp), copy(vp), wk,
                                             torch.zeros_like(wk), first, pos0, pos0,
                                             bt, active, 0, impl)
        pa.reset_launch_counts()
        toks[run], _, _ = model.decode_loop(p, c, copy(kp), copy(vp), first, pos0, bt,
                                            active, None, 1.0, n_steps=W,
                                            attn_impl=impl)
        pa_counts[run] = pa.route_counts["paged_flash_decode_int8"]["sm90"]
    sdist = lambda a, b: (step_logits[a] - step_logits[b]).abs().max().item()
    d_step, noise = sdist("kernel", "einsum"), sdist("einsum", "fp32")
    agree = lambda a, b: (toks[a] == toks[b]).float().mean().item()
    good = d_step <= NOISE_FACTOR * noise and pa_counts["kernel"] == W * cfg.num_layers
    log(f"int8 path parity decode step ({name} widths, 2 layers, D {cfg.head_dim}, 8 seqs, "
        f"ctx 100..1900): "
        f"max|dlogits| kernel-einsum={d_step:.3e}, einsum-fp32={noise:.3e}, "
        f"kernel-fp32={sdist('kernel', 'fp32'):.3e} (need kernel-einsum <= "
        f"{NOISE_FACTOR:g} x einsum-fp32); decode_loop {W} greedy steps: int8 kernel "
        f"launches on sm90 {pa_counts['kernel']}, token agreement kernel-einsum "
        f"{agree('kernel', 'einsum'):.3f}, kernel-fp32 {agree('kernel', 'fp32'):.3f}, "
        f"einsum-fp32 {agree('einsum', 'fp32'):.3f} {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit(f"int8 path parity FAILED ({name} widths)")
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

# EleutherAI/pythia-1b config.json, mapped field by field as the JAX
# package's inference/hf.py maps gpt_neox: hidden_size 2048,
# num_hidden_layers 16, num_attention_heads 8 (head dim 256),
# intermediate_size 8192, vocab_size 50304, rotary_pct 0.25,
# rotary_emb_base 10000, use_parallel_residual, layer_norm_eps 1e-5,
# hidden_act gelu, untied embed_out; LayerNorm and projections with biases
PYTHIA_1B = dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192, num_layers=16,
                 num_heads=8, max_seq_len=2048, norm="layernorm", activation="gelu",
                 position="rope", rope_theta=10000.0, rotary_pct=0.25, norm_eps=1e-5,
                 parallel_residual=True, tie_embeddings=False)
# EleutherAI/pythia-2.8b: the same family at hidden 2560, 32 layers, 32
# heads (head dim 80), intermediate 10240
PYTHIA_2P8B = dict(PYTHIA_1B, hidden_size=2560, intermediate_size=10240, num_layers=32,
                   num_heads=32)
# microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32 layers, 32 /
# 32 heads (head dim 96), intermediate 8192 (silu-gated), vocab 32064,
# rms_norm_eps 1e-5, rope theta 10000, untied lm_head, no biases
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_layers=32,
                 num_heads=32, num_kv_heads=32, max_seq_len=4096, norm="rmsnorm",
                 activation="swiglu", position="rope", rope_theta=10000.0, norm_eps=1e-5,
                 tie_embeddings=False)


def train_models():
    """The models the training phases drive, by name: TinyLlama-1.1B (phase
    6) and Pythia-1B (phase 15) at full size, and the widths of phase 7's
    parity runs."""
    from deepspeed_tpu_torch.models import TransformerConfig, llama_config

    return {"TinyLlama-1.1B": llama_config("1b", dtype=torch.bfloat16),
            "Pythia-1B": TransformerConfig(**PYTHIA_1B, dtype=torch.bfloat16),
            "Pythia-2.8B": TransformerConfig(**PYTHIA_2P8B, dtype=torch.bfloat16),
            "phi-3-mini": TransformerConfig(**PHI3_MINI, dtype=torch.bfloat16)}


def train_flops(cfg, n_matmul, tokens, seq):
    """Model flops of one step: 6 * N_matmul * tokens (the LM head counted
    in N once: the fused loss's recompute of the logits is not model flop;
    the embedding gather not counted), plus causal attention:
    QK^T and PV are 4 * D flops per visible (query, key) pair and head in
    the forward, 3x that forward and backward."""
    pairs_per_seq = seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.head_dim * cfg.num_heads * cfg.num_layers * pairs_per_seq
    return 6 * n_matmul * tokens + attn * (tokens // seq)


@contextlib.contextmanager
def timed_updates(engine):
    """Within the block the engine's optimizer step (``_update``) runs
    between CUDA events: the yielded list gets one (start, end) pair a
    step. The wrapper goes on exit (it holds the engine: left in place, the
    cycle would keep a deleted engine's memory until a collection)."""
    marks, update = [], engine._update

    def timed(grads, params):
        start = _cuda_event()
        update(grads, params)
        marks.append((start, _cuda_event()))

    engine._update = timed
    try:
        yield marks
    finally:
        del engine._update


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def updates_ms(marks, skip: int) -> float:
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in marks[skip:]]))


#: phase 6's figures (step time, tokens/s, MFU, peak memory, optimizer ms a
#: step) by model, beside which phase 20 prints LAMB's
TRAIN_FIGURES = {}


def train_phase(kernels, card, name, cfg, profile=False):
    """A model (``name``, ``cfg``: TinyLlama-1.1B in phase 6, Pythia-1B in
    phase 15) through initialize + train_batch, the optimizer and schedule
    from the config (AdamW takes the fused Adam kernel on the card),
    ``loss_impl: auto`` (the fused loss kernels on the card); the optimizer
    step timed with CUDA events."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn

    tag = f"train {name}"
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
    log(f"{tag}: {name} (hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.kv_heads} heads, D {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), {n_params} parameters, bf16 "
        f"over fp32 masters, micro {micro} x {TRAIN_SEQ} tokens, gas {gas}; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset_launch_counts()
    losses, times = [], []
    with timed_updates(engine) as marks:
        for step in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            losses.append(float(loss))          # waits for the step's device work
            times.append(time.perf_counter() - t0)
    opt_ms = updates_ms(marks, WARMUP_STEPS)
    launches = {}
    for k in kernels:
        launches.update(k.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = gas * micro * TRAIN_SEQ
    step_s = float(np.mean(times[WARMUP_STEPS:]))
    flops = train_flops(cfg, n_matmul, tokens, TRAIN_SEQ)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"{tag}: losses {[round(x, 4) for x in losses]}")
    log(f"{tag}: step times (s) {[round(x, 4) for x in times]}")
    log(f"{tag} [{card}]: {step_s * 1e3:.1f} ms/step over {TIMED_STEPS} timed steps, "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} ({flops:.4e} model flop/step: "
        f"6 x {n_matmul} matmul params x {tokens} tokens + causal attention; over "
        f"989 TFLOP/s bf16), max_memory_allocated {peak / 2**30:.2f} GiB, optimizer "
        f"step {opt_ms:.2f} ms (CUDA events around _update)")
    TRAIN_FIGURES[name] = dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s, mfu=mfu,
                               peak_gib=peak / 2**30, opt_ms=opt_ms)
    log(f"{tag}: kernel launches {launches}")
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width

    loss_chunks = -(-cfg.vocab_size // chunk_width(micro * TRAIN_SEQ, cfg.vocab_size, 2))
    steps = WARMUP_STEPS + TIMED_STEPS
    want = {n: cfg.num_layers * gas * steps for n in
            ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    want["fused_adam"] = steps
    want["fused_loss_fwd"] = want["fused_loss_fwd_combine"] = gas * steps
    for n in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[n] = gas * steps * loss_chunks
    bad = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if bad:
        raise SystemExit(f"{tag}: launch counts off (got, want): {bad}; flash: {cfg.num_layers} "
                         f"layers x gas {gas} x {steps} steps; fused loss (and its "
                         f"forward's combine): gas x steps "
                         f"(x {loss_chunks} vocab chunks in the backward); Adam: one per step")
    # every launch of the redesigned kernels took the wgmma route
    from deepspeed_tpu_torch.ops import flash_attention, fused_loss

    routes = {"flash forward": (dict(flash_attention.route_counts["flash_attention_fwd"]),
                                want["flash_attention_fwd"]),
              "flash dK/dV": (dict(flash_attention.route_counts["flash_attention_bwd_dkdv"]),
                              want["flash_attention_bwd_dkdv"]),
              "flash dQ": (dict(flash_attention.route_counts["flash_attention_bwd_dq"]),
                           want["flash_attention_bwd_dq"]),
              "fused-loss forward": (dict(fused_loss.fwd_route_counts), want["fused_loss_fwd"]),
              "fused-loss backward": (dict(fused_loss.route_counts),
                                      3 * want["fused_loss_dlogits"])}
    log(f"{tag}: routes {routes}")
    bad = {n: r for n, (r, w) in routes.items() if r != {"wgmma": w, "mma_sync": 0}}
    if bad:
        raise SystemExit(f"{tag}: launches off the wgmma route: {bad}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{tag}: a loss is not finite")
    if not losses[-1] < losses[WARMUP_STEPS]:
        raise SystemExit(f"{tag}: the loss did not fall over the timed steps")
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


def train_parity_phase(name, full):
    """Two train_batch steps on ``name``'s widths (``full``, cut to 2
    layers) through the
    kernel path (flash, fused loss and Adam kernels, bf16), the plain path
    (plain attention, dense loss and Adam, bf16) and the plain path in
    float32 (TF32 off), from
    the same weights and batch. The kernel path's loss, gradient norm and
    weight updates must sit within NOISE_FACTOR x the plain path's own
    distance from float32 (updates by their L2 norm over all weights), and
    its flash launches must be counted exactly (2 layers x gas 2 x 2 steps
    of each kernel), all on ``wgmma``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn
    from deepspeed_tpu_torch.models.convert import _flatten
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.optimizers import fused_adam

    base = dataclasses.replace(full, num_layers=2)
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
    for run, (attn, use_kernel, dtype) in runs.items():
        cfg = dataclasses.replace(base, attn_impl=attn, dtype=dtype,
                                  loss_impl="fused" if use_kernel else "xla")
        params = _cast(init, torch.float32, copy=True)   # each run trains its own
        engine, *_ = dst.initialize(
            model=make_loss_fn(TransformerLM(cfg, params)), model_parameters=params,
            optimizer=(fused_adam(lr=3e-4, weight_decay=0.1, use_pallas=True) if use_kernel
                       else plain_adamw(3e-4, 0.1)),
            config=dict(config, bf16={"enabled": dtype == torch.bfloat16}))
        losses, norms = [], []
        fa.reset_launch_counts()
        for b in batches:
            losses.append(float(engine.train_batch(b)))
            norms.append(engine.get_global_grad_norm())
        if use_kernel:
            want = base.num_layers * config["gradient_accumulation_steps"] * len(batches)
            routes = {n: dict(fa.route_counts[n]) for n in fa.launch_counts}
            log(f"train path parity ({name} widths): flash launches {dict(fa.launch_counts)}, "
                f"routes {routes}; want {want} of each, all on wgmma")
            if any(r != {"wgmma": want, "mma_sync": 0} for r in routes.values()):
                raise SystemExit(f"train path parity ({name} widths): flash launches off")
        delta = torch.cat([(v - p0[k]).flatten() for k, v in
                           _flatten(engine.state.params).items()])
        out[run] = (np.array(losses), np.array(norms), delta)
        del engine, params
        torch.cuda.empty_cache()
    dl = lambda a, b: np.abs(out[a][0] - out[b][0]).max()
    dn = lambda a, b: np.abs(out[a][1] - out[b][1]).max()
    du = lambda a, b: (out[a][2] - out[b][2]).norm().item()
    log(f"train path parity ({name} widths, D {base.head_dim}, 2 layers, 2 steps): "
        f"losses kernel {out['kernel'][0]}, plain {out['plain'][0]}, fp32 {out['fp32'][0]}; "
        f"|dloss| kernel-plain={dl('kernel', 'plain'):.3e} plain-fp32={dl('plain', 'fp32'):.3e}; "
        f"|dgrad_norm| kernel-plain={dn('kernel', 'plain'):.3e} "
        f"plain-fp32={dn('plain', 'fp32'):.3e}; ||dupdate|| kernel-plain="
        f"{du('kernel', 'plain'):.3e} plain-fp32={du('plain', 'fp32'):.3e} "
        f"(||update|| {out['fp32'][2].norm().item():.3e}); need kernel-plain <= "
        f"{NOISE_FACTOR:g} x plain-fp32 on each")
    for d in (dl, dn, du):
        if d("kernel", "plain") > NOISE_FACTOR * d("plain", "fp32"):
            raise SystemExit(f"train path parity FAILED ({name} widths)")


def offload_parity_phase():
    """2 layers of TinyLlama widths (micro 2 x 2048, gas 2, clipping 1.0,
    AdamW lr 3e-4 and weight decay 0.1 from the config, the fused loss), 3
    steps from one seed and batch: the device path (the fused Adam kernel)
    in bf16 and in float32 (TF32 off), the host-Adam tier (offload_optimizer
    cpu) with fp32 and with bf16 transport, and the storage tier (a
    caller's fused_adam with offload_optimizer cpu). Each host run's
    losses, gradient norms and master updates must sit within NOISE_FACTOR
    x the device path's own distance from float32, and launch the host
    Adam once a slice of the ring's walk a step and fused Adam never; the storage tier must be
    bitwise the device path, with one fused-Adam launch a step and its
    state in pinned host memory."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import adam as host_adam
    from deepspeed_tpu_torch.ops import fused_adam as adam
    from deepspeed_tpu_torch.ops.optimizers import fused_adam

    base = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    init = init_params(base, seed=13, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    batches = [torch.randint(0, base.vocab_size, (2, 2, TRAIN_SEQ), generator=gen,
                             device="cuda") for _ in range(3)]
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0, "steps_per_print": 10**9,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
              "bf16": {"enabled": True}, "training_fastpath": {"loss_impl": "auto"}}
    cpu = {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}
    runs = {"device": (config, False),
            "fp32": (dict(config, bf16={"enabled": False}), False),
            "host": (dict(config, **cpu), False),
            "host bf16 transport": (dict(config, zero_optimization={"offload_optimizer": {
                "device": "cpu", "grad_dtype": "bfloat16"}}), False),
            "storage": (dict(config, **cpu), True)}
    out = {}
    for name, (cfg_dict, caller) in runs.items():
        dtype = torch.bfloat16 if cfg_dict["bf16"]["enabled"] else torch.float32
        cfg = dataclasses.replace(base, dtype=dtype)
        params = _cast(init, torch.float32, copy=True)
        engine, *_ = dst.initialize(
            model=make_loss_fn(TransformerLM(cfg, params)), model_parameters=params,
            config=cfg_dict,
            optimizer=fused_adam(lr=3e-4, weight_decay=0.1) if caller else None)
        adam.reset_launch_counts()
        host_adam.reset_launch_counts()
        losses, norms = [], []
        for b in batches:
            losses.append(float(engine.train_batch(b)))
            norms.append(engine.get_global_grad_norm())
        masters = (engine._host_adam.leaves()[0] if engine._host_adam is not None
                   else engine._masters)
        delta = torch.cat([(m.to("cuda") - p0).flatten() for m, p0 in
                           zip(masters, torch.utils._pytree.tree_leaves(init))])
        state_home = {str(t.device) + (" pinned" if t.is_pinned() else "") for t in
                      torch.utils._pytree.tree_leaves(engine.state.opt_state)
                      if isinstance(t, torch.Tensor)}
        out[name] = dict(losses=np.array(losses), norms=np.array(norms), delta=delta,
                         fused=adam.launch_counts["fused_adam"],
                         host=host_adam.launch_counts["cpu_adam"],
                         calls=host_adam.call_counts["cpu_adam"],
                         slices=(sum(len(c) for c in engine._ring_plan)
                                 if engine._host_adam is not None else 0),
                         state=state_home)
        log(f"offload parity {name}: losses {losses}, grad norms {norms}, fused Adam "
            f"launches {out[name]['fused']}, host Adam launches {out[name]['host']} in "
            f"{out[name]['calls']} library calls, "
            f"optimizer state on {sorted(state_home)}")
        del engine, params, masters
        torch.cuda.empty_cache()
    dl = lambda a, b: np.abs(out[a]["losses"] - out[b]["losses"]).max()
    dn = lambda a, b: np.abs(out[a]["norms"] - out[b]["norms"]).max()
    du = lambda a, b: (out[a]["delta"] - out[b]["delta"]).norm().item()
    ok = True
    for name in ("host", "host bf16 transport"):
        r = out[name]
        good = (all(d(name, "device") <= NOISE_FACTOR * d("device", "fp32")
                    for d in (dl, dn, du))
                and r["fused"] == 0 and r["host"] == len(batches) * r["slices"])
        ok &= good
        log(f"offload parity {name} vs device (TinyLlama widths, 2 layers, 3 steps): "
            f"|dloss| {dl(name, 'device'):.3e}, |dgrad_norm| {dn(name, 'device'):.3e}, "
            f"||dupdate|| {du(name, 'device'):.3e}; device-fp32 {dl('device', 'fp32'):.3e}, "
            f"{dn('device', 'fp32'):.3e}, {du('device', 'fp32'):.3e}; need <= "
            f"{NOISE_FACTOR:g}x on each, no fused-Adam launch, {r['slices']} host launches "
            f"a step (a slice of the ring's walk each): {'ok' if good else 'FAIL'}")
    st, dv = out["storage"], out["device"]
    good = (np.array_equal(st["losses"], dv["losses"]) and np.array_equal(st["norms"],
                                                                          dv["norms"])
            and torch.equal(st["delta"], dv["delta"]) and st["fused"] == len(batches)
            and st["host"] == 0 and st["state"] == {"cpu pinned"})
    ok &= good
    log(f"offload parity storage tier (a caller's fused_adam, offload cpu) bitwise the "
        f"device path, one fused-Adam launch a step, state in pinned host memory: "
        f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("offload parity FAILED")


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
    as a pallas_call is none in JAX). Per-layer remat with no policy under
    ``checkpointing.configure(checkpoint_in_cpu=True)`` keeps what
    "dots_saveable" keeps in pinned host memory: its loss and grad norm
    must equal "dots_saveable"'s bitwise and its peak must be lower."""
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
                "engine_wrap": True, "policy": "nothing_saveable"}}),
            "remat cpu_checkpointing": (dict(remat=True), {"activation_checkpointing": {
                "cpu_checkpointing": True}})}
    out = {}
    for name, (model_over, config_over) in runs.items():
        cfg = dataclasses.replace(base, **model_over)
        params = _cast(init, torch.float32, copy=True)
        config = dict(TRAIN_CONFIG, **config_over)
        engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                    model_parameters=params, config=config)
        saved = dst.checkpointing.get_config()
        # the reference idiom: the checkpointing module reads the config
        dst.checkpointing.configure(deepspeed_config=config)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        loss = float(engine.train_batch(batch))
        peak = torch.cuda.max_memory_allocated() - base_mem
        dst.checkpointing._config.update(saved)
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
    cpu, dots = out["remat cpu_checkpointing"], out["remat dots_saveable"]
    good = cpu[0] == dots[0] and cpu[1] == dots[1] and cpu[2] < dots[2]
    log(f"remat cpu_checkpointing vs dots_saveable: loss {cpu[0]!r} / {dots[0]!r}, grad "
        f"norm {cpu[1]!r} / {dots[1]!r} (bitwise), step peak {cpu[2] / 2**30:.2f} vs "
        f"{dots[2] / 2**30:.2f} GiB above the resident state: {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("remat cpu_checkpointing FAILED")


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


def offload_checkpoint_phase():
    """The host-Adam tier's checkpoint (TinyLlama widths at 2 layers, phase
    9's schedule and batches, offload_optimizer cpu with bf16 transport):
    3 steps, save into build/, a fresh engine, load, 2 steps, against 5
    uninterrupted steps. After the load the host masters, both moments, the
    host step count and the compute leaves on the card must equal the
    saved engine's bitwise, and the resumed losses the uninterrupted ones;
    zero_to_fp32 must return the host masters."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.models.convert import _flatten

    cfg = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    init = init_params(cfg, seed=7, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    batches = [torch.randint(0, cfg.vocab_size, (2, 2, TRAIN_SEQ), generator=gen,
                             device="cuda") for _ in range(5)]
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2, zero_optimization={
        "stage": 0, "offload_optimizer": {"device": "cpu", "grad_dtype": "bfloat16"}})
    ckpt_dir = REPO / "build" / "offload_checkpoint_smoke"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def engine():
        params = _cast(init, torch.float32, copy=True)
        return dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                              model_parameters=params, config=config)[0]

    def state(e):
        p, m, v = e._host_adam.leaves()
        return ([x.clone() for x in p + m + v] + [x.detach().cpu() for x in e._masters]
                + [e._host_adam.step_count, e.state.step, e.global_steps])

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
    first.save_checkpoint(str(ckpt_dir))
    save_s = time.perf_counter() - t0
    saved = state(first)
    masters = {k: v.numpy() for k, v in _flatten(first._host_adam.master).items()}
    del first
    torch.cuda.empty_cache()
    resumed = engine()
    t0 = time.perf_counter()
    resumed.load_checkpoint(str(ckpt_dir))
    load_s = time.perf_counter() - t0
    state_equal = same(state(resumed), saved)
    got += [float(resumed.train_batch(b)) for b in batches[3:]]
    split = resumed.offload_timings()
    log(f"offload checkpoint: the last step's host walk on the {resumed._host_adam.route} "
        f"route: D2H {split['d2h']:.4f} s, host Adam {split['host_adam']:.4f} s, H2D "
        f"{split['h2d']:.4f} s summed over {len(resumed._ring_plan)} ring chunks, the walk "
        f"{resumed._offload_walk_s:.4f} s of wall")
    flat = zero_to_fp32(str(ckpt_dir))
    fp32_equal = set(flat) == set(masters) and all(
        np.array_equal(flat[k], masters[k]) for k in masters)
    n_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    log(f"offload checkpoint (TinyLlama widths, 2 layers, host Adam, bf16 transport): save "
        f"{save_s:.2f} s, load {load_s:.2f} s, {n_bytes / 2**30:.2f} GiB on disk; host "
        f"state and compute leaves bitwise equal after load: {state_equal}; zero_to_fp32 = "
        f"host masters: {fp32_equal}; losses resumed {got}, uninterrupted {want}, bitwise "
        f"equal: {got == want}")
    del resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    if not (state_equal and fp32_equal and got == want):
        raise SystemExit("offload checkpoint resume FAILED")


def allocator_block_bytes(tensors) -> int:
    """The bytes of the CUDA caching allocator's blocks that hold the
    storages of ``tensors``: a block may exceed its request (512-byte
    granules, and a cached block whose remainder is too small to split is
    handed out whole)."""
    starts = {t.untyped_storage().data_ptr() for t in tensors}
    total = 0
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for block in seg["blocks"]:
            if addr in starts and block["state"] == "active_allocated":
                total += block["size"]
            addr += block["size"]
    return total


def offload_states_phase():
    """offload_states / reload_states mid-run (TinyLlama widths at 2 layers,
    the device path with fused Adam): 2 steps, the optimizer state and then
    the params to host memory and back, 1 step, both to files under build/
    through the aio swapper and back, 2 steps, against 5 uninterrupted
    steps: while offloaded the card's allocated memory must drop by at
    least the optimizer state's bytes, and by exactly the allocator blocks
    that hold the params;
    after each reload the state must equal the state before bitwise (the
    params the same tensors) and the losses the uninterrupted ones. Returns
    the aio requests of the run."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import aio

    cfg = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    init = init_params(cfg, seed=7, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    batches = [torch.randint(0, cfg.vocab_size, (2, 2, TRAIN_SEQ), generator=gen,
                             device="cuda") for _ in range(5)]
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2)
    nvme = REPO / "build" / "offload_states_smoke"
    shutil.rmtree(nvme, ignore_errors=True)

    def engine():
        params = _cast(init, torch.float32, copy=True)
        return dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                              model_parameters=params, config=config)[0]

    whole = engine()
    want = [float(whole.train_batch(b)) for b in batches]
    del whole
    torch.cuda.empty_cache()
    eng = engine()
    got = [float(eng.train_batch(b)) for b in batches[:2]]
    ok = True
    aio.reset_launch_counts()
    for where, steps in (("cpu", batches[2:3]), ("nvme", batches[3:])):
        leaves = torch.utils._pytree.tree_leaves(eng.state.opt_state)
        before = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        nbytes = sum(x.numel() * x.element_size() for x in leaves
                     if isinstance(x, torch.Tensor))
        del leaves
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng.offload_states(device=where, nvme_path=str(nvme))
        out_s = time.perf_counter() - t0
        drop = mem0 - torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng.reload_states()
        in_s = time.perf_counter() - t0
        after = torch.utils._pytree.tree_leaves(eng.state.opt_state)
        same = len(after) == len(before) and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(after, before))
        del before, after
        good = same and drop >= nbytes
        ok &= good
        log(f"offload_states {where}: {nbytes / 2**30:.2f} GiB of optimizer state out in "
            f"{out_s:.2f} s, back in {in_s:.2f} s; the card's allocated memory dropped "
            f"{drop / 2**30:.2f} GiB while offloaded; state bitwise after reload: {same}: "
            f"{'ok' if good else 'FAIL'}")
        # the params: the same tensors, their storage away and back; the
        # card's allocator frees each storage's block (512-byte granules)
        ids = [id(p) for p in eng._masters]
        before = [p.detach().clone() for p in eng._masters]
        pbytes = sum(p.numel() * p.element_size() for p in eng._masters)
        blocks = allocator_block_bytes(eng._masters)
        gc.collect()          # the step's unreachable tensors go before the count
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng.offload_states(include=("params",), device=where, nvme_path=str(nvme))
        out_s = time.perf_counter() - t0
        drop = mem0 - torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng.reload_states()
        in_s = time.perf_counter() - t0
        same = ids == [id(p) for p in eng._masters] and all(
            torch.equal(p.detach(), b) for p, b in zip(eng._masters, before))
        del before
        good = same and drop == blocks
        ok &= good
        log(f"offload_states params {where}: {pbytes} bytes ({len(ids)} leaves, in "
            f"{blocks} bytes of the allocator's blocks) out in {out_s:.2f} s, back in "
            f"{in_s:.2f} s; the card's allocated memory dropped {drop} bytes, equal to the "
            f"params' blocks: {drop == blocks}; the same tensors, bitwise after reload: "
            f"{same}: {'ok' if good else 'FAIL'}")
        got += [float(eng.train_batch(b)) for b in steps]
    requests = aio.launch_counts["aio"]
    good = got == want and requests > 0
    ok &= good
    log(f"offload_states: losses {got}, uninterrupted {want}, bitwise equal: {got == want}; "
        f"aio requests {requests}")
    del eng
    shutil.rmtree(nvme, ignore_errors=True)
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("offload_states FAILED")
    return {"aio": requests}


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
# one device), TinyLlama widths at 4 layers, stage 0 with each
# compressed_collectives mode and ZeRO stages 1-3 with the exact reduction.
# Phase 18 runs the same world at full depth (stage 0 against stage 3);
# --cards N runs it over NCCL with one rank per card at full depth.
ZERO_MODES = ["stage1", "stage2", "stage3"]
# stage 1 with offload_optimizer cpu: over several ranks the JAX rule takes
# the pinned-host storage tier (the stage-1 update on host-resident state)
OFFLOAD_MODE = "stage1_offload"
# phase 20 (d), run in phase 11's world after its modes: LAMB with the
# embedding frozen at 2 layers, ZeRO stage 0, 2 and 3, 3 steps each
LAMB_MODES = ["lamb_stage0", "lamb_stage2", "lamb_stage3"]
LAMB_LAYERS, LAMB_STEPS = 2, 3
DP_SPEC = {"world": 2, "backend": "gloo", "model": "1b", "layers": 4, "micro": 2,
           "seq": 2048, "steps": 5, "remat": False,
           "modes": ["none", "int8", "int8_sr"] + ZERO_MODES + [OFFLOAD_MODE]}
DP_CONFIG = {
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "zero_optimization": {"stage": 0}, "bf16": {"enabled": True},
    "gradient_clipping": 1.0, "training_fastpath": {"loss_impl": "auto"},
    "comms_logger": {"enabled": True}, "steps_per_print": 10**9,
}
QUANT_KERNELS = ("quantize_int8", "quantize_int8_sr", "dequantize_int8")


def dp_stage(mode: str) -> int:
    if mode == OFFLOAD_MODE:
        return 1
    return int(mode[-1]) if mode in ZERO_MODES or mode in LAMB_MODES else 0


def dp_mode_config(mode: str) -> dict:
    """A mode's config section: ZeRO stage 1-3 with the exact reduction
    (stage 1 also with offload_optimizer cpu), or stage 0 with a
    compressed_collectives mode."""
    if mode == OFFLOAD_MODE:
        return {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}}
    if mode in LAMB_MODES:
        return {"zero_optimization": {"stage": dp_stage(mode)},
                "optimizer": LAMB_CONFIG["optimizer"]}
    if mode in ZERO_MODES:
        return {"zero_optimization": {"stage": dp_stage(mode)}}
    return {"compressed_collectives": {"mode": mode, "block": 2048}}


def dp_batch(cfg, micro_total, seq=TRAIN_SEQ):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    return torch.randint(0, cfg.vocab_size, (DP_CONFIG["gradient_accumulation_steps"],
                                             micro_total, seq), generator=gen,
                         device="cuda")


def dp_model(spec, mode=None):
    from deepspeed_tpu_torch.models import llama_config

    layers = LAMB_LAYERS if mode in LAMB_MODES else spec["layers"]
    return llama_config(spec["model"], num_layers=layers, dtype=torch.bfloat16,
                        remat=spec["remat"],
                        remat_policy="nothing_saveable" if spec["remat"] else None)


def dp_child(rank: int, workdir: Path) -> int:
    """One rank of a data-parallel world (workdir/spec.json): each mode
    trains ``steps`` steps from the same seeded weights (an init closure
    made on the card, so at stage 3 the engine keeps only this rank's shard)
    on the same global batch; writes losses, step times, peak memory beside
    the ZeRO estimator's model-state bytes, every kernel's launches, the
    ledger and whether the full masters (``safe_get_full_fp32_param``, leaf
    by leaf) equal rank 0's bitwise to workdir/out_<rank>.json."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm, zero
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn
    from deepspeed_tpu_torch.models.convert import _nest, param_shapes
    from deepspeed_tpu_torch.ops import flash_attention, fused_adam, fused_loss, quant
    from deepspeed_tpu_torch.utils import safe_get_full_fp32_param

    spec = json.loads((workdir / "spec.json").read_text())
    comm.init_distributed(dist_backend=spec["backend"], init_method=f"file://{workdir}/store",
                          rank=rank, world_size=spec["world"], timeout=900)
    kernels = (flash_attention, fused_adam, fused_loss, quant)
    out = {}
    for mode in spec["modes"]:
        cfg = dp_model(spec, mode)
        batch = dp_batch(cfg, spec["micro"] * spec["world"], spec["seq"])
        # the module holds meta tensors: the engine's tree is what it runs on
        meta = _nest({k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()})
        config = dict(DP_CONFIG, train_micro_batch_size_per_gpu=spec["micro"],
                      **dp_mode_config(mode))
        lamb = mode in LAMB_MODES
        init = zero.Init(lambda: init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
        engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, meta)),
                                    model_parameters=init, config=config,
                                    frozen_params=FROZEN if lamb else None)
        ledger = comm.get_comms_logger()
        ledger.reset()
        for k in kernels:
            k.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()      # the closure's full tree is gone
        torch.cuda.reset_peak_memory_stats()
        losses, times, trust = [], [], []
        for _ in range(LAMB_STEPS if lamb else spec["steps"]):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t0)
            if lamb:
                trust.append(engine.tx.update.last_trust.float().cpu().tolist())
        launches = {}
        for k in kernels:
            launches.update(k.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        totals = ledger.totals().get("quantized_all_reduce")
        paths = ["/".join(str(k.key) for k in kp) for kp, _ in
                 torch.utils._pytree.tree_flatten_with_path(engine.state.params)[0]]
        same, n = True, 0
        for path in paths:
            full = safe_get_full_fp32_param(engine, path)
            same &= torch.equal(full, comm.broadcast(full.clone(), src=0))
            n += full.numel()
        frozen_equal = None
        if lamb:
            embed = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)["embed"]
            frozen_equal = torch.equal(safe_get_full_fp32_param(engine, "embed/embedding"),
                                       embed["embedding"])
            del embed
        same = torch.tensor([int(same)], device="cuda")
        comm.all_reduce(same, op="min")
        stage = engine.zero_stage()
        estimate = zero.estimate_zero_model_states_mem_needs(n, stage, spec["world"])
        tier = ["host Adam" if engine._host_adam is not None else
                "storage" if engine._offload_optimizer else "none",
                ",".join(sorted({t.device.type for t in torch.utils._pytree.tree_leaves(
                    engine.state.opt_state) if isinstance(t, torch.Tensor)}))]
        z3 = engine._z3
        units = None if z3 is None else dict(
            peak_units=z3.peak_units, peak_bytes=z3.peak_bytes, gathers=z3.gathers,
            count=len(z3.units), largest=max(z3._nbytes), total=sum(z3._nbytes))
        out[mode] = dict(losses=losses, times=times, launches=launches, peak=peak,
                         units=units, trust=trust, frozen_equal=frozen_equal,
                         n_frozen=math.prod(param_shapes(cfg)["embed/embedding"])
                         if lamb else 0,
                         ledger=totals, masters_equal=bool(same.item()), n=n,
                         reduce=engine._dp_grad_mode, stage=stage, tier=tier,
                         estimate=estimate["total_bytes"],
                         adam_elems=sum(t.numel() for t in
                                        torch.utils._pytree.tree_leaves(
                                            engine.state.opt_state.exp_avg)))
        del engine, init
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
            p.wait(timeout=900)
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
    """The checks of a data-parallel world: one loss across ranks, the full
    masters bitwise equal across ranks, losses finite and falling; in each
    compressed mode and at each ZeRO stage the first loss bitwise equal to
    none's (no update has acted yet) and every loss within 0.02 |ref| +
    1e-3 of it; compressed: 2 + 2 quant launches per rank per step and the
    ledger equal to the JAX package's formula; ZeRO: one Adam launch per rank
    per step over ceil(n / world) elements, no quant launch. Returns (ok,
    rank 0's results)."""
    from deepspeed_tpu_torch.ops.quant import shard_layout

    world, steps = spec["world"], spec["steps"]
    r0 = ranks[0]
    ref = r0["none"]["losses"] if "none" in r0 else None
    n = r0[spec["modes"][0]]["n"]
    shard, shard_p, b1 = shard_layout(n, world, 2048)
    wire = (world * shard_p + 4 * world * (shard_p // b1)) + (shard_p + 4 * (shard_p // b1))
    tokens = (DP_CONFIG["gradient_accumulation_steps"] * spec["micro"] * world
              * spec["seq"])
    where = (f"{world} ranks on cuda:0 over gloo: a correctness run, not a scaling number"
             if spec["backend"] == "gloo" else f"{world} cards, one rank each, over NCCL")
    ok = True
    for mode in [m for m in spec["modes"] if m not in LAMB_MODES]:
        a = r0[mode]
        quant = lambda r: {k: r[mode]["launches"][k] for k in QUANT_KERNELS}
        checks = {
            "ranks report one loss": all(r[mode]["losses"] == a["losses"] for r in ranks),
            "masters bitwise equal across ranks": all(r[mode]["masters_equal"]
                                                      for r in ranks),
            "losses finite and falling": (all(math.isfinite(x) for x in a["losses"])
                                          and a["losses"][-1] < a["losses"][0]),
            "reduction": a["reduce"] == (mode if mode in ("int8", "int8_sr") and world > 1
                                         else None),
            "stage": a["stage"] == dp_stage(mode),
        }
        if mode != "none" and ref is not None:
            checks.update({
                "first loss bitwise equal to none's": a["losses"][0] == ref[0],
                "losses within 0.02|ref| + 1e-3 of none": all(
                    abs(x - y) < 0.02 * abs(y) + 1e-3 for x, y in zip(a["losses"], ref)),
            })
        if mode in ("int8", "int8_sr"):
            kq = "quantize_int8" if mode == "int8" else "quantize_int8_sr"
            want = {"quantize_int8": 0, "quantize_int8_sr": 0, "dequantize_int8": 2 * steps}
            want[kq] = 2 * steps
            checks.update({
                "quant launches 2 + 2 per rank per step": all(quant(r) == want for r in ranks),
                "ledger bytes = the JAX formula": a["ledger"] is not None and (
                    a["ledger"]["count"], a["ledger"]["bytes"], a["ledger"]["wire_bytes"]) == (
                    steps, steps * 4 * n, steps * wire),
            })
        else:
            checks["no quant launches"] = not any(any(quant(r).values()) for r in ranks)
            checks["one Adam launch per rank per step"] = all(
                r[mode]["launches"]["fused_adam"] == steps for r in ranks)
        if (mode in ZERO_MODES or mode == OFFLOAD_MODE) and world > 1:
            checks["Adam state ceil(n / world) per rank"] = all(
                r[mode]["adam_elems"] == -(-n // world) for r in ranks)
        if mode == OFFLOAD_MODE and "stage1" in r0:
            checks["losses bitwise equal to stage 1's"] = all(
                r[mode]["losses"] == r["stage1"]["losses"] for r in ranks)
            checks["storage tier: host-resident state, no host Adam"] = all(
                r[mode]["tier"] == ["storage", "cpu"] for r in ranks)
        good = all(checks.values())
        ok &= good
        step_s = float(np.mean(a["times"][1:]))
        log(f"dp {mode} (world {world}): losses {a['losses']}; {step_s * 1e3:.1f} ms/step "
            f"(steps 2-{steps}; {where}), {tokens / step_s:.0f} tokens/s, peak memory per "
            f"rank {[round(r[mode]['peak'] / 2**30, 2) for r in ranks]} GiB against the "
            f"estimator's stage-{a['stage']} model state {a['estimate'] / 2**30:.2f} GiB; "
            f"launches {a['launches']}; ledger {a['ledger']}; "
            f"{'ok' if good else 'FAIL ' + str([k for k, v in checks.items() if not v])}")
    log(f"dp [{card}]: llama {spec['model']} widths, {spec['layers']} layers ({n} "
        f"parameters), micro {spec['micro']} x {spec['seq']} per rank, gas "
        f"{DP_CONFIG['gradient_accumulation_steps']}, {steps} steps per mode, {where}; "
        f"wire bytes per int8 reduction {wire} vs logical {4 * n} ({4 * n / wire:.2f}x)")
    return ok, r0


def dp_phase(card):
    """Phase 11: DP_SPEC's world (dp_child), its checks, the none run against
    one process on the same global batch, and NCCL at world size 1; phase
    20 (d) in the same world (LAMB_MODES, check_lamb_dp). Returns the quant
    kernels' launches in the compressed runs."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn

    spec = dict(DP_SPEC, modes=DP_SPEC["modes"] + LAMB_MODES)
    workdir = REPO / "build" / "dp_smoke"
    t0 = time.perf_counter()
    ranks = run_dp_world(spec, workdir)
    ok, r0 = check_dp(spec, ranks, card)
    ok &= check_lamb_dp(spec, ranks, card)
    log(f"dp: phase wall {time.perf_counter() - t0:.1f} s (with phase 20 (d))")

    # the none run against one process on the same global batch
    micro_total = spec["micro"] * spec["world"]
    cfg = dp_model(spec)
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


# ---------------------------------------------------------------------------
# phase 18: full-depth ZeRO-3 on one card
# ---------------------------------------------------------------------------

ZERO3_SPEC = dict(DP_SPEC, layers=22, steps=3, modes=["none", "stage3"])


def zero3_phase(card):
    """Phase 18: TinyLlama-1.1B at all 22 layers, two ranks on cuda:0 over
    gloo (micro 2 x 2048 each, gas 2, bf16, fused loss), 3 steps at stage 0
    and 3 at stage 3 from the same seed and batch: check_dp's gates, every
    flash, fused-loss and Adam launch exact per rank, stage 3's peak per
    rank at least three quarters of the estimator's predicted saving below
    stage 0's, and at stage 3 at most MAX_LIVE units gathered at once."""
    import shutil

    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width
    from deepspeed_tpu_torch.runtime.zero.stage3 import MAX_LIVE

    spec = ZERO3_SPEC
    workdir = REPO / "build" / "zero3_smoke"
    t0 = time.perf_counter()
    ranks = run_dp_world(spec, workdir)
    ok, r0 = check_dp(spec, ranks, card)
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = dp_model(spec)
    gas, steps = DP_CONFIG["gradient_accumulation_steps"], spec["steps"]
    chunks = -(-cfg.vocab_size // chunk_width(spec["micro"] * spec["seq"], cfg.vocab_size, 2))
    want = {k: cfg.num_layers * gas * steps for k in
            ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    want.update(fused_adam=steps, fused_loss_fwd=gas * steps,
                fused_loss_fwd_combine=gas * steps)
    for k in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[k] = gas * steps * chunks
    for mode in spec["modes"]:
        bad = {k: [r[mode]["launches"][k] for r in ranks] for k, w in want.items()
               if any(r[mode]["launches"][k] != w for r in ranks)}
        log(f"zero3 {mode}: launches per rank {r0[mode]['launches']} (want {want}) "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        ok &= not bad
    n = r0["none"]["n"]
    est0 = zero.estimate_zero_model_states_mem_needs(n, 0, spec["world"])["total_bytes"]
    est3 = zero.estimate_zero_model_states_mem_needs(n, 3, spec["world"])["total_bytes"]
    need = 3 * (est0 - est3) / 4
    peaks0 = [r["none"]["peak"] for r in ranks]
    peaks3 = [r["stage3"]["peak"] for r in ranks]
    saved = min(a - b for a, b in zip(peaks0, peaks3))
    mem_ok = saved >= need
    ok &= mem_ok
    units = [r["stage3"]["units"] for r in ranks]
    live_ok = all(max(u["peak_units"].values()) <= MAX_LIVE for u in units)
    ok &= live_ok
    u0 = units[0]
    log(f"zero3 stage 3 units (rank 0): {u0['count']} units, the largest "
        f"{u0['largest'] / 2**20:.1f} MiB, all {u0['total'] / 2**30:.2f} GiB; most gathered "
        f"at once: forward {u0['peak_units']['forward']} units "
        f"({u0['peak_bytes']['forward'] / 2**20:.1f} MiB), backward "
        f"{u0['peak_units']['backward']} units ({u0['peak_bytes']['backward'] / 2**20:.1f} "
        f"MiB); unit gathers {u0['gathers']} over {spec['steps']} steps; at most "
        f"{MAX_LIVE} on every rank: {'ok' if live_ok else 'FAIL'}")
    ms = {m: float(np.mean(r0[m]["times"][1:])) * 1e3 for m in spec["modes"]}
    log(f"zero3 [{card}]: TinyLlama-1.1B, 22 layers, {n} parameters, two ranks sharing "
        f"cuda:0 over gloo (not a scaling number): peak per rank stage 0 "
        f"{[round(p / 2**30, 2) for p in peaks0]} GiB, stage 3 "
        f"{[round(p / 2**30, 2) for p in peaks3]} GiB; the estimator's model state "
        f"{est0 / 2**30:.2f} GiB (18P) against {est3 / 2**30:.2f} GiB (9P); stage 3 "
        f"saves {saved / 2**30:.2f} GiB per rank, at least three quarters of the "
        f"predicted {(est0 - est3) / 2**30:.2f} GiB ({need / 2**30:.2f}) required: "
        f"{'ok' if mem_ok else 'FAIL'}; step {ms['none']:.1f} ms at stage 0, "
        f"{ms['stage3']:.1f} ms at stage 3 (steps 2-{steps}); phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if not ok:
        raise SystemExit("zero3 phase FAILED")


# ---------------------------------------------------------------------------
# phase 19: ZeRO-Offload at full size on one card
# ---------------------------------------------------------------------------

# phase 19's run: meta-llama/Llama-2-7b-hf's widths (llama_config("7b"), as
# --cards 4 runs them) when the host can hold its need (host_need), else
# microsoft/Phi-3-mini-4k-instruct's (PHI3_MINI)
OFFLOAD_CONFIG = {
    "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                 "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 4}},
    "zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu",
                                                            "grad_dtype": "bfloat16"}},
    "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "training_fastpath": {"loss_impl": "auto"}, "steps_per_print": 10**9,
}
OFFLOAD_SEQ, OFFLOAD_WARMUP, OFFLOAD_STEPS = 4096, 1, 3
#: what the host-Adam run adds to the process's resident bytes beyond 12P and
#: the ring (the host step's transients, the leaf check's copies): 0.25 GB
#: measured at Llama-2-7B on the one-card machine, rounded up to 1 GB
HOST_REST_BYTES = 1e9
#: how long phase 19 waits for MemAvailable to cover the 7B's host need
HOST_MEMORY_WAIT_S = 120


def host_need(cfg) -> tuple:
    """(P, bytes) the host-Adam tier adds to the host for ``cfg``: 12P of
    fp32 masters and moments, the transfer ring, HOST_REST_BYTES."""
    from deepspeed_tpu_torch.models.convert import param_shapes
    from deepspeed_tpu_torch.runtime.engine import HOST_RING_CHUNK_BYTES, HOST_RING_SLOTS

    n = sum(math.prod(s) for s in param_shapes(cfg).values())
    return n, 12 * n + 2 * HOST_RING_SLOTS * HOST_RING_CHUNK_BYTES + HOST_REST_BYTES


def host_memory():
    """(MemAvailable bytes from /proc/meminfo, the CPU model and its core
    count from lscpu)."""
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    info = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        for line in out.splitlines():
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    model = info.get("Model name", "?")
    if model in ("?", "-", "unknown"):
        # a virtual machine's lscpu may not name the model: /proc/cpuinfo's
        # vendor, family and model numbers then stand for it
        with open("/proc/cpuinfo") as f:
            cpu = dict(line.split(":", 1) for line in f.read().split("\n\n")[0].splitlines()
                       if ":" in line)
        cpu = {k.strip(): v.strip() for k, v in cpu.items()}
        model = (f"{cpu.get('model name', model)} ({info.get('Vendor ID', cpu.get('vendor_id'))}"
                 f", family {cpu.get('cpu family', '?')}, model {cpu.get('model', '?')}, "
                 f"{info.get('Hypervisor vendor', 'no')} hypervisor)")
    return avail, model, info.get("CPU(s)", str(os.cpu_count()))


def meminfo_gb() -> dict:
    """/proc/meminfo's MemAvailable, MemFree, Cached, AnonPages, Shmem and
    Mapped in GB."""
    keys = ("MemAvailable", "MemFree", "Cached", "AnonPages", "Shmem", "Mapped")
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in keys:
                out[key] = int(val.split()[0]) * 1024 / 1e9
    return out


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def offload_phase(card, cpu_model):
    """A model at its published size trained on one card with the optimizer
    on the host (the host-Adam tier): Llama-2-7B if the host's MemAvailable
    covers host_need within HOST_MEMORY_WAIT_S, else phi-3-mini-4k; seeded
    random weights made on the card (an init closure: the engine takes the
    host masters and the bf16 leaves and drops the fp32 tree), seq 4096,
    micro 1, gas 2,
    per-layer remat, bf16, bf16 gradient transport, clipping 1.0, WarmupLR;
    1 warm-up and 3 timed steps; the process's resident bytes after each
    stage of initialize and of the first step. Gates: losses finite and the
    last below the first; no fused-Adam launch and one host step a step (a
    host Adam launch a slice of the ring's walk); flash (forward twice
    under remat) and fused-loss launches exact, all on wgmma; after the
    last step every compute leaf on the card bitwise the bf16 rounding of
    its host master; peak device memory from after initialize below 9P (no
    fp32 master or moment on the card). Returns the host Adam's launches."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, init_params,
                                            llama_config, make_loss_fn)
    from deepspeed_tpu_torch.models.convert import _nest, param_shapes
    from deepspeed_tpu_torch.ops import adam as host_adam
    from deepspeed_tpu_torch.ops import flash_attention, fused_adam, fused_loss
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width

    # pinned blocks earlier phases freed stay in the caching host allocator,
    # and tensors that only a reference cycle holds stay until a collection
    rss_in = rss_bytes()
    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    remat = dict(remat=True, remat_policy="nothing_saveable", dtype=torch.bfloat16)
    n7, need7 = host_need(llama_config("7b"))
    # the pages of the child processes that phases 11 and 18 started return
    # to MemAvailable some seconds after the children exit (12-19 GB short
    # right after phase 11 or 18 on the one-card machine): wait for them
    t_wait = time.perf_counter()
    while (meminfo_gb()["MemAvailable"] * 1e9 < need7
           and time.perf_counter() - t_wait < HOST_MEMORY_WAIT_S):
        time.sleep(2)
    waited = time.perf_counter() - t_wait
    mem_available = host_memory()[0]
    rss0 = rss_bytes()
    log(f"offload: resident {rss_in / 1e9:.2f} GB at the phase's start, "
        f"{rss0 / 1e9:.2f} GB after a garbage collection and emptying the pinned-host "
        f"cache ({'torch._C._host_emptyCache' if empty else 'no host cache to empty'}); "
        f"host memory (GB) " + ", ".join(f"{k} {v:.2f}" for k, v in meminfo_gb().items()))
    if mem_available >= need7:
        name, cfg = "Llama-2-7B", llama_config("7b", **remat)
    else:
        name, cfg = "phi-3-mini-4k", TransformerConfig(**PHI3_MINI, **remat)
    log(f"offload: MemAvailable {mem_available / 1e9:.1f} GB after {waited:.0f} s of waiting "
        f"for it (at most {HOST_MEMORY_WAIT_S} s), resident {rss0 / 1e9:.1f} "
        f"GB; Llama-2-7B's host need {need7 / 1e9:.1f} GB (12P = {12 * n7 / 1e9:.1f} GB, the "
        f"ring, {HOST_REST_BYTES / 1e9:.0f} GB of rest): {name} at its published size")
    stages = [("phase start", rss_in), ("pinned cache emptied", rss0)]
    mark = lambda what: stages.append((what, rss_bytes()))
    real_init = host_adam.DeepSpeedCPUAdam.__init__

    def traced_init(self, *a, **kw):        # the host state's own share
        mark("fp32 tree on the card")
        real_init(self, *a, **kw)
        mark("host masters and moments")

    t0 = time.perf_counter()
    meta = _nest({k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()})
    init = zero.Init(lambda: init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
    host_adam.DeepSpeedCPUAdam.__init__ = traced_init
    try:
        engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, meta)),
                                    model_parameters=init, config=OFFLOAD_CONFIG)
    finally:
        host_adam.DeepSpeedCPUAdam.__init__ = real_init
    del init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mark("after initialize")
    n = sum(p.numel() for p in engine._masters)
    n_matmul = n - cfg.vocab_size * cfg.hidden_size
    gas, micro = engine.gas, engine.micro_batch_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = torch.randint(0, cfg.vocab_size, (gas, micro, OFFLOAD_SEQ), generator=gen,
                          device="cuda")
    slices = sum(len(c) for c in engine._ring_plan)
    log(f"offload {name} (hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.kv_heads} heads, D {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}): {n} parameters, set-up "
        f"{time.perf_counter() - t0:.1f} s; host {cpu_model}; the ring: "
        f"{len(engine._ring_plan)} chunks of {engine._ring_chunk} elements, {slices} slices")
    real_apply = engine._apply_host

    def traced_apply():                     # the first step's stages
        mark("first step: forward and backward")
        out = real_apply()
        mark("first step: after the host walk")
        return out

    engine._apply_host = traced_apply
    torch.cuda.reset_peak_memory_stats()
    for k in (flash_attention, fused_adam, fused_loss, host_adam):
        k.reset_launch_counts()
    losses, times, phases = [], [], []
    for step in range(OFFLOAD_WARMUP + OFFLOAD_STEPS):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        phases.append(dict(engine.offload_timings(), walk=engine._offload_walk_s))
        if step == 0:
            del engine._apply_host
            mark("after the first step")
    peak = torch.cuda.max_memory_allocated()
    mark("after the last step")
    from deepspeed_tpu_torch.runtime.engine import HOST_RING_CHUNK_BYTES, HOST_RING_SLOTS

    ring = sum(t.numel() * t.element_size() for side in engine._ring for t in side)
    rest = max(b for _, b in stages) - rss0 - 12 * n - ring
    log(f"offload {name}: resident bytes by stage (GB): "
        + "; ".join(f"{what} {b / 1e9:.2f}" for what, b in stages)
        + f"; 12P = {12 * n / 1e9:.2f} GB, the ring {ring / 2**20:.0f} MiB pinned "
        f"({2 * HOST_RING_SLOTS} x {HOST_RING_CHUNK_BYTES / 2**20:.0f} MiB at most); the rest "
        f"beyond the phase's start, 12P and the ring {rest / 1e9:.2f} GB "
        f"(HOST_REST_BYTES {HOST_REST_BYTES / 1e9:.0f} GB)")
    launches = {}
    for k in (flash_attention, fused_adam, fused_loss, host_adam):
        launches.update(k.launch_counts)
    steps = OFFLOAD_WARMUP + OFFLOAD_STEPS
    tokens = gas * micro * OFFLOAD_SEQ
    step_s = float(np.mean(times[OFFLOAD_WARMUP:]))
    flops = train_flops(cfg, n_matmul, tokens, OFFLOAD_SEQ)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    keys = ("d2h", "host_adam", "h2d", "walk")
    mean = {k: float(np.mean([p[k] for p in phases[OFFLOAD_WARMUP:]])) for k in keys}
    log(f"offload {name}: losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(x, 3) for x in times]}; D2H / host Adam / H2D summed over the chunks, "
        f"and the walk's wall (s) {[tuple(round(p[k], 3) for k in keys) for p in phases]}")
    log(f"offload {name} [{card}; host {cpu_model}]: {step_s * 1e3:.1f} ms/step over "
        f"{OFFLOAD_STEPS} timed steps, {tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} "
        f"({flops:.4e} model flop/step over 989 TFLOP/s bf16); per step D2H "
        f"{mean['d2h']:.3f} s, host Adam {mean['host_adam']:.3f} s, H2D {mean['h2d']:.3f} s "
        f"summed over the chunks, the walk {mean['walk']:.3f} s of wall (overlap "
        f"{mean['d2h'] + mean['host_adam'] + mean['h2d'] - mean['walk']:.3f} s), the rest of "
        f"the step {step_s - mean['walk']:.3f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB from after initialize (6P = "
        f"{6 * n / 2**30:.2f} GiB, gate 9P = {9 * n / 2**30:.2f} GiB); host resident "
        f"{rss_bytes() / 1e9:.1f} GB")
    chunks = -(-cfg.vocab_size // chunk_width(micro * OFFLOAD_SEQ, cfg.vocab_size, 2))
    want = {"flash_attention_fwd": 2 * cfg.num_layers * gas * steps,
            "flash_attention_bwd_dkdv": cfg.num_layers * gas * steps,
            "flash_attention_bwd_dq": cfg.num_layers * gas * steps,
            "fused_loss_fwd": gas * steps, "fused_loss_fwd_combine": gas * steps,
            "fused_adam": 0, "cpu_adam": steps * slices}
    for k in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[k] = gas * steps * chunks
    bad = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
    routes = {k: dict(flash_attention.route_counts[k]) for k in
              ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    routes["fused_loss_fwd"] = dict(fused_loss.fwd_route_counts)
    routes["fused_loss_bwd"] = dict(fused_loss.route_counts)
    off_route = {k: r for k, r in routes.items() if r.get("mma_sync", 0)}
    match = all(torch.equal(leaf.detach().cpu(), master.to(torch.bfloat16))
                for leaf, master in zip(engine._masters, engine._host_adam.leaves()[0]))
    chunks_walked = steps * len(engine._ring_plan)
    checks = {
        "losses finite, the last below the first": (
            all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]),
        "launches exact (no fused Adam, a host launch a slice a step)": not bad,
        "one host step a step": engine._host_adam.step_count == steps,
        "one host library call a ring chunk": host_adam.call_counts["cpu_adam"] == chunks_walked,
        "flash and fused loss all on wgmma": not off_route,
        "compute leaves bitwise the bf16 of the host masters": match,
        "peak below 9P": peak < 9 * n,
        "no optimizer state on the card": engine.state.opt_state == (),
    }
    log(f"offload {name}: host Adam on the {engine._host_adam.route} route, "
        f"{host_adam.call_counts['cpu_adam']} library calls for {chunks_walked} ring chunks "
        f"walked, launches by route {host_adam.route_counts}; the walk's wall minus the "
        f"host Adam's sum {mean['walk'] - mean['host_adam']:.3f} s a step")
    log(f"offload {name}: launches {launches} (want {want}); routes {routes}; "
        + "; ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    host_launches = launches["cpu_adam"]
    del engine, batch
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"offload phase FAILED: {[k for k, v in checks.items() if not v]}"
                         f"{'; launches (got, want) ' + str(bad) if bad else ''}")
    return {"cpu_adam": host_launches}


#: --cards 4: the most Llama-2-7B's stage 3 may take a rank (18P / 4 = 28.2
#: GiB of model state, the gathered units and the remat activations)
ZERO3_7B_GIB = 40


# ---------------------------------------------------------------------------
# phase 20: the training engine's remainder
# ---------------------------------------------------------------------------

#: phase 20 (a): phase 6's run with LAMB (lr warmed up to 1e-2: LAMB moves
#: each tensor by lr times its norm, where Adam moves each element by lr),
#: dropout 0.1 and the embedding frozen ("embed": the TransformerLM tree's
#: name of the table, "embed/embedding")
LAMB_CONFIG = dict(TRAIN_CONFIG, optimizer={"type": "Lamb", "params": {
    "lr": 1e-2, "weight_decay": 0.01}}, scheduler={"type": "WarmupLR", "params": {
        "warmup_min_lr": 0, "warmup_max_lr": 1e-2, "warmup_num_steps": 4}})
FROZEN = ["embed"]
EXTRAS_DROPOUT = 0.1
EXTRAS_WARMUP, EXTRAS_STEPS, EXTRAS_REPEAT = 2, 5, 3
#: phase 20 (b): each optimizer at 2 layers of TinyLlama, a constant lr
OTHER_OPTIMIZERS = {
    "Lion": {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "Adagrad": {"type": "Adagrad", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "SGD": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9, "nesterov": True,
                                      "weight_decay": 0.01}},
    "MuAdamW": {"type": "MuAdamW", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                              "base_width": 256}},
}
#: the card's update (fp32) against float64 on the CPU from the same state:
#: the L2 error relative to the update's norm (fp32 rounds each of ~15
#: operations at 6e-8; Adam's bias correction 1 - 0.999 ** t, taken in fp32
#: as the JAX package takes it, is off by up to 1e-5 of itself at step 3, so
#: MuAdamW's update sits ~4e-6 from float64). Lion's sign is compared where the float64 argument
#: stands clear of fp32 rounding (|c| > SIGN_MARGIN (|b1 m| + |(1-b1) g|));
#: at most SIGN_EXCLUDED of the elements may fall inside the margin
UPDATE_RTOL, SIGN_MARGIN, SIGN_EXCLUDED = 1e-5, 1e-5, 1e-3
#: phase 20 (d): LAMB's trust ratios at stages 2 and 3 against stage 0's
#: (the per-leaf norms summed over two ranks in another order), relative
TRUST_RTOL = 1e-3


def extras_engine(cfg, init, config, frozen=None, seeds=None):
    """An engine over a copy of ``init``; ``seeds`` collects the seed each
    micro-batch's loss gets."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import TransformerLM, make_loss_fn

    params = _cast(init, torch.float32, copy=True)
    inner = make_loss_fn(TransformerLM(cfg, params))

    def loss_fn(p, batch, rng=None):
        if seeds is not None:
            seeds.append(rng)
        return inner(p, batch, rng)

    engine, *_ = dst.initialize(model=loss_fn, model_parameters=params, config=config,
                                frozen_params=frozen)
    return engine


def extras_phase(card, kernels):
    """Phase 20 (a): TinyLlama-1.1B at phase 6's size and configuration with
    LAMB, dropout 0.1 and the embedding frozen, the batches fed through
    PrefetchLoader: 2 warm-up and 5 timed steps; step time, tokens/s, MFU,
    peak memory and the optimizer step beside phase 6's AdamW; the gates:
    losses finite and falling, the embedding bitwise unchanged, flash and
    fused-loss launches exact and on wgmma, no fused-Adam launch, a second
    engine's 3 steps from the same seed bitwise the first 3 losses, and one
    layer's mask keeping 0.9 of its elements within 4 sigma."""
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.models.transformer import dropout
    from deepspeed_tpu_torch.ops import flash_attention, fused_loss
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width
    from deepspeed_tpu_torch.ops.quant import fold_in
    from deepspeed_tpu_torch.runtime.dataloader import PrefetchLoader

    name, tag = "TinyLlama-1.1B", "extras (a)"
    cfg = dataclasses.replace(train_models()[name], dropout=EXTRAS_DROPOUT)
    init = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    embed = init["embed"]["embedding"].clone()
    gas, micro = TRAIN_CONFIG["gradient_accumulation_steps"], TRAIN_CONFIG[
        "train_micro_batch_size_per_gpu"]
    host = np.random.default_rng(1).integers(0, cfg.vocab_size, (gas * micro, TRAIN_SEQ))
    steps = EXTRAS_WARMUP + EXTRAS_STEPS
    seeds = []
    engine = extras_engine(cfg, init, LAMB_CONFIG, FROZEN, seeds)
    n_params = sum(p.numel() for p in engine._masters)
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size
    for k in kernels:
        k.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with timed_updates(engine) as marks:
        t0 = time.perf_counter()
        for batch in PrefetchLoader([host] * steps):
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    opt_ms = updates_ms(marks, EXTRAS_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    launches = {}
    for k in kernels:
        launches.update(k.launch_counts)
    frozen_same = torch.equal(engine.state.params["embed"]["embedding"], embed)
    trust = engine.tx.update.last_trust.float().cpu()
    routes = {n: dict(flash_attention.route_counts[n]) for n in
              ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    routes["fused_loss_fwd"] = dict(fused_loss.fwd_route_counts)
    del engine
    torch.cuda.empty_cache()
    again = extras_engine(cfg, init, LAMB_CONFIG, FROZEN)
    repeat = [float(again.train_batch(b)) for b in PrefetchLoader([host] * EXTRAS_REPEAT)]
    del again, init
    torch.cuda.empty_cache()
    # one layer's mask: layer 0 of the first micro-batch, at its shape
    ones = torch.ones(micro, TRAIN_SEQ, cfg.hidden_size, dtype=torch.bfloat16, device="cuda")
    kept = float((dropout(ones, EXTRAS_DROPOUT, fold_in(seeds[0], 0)) != 0).float().mean())
    n_mask = ones.numel()
    sigma = math.sqrt(EXTRAS_DROPOUT * (1 - EXTRAS_DROPOUT) / n_mask)

    tokens = gas * micro * TRAIN_SEQ
    step_s = float(np.mean(times[EXTRAS_WARMUP:]))
    mfu = train_flops(cfg, n_matmul, tokens, TRAIN_SEQ) / step_s / PEAK_FLOPS[torch.bfloat16]
    adam = TRAIN_FIGURES.get(name)
    log(f"{tag}: losses {losses}; step times (s) {[round(x, 4) for x in times]}")
    log(f"{tag} [{card}]: {name} with LAMB, dropout {EXTRAS_DROPOUT}, frozen {FROZEN}, "
        f"through PrefetchLoader: {step_s * 1e3:.1f} ms/step over {EXTRAS_STEPS} timed "
        f"steps, {tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (phase 6's N_matmul "
        f"{n_matmul}), max_memory_allocated {peak / 2**30:.2f} GiB, optimizer step "
        f"{opt_ms:.2f} ms; phase 6 AdamW in this run: "
        + (f"{adam['step_ms']:.1f} ms/step, {adam['tokens_s']:.0f} tokens/s, MFU "
           f"{adam['mfu']:.4f}, {adam['peak_gib']:.2f} GiB, optimizer step "
           f"{adam['opt_ms']:.2f} ms (LAMB / AdamW optimizer step "
           f"{opt_ms / adam['opt_ms']:.2f}x)" if adam else "not run"))
    log(f"{tag}: LAMB trust ratios of the last step: min {float(trust.min()):.4f}, max "
        f"{float(trust.max()):.4f} over {trust.numel()} leaves")
    chunks = -(-cfg.vocab_size // chunk_width(micro * TRAIN_SEQ, cfg.vocab_size, 2))
    want = {n: cfg.num_layers * gas * steps for n in
            ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    want.update(fused_adam=0, fused_loss_fwd=gas * steps, fused_loss_fwd_combine=gas * steps)
    for n in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[n] = gas * steps * chunks
    checks = {
        "losses finite, the last below the first": (all(map(math.isfinite, losses))
                                                     and losses[-1] < losses[0]),
        "embed/embedding bitwise unchanged": frozen_same,
        "launches exact (flash 22 x gas x steps, fused loss, no fused Adam)": all(
            launches[n] == w for n, w in want.items()),
        "flash and fused-loss forward launches on wgmma": all(
            r == {"wgmma": want[n], "mma_sync": 0} for n, r in routes.items()),
        f"{EXTRAS_REPEAT} steps of a second engine bitwise the first "
        f"{EXTRAS_REPEAT} losses": repeat == losses[:EXTRAS_REPEAT],
        "layer 0's mask keeps 0.9 within 4 sigma": abs(kept - 0.9) <= 4 * sigma,
    }
    log(f"{tag}: launches {launches} (want {want}); routes {routes}; repeat {repeat}; "
        f"mask kept share {kept:.6f} of {n_mask} (sigma {sigma:.2e})")
    for what, ok in checks.items():
        log(f"{tag}: {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"{tag} FAILED")


def mu_factor(path: str, shape: tuple, base_width: int) -> float:
    """MuAdamW's factor of a TinyLlama leaf: base_width over the contracted
    extent of a matrix (every dim but the last for o_proj and down_proj,
    the leading dim otherwise), 1 for vectors and the input table."""
    if len(shape) < 2 or path.startswith("embed/"):
        return 1.0
    fan_in = math.prod(shape[:-1]) if path.split("/")[-2] in ("o_proj", "down_proj") \
        else shape[0]
    return base_width / fan_in


def reference_update(name, spec, g, p, state, step):
    """The optimizer's update of one leaf in float64 from the state before
    the step: (update, Lion's sign-argument margin mask or None)."""
    params = spec["params"]
    lr, wd = params["lr"], params.get("weight_decay", 0.0)
    if name == "Lion":
        m = state["exp_avg"]
        c = 0.9 * m + 0.1 * g
        clear = c.abs() > SIGN_MARGIN * (0.9 * m.abs() + 0.1 * g.abs())
        return -lr * (torch.sign(c) + wd * p), clear
    if name == "Adagrad":
        g = g + wd * p
        return -lr * g / ((state["sum_sq"] + g * g).sqrt() + 1e-10), None
    if name == "SGD":
        u = g + wd * p
        t = u + params["momentum"] * state["trace"]
        return -lr * (u + params["momentum"] * t), None
    m = 0.9 * state["exp_avg"] + 0.1 * g
    v = 0.999 * state["exp_avg_sq"] + 0.001 * g * g
    u = -lr * (m / (1 - 0.9 ** step)) / ((v / (1 - 0.999 ** step)).sqrt() + 1e-8) - lr * wd * p
    return u, None


def other_optimizers_phase(card):
    """Phase 20 (b): Lion, Adagrad, SGD (momentum 0.9, nesterov) and MuAdamW
    (base_width 256) at TinyLlama's full width and 2 layers (micro 4 x
    2048, gas 2, bf16, clipping 1.0, the fused loss), 3 steps each on one
    batch: losses finite and falling; the last step's update of layer 0's
    leaves and the final norm against the same step in float64 on the CPU
    from the same state and gradients (UPDATE_RTOL; Lion's sign outside
    SIGN_MARGIN); MuAdamW launches fused Adam once a step, the others
    never."""
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import fused_adam
    from deepspeed_tpu_torch.ops.optimizers import path_name

    cfg = dataclasses.replace(train_models()["TinyLlama-1.1B"], num_layers=2)
    init = init_params(cfg, seed=7, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    batch = torch.randint(0, cfg.vocab_size, (2, 4, TRAIN_SEQ), generator=gen, device="cuda")
    base = {k: v for k, v in TRAIN_CONFIG.items() if k != "scheduler"}
    checked = lambda path: path.startswith("layer_0/") or path.startswith("final_norm/")
    ok = True
    for name, spec in OTHER_OPTIMIZERS.items():
        engine = extras_engine(cfg, init, dict(base, optimizer=spec))
        seen = {}
        update = engine.tx.update

        def recording(grads, state, params, update=update, seen=seen):
            # the state's tensors by (state key, leaf path), copied before
            # the step changes them in place
            before = {}
            for kp, x in torch.utils._pytree.tree_flatten_with_path(state)[0]:
                if isinstance(x, torch.Tensor):
                    field = [getattr(e, "name", None) for e in kp if hasattr(e, "name")]
                    path = path_name([e for e in kp if hasattr(e, "key")])
                    if checked(path):
                        before[(field[-1], path)] = x.double().cpu()
            g = {path_name(kp): x.double().cpu() for kp, x in
                 torch.utils._pytree.tree_flatten_with_path(grads)[0] if checked(path_name(kp))}
            p = {path_name(kp): x.double().cpu() for kp, x in
                 torch.utils._pytree.tree_flatten_with_path(params)[0]
                 if checked(path_name(kp))}
            u, new = update(grads, state, params)
            seen.update(g=g, p=p, state=before, u={
                path_name(kp): x.double().cpu() for kp, x in
                torch.utils._pytree.tree_flatten_with_path(u)[0] if checked(path_name(kp))})
            return u, new

        engine.tx = engine.tx._replace(update=recording)
        fused_adam.reset_launch_counts()
        losses = [float(engine.train_batch(batch)) for _ in range(3)]
        launches = fused_adam.launch_counts["fused_adam"]
        shapes = dict(zip(engine._paths, (tuple(m.shape) for m in engine._masters)))
        del engine
        torch.cuda.empty_cache()
        num = den = 0.0
        excluded = total = 0
        for path, g in seen["g"].items():
            state = {k: v for (k, pth), v in seen["state"].items() if pth == path}
            want, clear = reference_update(name, spec, g, seen["p"][path], state, 3)
            if name == "MuAdamW":
                want = want * mu_factor(path, shapes[path], spec["params"]["base_width"])
            got = seen["u"][path].reshape(want.shape)
            if clear is not None:
                excluded += int((~clear).sum())
                total += clear.numel()
                want, got = want[clear], got[clear]
            num += float((got - want).square().sum())
            den += float(want.square().sum())
        err = math.sqrt(num / den)
        want_launches = 3 if name == "MuAdamW" else 0
        good = (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
                and err <= UPDATE_RTOL and launches == want_launches
                and (total == 0 or excluded <= SIGN_EXCLUDED * total))
        ok &= good
        log(f"extras (b) {name} (TinyLlama widths, 2 layers, 3 steps): losses {losses}; "
            f"step 3's update of {len(seen['g'])} leaves against float64 on the CPU: "
            f"relative L2 error {err:.3e} (<= {UPDATE_RTOL:g})"
            + (f", {excluded} of {total} elements inside Lion's sign margin "
               f"(<= {SIGN_EXCLUDED:g})" if total else "")
            + f"; fused Adam launches {launches} (want {want_launches}): "
            f"{'ok' if good else 'FAIL'}")
    del init
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"extras (b) FAILED [{card}]")


def dropout_remat_phase():
    """Phase 20 (c): phase 8's remat ("nothing_saveable" per layer) at 2
    layers of TinyLlama with dropout 0.1, one step (micro 4 x 2048, gas 2)
    from the same weights, seed and batch as the run without remat: each
    layer's mask comes from a seed fixed before the forward, so the
    recompute draws it again and the loss and gradient norm agree within
    REMAT_RTOL, at a lower peak."""
    from deepspeed_tpu_torch.models import init_params

    base = dataclasses.replace(train_models()["TinyLlama-1.1B"], num_layers=2,
                               dropout=EXTRAS_DROPOUT)
    init = init_params(base, seed=5, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    batch = torch.randint(0, base.vocab_size, (2, 4, TRAIN_SEQ), generator=gen, device="cuda")
    out = {}
    for name, over in (("none", {}), ("remat", dict(remat=True,
                                                    remat_policy="nothing_saveable"))):
        engine = extras_engine(dataclasses.replace(base, **over), init, TRAIN_CONFIG)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = float(engine.train_batch(batch))
        out[name] = (loss, engine.get_global_grad_norm(),
                     torch.cuda.max_memory_allocated() - base_mem)
        del engine
        torch.cuda.empty_cache()
    (l0, n0, p0), (l1, n1, p1) = out["none"], out["remat"]
    good = (abs(l1 - l0) <= REMAT_RTOL * abs(l0) and abs(n1 - n0) <= REMAT_RTOL * abs(n0)
            and p1 < p0)
    log(f"extras (c) remat with dropout {EXTRAS_DROPOUT} (TinyLlama widths, 2 layers): loss "
        f"{l1!r} vs {l0!r}, grad norm {n1!r} vs {n0!r} (tol rel {REMAT_RTOL:g}), step "
        f"peak {p1 / 2**30:.2f} vs {p0 / 2**30:.2f} GiB above the resident state: "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("extras (c) FAILED")


def check_lamb_dp(spec, ranks, card):
    """Phase 20 (d), in phase 11's world: LAMB with the embedding frozen at
    2 layers at ZeRO stages 0, 2 and 3 (LAMB_MODES): stage 2's and 3's
    first loss bitwise stage 0's and the later ones within 0.02 |ref| +
    1e-3, the masters bitwise equal across ranks, the frozen leaf bitwise
    its initial value, LAMB's trust ratios of every step within TRUST_RTOL
    of stage 0's, the state over the trainable leaves' fragments only and
    no fused-Adam launch."""
    r0 = ranks[0]
    ref = r0[LAMB_MODES[0]]
    ok = True
    for mode in LAMB_MODES:
        a = r0[mode]
        checks = {
            "ranks report one loss": all(r[mode]["losses"] == a["losses"] for r in ranks),
            "masters bitwise equal across ranks": all(r[mode]["masters_equal"]
                                                      for r in ranks),
            "frozen leaf bitwise unchanged": all(r[mode]["frozen_equal"] for r in ranks),
            "losses finite and falling": (all(map(math.isfinite, a["losses"]))
                                          and a["losses"][-1] < a["losses"][0]),
            "no fused-Adam launch": all(r[mode]["launches"]["fused_adam"] == 0
                                        for r in ranks),
            "state over the trainable leaves only": (
                sum(r[mode]["adam_elems"] for r in ranks) == a["n"] - a["n_frozen"]
                if a["stage"] else a["adam_elems"] == a["n"] - a["n_frozen"]),
        }
        if mode != LAMB_MODES[0]:
            trust = np.array(a["trust"]) / np.array(ref["trust"]) - 1
            checks.update({
                "first loss bitwise stage 0's": a["losses"][0] == ref["losses"][0],
                "losses within 0.02|ref| + 1e-3 of stage 0's": all(
                    abs(x - y) < 0.02 * abs(y) + 1e-3
                    for x, y in zip(a["losses"], ref["losses"])),
                f"trust ratios within {TRUST_RTOL:g} of stage 0's": (
                    float(np.abs(trust).max()) <= TRUST_RTOL),
            })
            log(f"extras (d) {mode}: trust ratios' largest relative distance from stage "
                f"0's {float(np.abs(trust).max()):.3e}")
        good = all(checks.values())
        ok &= good
        log(f"extras (d) {mode} (world {spec['world']}, LAMB, frozen {FROZEN}, "
            f"{LAMB_LAYERS} layers): losses {a['losses']}, peak per rank "
            f"{[round(r[mode]['peak'] / 2**30, 2) for r in ranks]} GiB, "
            f"{float(np.mean(a['times'][1:])) * 1e3:.1f} ms/step (two ranks sharing "
            f"{card}): {'ok' if good else 'FAIL ' + str([k for k, v in checks.items() if not v])}")
    return ok


def zero3_7b_run(card: str, workdir: Path) -> bool:
    """Llama-2-7B at ZeRO stage 3 on four cards (32 layers, seq 4096, micro
    1 per rank, gas 2, per-layer remat): check_dp's gates and the peak per
    rank at most ZERO3_7B_GIB, printed beside 18P / 4."""
    from deepspeed_tpu_torch.runtime.zero.stage3 import MAX_LIVE

    base = dict(DP_SPEC, backend="nccl", layers=22, micro=4, steps=6)
    spec7 = dict(base, world=4, model="7b", layers=32, micro=1, seq=4096, steps=4,
                 remat=True, modes=["stage3"])
    ranks = run_dp_world(spec7, workdir)
    ok, r0 = check_dp(spec7, ranks, card)
    peaks = [r["stage3"]["peak"] for r in ranks]
    n = r0["stage3"]["n"]
    fits = max(peaks) <= ZERO3_7B_GIB * 2**30
    u = r0["stage3"]["units"]
    live_ok = all(max(r["stage3"]["units"]["peak_units"].values()) <= MAX_LIVE for r in ranks)
    log(f"dp cards llama-2-7b stage 3 [{card}]: {n} parameters, peak per rank "
        f"{[round(p / 2**30, 2) for p in peaks]} GiB against 18P / 4 = "
        f"{18 * n / 4 / 2**30:.2f} GiB of model state, at most {ZERO3_7B_GIB} GiB: "
        f"{'ok' if fits else 'FAIL'}; units gathered at once (rank 0) forward "
        f"{u['peak_units']['forward']} ({u['peak_bytes']['forward'] / 2**30:.2f} GiB), "
        f"backward {u['peak_units']['backward']} ({u['peak_bytes']['backward'] / 2**30:.2f} "
        f"GiB) of {u['count']}, at most {MAX_LIVE}: {'ok' if live_ok else 'FAIL'}; stage 0 "
        f"would need {18 * n / 1e9:.1f} GB of model state per rank (18P)")
    return ok and fits and live_ok


def cards_run(n_cards: int, card: str, only_7b: bool = False) -> int:
    """--cards N: data-parallel training over NCCL, one rank per card, at
    TinyLlama-1.1B's full depth (micro 4 x 2048 per rank, gas 2): one card
    with the exact reduction as the baseline, then N cards in every mode
    (stage 0 with each compressed_collectives mode, ZeRO stages 1-3), each
    held to check_dp. Prints tokens/s and the scaling over one card. On
    four cards also Llama-2-7B at ZeRO stage 3 (zero3_7b_run), alone with
    ``only_7b``."""
    import shutil

    base = dict(DP_SPEC, backend="nccl", layers=22, micro=4, steps=6)
    workdir = REPO / "build" / "dp_cards"
    ok1 = okn = True
    if not only_7b:
        ok1, one = check_dp(dict(base, world=1, modes=["none"]),
                            run_dp_world(dict(base, world=1, modes=["none"]), workdir), card)
        spec = dict(base, world=n_cards)
        okn, many = check_dp(spec, run_dp_world(spec, workdir), card)
        t1 = float(np.mean(one["none"]["times"][1:]))
        for mode in spec["modes"]:
            tn = float(np.mean(many[mode]["times"][1:]))
            log(f"dp cards {mode}: {n_cards} cards {tn * 1e3:.1f} ms/step vs one card "
                f"{t1 * 1e3:.1f} ms/step: {n_cards * t1 / tn:.2f}x the tokens/s of one card "
                f"({t1 / tn:.3f} scaling efficiency)")
    ok7 = zero3_7b_run(card, workdir) if n_cards == 4 else True
    shutil.rmtree(workdir, ignore_errors=True)
    return 0 if ok1 and okn and ok7 else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving runs (bf16 and int8 KV) and one extra "
                         "training step with torch.profiler and print device time "
                         "by kernel (slows the runs it traces)")
    ap.add_argument("--cards", type=int, default=0,
                    help="instead of the phases: data-parallel training over NCCL on "
                         "this many cards, one rank each, at full depth")
    ap.add_argument("--zero3-7b", action="store_true",
                    help="with --cards 4: only Llama-2-7B at ZeRO stage 3")
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
    mem_available, cpu_model, cpu_count = host_memory()
    cpu_model = f"{cpu_model}, {cpu_count} CPUs"
    log(f"host: MemAvailable {mem_available / 1e9:.1f} GB, {cpu_model}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 parity: no TF32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    libs = _build.build(sorted(p.name for p in _build.CSRC.glob("*.cu")))
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_libs = [_build.build_host(p.name) for p in sorted(_build.HOST_CSRC.glob("*.cpp"))]
    log(f"build (g++, host): {', '.join(p.name for p in host_libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.build_logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"ptxas {src} {kernel}: {line.split(':', 1)[-1].strip()}")

    if args.cards:
        if args.cards > count:
            raise SystemExit(f"--cards {args.cards}: only {count} cards")
        return cards_run(args.cards, card, only_7b=args.zero3_7b)

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        mem = meminfo_gb()
        log(f"phase time: {label} {time.perf_counter() - t:.1f} s; after it MemAvailable "
            f"{mem['MemAvailable']:.1f} GB (Cached {mem['Cached']:.1f}, AnonPages "
            f"{mem['AnonPages']:.1f}), resident {rss_bytes() / 1e9:.2f} GB")
        return out

    # phase 3
    rows = timed("3 paged", kernel_phase, pa)
    timed("3 paged (D 96, 256, 80)", wide_paged_phase, pa)
    rows.update(timed("3 flash", flash_phase, fa))
    rows.update(timed("3 sparse", sparse_phase, sa, fa))
    rows.update(timed("3 adam", adam_phase, adam))
    rate, rates = host_ceiling()
    log(f"host memory ceiling: {rate / 1e9:.1f} GB/s ({rates}; {torch.get_num_threads()} "
        f"torch threads); {cpu_model}")
    rows.update(timed("3 host adam", host_adam_phase, rate))
    rows.update(timed("3 aio", aio_phase, rate))
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
        # every bf16 paged launch on the sm90 route, a whole number per layer
        if (bf16_run["routes"][kernel] != {"sm90": n, "cuda_core": 0}
                or n % bf16_run["cfg"].num_layers):
            raise SystemExit(f"slice: {kernel} launches {n} routed "
                             f"{bf16_run['routes'][kernel]}, not all on sm90 per layer")
    timed("5 serving parity", path_phase)
    models = train_models()
    # phase 12, 13: int8 and float8 KV serving, int8 path parity
    launches.update(timed("12 int8/fp8 KV serving", kv_quant_phase, pa, card, bf16_run,
                          profile=args.profile))
    timed("13 int8 path parity", int8_path_phase)
    # phase 14: sparse attention through its entry point
    launches.update(timed("14 sparse path", sparse_path_phase, sa, sparse_op))
    # phase 16, 17: serving phi-3-mini (D 96) and Pythia-1B (D 256) at full
    # size, and serving path parity at the widths of D 96, 256 and 80
    timed("16 serving (phi-3-mini, Pythia-1B)", wide_serving_phase, pa, card, models,
                 profile=args.profile)
    for name in ("phi-3-mini", "Pythia-1B", "Pythia-2.8B"):
        cfg = dataclasses.replace(models[name], num_layers=2)
        timed(f"17 serving parity ({name} widths)", path_phase, cfg, name)
        timed(f"17 int8 path parity ({name} widths)", int8_path_phase, cfg, name)
    # phase 6, 7: the training path
    launches.update(timed("6 training", train_phase, (fa, adam, fl), card, "TinyLlama-1.1B",
                          models["TinyLlama-1.1B"], profile=args.profile))
    # phase 15: Pythia-1B, its head dim 256 through the flash kernels
    timed("15 training (Pythia-1B)", train_phase, (fa, adam, fl), card, "Pythia-1B",
          models["Pythia-1B"], profile=args.profile)
    for name, cfg in models.items():
        timed(f"7 training parity ({name} widths)", train_parity_phase, name, cfg)
    timed("7 offload parity (TinyLlama widths)", offload_parity_phase)
    # phase 8, 9: activation checkpointing, checkpoint save and resume,
    # offload_states
    timed("8 remat", remat_phase, fa)
    timed("9 checkpoint", checkpoint_phase)
    timed("9 offload checkpoint", offload_checkpoint_phase)
    launches.update(timed("9 offload_states", offload_states_phase))
    # phase 11: data-parallel training, the compressed gradient all-reduce
    # and ZeRO stages 1-3
    launches.update(timed("11 data parallel", dp_phase, card))
    # phase 18: full-depth ZeRO-3, two ranks on one card
    timed("18 zero3 (TinyLlama-1.1B, 22 layers)", zero3_phase, card)
    # phase 19: ZeRO-Offload at full size on one card
    launches.update(timed("19 offload", offload_phase, card, cpu_model))
    # phase 20: the engine's remainder ((d) ran in phase 11's world)
    timed("20 (a) LAMB, dropout, frozen, prefetch (TinyLlama-1.1B)", extras_phase, card,
          (fa, adam, fl))
    timed("20 (b) Lion, Adagrad, SGD, MuAdamW (TinyLlama widths)", other_optimizers_phase,
          card)
    timed("20 (c) remat with dropout (TinyLlama widths)", dropout_remat_phase)

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/pallas/"
    origin = {
        "paged_attention": ("paged_attention_sm90.cu", "paged_attention.py:53"),
        "paged_flash_decode": ("paged_attention_sm90.cu", "paged_attention.py:224"),
        "paged_flash_decode_int8": ("paged_attention_sm90_int8.cu", "paged_attention.py:224"),
        "sparse_attention_fwd": ("sparse_attention_sm90.cu", "sparse_attention.py:151"),
        "flash_attention_fwd": ("flash_attention_sm90.cu", "flash_attention.py:52"),
        "flash_attention_bwd_dkdv": ("flash_attention_sm90.cu", "flash_attention.py:149"),
        "flash_attention_bwd_dq": ("flash_attention_sm90.cu", "flash_attention.py:199"),
        "fused_adam": ("fused_adam.cu", "fused_adam.py:27"),
        "fused_loss_fwd": ("fused_loss_sm90.cu", "fused_loss.py:73"),
        "fused_loss_dlogits": ("fused_loss_sm90.cu", "fused_loss.py:152"),
        "fused_loss_dh": ("fused_loss_sm90.cu", "fused_loss.py:164"),
        "fused_loss_dk": ("fused_loss_sm90.cu", "fused_loss.py:185"),
        "quantize_int8": ("quant.cu", "quant.py:32"),
        "quantize_int8_sr": ("quant.cu", "quant.py:41"),
        "dequantize_int8": ("quant.cu", "quant.py:55"),
        # the host kernels replace the JAX package's own C++ (no Pallas kernel)
        "cpu_adam": ("host/cpu_adam.cpp", "csrc/adam/cpu_adam.cpp:55"),
        "aio": ("host/aio.cpp", "csrc/aio/aio.cpp:229"),
    }
    kernels = [dict(name=n, route="cuda", source=csrc + origin[n][0],
                    replaces=(origin[n][1] if origin[n][1].startswith("csrc/")
                              else pallas + origin[n][1]),
                    launches=launches[n],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    **({"runs_on": "host"} if origin[n][0].startswith("host/") else {}))
               for n, r in rows.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
