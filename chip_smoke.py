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
   widths of phi-3-mini (32/32, D 96), Pythia-1B (8/8, D 256),
   Pythia-2.8B (32/32, D 80) and Megatron GPT-2 345M (16/16, D 64), a GQA
   16/4 case at D 256 and pages of 16
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
   on NCCL at world size 1 with one all-reduce; stage 2's peak per rank at
   least 2P bytes (half the full fp32 gradient buffer stage 1 keeps) below
   stage 1's (phase 23 (d)). Its step time is two ranks sharing one card,
   not a scaling number. Phase 20 (d) runs in the same world after these
   modes;
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
   layers of the widths of phi-3-mini, Pythia-1B, Pythia-2.8B (D 80) and
   Megatron GPT-2 345M (D 64):
   the kernel path's packed-step and decode-step logits (and the int8
   decode step's) within twice the einsum path's distance from float32,
   each paged launch of the kernel path on ``sm90``;
18. ZeRO-3 at depth — phase 11's world at 6 of TinyLlama-1.1B's 22 layers, 3
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
   within TRUST_RTOL of stage 0's;
21. mixture of experts — (a) Mixtral-8x7B's widths (hidden 4096, 32/8
   heads, ffn 14336, 8 experts, top-2, vocab 32000) at 2 of its 32 layers
   through phase 6's recipe, once on the capacity path (factor 1.25) and
   once dropless: phase 6's gates, peak memory below 18 B a parameter plus
   MOE_ACTIVATION_BYTES; step time, tokens/s, MFU over the parameters a
   token runs through, the MoE blocks' share of the step (CUDA events),
   one step's host syncs and the dropped assignments printed; (b) one
   Mixtral block in bf16 against float32 on both paths: top-2 agreement and
   the error on agreeing tokens within MOE_BF16_RTOL; (c) Mixtral-8x7B's
   widths at 8 layers and Qwen1.5-MoE-A2.7B (60 experts, top-4, a shared
   expert) at its published size served with phase 16's gates, then phase
   5's path parity for both at 2 layers with the routing of the kernel
   run replayed (ROUTE_AGREE of tokens routing alike);
22. every decoder family the JAX package loads — (a) BLOOM-1b7 (ALiBi)
   and GPT-Neo-1.3B (alternating 256-token windows, unscaled) at their
   published widths and 12 of their 24 layers, their HF configs as dicts
   in this script and seeded
   HF-named bf16 state dicts drawn on the host, loaded through
   ``inference.params_from_hf`` and served by phase 4's ``slice_phase``
   (16 requests, prompts of 300..1024 tokens, 64 new tokens): phase 4's
   gates, no paged-kernel launch (both attention paths on the einsum, the
   decode's source ``fallback``), ``attn_backend="pallas"`` refused with
   the ``ValueError``; (b) at 2 layers of BLOOM-1b7's, GPT-Neo-1.3B's and
   MPT-7B's widths (post-scale ALiBi): the last packed step of a chunked
   prefill over prompts that cross pages and windows, a fused decode step
   and a 16-step ``decode_loop`` in float32 and bf16, against the dense
   ``lm_forward`` over the same sequences: float32 within
   ``FAMILY_FP32_RTOL`` of the largest logit, bf16 within ``NOISE_FACTOR``
   x the bf16 dense forward's distance; (c) speculative decoding on
   Llama-2-7B at phase 4's full depth: 16 requests of a seeded 64-token
   segment repeated 4 times, 64 new tokens, ``spec_decode_k=4`` against
   spec off: the packed kernel launched in the spec run, a whole number
   per layer, all on ``sm90``; each spec stream equal to the spec-off
   stream or first differing where both tokens' logits lie within
   ``SPEC_TIE_MARGIN`` of the float32 recompute's largest; spec_steps, drafted,
   accepted, acceptance and tok/s of both runs printed;
23. checkpoint interchange — (a) ``nvidia/megatron-gpt2-345m``'s args
   (hidden 1024, 24 layers, 16 heads of D 64, ffn 4096, 1024 positions,
   padded vocab 50304) written with seeded fp16 weights as two tp ranks in
   Megatron-LM's layout (``build/megatron_smoke/mp_rank_0r/model_optim_rng.pt``,
   checkpoint version 2.0), read by ``load_megatron_checkpoint``, merged by
   ``SDLoaderFactory`` (``layout="megatron"``), mapped by
   ``megatron_config`` / ``megatron_params``, put on the card by
   ``params_from_jax`` and served by phase 4's ``slice_phase`` (prompts of
   128..896 tokens) with phase 16's gates at D 64; (b) resharding bitwise:
   the merged dict split into 4 and merged back, ``params_to_megatron`` of
   ``megatron_params``, the written shards split again; (c) phase 11's
   world on the 345M at full depth at stage 0 and stage 2 (micro 2 x 1024,
   gas 2, 3 steps): phase 11's gates, launches exact (flash 24 x gas x
   steps a kernel on ``wgmma``), the stage-2 run saved, consolidated by
   ``python -m deepspeed_tpu_torch.utils.zero_to_fp32`` (bitwise
   ``safe_get_full_fp32_param``), exported as two tp shards through
   ``python -m deepspeed_tpu_torch.checkpoint.ds_to_universal --format
   megatron`` (bitwise the masters), and the universal tree trained a
   step at world size 1 (loss finite); (d) runs in phase 11's world, (e)
   in phase 3. The ``kernels`` line's launches stay the counts of the path
   each kernel's row names (the packed kernel's: phase 4's run);
24. the serving fleet — (a) two Llama-2-7B replicas (bf16, seeded weights
   of their own, 512 KV blocks of 32 slots each) built by
   ``LLMServer.from_config`` from a ``serving:`` block (heartbeats every
   0.5 s into ``build/fleet_smoke``, tenants gold and bronze on
   ``DEFAULT_CLASSES``, the deadline policy with a 120 s SLA, the canary
   every 16 steps, fused decode chunks of 16) behind a
   ``ReplicaRouter(dead_after_s=3.0)``, a ``ControlSupervisor`` ticking on
   replica 0 every 25 steps and a ``TelemetryManager`` tracing;
   ``OpenLoopTraffic`` (seed 11) sends 48 requests at 3 a second (prompts
   128..1024, 128 new tokens, tenants alternating) while a chaos schedule
   kills replica 1 at its serving step 60, stalls a prefill of replica 0,
   drops 4 of its token deliveries and reads the pool dry once, and a host
   loop calls ``router.check()`` every 0.25 s. Gates: every request
   finishes by length, each stream callback fires once per token index in
   order, replica 1 is declared dead within 5 s of the kill, the requeues
   equal replica 1's unfinished book at takeover and each resumed on
   replica 0 keeping its checkpointed tokens, the survivor drains with KV
   conservation, the packed kernel launched on both replicas before the
   kill and both paged kernels on the survivor after it, every launch on
   ``sm90`` and a whole number per layer per engine thread
   (``ThreadLaunches``), replica 0's canary ran >= 3 probes with no fail,
   the Chrome trace holds both threads' step and deliver spans, the
   registry exports replica 0's ``dstpu_serving_*`` and not the dead
   replica's, the tenants' completions sum to 48 and the supervisor
   ticked; (b) the SDC drill: two replicas at 8 layers, the canary every 8
   steps, replica 0's layer-0 ``o_proj`` negated after both learned their
   hash: its next probe fails, the router takes it over and the requests
   sent after the verdict finish on replica 1, whose canary stays clean;
25. the fleet's warm join — (a) a measuring comm planner on a fresh cache
   under ``build/fleet_join_smoke`` (margin 8, probe pools of 4M values:
   the paged decode kernel against the gathered-page einsum at the serving
   site), a ``FleetManager`` of 1..2 Llama-2-7B replicas (bf16, seeded
   weights of their own, phase 24's pool) started with one, a
   ``ControlSupervisor`` ticking on it every 32 steps with
   ``manager.scale_out`` as its ``scale_fn``; ``OpenLoopTraffic`` (seed
   25) sends 40 requests at 3 a second (prompts 128..1024, 64 new tokens,
   a 1 s deadline each) so ``rule_sla`` scales out, and once the fleet
   idles ``manager.poll()`` drains the less loaded replica. Gates: every
   request finishes by length; replica 0's engine resolved ``decode_attn``
   from the planner (both probes built, the decision measured) and its warm
   ran the two winner probes; replica 1 joined with zero probes (the cached
   winner, the planner's decision, no probe built); no request reached
   replica 1 before its JOINED time; the ledger holds ``replica_join``
   (``fleet_start``), ``serving_scale``, ``replica_join``
   (``fleet_scale_out``) and ``serving_scale_in`` drained clean; each
   replica's KV conservation; the serving winner was timed with the
   server's batch in flight and keyed by the model (ROADMAP C3), and served
   traffic ran the decided path: the decode kernel launched after JOINED
   iff ``fd8`` won and the planner picked the kernel; every launch on
   ``sm90``, a whole number
   per layer in all and per engine thread (replica 1's warm runs on replica
   0's thread, inside its control tick); the plan table names
   ``decode_attn``. (b) a router over replica 0 in this process and a
   ``SubprocessReplica`` replica 1 (``python -m
   deepspeed_tpu_torch.fleet.subproc`` with the factory
   ``chip_smoke:fleet_join_child_server``), both at Llama-2-7B's widths with
   8 layers and seed 0: replica 0 times the serving winner of its depth
   (a's 32-layer winner does not apply), the child's ``hello`` shows a
   zero-probe join from (a)'s plan and replica 0's winner, the counts its
   factory writes show the paged kernels on
   ``sm90``, its streams equal replica 0's for the same prompts (phase 22's
   tie rule), and after a SIGKILL mid-run ``router.check()`` takes it over
   within 5 s and every request finishes by length on replica 0;
26. tensor parallelism — (a) two ranks on cuda:0 over gloo (``--tp-child``,
   ``build/tp_smoke``), ``tensor_parallel.tp_size`` 2: TinyLlama-1.1B's
   widths at 4 of 22 layers (seeded weights, each leaf sliced to its rank by
   the generic rule pack), micro 2 x 2048, gas 2, bf16,
   ``vocab_parallel_loss`` with the fused loss on a 16000-wide vocab shard,
   AdamW, ZeRO 0, 4 steps. Gates: losses finite, falling and one value on
   both ranks; the first within 1e-3 |ref| of a tp 1 run of the same
   weights and batches in this process; every replicated leaf bitwise
   equal on both ranks; launches a rank exact (flash = layers x gas x
   steps, the fused loss's forward and combine gas x steps and each
   backward kernel gas x steps x chunks, fused Adam one a step), all on
   ``wgmma``; the fused-loss kernels on each rank's vocab shard at the
   path's shape (4096 x 2048 x 16000, target ids shifted by rank x 16000,
   so half of them out of the shard, on rank 1 negative) against their
   plain versions (lse / tgt rel 1e-4, dl / dh / dK rel 2e-2, as phase
   3's), the target logit 0 on every out-of-shard id, and
   ``fused_vocab_nll(axis_name="tp")`` against the plain NLL over the
   whole head; prints the step time, tokens/s and the peak per rank beside
   18P / 2. (b) ``all_gather_matmul`` and ``matmul_reduce_scatter`` at
   TinyLlama's MLP shape (4096 tokens, 2048 x 5632 split over tp), exact
   within bf16 rounding; over the int8 wire the all-gather within one bf16
   rounding of the product of the chunks through the plain quantizer and
   back, the reduce-scatter within half a step (absmax / 254) of its one
   hop's partial sum; the quant kernels launched. (c) the five TP decode functions at Llama-2-7B's
   widths (32 sequences, hidden 4096, vocab 32000) against the dense
   products, ``tp_greedy_token`` equal to the dense argmax. The world's
   launches add to the ``kernels`` line's counts.

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


#: the paged kernels' head dims other than 128 at published attention
#: widths (phase 3): phi-3-mini and Pythia-1B (phase 16 serves them),
#: Pythia-2.8B, and Megatron GPT-2 345M at D 64 (phase 23 serves it)
PAGED_WIDE = {"phi-3-mini 32/32 D96": dict(Hq=32, Hk=32, D=96),
              "pythia-1b 8/8 D256": dict(Hq=8, Hk=8, D=256),
              "pythia-2.8b 32/32 D80": dict(Hq=32, Hk=32, D=80),
              "megatron-gpt2-345m 16/16 D64": dict(Hq=16, Hk=16, D=64)}


def wide_paged_phase(pa):
    """Phase 3 at the head dims 96, 256, 80 and 64: at each width a serving
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
                n_requests=16, new_tokens=128, name="Llama-2-7B", cfg=None,
                params=None, lens=(128, 1024)):
    """Serve ``n_requests`` seeded prompts (lengths ``lens``, default
    128..1024) for ``new_tokens`` each through ``LLMServer`` at the widths
    of ``name`` (``cfg``; default Llama-2-7B; seeded random weights unless
    ``params`` are given) with the KV storage ``kv`` (``kv_cache_dtype``).
    Kernel launch counts are reset just before and read just after the run.
    Gates: every request finishes by length with in-vocabulary tokens, the
    server drains, KV conservation holds. Returns what the run measured."""
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
    if params is None:
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
    lens = rng.integers(lens[0], lens[1] + 1, 16)[:n_requests]
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


def wide_serving_phase(pa, card, models, profile=False, names=("phi-3-mini", "Pythia-1B")):
    """Phase 16: phi-3-mini-4k (head dim 96) and Pythia-1B (256) served at
    their published sizes (phase 21: ``names`` of the MoE models) through
    ``slice_phase`` (16 requests, 128 new tokens each, 1024 KV blocks of 32
    slots), with phase 4's gates and theirs: both paged kernels launch,
    every launch on ``sm90``, a whole number per layer, and the engine
    resolves the kernels on both paths by its heuristic. Returns each
    model's run."""
    out = {}
    for name in names:
        out[name] = check_kernel_serving(
            slice_phase(pa, card, profile=profile, name=name, cfg=models[name]), name)
    return out


def check_kernel_serving(run, name):
    """Phase 16's gates on a ``slice_phase`` run: both paged kernels launch,
    every launch on ``sm90``, a whole number per layer, and the engine
    resolves the kernels on both paths by its heuristic. Returns the run."""
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
    return run


# ---------------------------------------------------------------------------
# phase 5: kernel path vs einsum path through the model functions
# ---------------------------------------------------------------------------


class RouteReplay:
    """Phase 21's rule for routing near-ties in path parity. An MoE model's
    bf16 runs round activations at different places, so a token whose k-th
    and (k+1)-th router probabilities nearly tie can pick another expert on
    each path, and its logits then differ by O(1) whatever the attention
    kernels do. So the kernel run records each dropless call's top-k choice
    (``moe.sharded_moe._top_k``), the einsum runs (bf16 and float32) replay
    it with their own gate values, and the logits compare as a dense
    model's do. Each replaying call counts the tokens whose own choice was
    the recorded one; their share must reach ``ROUTE_AGREE``."""

    def __init__(self):
        self.recorded, self.pos, self.agree, self.total = [], 0, 0, 0

    @contextlib.contextmanager
    def __call__(self, record: bool):
        from deepspeed_tpu_torch.moe import sharded_moe

        orig = sharded_moe._top_k
        if record:
            self.recorded = []
        self.pos = 0

        def top_k(x, k):
            vals, idx = orig(x, k)
            if record:
                self.recorded.append(idx)
                return vals, idx
            want = self.recorded[self.pos]
            self.pos += 1
            same = (idx.sort(-1).values == want.sort(-1).values).all(-1)
            self.agree += int(same.sum())
            self.total += same.numel()
            return torch.gather(x, -1, want), want

        sharded_moe._top_k = top_k
        try:
            yield
        finally:
            sharded_moe._top_k = orig

    def share(self):
        share = self.agree / max(self.total, 1)
        self.agree = self.total = 0
        return share


ROUTE_AGREE = 0.9


def path_phase(cfg=None, name="Llama-2-7B"):
    """Phase 5 (Llama-2-7B widths at 4 layers), 17 and 21 (``cfg``): one
    packed step and one fused decode step / chunk through the kernel path
    (every paged launch on ``sm90``, once per layer), the einsum path in
    bf16 and the einsum path in float32 on identical pools; the kernel
    path's logits within ``NOISE_FACTOR`` x the einsum path's distance from
    float32. An MoE model's packed and decode steps route as the kernel
    run did (:class:`RouteReplay`); the 16-step ``decode_loop`` routes each
    run its own way (its token agreement is printed, not gated)."""
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
    routing = RouteReplay() if cfg.num_experts else None
    routed = lambda run: (routing(run == "kernel") if routing is not None
                          else contextlib.nullcontext())
    pools, packed, sm90 = {}, {}, {}
    for run, (impl, c, p) in runs.items():
        kk, vv = k0.to(c.dtype, copy=True), v0.to(c.dtype, copy=True)
        pa.reset_launch_counts()
        with routed(run):
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
    agreed = {}
    if routing is not None:
        agreed["packed"] = routing.share()
        log(f"path parity packed step ({tag}): einsum and fp32 runs replay the kernel "
            f"run's routing; share of tokens whose own top-{cfg.moe_top_k} set agreed "
            f"{agreed['packed']:.4f} (need >= {ROUTE_AGREE})")
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
        with routed(run):
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
    if routing is not None:
        agreed["decode"] = routing.share()
        log(f"path parity decode step ({tag}): routing replayed from the kernel run; "
            f"own top-{cfg.moe_top_k} set agreed for {agreed['decode']:.4f} of tokens "
            f"(need >= {ROUTE_AGREE})")
        launched = launched and min(agreed.values()) >= ROUTE_AGREE
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
    # contexts of up to 1900 tokens, fewer where the model has fewer
    # positions (learned ones: Megatron GPT-2 345M's 1024)
    hi = min(1900, cfg.max_seq_len - W)
    pos0 = torch.from_numpy(rng.integers(100, hi, S).astype(np.int32)).to(dev)
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
        f"ctx 100..{hi}): "
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


def train_phase(kernels, card, name, cfg, profile=False, n_matmul=None, after=None):
    """A model (``name``, ``cfg``: TinyLlama-1.1B in phase 6, Pythia-1B in
    phase 15, Mixtral-8x7B widths in phase 21) through initialize +
    train_batch, the optimizer and schedule from the config (AdamW takes
    the fused Adam kernel on the card), ``loss_impl: auto`` (the fused loss
    kernels on the card); the optimizer step timed with CUDA events.
    ``n_matmul``: the matrix parameters a token runs through (default: all
    but the embedding; an MoE model's k of E experts); ``after(engine,
    batch)`` runs once the gates hold, before the engine goes."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn

    tag = f"train {name}"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    model = TransformerLM(cfg, params)
    engine, *_ = dst.initialize(model=make_loss_fn(model), model_parameters=params,
                                config=TRAIN_CONFIG)
    n_params = sum(p.numel() for p in engine._masters)
    if n_matmul is None:
        n_matmul = n_params - cfg.vocab_size * cfg.hidden_size  # no embedding gather
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
                               peak_gib=peak / 2**30, opt_ms=opt_ms, n_params=n_params,
                               losses=losses)
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
    if after is not None:
        after(engine, batch)
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

    if spec["model"] == MEGATRON_MODEL:
        return megatron_345m_config(spec["megatron_args"], num_layers=spec["layers"])
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
    by leaf) equal rank 0's bitwise to workdir/out_<rank>.json. A Megatron
    spec (phase 23) starts each mode from the tree merged from the shards
    under ``spec["megatron_dir"]`` and, with ``spec["export"]``, saves the
    stage-2 run and consolidates and exports it (``megatron_export``)."""
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
        if spec["model"] == MEGATRON_MODEL:
            init = zero.Init(lambda: megatron_tree_on_card(Path(spec["megatron_dir"]), cfg))
        else:
            init = zero.Init(lambda: init_params(cfg, seed=0, device="cuda",
                                                 dtype=torch.float32))
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
        flash_routes = {k: dict(v) for k, v in flash_attention.route_counts.items()}
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
        export = None
        if spec.get("export") and stage == 2:
            export = megatron_export(engine, cfg, paths, workdir, rank, spec["megatron_args"])
        out[mode] = dict(losses=losses, times=times, launches=launches, peak=peak,
                         flash_routes=flash_routes, export=export,
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


def run_dp_world(spec, workdir: Path, child: str = "--dp-child"):
    """Start spec["world"] ranks (this script with ``child``: --dp-child or
    --tp-child), one card each over NCCL or all on cuda:0 over gloo; returns
    their results."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    (workdir / "spec.json").write_text(json.dumps(spec))
    world = spec["world"]
    logs = [open(workdir / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), child, str(r), str(workdir)],
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
    model = spec["model"] if spec["model"] == MEGATRON_MODEL else f"llama {spec['model']}"
    log(f"dp [{card}]: {model} widths, {spec['layers']} layers ({n} "
        f"parameters), micro {spec['micro']} x {spec['seq']} per rank, gas "
        f"{DP_CONFIG['gradient_accumulation_steps']}, {steps} steps per mode, {where}; "
        f"wire bytes per int8 reduction {wire} vs logical {4 * n} ({4 * n / wire:.2f}x)")
    return ok, r0


def check_stage2_saving(ranks, card):
    """Phase 23 (d), read in phase 11's world: stage 2 holds no full fp32
    gradient buffer, so its peak per rank must lie at least half of that
    buffer's 4P bytes below stage 1's (P the model's parameters; the
    saving is about 4P less the largest unit's transient buffer). Prints
    the difference beside 4P and the estimator's stage-1 and stage-2
    model-state figures."""
    from deepspeed_tpu_torch import zero

    n, world = ranks[0]["stage1"]["n"], len(ranks)
    saved = [r["stage1"]["peak"] - r["stage2"]["peak"] for r in ranks]
    est = {s: zero.estimate_zero_model_states_mem_needs(n, s, world)["total_bytes"]
           for s in (1, 2)}
    ok = min(saved) >= 2 * n
    log(f"dp stage 2 against stage 1 [{card}]: peak per rank stage 1 "
        f"{[r['stage1']['peak'] for r in ranks]} B, stage 2 "
        f"{[r['stage2']['peak'] for r in ranks]} B: stage 2 lower by {saved} B "
        f"({[round(x / 2**30, 3) for x in saved]} GiB) against the full buffer's 4P = "
        f"{4 * n} B ({4 * n / 2**30:.3f} GiB), at least 2P = {2 * n} B required: "
        f"{'ok' if ok else 'FAIL'}; the estimator's model state stage 1 {est[1]} B "
        f"({est[1] / 2**30:.3f} GiB), stage 2 {est[2]} B ({est[2] / 2**30:.3f} GiB)")
    return ok


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
    ok &= check_stage2_saving(ranks, card)
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


def exact_launches(spec, ranks, tag):
    """Every rank's flash, fused-loss and Adam launches in each mode of a
    data-parallel world exactly what its path runs (flash: layers x gas x
    steps a kernel; the fused loss's forward and combine gas x steps, each
    backward kernel once per vocab chunk; Adam once a step), and every
    flash launch on ``wgmma``. Returns whether they were."""
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width

    cfg = dp_model(spec)
    gas, steps = DP_CONFIG["gradient_accumulation_steps"], spec["steps"]
    chunks = -(-cfg.vocab_size // chunk_width(spec["micro"] * spec["seq"], cfg.vocab_size, 2))
    want = {k: cfg.num_layers * gas * steps for k in FLASH_NAMES}
    want.update(fused_adam=steps, fused_loss_fwd=gas * steps,
                fused_loss_fwd_combine=gas * steps)
    for k in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[k] = gas * steps * chunks
    ok = True
    for mode in spec["modes"]:
        bad = {k: [r[mode]["launches"][k] for r in ranks] for k, w in want.items()
               if any(r[mode]["launches"][k] != w for r in ranks)}
        off_route = {k: r[mode]["flash_routes"][k] for r in ranks for k in FLASH_NAMES
                     if r[mode]["flash_routes"][k]["mma_sync"]}
        log(f"{tag} {mode}: launches per rank {ranks[0][mode]['launches']} (want {want}), "
            f"flash routes {ranks[0][mode]['flash_routes']} "
            f"{'ok' if not bad and not off_route else 'FAIL ' + str((bad, off_route))}")
        ok &= not bad and not off_route
    return ok


# ---------------------------------------------------------------------------
# phase 18: ZeRO-3 at depth on one card
# ---------------------------------------------------------------------------

#: 6 of TinyLlama-1.1B's 22 layers (its widths whole), so the script stays
#: within its time limit (11 until phase 26 came); the memory gate is
#: computed from the parameters
ZERO3_SPEC = dict(DP_SPEC, layers=6, steps=3, modes=["none", "stage3"])


def zero3_phase(card):
    """Phase 18: TinyLlama-1.1B at 6 of its 22 layers, two ranks on cuda:0 over
    gloo (micro 2 x 2048 each, gas 2, bf16, fused loss), 3 steps at stage 0
    and 3 at stage 3 from the same seed and batch: check_dp's gates, every
    flash, fused-loss and Adam launch exact per rank, stage 3's peak per
    rank at least three quarters of the estimator's predicted saving below
    stage 0's, and at stage 3 at most MAX_LIVE units gathered at once."""
    import shutil

    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.runtime.zero.stage3 import MAX_LIVE

    spec = ZERO3_SPEC
    workdir = REPO / "build" / "zero3_smoke"
    t0 = time.perf_counter()
    ranks = run_dp_world(spec, workdir)
    ok, r0 = check_dp(spec, ranks, card)
    shutil.rmtree(workdir, ignore_errors=True)
    ok &= exact_launches(spec, ranks, "zero3")
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
    log(f"zero3 [{card}]: TinyLlama-1.1B, {spec['layers']} layers, {n} parameters, two ranks sharing "
        f"cuda:0 over gloo (not a scaling number): peak per rank stage 0 "
        f"{[round(p / 2**30, 2) for p in peaks0]} GiB, stage 3 "
        f"{[round(p / 2**30, 2) for p in peaks3]} GiB; the estimator's model state "
        f"{est0 / 2**30:.2f} GiB (18P) against {est3 / 2**30:.2f} GiB (9P); stage 3 "
        f"saves {saved / 2**30:.2f} GiB per rank, at least three quarters of the "
        f"predicted {(est0 - est3) / 2**30:.2f} GiB ({need / 2**30:.2f}) required: "
        f"{'ok' if mem_ok else 'FAIL'}; step {ms['none']:.1f} ms at stage 0, "
        f"{ms['stage3']:.1f} ms at stage 3 (steps 2-{spec['steps']}); phase wall "
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


# ---------------------------------------------------------------------------
# phase 21: mixture of experts
# ---------------------------------------------------------------------------

# Qwen/Qwen1.5-MoE-A2.7B config.json, mapped as the JAX package's
# inference/hf.py maps qwen2_moe: hidden_size 2048, num_hidden_layers 24,
# num_attention_heads 16 = num_key_value_heads (head dim 128), vocab_size
# 151936, intermediate_size 5632, moe_intermediate_size 1408,
# shared_expert_intermediate_size 5632, num_experts 60, num_experts_per_tok
# 4, norm_topk_prob false, decoder_sparse_step 1, rope_theta 1e6,
# rms_norm_eps 1e-6, max_position_embeddings 8192, q/k/v biases, untied
# lm_head; served dropless, as the JAX serving path always is
QWEN_MOE = dict(vocab_size=151936, hidden_size=2048, intermediate_size=5632, num_layers=24,
                num_heads=16, num_kv_heads=16, max_seq_len=8192, norm="rmsnorm",
                activation="swiglu", position="rope", rope_theta=1e6, norm_eps=1e-6,
                attn_qkv_bias=True, tie_embeddings=False, num_experts=60, moe_top_k=4,
                moe_every=1, moe_offset=0, moe_intermediate_size=1408,
                moe_shared_expert_size=5632, moe_norm_topk=False, moe_dropless=True)
MIXTRAL_TRAIN_LAYERS, MIXTRAL_SERVE_LAYERS = 2, 8
# the trainer's model state: fp32 master, first and second moment and
# gradient, and the bf16 compute copy; activations at micro 4 x 2048 of two
# Mixtral layers (the capacity path keeps ~3.4 GiB a layer: the [E, G, C, F]
# expert intermediates and the [G, S, E, C] gating tensors) within the rest
MOE_STATE_BYTES_PER_PARAM = 18
MOE_ACTIVATION_BYTES = 16 * 2**30
# the bf16 MoE block against the same block in float32 (bf16 weights and
# inputs cast up): on the tokens whose top-k set agrees, the output within
# this share of the float32 output's largest magnitude (bf16 rounds each
# expert product's operands and the combine once, unit roundoff 2^-9)
MOE_BF16_RTOL = 3e-2


def mixtral_models():
    from deepspeed_tpu_torch.models import TransformerConfig, mixtral_config

    return {"Mixtral-8x7B": mixtral_config("8x7b", dtype=torch.bfloat16),
            "Qwen1.5-MoE-A2.7B": TransformerConfig(**QWEN_MOE, dtype=torch.bfloat16)}


class MoEProbe:
    """Phase 21's instruments on the MoE blocks of a training run: CUDA
    events around each block's forward and, through gradient hooks on its
    output and its input, its backward; the capacity path's kept
    assignments; while ``syncs`` is a list, the host syncs a block causes
    (``torch.cuda.set_sync_debug_mode`` warnings)."""

    def __init__(self):
        self.blocks, self.kept, self.syncs = [], [], None
        self.block_syncs = 0

    @contextlib.contextmanager
    def installed(self):
        from deepspeed_tpu_torch.moe import layer

        block, gating = layer.moe_block, layer.topk_gating

        def timed_block(cfg, p, x, used_token=None, seed=None, return_counts=False):
            n0 = None if self.syncs is None else len(self.syncs)
            ev = {"f0": _cuda_event()}
            out = block(cfg, p, x, used_token, seed=seed, return_counts=return_counts)
            ev["f1"] = _cuda_event()
            if n0 is not None:
                self.block_syncs += syncs_in(self.syncs, n0)
            if out[0].requires_grad:
                out[0].register_hook(lambda g: ev.setdefault("b0", _cuda_event()) and None)
                x.register_hook(lambda g: ev.setdefault("b1", _cuda_event()) and None)
            self.blocks.append(ev)
            return out

        def counted_gating(logits, k, capacity, *args, **kwargs):
            dispatch, combine, aux = gating(logits, k, capacity, *args, **kwargs)
            self.kept.append((dispatch.sum(), k * logits.shape[0] * logits.shape[1]))
            return dispatch, combine, aux

        layer.moe_block, layer.topk_gating = timed_block, counted_gating
        try:
            yield self
        finally:
            layer.moe_block, layer.topk_gating = block, gating

    def block_ms(self, first: int, last: int) -> float:
        """Forward plus backward milliseconds of the block calls
        ``[first, last)``, summed."""
        torch.cuda.synchronize()
        ms = 0.0
        for ev in self.blocks[first:last]:
            ms += ev["f0"].elapsed_time(ev["f1"])
            if "b0" in ev and "b1" in ev:
                ms += ev["b0"].elapsed_time(ev["b1"])
        return ms

    def dropped(self) -> float:
        kept = sum(int(n) for n, _ in self.kept)
        return 1.0 - kept / max(sum(m for _, m in self.kept), 1)


@contextlib.contextmanager
def sync_log():
    """The CUDA sync debug mode on: yields the live list of the warnings
    recorded meanwhile; :func:`syncs_in` counts the synchronizing calls
    among them (the autograd engine hands its threads' warnings over when
    the backward ends)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)


def syncs_in(seen, start: int = 0) -> int:
    return sum("synchronizing" in str(w.message) for w in seen[start:])


def moe_train_phase(card, kernels):
    """Phase 21 (a): Mixtral-8x7B's widths at 2 of its 32 layers (the
    whole model is 93 GB in bf16) through phase 6's recipe, on the capacity
    path (factor 1.25) and on the dropless path: phase 6's gates (losses
    finite and falling, flash / fused-loss / fused-Adam launches exact and
    on ``wgmma``) and peak memory below 18 B a parameter plus
    MOE_ACTIVATION_BYTES. MFU counts the matrix parameters a token runs
    through (k of E experts); the MoE blocks' share of the step comes from
    CUDA events around their forward and backward over the timed steps;
    the host syncs of one more step are counted with the sync debug mode;
    the capacity path's dropped assignments are counted over the run."""
    from deepspeed_tpu_torch.models.convert import param_shapes

    base = dataclasses.replace(mixtral_models()["Mixtral-8x7B"],
                               num_layers=MIXTRAL_TRAIN_LAYERS)
    ok = True
    for path, cfg in (("capacity", dataclasses.replace(base, moe_capacity_factor=1.25)),
                      ("dropless", dataclasses.replace(base, moe_dropless=True))):
        name = f"Mixtral-8x7B widths, {cfg.num_layers} layers, {path}"
        shapes = param_shapes(cfg)
        numel = lambda keys: sum(math.prod(shapes[k]) for k in keys)
        experts = numel([k for k in shapes if "/moe/expert_" in k])
        n_all = numel(shapes)
        n_active = (n_all - cfg.vocab_size * cfg.hidden_size
                    - experts * (cfg.num_experts - cfg.moe_top_k) // cfg.num_experts)
        probe = MoEProbe()
        syncs = {}

        def after(engine, batch):
            probe.block_syncs = 0
            with sync_log() as seen:
                probe.syncs = seen
                float(engine.train_batch(batch))
            probe.syncs = None
            syncs.update(step=syncs_in(seen), blocks=probe.block_syncs)

        with probe.installed():
            train_phase(kernels, card, name, cfg, n_matmul=n_active, after=after)
        fig = TRAIN_FIGURES[name]
        per_step = cfg.num_layers * TRAIN_CONFIG["gradient_accumulation_steps"]
        moe_ms = probe.block_ms(WARMUP_STEPS * per_step,
                                (WARMUP_STEPS + TIMED_STEPS) * per_step) / TIMED_STEPS
        budget = MOE_STATE_BYTES_PER_PARAM * fig["n_params"] + MOE_ACTIVATION_BYTES
        peak = fig["peak_gib"] * 2**30
        dropped = probe.dropped() if path == "capacity" else 0.0
        log(f"moe train [{name}] [{card}]: {fig['n_params']} parameters ({n_active} "
            f"matrix parameters a token runs through: top-{cfg.moe_top_k} of "
            f"{cfg.num_experts} experts), {fig['step_ms']:.1f} ms/step, "
            f"{fig['tokens_s']:.0f} tokens/s, MFU {fig['mfu']:.4f}, peak "
            f"{fig['peak_gib']:.2f} GiB (budget {MOE_STATE_BYTES_PER_PARAM} B x params + "
            f"{MOE_ACTIVATION_BYTES / 2**30:.0f} GiB = {budget / 2**30:.2f} GiB); MoE "
            f"blocks {moe_ms:.1f} ms/step forward + backward = "
            f"{moe_ms / fig['step_ms']:.3f} of the step (CUDA events); host syncs in one "
            f"step {syncs['step']} ({syncs['blocks']} inside MoE block forwards); "
            f"assignments dropped by capacity {dropped:.4f}")
        if peak > budget:
            log(f"moe train [{name}]: peak above the budget FAIL")
            ok = False
        gc.collect()
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("moe train phase FAILED")


def moe_block_phase(card):
    """Phase 21 (b): one Mixtral-8x7B MoE block (D 4096, F 14336, 8
    experts, top-2) on 4 x 2048 seeded tokens, on the capacity and the
    dropless path, in bf16 against the same block in float32 (the bf16
    weights and inputs cast up, TF32 off): the share of tokens whose top-2
    set agrees, and on those tokens the largest output error over the
    float32 output's largest magnitude, within MOE_BF16_RTOL."""
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.moe.layer import moe_block

    cfg = dataclasses.replace(mixtral_models()["Mixtral-8x7B"], num_layers=1)
    params = init_params(cfg, seed=5, device="cuda", dtype=torch.bfloat16)["layer_0"]["moe"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((4, TRAIN_SEQ, cfg.hidden_size), generator=gen, device="cuda").to(
        torch.bfloat16)
    ok = True
    for path in ("capacity", "dropless"):
        c = dataclasses.replace(cfg, moe_dropless=path == "dropless")
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            with torch.no_grad():
                p = _cast(params, dtype)
                y, aux = moe_block(dataclasses.replace(c, dtype=dtype), p, x.to(dtype))
                gates = torch.softmax(x.float() @ p["router"]["kernel"].float(), dim=-1)
                top = sharded_moe._top_k(gates, c.moe_top_k)[1].sort(-1).values
            out[dtype] = (y.float(), aux.item(), top)
        (yb, ab, tb), (yf, af, tf) = out[torch.bfloat16], out[torch.float32]
        agree = (tb == tf).all(-1)
        err = ((yb - yf).abs().amax(-1)[agree].max() / yf.abs().max()).item()
        share = agree.float().mean().item()
        good = err <= MOE_BF16_RTOL and share >= ROUTE_AGREE and math.isfinite(ab)
        log(f"moe block bf16 vs fp32 [{path}, Mixtral-8x7B widths, 4 x {TRAIN_SEQ} tokens] "
            f"[{card}]: top-{c.moe_top_k} set agrees for {share:.4f} of tokens (need >= "
            f"{ROUTE_AGREE}); on those max|y_bf16 - y_fp32| / max|y_fp32| = {err:.3e} (need "
            f"<= {MOE_BF16_RTOL:g}); aux bf16 {ab:.6f} fp32 {af:.6f} "
            f"{'ok' if good else 'FAIL'}")
        ok = ok and good
    del params, x
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("moe block phase FAILED")


def moe_serving_phase(pa, card):
    """Phase 21 (c): Mixtral-8x7B's widths at 8 of 32 layers and
    Qwen1.5-MoE-A2.7B at its published size served through ``slice_phase``
    with phase 16's gates (every packed and decode launch on ``sm90``, a
    whole number per layer); then phase 5's path parity for both at 2
    layers, routing replayed from the kernel run (:class:`RouteReplay`)."""
    models = mixtral_models()
    models["Mixtral-8x7B"] = dataclasses.replace(models["Mixtral-8x7B"],
                                                 num_layers=MIXTRAL_SERVE_LAYERS)
    wide_serving_phase(pa, card, models, names=tuple(models))
    for name, cfg in models.items():
        path_phase(dataclasses.replace(cfg, num_layers=2), name)


# ---------------------------------------------------------------------------
# phase 22: the HF families the JAX package loads, served; speculative decoding
# ---------------------------------------------------------------------------

# bigscience/bloom-1b7 config.json, the fields inference/hf.py reads: ALiBi
# (slopes rounded through bf16), the embedding layernorm, biased LayerNorms
# and projections, per-head interleaved fused qkv, tied embeddings
BLOOM_1B7 = {"model_type": "bloom", "vocab_size": 250880, "hidden_size": 2048,
             "n_layer": 24, "n_head": 16, "layer_norm_epsilon": 1e-5}
# EleutherAI/gpt-neo-1.3B config.json: global and local (window 256)
# layers alternating, unscaled attention, learned positions, tied embeddings
GPT_NEO_1P3B = {"model_type": "gpt_neo", "vocab_size": 50257, "hidden_size": 2048,
                "num_layers": 24, "num_heads": 16, "max_position_embeddings": 2048,
                "attention_types": [[["global", "local"], 12]], "window_size": 256,
                "intermediate_size": None, "layer_norm_epsilon": 1e-5}
# mosaicml/mpt-7b config.json: post-scale ALiBi (fp32 slopes), fused Wqkv,
# bias-free projections and norms, exact gelu, tied embeddings
MPT_7B = {"model_type": "mpt", "vocab_size": 50432, "d_model": 4096, "n_layers": 32,
          "n_heads": 32, "max_seq_len": 2048, "layer_norm_epsilon": 1e-5,
          "attn_config": {"alibi": True, "softmax_scale": None, "clip_qkv": None}}
HF_FAMILIES = {"BLOOM-1b7": BLOOM_1B7, "GPT-Neo-1.3B": GPT_NEO_1P3B, "MPT-7B": MPT_7B}
# the family path parity: the engine's float32 logits (packed step, fused
# decode step) against the dense float32 forward over the same sequences,
# within this share of the dense logits' largest magnitude (both sum in
# fp32 in other orders through 2 layers and a 2048-4096-wide head)
FAMILY_FP32_RTOL = 1e-4
# speculative decoding against the spec-off run, bf16 at full depth: where
# a stream first differs, both tokens' logits in the float32 recompute must
# lie within this of its largest (so its top-2 gap does too): random
# weights give logits of unit scale, and bf16 paths at 2 layers already sit
# 1-3e-2 from float32 (phase 21 (c)); at 32 layers bf16 picks among float32
# near-ties of several tokens, not only the top 2 (2.9e-3 across the top 4)
SPEC_TIE_MARGIN = 0.25
SPEC_K, SPEC_SEGMENT, SPEC_REPEATS, SPEC_NEW = 4, 64, 4, 64


def hf_shapes(hf: dict) -> dict:
    """HF's own state-dict names and shapes for the three families phase 22
    builds (the tied ``lm_head.weight`` left out, as the loader reads the
    embedding)."""
    mt = hf["model_type"]
    if mt == "bloom":
        H, L, V = hf["hidden_size"], hf["n_layer"], hf["vocab_size"]
        out = {"transformer.word_embeddings.weight": (V, H)}
        for n in ("word_embeddings_layernorm", "ln_f"):
            out.update({f"transformer.{n}.weight": (H,), f"transformer.{n}.bias": (H,)})
        for i in range(L):
            p = f"transformer.h.{i}."
            for n, shape in (("self_attention.query_key_value", (3 * H, H)),
                             ("self_attention.dense", (H, H)),
                             ("mlp.dense_h_to_4h", (4 * H, H)),
                             ("mlp.dense_4h_to_h", (H, 4 * H)),
                             ("input_layernorm", (H,)), ("post_attention_layernorm", (H,))):
                out[p + n + ".weight"] = shape
                out[p + n + ".bias"] = shape[:1]
        return out
    if mt == "gpt_neo":
        H, L = hf["hidden_size"], hf["num_layers"]
        out = {"transformer.wte.weight": (hf["vocab_size"], H),
               "transformer.wpe.weight": (hf["max_position_embeddings"], H),
               "transformer.ln_f.weight": (H,), "transformer.ln_f.bias": (H,)}
        for i in range(L):
            p = f"transformer.h.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[p + f"attn.attention.{n}.weight"] = (H, H)
            out[p + "attn.attention.out_proj.bias"] = (H,)
            for n, shape in (("mlp.c_fc", (4 * H, H)), ("mlp.c_proj", (H, 4 * H)),
                             ("ln_1", (H,)), ("ln_2", (H,))):
                out[p + n + ".weight"] = shape
                out[p + n + ".bias"] = shape[:1]
        return out
    H, L = hf["d_model"], hf["n_layers"]                   # mpt
    out = {"transformer.wte.weight": (hf["vocab_size"], H), "transformer.norm_f.weight": (H,)}
    for i in range(L):
        p = f"transformer.blocks.{i}."
        out.update({p + "norm_1.weight": (H,), p + "norm_2.weight": (H,),
                    p + "attn.Wqkv.weight": (3 * H, H), p + "attn.out_proj.weight": (H, H),
                    p + "ffn.up_proj.weight": (4 * H, H),
                    p + "ffn.down_proj.weight": (H, 4 * H)})
    return out


def hf_state_dict(hf: dict, seed: int) -> dict:
    """A seeded bf16 state dict on the host with HF's names and shapes:
    norm weights 1, biases 0, embedding tables N(0, 1), projections
    N(0, 1 / fan_in) (``init_params``' scales). Each block of up to 2^25
    values draws from its own ``torch.Generator`` seeded from ``seed`` and
    its place, the blocks spread over the host's cores."""
    from concurrent.futures import ThreadPoolExecutor

    out, jobs = {}, []
    for n, (name, shape) in enumerate(hf_shapes(hf).items()):
        t = torch.empty(shape, dtype=torch.bfloat16)
        out[name] = t
        if len(shape) == 1:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
            continue
        std = 1.0 if ("wte" in name or "wpe" in name or "word_embeddings" in name) \
            else shape[1] ** -0.5
        flat, step = t.view(-1), 1 << 25
        jobs += [(flat[a:a + step], std, seed * 1_000_003 + n * 4096 + a // step)
                 for a in range(0, flat.numel(), step)]

    def draw(job):
        block, std, block_seed = job
        block.normal_(0.0, std, generator=torch.Generator().manual_seed(block_seed))

    with ThreadPoolExecutor(max(1, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, jobs))
    return out


def hf_model(name: str, num_layers=None, seed: int = 0):
    """``(cfg, params)`` of an HF-format model through the port's loader
    (``params_from_hf`` on the card), its weights cast to bf16; with
    ``num_layers`` the config's depth is cut to it."""
    from deepspeed_tpu_torch.inference import params_from_hf
    from deepspeed_tpu_torch.models.convert import _flatten

    hf = dict(HF_FAMILIES[name])
    if num_layers is not None:
        key = {"bloom": "n_layer", "gpt_neo": "num_layers", "mpt": "n_layers"}[hf["model_type"]]
        hf[key] = num_layers
        if hf["model_type"] == "gpt_neo":
            hf["attention_types"] = [[["global", "local"], num_layers // 2]]
    t0 = time.perf_counter()
    sd = hf_state_dict(hf, seed)
    t1 = time.perf_counter()
    cfg, params = params_from_hf(sd, hf, device="cuda")
    del sd
    params = _cast(params, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"hf {name}: {sum(p.numel() for p in _flatten(params).values()) / 1e9:.3f} B "
        f"parameters, "
        f"state dict drawn in {t1 - t0:.1f} s, params_from_hf + bf16 in "
        f"{time.perf_counter() - t1:.1f} s")
    return dataclasses.replace(cfg, dtype=torch.bfloat16), params


#: phase 22 (a)'s depth: 12 of the two models' 24 layers (their widths,
#: vocabularies and attention rules whole), so the script stays within its
#: time limit; the loading and the einsum path scale with depth
HF_SERVING_LAYERS = 12


def hf_serving_phase(pa, card):
    """Phase 22 (a): BLOOM-1b7 and GPT-Neo-1.3B at their published widths
    and 12 of their 24 layers, loaded from seeded HF-named state dicts through ``params_from_hf`` and
    served by ``slice_phase`` (16 requests, prompts of 300..1024 tokens so
    that GPT-Neo's 256-token window bites in every one, 64 new tokens):
    phase 4's gates and no paged-kernel launch (both attention paths on the
    einsum, the decode's source ``fallback``), and ``attn_backend="pallas"``
    refused with the JAX engine's ``ValueError``."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)

    for name in ("BLOOM-1b7", "GPT-Neo-1.3B"):
        cfg, params = hf_model(name, num_layers=HF_SERVING_LAYERS)
        try:
            InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
                **SLICE, attn_backend="pallas"), device="cuda")
            refused = False
        except ValueError as e:
            refused = "plain scaled causal" in str(e)
        run = slice_phase(pa, card, name=name, cfg=cfg, params=params, lens=(300, 1024),
                          new_tokens=64)
        del params
        torch.cuda.empty_cache()
        checks = {"no paged kernel launched": not any(run["launches"].values()),
                  "einsum / einsum (fallback)": run["resolution"] == ("einsum", "einsum",
                                                                     "fallback"),
                  "attn_backend='pallas' refused (ValueError)": refused}
        log(f"serving {name} (ALiBi {cfg.position == 'alibi'}, windows "
            f"{sorted(set(cfg.layer_windows or ()), key=str)}): attn_impl {run['resolution'][0]}, "
            f"decode_attn_impl {run['resolution'][1]} ({run['resolution'][2]}); "
            + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        if not all(checks.values()):
            raise SystemExit(f"serving {name} FAILED")


def family_parity_phase():
    """Phase 22 (b): at 2 layers of the widths of BLOOM-1b7, GPT-Neo-1.3B
    and MPT-7B (HF-named state dicts through ``params_from_hf``), four
    sequences of 300..1000 prompt tokens prefilled through ``ragged_forward``
    in chunks that cross pages and GPT-Neo's window, one packed step with
    each sequence's last chunk, then a fused decode step and a 16-step
    ``decode_loop``, in bf16 and in float32 (each on its own pools of one
    layout). The dense forward (``lm_forward``) over the same whole
    sequences in float32 and bf16 is the reference: the float32 engine
    within ``FAMILY_FP32_RTOL`` of it, the bf16 engine within
    ``NOISE_FACTOR`` x the bf16 dense forward's distance from it."""
    from deepspeed_tpu_torch.inference.v2 import model
    from deepspeed_tpu_torch.inference.v2.ragged import RaggedBatchWrapper
    from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
        DSSequenceDescriptor
    from deepspeed_tpu_torch.models.transformer import lm_forward

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)
    fields = ("tokens", "positions", "gather_idx", "block_table", "kv_len",
              "logits_idx", "start_pos", "chunk_len")
    for name in HF_FAMILIES:
        cfg, params = hf_model(name, num_layers=2, seed=3)
        runs = {"fp32": (dataclasses.replace(cfg, dtype=torch.float32, attn_impl="xla"),
                         _cast(params, torch.float32)),
                "bf16": (dataclasses.replace(cfg, attn_impl="xla"), params)}
        rng = np.random.default_rng(17)
        plens, last = [300, 517, 733, 1000], [37, 1, 64, 5]
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in plens]
        S, bs, B = len(prompts), 32, 40
        shape = (cfg.num_layers, 1 + S * B, cfg.kv_heads, bs, cfg.head_dim)
        packed, step, toks, dense, dense_step = {}, {}, {}, {}, {}
        for run, (c, p) in runs.items():
            kk = torch.zeros(shape, dtype=c.dtype, device=dev)
            vv = torch.zeros_like(kk)
            seqs = []
            for s, pr in enumerate(prompts):
                seq = DSSequenceDescriptor(uid=s, prompt_tokens=pr)
                seq.blocks = list(range(1 + s * B, 1 + (s + 1) * B))
                seqs.append(seq)
            wrapper = RaggedBatchWrapper(token_budget=512, max_seqs=S, max_chunk=128,
                                         max_blocks_per_seq=B)
            while True:                       # every chunk but each sequence's last
                sched = []
                for seq, n in zip(seqs, last):
                    left = len(seq.prompt_tokens) - n - seq.seen_tokens
                    if left > 0:
                        sched.append((seq, seq.next_tokens(min(left, 128))))
                if not sched:
                    break
                batch = wrapper.pack(sched, bs)
                model.ragged_forward(p, c, kk, vv, *[t(getattr(batch, f)) for f in fields])
                for seq, tk in sched:
                    seq.seen_tokens += len(tk)
            batch = wrapper.pack([(seq, seq.next_tokens(n)) for seq, n in zip(seqs, last)],
                                 bs)
            packed[run], _, _ = model.ragged_forward(
                p, c, kk, vv, *[t(getattr(batch, f)) for f in fields])
            first = packed["fp32"].argmax(-1).to(torch.int32)
            pos0 = t(np.asarray(plens, np.int32))
            bt = t(batch.block_table)
            active = torch.ones(S, dtype=torch.bool, device=dev)
            wk = torch.zeros((c.num_layers, 16, S, c.kv_heads, c.head_dim), dtype=c.dtype,
                             device=dev)
            step[run] = model.decode_step(p, c, kk, vv, wk, torch.zeros_like(wk), first,
                                          pos0, pos0, bt, active, 0, "einsum")
            toks[run], _, _ = model.decode_loop(p, c, kk, vv, first, pos0, bt, active, None,
                                                1.0, n_steps=16)
            with torch.no_grad():
                rows = [lm_forward(c, p, t(np.concatenate([pr, [int(f)]]).astype(
                    np.int64))[None])[0, -2:].float() for pr, f in zip(prompts, first.tolist())]
            dense[run] = torch.stack([r[0] for r in rows])
            dense_step[run] = torch.stack([r[1] for r in rows])
        d = lambda a, b: (a - b).abs().max().item()
        top = dense["fp32"].abs().max().item()
        checks = {
            "packed fp32": d(packed["fp32"], dense["fp32"]) <= FAMILY_FP32_RTOL * top,
            "decode fp32": d(step["fp32"], dense_step["fp32"]) <= FAMILY_FP32_RTOL * top,
            "packed bf16": d(packed["bf16"], dense["fp32"])
            <= NOISE_FACTOR * d(dense["bf16"], dense["fp32"]),
            "decode bf16": d(step["bf16"], dense_step["fp32"])
            <= NOISE_FACTOR * d(dense_step["bf16"], dense_step["fp32"]),
        }
        agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"family parity ({name} widths, 2 layers, D {cfg.head_dim}, "
            f"{cfg.position}, windows {cfg.layer_windows}): packed max|d| fp32 engine-dense "
            f"{d(packed['fp32'], dense['fp32']):.3e}, bf16 engine-dense fp32 "
            f"{d(packed['bf16'], dense['fp32']):.3e}, bf16 dense-dense fp32 "
            f"{d(dense['bf16'], dense['fp32']):.3e}; decode step fp32 engine-dense "
            f"{d(step['fp32'], dense_step['fp32']):.3e}, bf16 engine-dense fp32 "
            f"{d(step['bf16'], dense_step['fp32']):.3e}, bf16 dense-dense fp32 "
            f"{d(dense_step['bf16'], dense_step['fp32']):.3e} (logits max {top:.2f}; need fp32 "
            f"<= {FAMILY_FP32_RTOL:g} x max, bf16 <= {NOISE_FACTOR:g} x dense bf16); greedy "
            f"agreement packed bf16-fp32 {agree(packed['bf16'], packed['fp32']):.3f}, "
            f"decode_loop 16 steps bf16-fp32 "
            f"{(toks['bf16'] == toks['fp32']).float().mean().item():.3f}; "
            + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        if not all(checks.values()):
            raise SystemExit(f"family parity FAILED ({name} widths)")
        del runs, params
        torch.cuda.empty_cache()


def spec_phase(pa, card):
    """Phase 22 (c): speculative decoding on Llama-2-7B at full width and
    depth: 16 requests, each a seeded random 64-token segment repeated 4
    times, 64 new tokens, served by ``LLMServer`` with ``spec_decode_k=4``
    and then with spec off (fused decode chunks of 16). Gates: the packed
    kernel launched during the spec run, a whole number of times per layer,
    every launch on ``sm90``; each spec stream equals the spec-off stream,
    or first differs where both tokens' logits lie within
    ``SPEC_TIE_MARGIN`` of the largest in a float32 recompute (the dense
    einsum forward over the common prefix), which puts its top-2 gap under
    the margin too."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.models.transformer import lm_forward
    from deepspeed_tpu_torch.serving import LLMServer, Request

    cfg = llama_config("7b", dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(23)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, SPEC_SEGMENT).astype(np.int32),
                       SPEC_REPEATS) for _ in range(16)]
    runs = {}
    for mode, k in (("spec", SPEC_K), ("off", 0)):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            **SLICE, spec_decode_k=k), device="cuda")
        server = LLMServer(engine, fused_decode_chunk=16)
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        resps = [server.submit(Request(p, max_new_tokens=SPEC_NEW), block=True)
                 for p in prompts]
        for r in resps:
            r.wait(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pa.launch_counts)
        routes = {n: dict(r) for n, r in pa.route_counts.items()}
        if not server.drain(timeout=60) or server.error is not None:
            raise SystemExit(f"spec phase: the {mode} server failed: {server.error}")
        snap = server.metrics.snapshot()
        runs[mode] = dict(streams=[list(r.tokens) for r in resps], launches=launches,
                          routes=routes, snap=snap, wall=wall)
        tokens = sum(len(r.tokens) for r in resps)
        log(f"spec[{mode}, Llama-2-7B] [{card}]: {tokens / wall:.1f} generated tok/s over "
            f"{wall:.2f} s, TTFT p50 {snap['ttft']['p50_ms']:.1f} ms p99 "
            f"{snap['ttft']['p99_ms']:.1f} ms; spec_steps {snap['spec_steps']}, drafted "
            f"{snap['spec_drafted']}, accepted {snap['spec_accepted']}, acceptance rate "
            f"{snap['spec_acceptance_rate']}; engine steps {engine.steps}, kernel launches "
            f"{launches}, routes {routes}")
        del server, engine
        torch.cuda.empty_cache()
    n = runs["spec"]["launches"]["paged_attention"]
    launched = (n > 0 and n % cfg.num_layers == 0
                and runs["spec"]["routes"]["paged_attention"] == {"sm90": n, "cuda_core": 0})
    # where a stream first differs: the float32 recompute's top 2 there
    firsts = []
    for i, (a, b) in enumerate(zip(runs["spec"]["streams"], runs["off"]["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            firsts.append((i, j))
    params32 = _cast(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, attn_impl="xla")
    ties = []
    for i, j in firsts:
        a, b = runs["spec"]["streams"][i][j], runs["off"]["streams"][i][j]
        ctx = np.concatenate([prompts[i], np.asarray(runs["off"]["streams"][i][:j], np.int32)])
        with torch.no_grad():
            logits = lm_forward(cfg32, params32, torch.from_numpy(ctx.astype(np.int64))
                                .cuda()[None])[0, -1]
        vals, idx = logits.topk(4)
        below = [(vals[0] - logits[x]).item() for x in (a, b)]
        ok = max(below) < SPEC_TIE_MARGIN
        ties.append(ok)
        log(f"spec stream {i}: first differs at token {j} ({a} against {b}), "
            f"{below[0]:.4e} and {below[1]:.4e} below the float32 maximum; float32 top 4 "
            f"{idx.tolist()}, top-2 gap {(vals[0] - vals[1]).item():.4e} "
            f"{'ok' if ok else 'FAIL'}")
    del params32
    torch.cuda.empty_cache()
    full = len(prompts) - len(firsts)
    log(f"spec against spec-off (Llama-2-7B, {SPEC_NEW} tokens x 16): streams equal to the "
        f"end {full}/16, first differing at a float32 near-tie {sum(ties)}/{len(firsts)}; "
        f"packed kernel launches in the spec run {n}, routes "
        f"{runs['spec']['routes']['paged_attention']} {'ok' if launched else 'FAIL'}; "
        f"tok/s spec {16 * SPEC_NEW / runs['spec']['wall']:.1f} against off "
        f"{16 * SPEC_NEW / runs['off']['wall']:.1f}")
    if not (launched and all(ties)):
        raise SystemExit("spec phase FAILED")


# ---------------------------------------------------------------------------
# phase 23: checkpoint interchange
# ---------------------------------------------------------------------------

# nvidia/megatron-gpt2-345m, the numbers of its checkpoint's ``args`` that
# megatron_config reads: hidden 1024, 24 layers, 16 heads (head dim 64),
# ffn 4096, max_position_embeddings 1024, padded_vocab_size 50304 (GPT-2:
# learned positions, LayerNorm, gelu, biased projections, the word
# embedding tied to the head)
MEGATRON_345M = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
                     ffn_hidden_size=4096, max_position_embeddings=1024,
                     padded_vocab_size=50304, layernorm_epsilon=1e-5)
MEGATRON_MODEL = "megatron-gpt2-345m"
MEGATRON_TP = 2            # the shards are written as two tensor-parallel ranks
MEGATRON_VERSION = 2       # checkpoint_version 2.0: per-head [q, k, v] rows
MEGATRON_INIT_STD = 0.02   # Megatron-LM's init_method_std
MEGATRON_DIR = REPO / "build" / "megatron_smoke"
# phase 23 (c): phase 11's world on the 345M at full depth, stage 0 against
# stage 2, the stage-2 run saved, consolidated and exported
MEGATRON_DP_SPEC = dict(DP_SPEC, model=MEGATRON_MODEL, megatron_args=MEGATRON_345M,
                        layers=24, micro=2, seq=1024, steps=3, modes=["none", "stage2"],
                        export=True)


def megatron_345m_config(args=MEGATRON_345M, **over):
    from deepspeed_tpu_torch.inference.megatron import megatron_config

    return dataclasses.replace(megatron_config(args), dtype=torch.bfloat16, **over)


def megatron_shapes(args) -> dict:
    """Megatron-LM GPT's state-dict keys (the ``model.`` prefix the
    converters read) and full shapes, torch ``[out, in]`` layout."""
    H, F_, L = args["hidden_size"], args["ffn_hidden_size"], args["num_layers"]
    pre = "model.language_model."
    shapes = {pre + "embedding.word_embeddings.weight": (args["padded_vocab_size"], H),
              pre + "embedding.position_embeddings.weight":
              (args["max_position_embeddings"], H)}
    for i in range(L):
        t = f"{pre}transformer.layers.{i}."
        for name, shape in (("input_layernorm", (H,)), ("attention.query_key_value", (3 * H, H)),
                            ("attention.dense", (H, H)), ("post_attention_layernorm", (H,)),
                            ("mlp.dense_h_to_4h", (F_, H)), ("mlp.dense_4h_to_h", (H, F_))):
            shapes[t + name + ".weight"] = shape
            shapes[t + name + ".bias"] = shape[:1]
    for part in ("weight", "bias"):
        shapes[f"{pre}transformer.final_layernorm.{part}"] = (H,)
    return shapes


def write_megatron_shards(args, out_dir: Path, tp: int = MEGATRON_TP, seed: int = 0):
    """Seeded random weights written as ``tp`` tensor-parallel ranks in
    Megatron-LM's on-disk layout: ``mp_rank_0r/model_optim_rng.pt``, each
    ``{"model": {"language_model": {"embedding": ..., "transformer":
    {"layers.0. ...": ...}}}, "args": Namespace, "checkpoint_version": 2.0}``
    in fp16, as Megatron-LM saves the published 345M. Megatron's init:
    weights N(0, 0.02), the two output projections N(0, 0.02 / sqrt(2L)),
    LayerNorm weights 1, biases 0. A leaf the layout table shards is drawn
    per rank (its rank's slice: for the fused QKV its heads' [q, k, v]
    rows); a replicated one once. Returns the files and their bytes."""
    import argparse as ap

    from deepspeed_tpu_torch.checkpoint.state_dict_factory import megatron_specs
    from deepspeed_tpu_torch.module_inject.auto_tp import sharded_dim

    shapes = megatron_shapes(args)
    specs = megatron_specs({k: np.broadcast_to(np.float32(0), v) for k, v in shapes.items()})
    out_std = MEGATRON_INIT_STD / math.sqrt(2 * args["num_layers"])
    files = []
    for rank in range(tp):
        model = {"language_model": {"embedding": {}, "transformer": {}}}
        for n, (key, shape) in enumerate(shapes.items()):
            dim = sharded_dim(specs[key], "tp")
            local = list(shape)
            if dim is not None:
                local[dim] //= tp
            if len(shape) == 1:
                t = torch.full(local, 1.0 if "layernorm.weight" in key else 0.0)
            else:
                gen = torch.Generator(device="cuda").manual_seed(
                    seed * 1_000_003 + n * 64 + (rank + 1 if dim is not None else 0))
                std = out_std if key.endswith(("attention.dense.weight",
                                               "dense_4h_to_h.weight")) else MEGATRON_INIT_STD
                t = torch.randn(local, generator=gen, device="cuda").mul_(std)
            t = t.half().cpu()
            name = key[len("model.language_model."):]
            if name.startswith("embedding."):
                table = name.split(".")[1]
                model["language_model"]["embedding"][table] = {"weight": t}
            else:
                model["language_model"]["transformer"][name[len("transformer."):]] = t
        path = out_dir / f"mp_rank_{rank:02d}" / "model_optim_rng.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model": model, "args": ap.Namespace(
            **args, tensor_model_parallel_size=tp, checkpoint_version=2.0),
            "checkpoint_version": 2.0, "iteration": 0}, path)
        files.append(path)
    return files, sum(f.stat().st_size for f in files)


def megatron_load(files):
    """The shards through the port's loader: each read by
    ``load_megatron_checkpoint``, merged by ``SDLoaderFactory`` (the
    Megatron layout table, version-2 fused QKV), mapped by
    ``megatron_config`` / ``megatron_params``. Returns (args, the shards,
    the merged state dict, the config, the float32 numpy tree, seconds by
    step)."""
    from deepspeed_tpu_torch.checkpoint.state_dict_factory import SDLoaderFactory
    from deepspeed_tpu_torch.inference.megatron import (load_megatron_checkpoint,
                                                        megatron_config, megatron_params)

    t0 = time.perf_counter()
    loaded = [load_megatron_checkpoint(str(f)) for f in files]
    args, shards = loaded[0][0], [sd for _, sd in loaded]
    t1 = time.perf_counter()
    merged = SDLoaderFactory.get_sd_loader(shards, version=MEGATRON_VERSION,
                                           num_heads=args["num_attention_heads"],
                                           layout="megatron").load(1, 0)
    t2 = time.perf_counter()
    cfg = megatron_config(args, sd=merged)
    tree = megatron_params(merged, cfg, version=MEGATRON_VERSION)
    t3 = time.perf_counter()
    return args, shards, merged, cfg, tree, {"load": t1 - t0, "merge": t2 - t1,
                                             "convert": t3 - t2}


def megatron_tree_on_card(out_dir: Path, cfg):
    """The fp32 tree merged from the shards under ``out_dir``, on the card
    (the init closure of phase 23 (c)'s ranks)."""
    from deepspeed_tpu_torch.models import params_from_jax

    files = sorted(out_dir.glob("mp_rank_*/model_optim_rng.pt"))
    return params_from_jax(megatron_load(files)[4], cfg, device="cuda")


def _tree_bitwise(got, want) -> bool:
    """Two flat dicts of arrays: the same keys, shapes, dtypes and bits."""
    return set(got) == set(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.array_equal(np.asarray(got[k]), np.asarray(want[k])) for k in want)


def megatron_export(engine, cfg, paths, workdir: Path, rank: int, margs: dict):
    """Phase 23 (c), after the stage-2 run: ``save_checkpoint``; then rank 0
    runs ``python -m deepspeed_tpu_torch.utils.zero_to_fp32`` in a
    subprocess and holds the ``.npz`` against ``safe_get_full_fp32_param``
    of every leaf, maps it through ``params_to_megatron``, writes two tp
    shards with ``save_shard_npz`` and runs ``python -m
    deepspeed_tpu_torch.checkpoint.ds_to_universal --format megatron`` on
    them; the universal tree (``load_universal``) must be bitwise the
    consolidated masters. Returns rank 0's results (None on the others)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal
    from deepspeed_tpu_torch.checkpoint.state_dict_factory import (megatron_specs,
                                                                   save_shard_npz,
                                                                   split_state_dict)
    from deepspeed_tpu_torch.inference.megatron import params_to_megatron
    from deepspeed_tpu_torch.models.convert import _flatten, _nest
    from deepspeed_tpu_torch.utils import safe_get_full_fp32_param

    ckpt = workdir / "ckpt"
    t0 = time.perf_counter()
    engine.save_checkpoint(str(ckpt))
    save_s = time.perf_counter() - t0
    result = None
    if rank == 0:
        env = dict(os.environ, PYTHONPATH=str(REPO))
        run = lambda *cmd: subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, env=env,
                                          check=True, capture_output=True, text=True,
                                          timeout=600)
        npz, universal = workdir / "fp32.npz", workdir / "universal"
        t0 = time.perf_counter()
        run("deepspeed_tpu_torch.utils.zero_to_fp32", str(ckpt), str(npz))
        t1 = time.perf_counter()
        with np.load(npz) as z:
            flat = {k: z[k] for k in z.files}
        masters = {p: safe_get_full_fp32_param(engine, p).cpu().numpy() for p in paths}
        npz_equal = _tree_bitwise(flat, masters)
        del masters
        sd = params_to_megatron(_nest(flat), cfg, version=MEGATRON_VERSION)
        specs = megatron_specs(sd)
        qkv = {k: "interleaved" for k in sd if "query_key_value" in k}
        files = []
        for r in range(MEGATRON_TP):
            shard, repl = split_state_dict(sd, r, MEGATRON_TP, specs, qkv_leaves=qkv,
                                           num_heads=cfg.num_heads, return_replicated=True)
            files.append(workdir / f"export_mp_rank_{r:02d}.npz")
            save_shard_npz(str(files[-1]), shard, replicated_paths=repl)
        del sd, shard
        args_file = workdir / "margs.json"
        args_file.write_text(json.dumps(margs))
        t2 = time.perf_counter()
        run("deepspeed_tpu_torch.checkpoint.ds_to_universal", "--input", *map(str, files),
            "--output", str(universal), "--version", str(MEGATRON_VERSION),
            "--num-heads", str(cfg.num_heads), "--format", "megatron", "--config",
            str(args_file))
        t3 = time.perf_counter()
        back = {k: v.numpy() for k, v in _flatten(load_universal(str(universal))).items()}
        result = dict(npz_equal=npz_equal, universal_equal=_tree_bitwise(back, flat),
                      leaves=len(flat), save_s=save_s, zero_to_fp32_s=t1 - t0,
                      ds_to_universal_s=t3 - t2,
                      ckpt_bytes=sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()),
                      npz_bytes=npz.stat().st_size,
                      shard_bytes=sum(f.stat().st_size for f in files),
                      universal_bytes=sum(f.stat().st_size for f in universal.rglob("*")
                                          if f.is_file()))
    comm.barrier()
    return result


def megatron_phase(pa, card):
    """Phase 23 (a) and (b): Megatron GPT-2 345M written as two tp shards
    (``write_megatron_shards``), read, merged and converted by the port
    (``megatron_load``), moved to the card by ``params_from_jax`` and served
    by ``slice_phase`` at bf16 (16 requests, prompts of 128..896 tokens,
    the model's 1024 positions holding their 128 new tokens) with phase
    16's gates at D 64; then the resharding round trips, all bitwise: the
    merged dict split into 4 and merged back, ``params_to_megatron`` of
    ``megatron_params``, and the two written shards split again from the
    merged dict. Returns the shards' directory."""
    import shutil

    from deepspeed_tpu_torch.checkpoint.state_dict_factory import (megatron_specs,
                                                                   merge_state_dicts,
                                                                   split_state_dict)
    from deepspeed_tpu_torch.inference.megatron import params_to_megatron
    from deepspeed_tpu_torch.models import params_from_jax

    shutil.rmtree(MEGATRON_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    files, nbytes = write_megatron_shards(MEGATRON_345M, MEGATRON_DIR)
    write_s = time.perf_counter() - t0
    args, shards, merged, cfg, tree, secs = megatron_load(files)
    t0 = time.perf_counter()
    params = _cast(params_from_jax(tree, cfg, device="cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    merged_bytes = sum(v.nbytes for v in merged.values())
    log(f"megatron {MEGATRON_MODEL}: {len(files)} tp shards of {nbytes} B (fp16) written "
        f"in {write_s:.2f} s; load_megatron_checkpoint {secs['load']:.2f} s, merge "
        f"(SDLoader.load(1, 0)) {secs['merge']:.2f} s to {len(merged)} leaves of "
        f"{merged_bytes} B (fp32), megatron_config + megatron_params {secs['convert']:.2f} s, "
        f"params_from_jax + bf16 on the card {to_card_s:.2f} s")
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    check_kernel_serving(slice_phase(pa, card, name=MEGATRON_MODEL, cfg=cfg, params=params,
                                     lens=(128, 896)), MEGATRON_MODEL)
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    specs = megatron_specs(merged)
    qkv = {k: "interleaved" for k in merged if "query_key_value" in k}
    heads = args["num_attention_heads"]
    four = [split_state_dict(merged, r, 4, specs, qkv_leaves=qkv, num_heads=heads,
                             return_replicated=True) for r in range(4)]
    back = merge_state_dicts([sd for sd, _ in four], specs, qkv_leaves=qkv,
                             replicated_paths=four[0][1])
    checks = {"split into 4 and merged back: bitwise the merged dict":
              _tree_bitwise(back, merged)}
    del four, back
    checks["params_to_megatron(megatron_params(sd)): bitwise sd"] = _tree_bitwise(
        params_to_megatron(tree, cfg, version=MEGATRON_VERSION), merged)
    checks["the written shards split again from the merged dict: bitwise"] = all(
        _tree_bitwise(split_state_dict(merged, r, MEGATRON_TP, specs, qkv_leaves=qkv,
                                       num_heads=heads), shards[r])
        for r in range(MEGATRON_TP))
    log(f"megatron resharding ({time.perf_counter() - t0:.2f} s): " + ", ".join(
        f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("megatron resharding FAILED")


def megatron_train_phase(card):
    """Phase 23 (c): phase 11's world (two ranks on cuda:0 over gloo) trains
    the 345M from the merged shards at full depth, at stage 0 and at stage
    2 (micro 2 x 1024 a rank, gas 2, bf16, the fused loss on the tied
    head, AdamW through the fused Adam kernel, 3 steps): ``check_dp``'s
    gates, ``exact_launches`` (flash 24 x gas x steps a kernel on
    ``wgmma`` at D 64), the stage-2 run saved, consolidated by
    ``zero_to_fp32`` and exported through ``ds_to_universal``
    (``megatron_export``), both bitwise the masters; then one engine at
    world size 1 trains a step from the universal tree: its loss finite."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal
    from deepspeed_tpu_torch.models import TransformerLM, make_loss_fn
    from deepspeed_tpu_torch.models.convert import _nest, param_shapes

    spec = dict(MEGATRON_DP_SPEC, megatron_dir=str(MEGATRON_DIR))
    workdir = MEGATRON_DIR / "dp"
    t0 = time.perf_counter()
    ranks = run_dp_world(spec, workdir)
    ok, r0 = check_dp(spec, ranks, card)
    ok &= exact_launches(spec, ranks, "megatron")
    ex = r0["stage2"]["export"]
    ok &= ex["npz_equal"] and ex["universal_equal"]
    peaks = {m: [round(r[m]["peak"] / 2**30, 3) for r in ranks] for m in spec["modes"]}
    ms = {m: round(float(np.mean(r0[m]["times"][1:])) * 1e3, 1) for m in spec["modes"]}
    log(f"megatron export [{card}]: save_checkpoint {ex['save_s']:.2f} s ({ex['ckpt_bytes']} "
        f"B), zero_to_fp32 {ex['zero_to_fp32_s']:.2f} s ({ex['npz_bytes']} B, {ex['leaves']} "
        f"leaves) bitwise safe_get_full_fp32_param: {'ok' if ex['npz_equal'] else 'FAIL'}; "
        f"two tp shards ({ex['shard_bytes']} B) through ds_to_universal "
        f"{ex['ds_to_universal_s']:.2f} s ({ex['universal_bytes']} B) bitwise the masters: "
        f"{'ok' if ex['universal_equal'] else 'FAIL'}; peak per rank {peaks} GiB, step "
        f"{ms} ms (steps 2-{spec['steps']}, two ranks sharing one card); world wall "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = dp_model(spec)
    tree = load_universal(str(workdir / "universal"))
    meta = _nest({k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()})
    engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, meta)),
                                model_parameters=tree,
                                config=dict(DP_CONFIG, comms_logger={"enabled": False},
                                            train_micro_batch_size_per_gpu=spec["micro"]))
    loss = float(engine.train_batch(dp_batch(cfg, spec["micro"], spec["seq"])))
    one_ok = math.isfinite(loss)
    log(f"megatron universal tree at world size 1: one train_batch, loss {loss} finite: "
        f"{'ok' if one_ok else 'FAIL'}")
    del engine, tree
    torch.cuda.empty_cache()
    shutil.rmtree(MEGATRON_DIR, ignore_errors=True)
    if not (ok and one_ok):
        raise SystemExit("megatron training and export FAILED")


# ---------------------------------------------------------------------------
# phase 24: the serving fleet
# ---------------------------------------------------------------------------

FLEET_DIR = REPO / "build" / "fleet_smoke"
#: phase 4's slice with half its pool a replica (8 GiB at Llama-2-7B), so two
#: replicas' weights (2 x 13.5 GB) and pools (2 x 8 GiB) fit one card
FLEET_SLICE = dict(SLICE, num_kv_blocks=512)
FLEET_REQUESTS = 48
FLEET_RATE = 3.0                     # requests a second, Poisson arrivals
FLEET_NEW = 128
FLEET_KILL_STEP = 60                 # replica 1's serving step the chaos kill lands at
#: beacons every 0.5 s from their own thread; phase 4's steps take well
#: under a second (16 requests, 128 new tokens, about 20 s in all), so 3 s of
#: silence is six missed beacons, never a long step
FLEET_DEAD_AFTER_S = 3.0
FLEET_DETECT_SLACK_S = 2.0
FLEET_DEADLINE_S = 120.0             # the SLA every request carries
FLEET_CANARY = 16                    # replica 0's probe cadence, engine steps
FLEET_TENANCY = {"tenants": {"gold": "gold", "bronze": "bronze"}}   # DEFAULT_CLASSES
SDC_LAYERS = 8
SDC_CANARY = 8


def fleet_block(hb_dir, canary_steps, engine):
    """The ``serving:`` block each replica is built from."""
    return {"serving": {"enabled": True, "policy": "deadline",
                        "heartbeat_dir": str(hb_dir), "heartbeat_interval_s": 0.5,
                        "tenancy": FLEET_TENANCY, "default_deadline_s": FLEET_DEADLINE_S,
                        "canary_interval_steps": canary_steps,
                        "fused_decode_chunk": 16, "engine": dict(engine)}}


class ThreadLaunches:
    """The paged wrappers' launches tallied by the launching thread's name
    (``llm-server-<replica>``), beside the wrappers' own counts, which sum
    every replica's: ``with ThreadLaunches(pa) as t`` wraps the wrappers'
    one counting point while it lasts."""

    def __init__(self, pa):
        import threading

        self.pa, self._orig, self._lock, self._tally = pa, pa._counted, threading.Lock(), {}

    def __enter__(self):
        import threading

        def counted(kernel, route, err, combined=False):
            self._orig(kernel, route, err, combined)
            with self._lock:
                t = self._tally.setdefault(threading.current_thread().name, {})
                for name in (kernel, "paged_combine") if combined else (kernel,):
                    by_route = t.setdefault(name, {"sm90": 0, "cuda_core": 0})
                    by_route[route] += 1
        self.pa._counted = counted
        return self

    def __exit__(self, *exc):
        self.pa._counted = self._orig
        return False

    def snapshot(self):
        """{thread: {kernel: {route: launches}}}, taken under the lock."""
        with self._lock:
            return {t: {k: dict(r) for k, r in c.items()} for t, c in self._tally.items()}


def tally_minus(a, b):
    """``a - b`` of two ``ThreadLaunches`` snapshots."""
    return {t: {k: {r: n - b.get(t, {}).get(k, {}).get(r, 0) for r, n in by.items()}
                for k, by in c.items()} for t, c in a.items()}


def tally_sum(snap, kernel):
    """Launches of ``kernel`` in a ``ThreadLaunches`` snapshot, every route."""
    return sum(sum(c.get(kernel, {}).values()) for c in snap.values())


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs) * 1e3, p)) if xs else float("nan")


def fleet_servers(cfg, block, n=2):
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.serving import LLMServer

    return [LLMServer.from_config(cfg, init_params(cfg, seed=rid, device="cuda",
                                                   dtype=torch.bfloat16),
                                  block, replica_id=rid) for rid in range(n)]


def fleet_phase(pa, card):
    """Phase 24 (a): two Llama-2-7B replicas (bf16, seeded weights of their
    own, an 8 GiB pool each) built by ``LLMServer.from_config`` behind a
    ``ReplicaRouter(dead_after_s=3.0)`` on one card, with tenancy (gold and
    bronze on ``DEFAULT_CLASSES``), the deadline policy, the canary every
    16 steps, a ``ControlSupervisor`` ticking on replica 0
    every 25 steps and a ``TelemetryManager`` tracing. ``OpenLoopTraffic``
    (seed 11): 48 requests at 3 a second, prompts 128..1024, 128 new tokens,
    tenants alternating; a chaos schedule kills replica 1 at its serving
    step 60, stalls one prefill of replica 0 by 0.05 s, drops 4 of its token
    deliveries and reads the pool dry once. A host loop calls
    ``router.check()`` every 0.25 s. Returns the launch counts."""
    import shutil
    import threading

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.control import ControlSupervisor, describe_action
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.runtime.config import ControlConfig, TelemetryConfig
    from deepspeed_tpu_torch.runtime.resilience.chaos import (ChaosEvent, ChaosSchedule,
                                                              configure_chaos)
    from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
    from deepspeed_tpu_torch.serving import (FINISH_LENGTH, LengthDist, OpenLoopTraffic,
                                             ReplicaRouter, TrafficConfig)

    acc = get_accelerator()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    hb_dir = FLEET_DIR / "heartbeats"
    tm = telemetry.TelemetryManager(TelemetryConfig(enabled=True, max_spans=1 << 18,
                                                    flight_steps=0), rank=0)
    cfg = llama_config("7b", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    servers = fleet_servers(cfg, fleet_block(hb_dir, FLEET_CANARY, FLEET_SLICE))
    acc.synchronize()
    tm.attach_engine(servers[0].engine)           # the device-memory gauges
    router = ReplicaRouter(servers, transport=FileHeartbeatTransport(str(hb_dir)),
                           dead_after_s=FLEET_DEAD_AFTER_S)
    sup = ControlSupervisor(ControlConfig.from_dict({"enabled": True}))
    ticks = []
    tick = sup.on_serving_tick
    sup.on_serving_tick = lambda server: (ticks.append(server._steps), tick(server))
    sup.attach_server(servers[0], interval_steps=25)
    log(f"fleet: 2 x Llama-2-7B (bf16, seeds 0 / 1), pools "
        f"{servers[0].engine.kv.pool_nbytes() / 2**30:.2f} GiB each, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    kill = {}
    chaos_step = servers[1]._chaos_step

    def killing_step(chaos):
        killed = chaos_step(chaos)
        if killed:
            kill["t"] = time.perf_counter()
            kill["tally"] = tally.snapshot()
        return killed
    servers[1]._chaos_step = killing_step
    takeovers = []
    take_over = router._take_over

    def recorded_take_over(rid):
        with router._lock:
            book = [r for r in router._assigned[rid].values() if not r.done]
        kept = {id(r): list(r.tokens[:r._ckpt_len]) for r in book}
        ok = take_over(rid)
        if ok:    # from check() (the host loop) or a submit refused by the corpse
            takeovers.append((rid, time.perf_counter(), book, kept,
                              threading.current_thread() is threading.main_thread()))
        return ok
    router._take_over = recorded_take_over

    traffic = OpenLoopTraffic(TrafficConfig(
        rate_rps=FLEET_RATE, num_requests=FLEET_REQUESTS, seed=11,
        vocab_size=cfg.vocab_size, prompt_len=LengthDist("uniform", 128, 1024),
        output_len=LengthDist("fixed", FLEET_NEW, FLEET_NEW)))
    streams, submitted = {}, []

    def submit(req):
        i = len(submitted)
        req.tenant = ("gold", "bronze")[i % 2]
        streams[i] = []
        req.stream = lambda tok, resp, i=i: streams[i].append(resp._delivered - 1)
        resp = router.submit(req)
        submitted.append(resp)
        if len(submitted) == 2:
            # live once both replicas hold a request: an idle engine loop
            # consults the admission site a thousand times a second, so an
            # index counted from the start would land on an idle cycle
            configure_chaos(schedule)
        return resp

    schedule = ChaosSchedule([
        ChaosEvent(kind="replica_kill", site="replica1", at=FLEET_KILL_STEP),
        ChaosEvent(kind="slow_prefill", site="replica0", at=10, param=0.05),
        ChaosEvent(kind="drop_token", site="replica0", at=200, count=4),
        ChaosEvent(kind="kv_exhaustion", site="scheduler.admit", at=40)])
    ran = {}
    try:
        acc.reset_peak_memory_stats()
        pa.reset_launch_counts()
        with ThreadLaunches(pa) as tally:
            router.start()
            t0 = time.perf_counter()
            feeder = threading.Thread(target=lambda: ran.update(zip(
                ("resps", "rejected"), traffic.run(submit))), daemon=True)
            feeder.start()
            while feeder.is_alive() or not all(r.done for r in submitted):
                router.check()
                if time.perf_counter() - t0 > 600:
                    raise SystemExit("fleet: requests still running after 600 s")
                time.sleep(0.25)
            wall = time.perf_counter() - t0
            text = tm.registry.exposition()          # before the loops end
            mem = tm.sample_memory()
            # a probe still in flight finishes in the drain: the counts after
            # it are whole steps
            drained = router.drain(timeout=120)
            acc.synchronize()
            final = tally.snapshot()
        launches = dict(pa.launch_counts)
        routes = {n: dict(r) for n, r in pa.route_counts.items()}
        trace_path = tm.export_trace(str(FLEET_DIR / "spans.trace.json"))
    finally:
        configure_chaos(None)
        router.close()
        tm.close()
    fired_classes = schedule.classes_fired()
    resps = ran["resps"]
    peak = acc.max_memory_allocated()

    layers = cfg.num_layers
    names = ("paged_attention", "paged_flash_decode")
    r0, r1 = (f"llm-server-{i}" for i in range(2))
    at_kill = kill.get("tally", {})

    def sm90(tally, thread, n):
        return tally.get(thread, {}).get(n, {}).get("sm90", 0)
    before = {n: sm90(at_kill, r0, n) + sm90(at_kill, r1, n) for n in names}
    after = {n: sm90(final, r0, n) - sm90(at_kill, r0, n) for n in names}
    t0f, t1 = final.get(r0, {}), final.get(r1, {})
    take = [t for t in takeovers if t[0] == 1]
    detect_s = take[0][1] - kill["t"] if take and "t" in kill else float("inf")
    held = take[0][2] if take else []
    kept = take[0][3] if take else {}
    by = ("router.check()" if take and take[0][4] else "a submit the dead replica refused")
    survivor = servers[0].engine
    survivor.kv.assert_conservation([s.blocks for s in survivor.state_manager.all()])
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    span_tids = {}
    for e in events:
        span_tids.setdefault(e["name"], set()).add(e.get("tid"))
    step_names = ("serve/prefill", "serve/decode", "serve/mixed")
    serving_lines = [ln for ln in text.splitlines() if ln.startswith("dstpu_serving_")]
    tenants = {}
    for s in servers:
        for name, ts in s.metrics.tenants.items():
            tenants[name] = tenants.get(name, 0) + ts.completed
    checks = {
        f"{FLEET_REQUESTS} requests submitted, none shed": (
            len(resps) == FLEET_REQUESTS and not ran["rejected"]),
        f"every request finished by length with {FLEET_NEW} tokens": all(
            r.finish_reason == FINISH_LENGTH and len(r.tokens) == FLEET_NEW for r in resps),
        "each stream callback once per token index, in order": all(
            streams[i] == list(range(FLEET_NEW)) for i in range(len(resps))),
        "chaos fired replica_kill, slow_prefill, drop_token, kv_exhaustion": set(
            fired_classes) == {"replica_kill", "slow_prefill", "drop_token", "kv_exhaustion"},
        f"replica 1 declared dead within {FLEET_DEAD_AFTER_S + FLEET_DETECT_SLACK_S:g} s "
        f"of the kill": len(take) == 1 and detect_s <= FLEET_DEAD_AFTER_S + FLEET_DETECT_SLACK_S,
        "router.requeues == replica 1's unfinished book at takeover": (
            router.requeues == len(held) > 0),
        "every requeued response resumed on replica 0, its checkpointed tokens kept": all(
            r.preemptions >= 1 and r.replica_id == 0
            and r.tokens[:len(kept[id(r)])] == kept[id(r)] for r in held),
        "survivor drained, KV conservation holds": (
            drained and not survivor.state_manager.all()
            and survivor.kv.free_blocks == survivor.kv.num_blocks - 1),
        # an open-loop prefill is always in flight before the kill, so the
        # fused decode (steady decode, nothing queued) cannot run there
        "the packed kernel on sm90 on both replicas before the kill": (
            sm90(at_kill, r0, names[0]) > 0 and sm90(at_kill, r1, names[0]) > 0),
        "both paged kernels on sm90 on the survivor after it": all(after[n] > 0 for n in names),
        "every launch on sm90, a whole number per layer per replica": all(
            routes[n] == {"sm90": launches[n], "cuda_core": 0} and launches[n] % layers == 0
            and sm90(final, r0, n) % layers == 0 and sm90(final, r1, n) % layers == 0
            and sm90(final, r0, n) + sm90(final, r1, n) == launches[n] for n in names),
        "replica 0's canary: >= 3 probes, no fail": (
            servers[0].metrics.canary_probes >= 3 and servers[0].metrics.canary_fails == 0
            and servers[0].error is None),
        "the trace holds serve/prefill|decode|mixed and serve/deliver of both threads": all(
            any(s._thread.ident in span_tids.get(n, ()) for n in step_names)
            and s._thread.ident in span_tids.get("serve/deliver", ()) for s in servers),
        "registry: replica 0's dstpu_serving_* samples, none of replica 1's": (
            any('replica="0"' in ln for ln in serving_lines)
            and not any('replica="1"' in ln for ln in serving_lines)),
        f"TenantStats.completed sums to {FLEET_REQUESTS}": sum(tenants.values()) == FLEET_REQUESTS,
        "the supervisor ticked": len(ticks) > 0,
    }
    ttft = [r.ttft_s for r in resps]
    per = {t: [r.ttft_s for r in resps if r.request.tenant == t] for t in ("gold", "bronze")}
    tokens = sum(len(r.tokens) for r in resps)
    log(f"fleet [{card}]: {tokens} tokens in {wall:.2f} s = {tokens / wall:.1f} generated tok/s "
        f"over two replicas; TTFT p50 {_pct(ttft, 50):.1f} ms p99 {_pct(ttft, 99):.1f} ms; "
        + "; ".join(f"{t} p50 {_pct(v, 50):.1f} p99 {_pct(v, 99):.1f} ms ({len(v)})"
                    for t, v in per.items()))
    log(f"fleet [{card}]: replica 1 killed at its step {FLEET_KILL_STEP}, declared dead "
        f"{detect_s:.2f} s later by {by} (dead_after_s {FLEET_DEAD_AFTER_S}); requeues "
        f"{router.requeues}; canary probes {servers[0].metrics.canary_probes} / "
        f"{servers[1].metrics.canary_probes}, fails {servers[0].metrics.canary_fails}; "
        f"supervisor ticks {len(ticks)}, ledger entries {len(sup.ledger)}"
        + "".join(f"\n  control: {describe_action(e)}" for e in sup.ledger.snapshot()))
    log(f"fleet [{card}]: max_memory_allocated {peak / 2**30:.2f} GiB; dstpu_mem gauge "
        f"{mem}; launches {launches} (replica 0 {t0f}, replica 1 {t1}; before the kill "
        f"{before}, survivor after {after}); tenants completed {tenants}; steps "
        f"{[s._steps for s in servers]}; spans {len(events)}")
    log("fleet: " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    del router, servers, survivor, tm, sup, resps, held, submitted
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit("fleet phase FAILED")
    return {n: launches[n] for n in names}


def sdc_phase(card):
    """Phase 24 (b): two replicas at Llama-2-7B's widths with 8 layers and
    the canary every 8 steps learn their probes' hashes; then replica 0's
    ``o_proj`` of layer 0 is negated on the card. Its next probe must fail
    (``canary_fails`` 1, ``server.error`` set), the router must take it over
    once its beacon goes stale, and every request submitted after the
    verdict finishes on replica 1, whose canary stays clean."""
    import shutil

    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, ReplicaRouter, Request

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    hb_dir = FLEET_DIR / "sdc_heartbeats"
    cfg = llama_config("7b", dtype=torch.bfloat16, num_layers=SDC_LAYERS)
    servers = fleet_servers(cfg, fleet_block(hb_dir, SDC_CANARY, FLEET_SLICE))
    router = ReplicaRouter(servers, transport=FileHeartbeatTransport(str(hb_dir)),
                           dead_after_s=FLEET_DEAD_AFTER_S).start()
    rng = np.random.default_rng(24)

    def requests(n):
        return [router.submit(Request(rng.integers(0, cfg.vocab_size, int(k)).astype(np.int32),
                                      max_new_tokens=64), block=True)
                for k in rng.integers(128, 1024, n)]

    def wait(cond, what, limit=120.0):
        t = time.perf_counter()
        while not cond():
            if time.perf_counter() - t > limit:
                raise SystemExit(f"sdc: {what} not within {limit:g} s")
            time.sleep(0.05)
        return time.perf_counter() - t

    try:
        warm = requests(4)
        wait(lambda: all(s.canary_expect is not None for s in servers)
             and all(r.done for r in warm), "both canaries learned")
        learned = [s.canary_expect for s in servers]
        probes = servers[0].metrics.canary_probes
        servers[0].engine.params["layer_0"]["attn"]["o_proj"]["kernel"].neg_()
        t_verdict = wait(lambda: servers[0].error is not None, "replica 0's verdict")
        after = requests(8)

        def taken_over():
            router.check()
            return 0 in router.dead_ids()
        t_takeover = wait(taken_over, "the takeover", FLEET_DEAD_AFTER_S + 10)
        wait(lambda: all(r.done for r in after), "the requests after the verdict", 300)
        drained = router.drain(timeout=120)
    finally:
        router.close()
    checks = {
        "both replicas learned their hash": all(learned),
        "replica 0's next probe failed: canary_fails 1, error set": (
            servers[0].metrics.canary_fails == 1
            and "integrity canary failed" in str(servers[0].error)
            and servers[0].metrics.canary_probes <= probes + 2),
        "the router took replica 0 over": 0 in router.dead_ids(),
        "every request after the verdict finished by length on replica 1": all(
            r.finish_reason == FINISH_LENGTH and r.replica_id == 1 and len(r.tokens) == 64
            for r in after),
        "the warm-up requests finished by length": all(
            r.finish_reason == FINISH_LENGTH for r in warm),
        "replica 1's canary clean": (servers[1].error is None
                                     and servers[1].metrics.canary_fails == 0
                                     and servers[1].metrics.canary_probes >= 2),
        "replica 1 drained": drained,
    }
    log(f"sdc [{card}]: {SDC_LAYERS} layers; hashes learned {learned}; verdict "
        f"{t_verdict:.2f} s after the corruption ({servers[0].error}); takeover "
        f"{t_takeover:.2f} s after it; replica 1 probes {servers[1].metrics.canary_probes}, "
        f"fails {servers[1].metrics.canary_fails}")
    log("sdc: " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    del router, servers
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit("sdc phase FAILED")


# ---------------------------------------------------------------------------
# phase 25: the fleet's warm join
# ---------------------------------------------------------------------------

JOIN_DIR = REPO / "build" / "fleet_join_smoke"
#: the plan and winner caches of phase 25, wiped at its start: a cache left
#: by an earlier run would let replica 0 join without probes
JOIN_CACHE = JOIN_DIR / "cache"
#: measure mode on the serving site: the cost model prices the einsum 4x the
#: paged kernel, so the default margin of 3 would prune it untimed; a margin
#: of 8 times both. The probe pool is capped at 4M values (16 pages of 64
#: slots a sequence at Llama-2-7B's KV widths), where the default cap of 64K
#: leaves one page
JOIN_PLANNER = dict(margin=8.0, measure_max_elems=1 << 22)
JOIN_REQUESTS = 40
JOIN_RATE = 3.0                      # requests a second, Poisson arrivals
JOIN_NEW = 64
#: one replica misses it on every request, so rule_sla fires at the first
#: judged tick: 64 tokens at one a step (fused chunks off) meet 1 s only at
#: steps under 16 ms, where the serving winner's probe times a Llama-2-7B
#: step at 47 ms with 16 sequences in flight. At 3 s one replica once
#: finished all 40 requests in time, and the fleet never scaled out
JOIN_DEADLINE_S = 1.0
JOIN_CONTROL = {"enabled": True,
                "guard": {"trigger_streak": 1, "cooldown_s": 600.0},
                "supervisor": {"sla_min_tracked": 3}}
#: the tick must see sla_min_tracked finishes: at one token a step (fused
#: chunks off) 16 sequences of 64 tokens finish about 8 a 32 steps
JOIN_TICK_STEPS = 32
#: (b): the subprocess replica and its in-process peer at Llama-2-7B's
#: widths with 8 layers (the drill needs a process and a kill, not depth;
#: the planner's site has no depth, so (a)'s plan applies; the serving winner
#: is keyed by depth, so replica 0 times it and the child reads replica 0's)
JOIN_CHILD_LAYERS = 8
JOIN_CHILD_PROMPTS = 6
JOIN_KILL_REQUESTS = 8
JOIN_CHILD_NEW = 64
#: the kill drill's requests run long enough that the kill lands mid-run
JOIN_KILL_NEW = 512
JOIN_KILL_AFTER_S = 1.0
JOIN_CHILD_START_S = 300.0


def join_block(hb_dir):
    """The ``serving:`` block of phase 25's replicas (no tenancy, no canary:
    the deadline rides on each request)."""
    return {"serving": {"enabled": True, "policy": "deadline",
                        "heartbeat_dir": str(hb_dir), "heartbeat_interval_s": 0.5,
                        "fused_decode_chunk": 16, "engine": dict(FLEET_SLICE)}}


def join_planner():
    """Phase 25's measuring planner on its own cache directory."""
    from deepspeed_tpu_torch.comm.planner import configure_planner

    return configure_planner("measure", cache_dir=str(JOIN_CACHE), **JOIN_PLANNER)


def join_server(rid, layers=None, seed=None):
    """One Llama-2-7B replica (bf16, seeded weights on the card)."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.serving import LLMServer

    over = {} if layers is None else {"num_layers": layers}
    cfg = llama_config("7b", dtype=torch.bfloat16, **over)
    params = init_params(cfg, seed=rid if seed is None else seed, device="cuda",
                         dtype=torch.bfloat16)
    return LLMServer.from_config(cfg, params, join_block(JOIN_DIR / "heartbeats"),
                                 replica_id=rid)


def fleet_join_child_server(replica_id):
    """Phase 25 (b)'s child factory (``python -m
    deepspeed_tpu_torch.fleet.subproc --factory chip_smoke:fleet_join_child_server``):
    the same planner and caches as the parent, a replica of 8 layers with
    seed 0, and the paged wrappers' counts written to
    ``heartbeats/launches_<id>.json`` every 0.25 s and at exit (the protocol
    carries no counts)."""
    import atexit
    import threading

    from deepspeed_tpu_torch.ops import paged_attention as pa

    # the worker's lifecycle handle reads the winner cache at the default
    # directory, which this variable names
    os.environ["DSTPU_PLAN_CACHE"] = str(JOIN_CACHE)
    join_planner()
    path = JOIN_DIR / "heartbeats" / f"launches_{replica_id}.json"

    def write():
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"launches": dict(pa.launch_counts),
                                   "routes": {n: dict(r) for n, r in pa.route_counts.items()}}))
        os.replace(tmp, path)

    def loop():
        while True:
            write()
            time.sleep(0.25)
    atexit.register(write)
    threading.Thread(target=loop, daemon=True, name="launch-counts").start()
    return join_server(replica_id, layers=JOIN_CHILD_LAYERS, seed=0)


def join_phase(pa, card):
    """Phase 25 (a): the scale arc in one process. A measuring planner on a
    fresh cache, a ``FleetManager`` (1..2 replicas of Llama-2-7B, bf16,
    seeded weights of their own) started with one replica, a
    ``ControlSupervisor`` ticking on it every 32 steps with the manager's
    ``scale_out`` as its ``scale_fn``; ``OpenLoopTraffic`` (seed 25) sends
    40 requests at 3 a second (prompts 128..1024, 64 new tokens, a 1 s
    deadline each), so ``rule_sla`` scales out; a host loop calls
    ``router.check()`` and ``manager.poll()`` every 0.25 s, and once the
    traffic is done the poll drains the less loaded replica. Returns the
    phase's numbers for (b)."""
    import shutil
    import threading

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.planner import microbench, probe_stats
    from deepspeed_tpu_torch.control import ControlSupervisor, describe_action
    from deepspeed_tpu_torch.fleet import JOINED, FleetManager
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.runtime.config import ControlConfig
    from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, LengthDist, OpenLoopTraffic, TrafficConfig

    from deepspeed_tpu_torch.comm.planner import reset_probe_memo

    shutil.rmtree(JOIN_DIR, ignore_errors=True)
    hb_dir = JOIN_DIR / "heartbeats"
    hb_dir.mkdir(parents=True)
    reset_probe_memo()
    planner = join_planner()
    cfg = llama_config("7b", dtype=torch.bfloat16)
    dispatched = {}        # replica -> monotonic times of its submits

    def factory(rid):
        server = join_server(rid)
        submit = server.submit

        def recorded(*a, **k):
            dispatched.setdefault(rid, []).append(time.monotonic())
            return submit(*a, **k)
        server.submit = recorded
        return server

    sup = ControlSupervisor(ControlConfig.from_dict(JOIN_CONTROL))
    mgr = FleetManager(factory, supervisor=sup, min_replicas=1, max_replicas=2,
                       autotune_cache_dir=str(JOIN_CACHE))
    scale, watch = {}, {}
    scale_out = mgr.scale_out

    def timed_scale_out(s=None):
        # replica 1's build and warm run here, on replica 0's engine thread:
        # the tally's snapshots around it split that thread's launches into
        # replica 1's warm and replica 0's served traffic
        scale["t0"] = time.monotonic()
        scale["built0"] = probe_stats()["built"]
        scale["launches0"] = watch["tally"].snapshot()
        try:
            return scale_out(s)
        finally:
            scale["t1"] = time.monotonic()
            scale["built1"] = probe_stats()["built"]
            scale["launches1"] = watch["tally"].snapshot()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    router = mgr.start(1, transport=FileHeartbeatTransport(str(hb_dir)),
                       dead_after_s=FLEET_DEAD_AFTER_S)
    start_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start_launches = dict(pa.launch_counts)
    h0 = mgr.handles[0]
    s0 = h0.server
    r0 = h0.report
    decision = planner.plan.decisions.get(s0.engine._decode_attn_site(torch.bfloat16)
                                          .signature())
    probes = {k[1]: v for k, v in microbench._PROBE_MEMO.items() if k[0].startswith("decode:")}
    stats_after_start = probe_stats()
    sup.attach_server(s0, interval_steps=JOIN_TICK_STEPS, scale_fn=timed_scale_out)
    traffic = OpenLoopTraffic(TrafficConfig(
        rate_rps=JOIN_RATE, num_requests=JOIN_REQUESTS, seed=25,
        vocab_size=cfg.vocab_size, prompt_len=LengthDist("uniform", 128, 1024),
        output_len=LengthDist("fixed", JOIN_NEW, JOIN_NEW), deadline_s=JOIN_DEADLINE_S))
    ran, polls, t_done = {}, [], None
    try:
        pa.reset_launch_counts()
        with ThreadLaunches(pa) as tally:
            watch["tally"] = tally
            t0 = time.perf_counter()
            feeder = threading.Thread(target=lambda: ran.update(zip(
                ("resps", "rejected"), traffic.run(router.submit))), daemon=True)
            feeder.start()
            while True:
                router.check()
                drained = mgr.poll()
                if drained is not None:
                    polls.append((drained, time.perf_counter() - t0))
                done = not feeder.is_alive() and all(r.done for r in ran.get("resps", []))
                if done and t_done is None:
                    t_done = time.perf_counter()
                # the scale-in comes from the poll once the fleet idles; a
                # fleet that never scaled out has none to make
                if done and (polls or time.perf_counter() - t_done > 30):
                    break
                if time.perf_counter() - t0 > 600:
                    raise SystemExit("fleet join: still running after 600 s")
                time.sleep(0.25)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            final = tally.snapshot()
        launches = dict(pa.launch_counts)
        routes = {n: dict(r) for n, r in pa.route_counts.items()}
        handles = dict(mgr.handles)
        survivors = [h for h in handles.values() if h.state == JOINED]
        drained_all = router.drain(timeout=120)
        conservation = {}
        for rid, h in handles.items():
            eng = h.server.engine
            eng.kv.assert_conservation([s.blocks for s in eng.state_manager.all()])
            conservation[rid] = (not eng.state_manager.all()
                                 and eng.kv.free_blocks == eng.kv.num_blocks - 1)
    finally:
        mgr.close()
    resps = ran["resps"]
    h1 = handles.get(1)
    r1 = h1.report if h1 is not None else None
    joined_at = {rid: next((t for s, t in h.transitions if s == JOINED), None)
                 for rid, h in handles.items()}
    ledger = [(e.action, e.rule, e.outcome, dict(e.params or {})) for e in sup.ledger.entries()]
    kinds = [(a, r) for a, r, _, _ in ledger]
    scale_ins = [p for a, _, _, p in ledger if a == "serving_scale_in"]
    names = ("paged_attention", "paged_flash_decode")
    layers = cfg.num_layers
    threads = {t: c for t, c in final.items()}
    engine_impls = {rid: (h.server.engine.decode_attn_impl, h.server.engine.decode_attn_source)
                    for rid, h in handles.items()}
    impl = decision.impl if decision is not None else None
    used = {n: launches[n] for n in names}
    # replica 1's warm (on replica 0's thread, inside scale_out) against the
    # traffic each engine thread served: replica 1's thread starts at its
    # JOINED, so all of its launches are served ones
    thread0 = "llm-server-0"
    warm1 = tally_minus({thread0: scale.get("launches1", {}).get(thread0, {})},
                        {thread0: scale.get("launches0", {}).get(thread0, {})})
    served = tally_minus(threads, warm1)
    warm_decode = tally_sum(warm1, "paged_flash_decode")
    served_decode = tally_sum(served, "paged_flash_decode")
    chunk = handles[0].server.fused_decode_chunk
    # replica 1's warm generation (``engine.generate``: SplitFuse steps,
    # then fused decode) runs the decided decode path whatever the winner;
    # served traffic runs it only where the winner keeps fused chunks on
    # (packed steps never launch the decode kernel)
    warm_gate = (warm_decode > 0) == (impl == "pallas")
    # the winner was timed at the serving batch (ROADMAP C3): served traffic
    # runs the decided path, so the decode kernel launches after JOINED iff
    # fused chunks won and the planner picked the kernel
    fused_won = r0.winner_name == "fd8" and chunk == 8
    served_name = (f"served traffic ran the decided path (winner {r0.winner_name}, fused "
                   f"chunk {chunk}, decode_attn {impl}): the decode kernel launched after "
                   "JOINED iff fd8 won and the kernel is the pick")
    served_gate = (served_decode > 0) == (fused_won and impl == "pallas")
    served_gate = served_gate and all(
        tally_sum({t: served.get(t, {})}, "paged_attention") > 0
        for t in ("llm-server-0", "llm-server-1"))
    stall = scale.get("t1", 0.0) - scale.get("t0", 0.0)
    sla_to_joined = (joined_at.get(1) - scale["t0"]) if "t0" in scale and joined_at.get(1) else None
    served1 = sum(1 for r in resps if r.replica_id == 1)
    checks = {
        f"{JOIN_REQUESTS} requests submitted, none shed": (
            len(resps) == JOIN_REQUESTS and not ran["rejected"]),
        f"every request finished by length with {JOIN_NEW} tokens": all(
            r.finish_reason == FINISH_LENGTH and len(r.tokens) == JOIN_NEW for r in resps),
        "replica 0 resolved decode_attn through the planner": (
            engine_impls[0] == (impl, "planner") and decision.source == "measured"),
        "replica 0 built both decode probes; its warm ran the 2 winner probes": (
            stats_after_start["built"] == 2 and len(probes) == 2
            and r0.autotune_probes == 2 and not r0.autotune_from_cache),
        "replica 1 joined with zero probes: cached winner, planner decision, no build": (
            r1 is not None and r1.zero_probe_join() and r1.autotune_from_cache
            and r1.winner_name == r0.winner_name and engine_impls.get(1) == (impl, "planner")
            and scale.get("built1") == scale.get("built0") == stats_after_start["built"]),
        "no request dispatched to replica 1 before its JOINED time": (
            joined_at.get(1) is not None
            and all(t >= joined_at[1] for t in dispatched.get(1, []))),
        "ledger: replica_join (fleet_start), serving_scale, replica_join "
        "(fleet_scale_out), serving_scale_in drained clean": (
            ("replica_join", "fleet_start") in kinds
            and any(a == "serving_scale" and o == "ok" for a, _, o, _ in ledger)
            and ("replica_join", "fleet_scale_out") in kinds
            and len(scale_ins) == 1 and scale_ins[0].get("drained_clean") == "True"),
        "each replica's KV conservation": len(conservation) == 2 and all(conservation.values()),
        "the router drained the survivor": drained_all and len(survivors) == 1,
        f"replica 1's warm ran decode_attn {impl}: the decode kernel launched in it iff "
        "it is the pick": warm_gate,
        served_name + "; both engine threads served packed steps": served_gate,
        "every launch on sm90, a whole number per layer in all, per engine thread, "
        "in replica 1's warm and in served traffic": all(
            routes[n] == {"sm90": launches[n], "cuda_core": 0} and launches[n] % layers == 0
            and all(c.get(n, {}).get("sm90", 0) % layers == 0
                    and c.get(n, {}).get("cuda_core", 0) == 0
                    for part in (threads, warm1, served) for c in part.values())
            for n in names) and used["paged_attention"] > 0,
        "the plan table names decode_attn": any(
            r.get("op") == "decode_attn" for r in comm.get_comms_logger().plan_records.values()),
    }
    ttft = [r.ttft_s for r in resps]
    tokens = sum(len(r.tokens) for r in resps)
    log(f"fleet join [{card}]: planner decision for {s0.engine._decode_attn_site(torch.bfloat16).signature()}: "
        f"{decision.to_dict() if decision else None}; probes "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in sorted(probes.items()))
        + f"; probe_stats after start {stats_after_start}; start(1) {start_s:.2f} s "
        f"(launches in it {start_launches})")
    log(f"fleet join [{card}]: replica 0 warm {r0.to_params()}")
    log(f"fleet join [{card}]: replica 1 warm {r1.to_params() if r1 else None}")
    log(f"fleet join [{card}]: SLA firing to JOINED {sla_to_joined if sla_to_joined is None else round(sla_to_joined, 3)} s; "
        f"replica 0's loop stalled {stall:.3f} s in scale_out (replica 1's build and warm run "
        f"on its engine thread); replica 1 served {served1} of {len(resps)} requests, first "
        f"dispatch {min(dispatched.get(1, [float('nan')])) - joined_at.get(1, 0.0) if joined_at.get(1) else None} s "
        f"after its JOINED time; scale-in {polls}")
    log(f"fleet join [{card}]: {tokens} tokens in {wall:.2f} s = {tokens / wall:.1f} generated "
        f"tok/s; TTFT p50 {_pct(ttft, 50):.1f} ms p99 {_pct(ttft, 99):.1f} ms; SLA "
        f"violations {sum(1 for r in resps if r.sla_violated())}/{len(resps)}; engines {engine_impls}")
    log(f"fleet join [{card}]: launches {launches} by thread {threads}; replica 1's warm "
        f"{warm1}; served after JOINED {served} (fused_decode_chunk {chunk})")
    log("fleet join: ledger" + "".join(f"\n  control: {describe_action(e)}"
                                       for e in sup.ledger.snapshot()))
    log("fleet join: " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    del router, handles, survivors, mgr, sup, resps, h0, s0, h1
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit("fleet join phase FAILED")
    return {"impl": impl, "launches": used}


def subproc_phase(pa, card, impl):
    """Phase 25 (b): a ``ReplicaRouter`` over replica 0 in this process and
    a ``SubprocessReplica`` replica 1 (``python -m
    deepspeed_tpu_torch.fleet.subproc``, factory
    ``chip_smoke:fleet_join_child_server``), both Llama-2-7B widths at 8
    layers with seed 0, sharing a heartbeat directory. Gates: replica 0
    times the serving winner of its depth (a's plan applies, a's 32-layer
    winner does not); the child's hello shows a zero-probe join from the
    plan of (a) and replica 0's winner; the child launched
    the paged kernels; its completed streams equal replica 0's for the same
    prompts under phase 22's tie rule; then the child is killed with
    SIGKILL mid-run, ``router.check()`` takes it over within
    ``dead_after_s`` + 2 s, and every request finishes by length on replica
    0."""
    import shutil
    import signal

    from deepspeed_tpu_torch.comm.planner import reset_planner
    from deepspeed_tpu_torch.fleet import ReplicaHandle, SubprocessReplica
    from deepspeed_tpu_torch.models.transformer import lm_forward
    from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
    from deepspeed_tpu_torch.serving import FINISH_LENGTH, ReplicaRouter, Request

    hb_dir = JOIN_DIR / "heartbeats"
    for f in hb_dir.glob("*"):
        f.unlink()
    h0 = ReplicaHandle(0, lambda rid: join_server(rid, layers=JOIN_CHILD_LAYERS, seed=0),
                       autotune_cache_dir=str(JOIN_CACHE))
    h0.spawn()
    r0 = h0.warm()
    s0 = h0.server
    router = ReplicaRouter([s0], transport=FileHeartbeatTransport(str(hb_dir)),
                           dead_after_s=FLEET_DEAD_AFTER_S).start()
    child = None
    rng = np.random.default_rng(252)
    vocab = s0.engine.cfg.vocab_size
    try:
        t0 = time.perf_counter()
        child = SubprocessReplica(1, "chip_smoke:fleet_join_child_server",
                                  heartbeat_dir=str(hb_dir),
                                  hello_timeout_s=JOIN_CHILD_START_S)
        start_s = time.perf_counter() - t0
        hello = dict(child.warm_params)
        router.add_replica(child)
        prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
                   for n in rng.integers(128, 512, JOIN_CHILD_PROMPTS)]
        mine = [child.submit(Request(p, max_new_tokens=JOIN_CHILD_NEW)) for p in prompts]
        ref = [s0.submit(Request(p, max_new_tokens=JOIN_CHILD_NEW)) for p in prompts]
        for r in mine + ref:
            if not r.wait(300):
                raise SystemExit("subproc: a stream did not finish within 300 s")
        counts_path = hb_dir / "launches_1.json"
        time.sleep(0.5)          # the child's writer runs every 0.25 s
        child_counts = json.loads(counts_path.read_text())
        # the kill drill: requests through the router, the child killed mid-run
        kill_reqs = [router.submit(Request(rng.integers(0, vocab, int(n)).astype(np.int32),
                                           max_new_tokens=JOIN_KILL_NEW))
                     for n in rng.integers(128, 512, JOIN_KILL_REQUESTS)]
        on_child = [r for r in kill_reqs if r.replica_id == 1]
        time.sleep(JOIN_KILL_AFTER_S)
        child_done_before_kill = sum(1 for r in on_child if r.done)
        os.kill(child.proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        child.proc.wait(30)
        detect = None
        while time.perf_counter() - t_kill < FLEET_DEAD_AFTER_S + 30:
            router.check()
            if 1 in router.dead_ids():
                detect = time.perf_counter() - t_kill
                break
            time.sleep(0.25)
        for r in kill_reqs:
            if not r.wait(300):
                raise SystemExit("subproc: a request after the kill did not finish in 300 s")
        requeues = router.requeues
        drained = router.drain(timeout=120)
        eng = s0.engine
        eng.kv.assert_conservation([s.blocks for s in eng.state_manager.all()])
    finally:
        router.close()
        if child is not None and child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(30)
    # phase 22's tie rule on the streams that differ
    firsts = []
    for i, (a, b) in enumerate(zip(mine, ref)):
        j = next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), None)
        if j is not None:
            firsts.append((i, j))
    ties = []
    if firsts:
        cfg32 = dataclasses.replace(eng.cfg, dtype=torch.float32, attn_impl="xla")
        params32 = _cast(eng.params, torch.float32, copy=True)
        for i, j in firsts:
            a, b = mine[i].tokens[j], ref[i].tokens[j]
            ctx = np.concatenate([prompts[i], np.asarray(ref[i].tokens[:j], np.int32)])
            with torch.no_grad():
                logits = lm_forward(cfg32, params32, torch.from_numpy(
                    ctx.astype(np.int64)).cuda()[None])[0, -1]
            below = [(logits.max() - logits[x]).item() for x in (a, b)]
            ties.append(max(below) < SPEC_TIE_MARGIN)
            log(f"subproc stream {i}: first differs at token {j} ({a} against {b}), "
                f"{below[0]:.4e} and {below[1]:.4e} below the float32 maximum")
        del params32
    layers = JOIN_CHILD_LAYERS
    cl, cr = child_counts["launches"], child_counts["routes"]
    checks = {
        "the child's hello: plan_from_cache >= 1, probes_built 0, autotune_probes 0, "
        "autotune_from_cache": (
            int(hello.get("plan_from_cache", 0)) >= 1 and hello.get("probes_built") == "0"
            and hello.get("autotune_probes") == "0"
            and hello.get("autotune_from_cache") == "True"),
        "replica 0 (8 layers) found no winner of its depth in (a)'s caches: it timed "
        "the 2 candidates and built no planner probe": (
            r0.probes_built == 0 and r0.autotune_probes == 2 and not r0.autotune_from_cache),
        "the child launched the paged kernels on sm90": (
            cl["paged_attention"] > 0 and cr["paged_attention"]["cuda_core"] == 0
            and (cl["paged_flash_decode"] > 0) == (impl == "pallas")
            and cr["paged_flash_decode"]["cuda_core"] == 0),
        f"{JOIN_CHILD_PROMPTS} child streams finished by length": all(
            r.finish_reason == FINISH_LENGTH and len(r.tokens) == JOIN_CHILD_NEW for r in mine),
        "child streams equal replica 0's or first differ at a float32 near-tie": all(ties),
        f"the child declared dead within {FLEET_DEAD_AFTER_S + FLEET_DETECT_SLACK_S:g} s of "
        "the SIGKILL": detect is not None and detect <= FLEET_DEAD_AFTER_S + FLEET_DETECT_SLACK_S,
        "the kill landed mid-run on the child": len(on_child) > child_done_before_kill,
        "every request finished by length on replica 0": all(
            r.finish_reason == FINISH_LENGTH and len(r.tokens) == JOIN_KILL_NEW
            and r.replica_id == 0 for r in kill_reqs),
        "replica 0 drained with KV conservation": (
            drained and not eng.state_manager.all()
            and eng.kv.free_blocks == eng.kv.num_blocks - 1),
    }
    log(f"subproc [{card}]: child start-up to hello {start_s:.2f} s; its warm {hello}; "
        f"replica 0 warm {r0.to_params()}; child launches {cl} routes {cr} "
        f"(per layer {cl['paged_attention'] / layers:.1f} / {cl['paged_flash_decode'] / layers:.1f})")
    log(f"subproc [{card}]: streams equal to the end {JOIN_CHILD_PROMPTS - len(firsts)}/"
        f"{JOIN_CHILD_PROMPTS}; kill with {len(on_child) - child_done_before_kill} of "
        f"{len(on_child)} child requests unfinished; declared dead "
        f"{'none' if detect is None else f'{detect:.2f}'} s after the SIGKILL "
        f"(dead_after_s {FLEET_DEAD_AFTER_S}); requeues {requeues}")
    log("subproc: " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    del router, s0, h0, eng, child
    gc.collect()
    torch.cuda.empty_cache()
    reset_planner()
    shutil.rmtree(JOIN_DIR, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit("subprocess replica phase FAILED")


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


# ---------------------------------------------------------------------------
# phase 26: tensor parallelism
# ---------------------------------------------------------------------------

#: (a): two ranks on cuda:0 over gloo, tensor_parallel.tp_size 2 (dp 1),
#: TinyLlama-1.1B's widths at 4 of 22 layers (phase 11's cut), micro 2 x
#: 2048, gas 2, bf16, vocab_parallel_loss with the fused loss, AdamW, ZeRO 0
TP_SPEC = {"world": 2, "tp": 2, "backend": "gloo", "model": "1b", "layers": 4,
           "micro": 2, "seq": 2048, "steps": 4}
TP_CONFIG = {
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "zero_optimization": {"stage": 0}, "bf16": {"enabled": True},
    "gradient_clipping": 1.0, "steps_per_print": 10**9,
    "tensor_parallel": {"enabled": True, "tp_size": 2},
}
#: (b): the rings at TinyLlama's MLP shape (tokens micro x seq, hidden 2048,
#: ffn 5632), bf16
TP_RING = {"tokens": 4096, "hidden": 2048, "ffn": 5632}
#: (c): Llama-2-7B's decode widths, 32 sequences
TP_DECODE = {"seqs": 32, "hidden": 4096, "vocab": 32000}


def tp_model(spec):
    from deepspeed_tpu_torch.models import llama_config

    return llama_config(spec["model"], num_layers=spec["layers"], dtype=torch.bfloat16,
                        vocab_parallel_loss=True, loss_impl="fused")


def tp_rings(rank, tp):
    """(b) in a tp world: ``all_gather_matmul`` and ``matmul_reduce_scatter``,
    exact and over the int8 wire (block 2048), at TinyLlama's MLP shape
    against the gathered product (the int8 all-gather against the product
    of the chunks through the plain quantizer and back); returns errors,
    bounds, the quant kernels' launches and times."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import collective_matmul as cm
    from deepspeed_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26 + rank)
    T, H, Fd = TP_RING["tokens"], TP_RING["hidden"], TP_RING["ffn"]
    x = torch.randn((1, T // tp, H), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((H, Fd // tp), generator=gen, device="cuda") / H ** 0.5).to(torch.bfloat16)
    hid = torch.randn((1, T, Fd // tp), generator=gen, device="cuda").to(torch.bfloat16)
    wd = (torch.randn((Fd // tp, H), generator=gen, device="cuda") / Fd ** 0.5).to(torch.bfloat16)
    x_full = comm.all_gather(x, "tp", gather_dim=1).float()
    ag_ref = x_full @ w.float()
    # the int8 wire's all-gather reference: every rank's chunk through the
    # plain block quantizer and back (ops/quant.py), then the fp32 product
    n_el, block = x.numel(), cm._WIRE_BLOCK
    nb = -(-n_el // block)
    ag_q_ref = torch.cat([quant.dequantize_ref(*quant.quantize_ref(
        c.reshape(-1).contiguous(), n_el, nb, block), n_el).reshape(c.shape)
        for c in x_full.split(T // tp, dim=1)], dim=1) @ w.float()
    part = hid.float() @ wd.float()
    rs_ref = comm.all_reduce(part.clone(), "tp").narrow(1, rank * (T // tp), T // tp)
    out = {}
    quant.reset_launch_counts()
    for wire in ("exact", "int8"):
        ag = cm.all_gather_matmul(x, w, "tp", wire_dtype=wire).float()
        rs = cm.matmul_reduce_scatter(hid, wd, "tp", wire_dtype=wire).float()
        out[f"ag_{wire}"] = float((ag - (ag_q_ref if wire == "int8" else ag_ref)).abs().max())
        out[f"rs_{wire}"] = float((rs - rs_ref).abs().max())
    out["quant_launches"] = dict(quant.launch_counts)
    # bounds: bf16 outputs one rounding (2^-8 relative) from fp32 values
    # summed in another order (the reduce-scatter adds two rounded
    # partials); the int8 all-gather's fp32 output against the plain
    # quantizer's chunks: one bf16 rounding of its scale (the kernels and
    # the plain version quantize alike, the products differ in order only);
    # the int8 reduce-scatter: half a quantization step of the one hop's
    # partial sum (absmax / 254, ops/quant.py)
    pmax = float(comm.all_reduce(part.abs().amax().reshape(1), "tp", op="max"))
    out["ag_exact_bound"] = 2 ** -7 * float(ag_ref.abs().max())
    out["rs_exact_bound"] = 2 ** -6 * max(pmax, float(rs_ref.abs().max()))
    out["ag_int8_bound"] = 2 ** -8 * float(ag_q_ref.abs().max())
    out["rs_int8_bound"] = pmax / 254 + 2 ** -7 * pmax + 1e-5
    for wire in ("exact", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            cm.all_gather_matmul(x, w, "tp", wire_dtype=wire)
            cm.matmul_reduce_scatter(hid, wd, "tp", wire_dtype=wire)
        torch.cuda.synchronize()
        out[f"ms_{wire}"] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def tp_loss_shard(rank, tp, T, E, vloc):
    """(a)'s fused-loss kernels on this rank's vocab shard at the main
    path's shape (``T`` tokens, hidden ``E``, shard ``vloc``, bf16) with
    global target ids shifted by ``rank * vloc``, as
    ``fused_vocab_nll(axis_name="tp")`` shifts them (on rank 0 half of them
    past the shard, on rank 1 half negative), against their plain versions
    on the same inputs: lse, the target logit, dh and dK (the mean loss's
    cotangents through the cross-rank combine), the first and last dl
    chunks (where a clamped id would land); the target logit of every
    out-of-shard id exactly 0; and ``fused_vocab_nll``'s combined per-token
    NLL against the plain NLL over the whole gathered head."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2600)                      # the same tokens on both ranks
    h = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.randint(0, vloc * tp, (T,), generator=gen, device="cuda", dtype=torch.int32)
    k_full = (0.02 * torch.randn(E, vloc * tp, generator=gen, device="cuda")).to(torch.bfloat16)
    k = k_full[:, rank * vloc:(rank + 1) * vloc].contiguous()
    tl = t - rank * vloc
    outside = (tl < 0) | (tl >= vloc)
    lse, tgt = fl.fused_nll_forward(h, k, tl)
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, tl)
    m = comm.all_reduce(lse_r.clone(), "tp", op="max")
    logz = torch.log(comm.all_reduce(torch.exp(lse_r - m), "tp")) + m
    g_lse = torch.exp(lse_r - logz) / T
    g_tgt = torch.full_like(lse_r, -1.0 / T)
    dh, dk = fl.fused_nll_backward(h, k, tl, lse_r, g_lse, g_tgt)
    dh_r, dk_r = fl.fused_nll_bwd_ref(h, k, tl, lse_r, g_lse, g_tgt)
    e = {"lse": scaled_err(lse, lse_r), "tgt": scaled_err(tgt, tgt_r),
         "dh": scaled_err(dh, dh_r), "dk": scaled_err(dk, dk_r)}
    kvt, base = fl._layout(k)
    vc = fl.chunk_width(T, vloc, h.element_size())
    ws = torch.empty((T, vc), dtype=h.dtype, device="cuda")
    for name, v0 in (("dl_first", 0), ("dl_last", (vloc - 1) // vc * vc)):
        width = min(vc, vloc - v0)
        fl.launch_dlogits(h, base, tl, lse_r, g_lse, g_tgt, ws, v0, width, kvt,
                          fl.loss_route(h, base))
        e[name] = scaled_err(ws[:, :width], fl.fused_dlogits_ref(h, k, tl, lse_r, g_lse,
                                                                 g_tgt, v0, width))
    lse_f, tgt_f = fl.fused_nll_fwd_ref(h, k_full, t)
    e["nll"] = scaled_err(fl.fused_vocab_nll(h, k, t, axis_name="tp"), lse_f - tgt_f)
    torch.cuda.synchronize()
    return {"errs": e, "outside": int(outside.sum()), "negative": int((tl < 0).sum()),
            "tgt_zero_outside": bool((tgt[outside] == 0).all()),
            "route": fl.loss_route(h, base)}


def tp_decode(rank, tp):
    """(c) in a tp world: the five TP decode functions at Llama-2-7B's widths
    (32 sequences, hidden 4096, vocab 32000, bf16) against the dense
    products; ``tp_greedy_token`` against the dense argmax."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.v2 import model as tmodel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(260 + rank)
    S, H, V = TP_DECODE["seqs"], TP_DECODE["hidden"], TP_DECODE["vocab"]
    bf = torch.bfloat16
    x = torch.randn((S // tp, H), generator=gen, device="cuda").to(bf)
    wqkv = (torch.randn((H, 3 * H // tp), generator=gen, device="cuda") / H ** 0.5).to(bf)
    attn = torch.randn((S, H // tp), generator=gen, device="cuda").to(bf)
    wo = (torch.randn((H // tp, H), generator=gen, device="cuda") / H ** 0.5).to(bf)
    wv = (torch.randn((H, V // tp), generator=gen, device="cuda") / H ** 0.5).to(bf)
    x_full = comm.all_gather(x, "tp", gather_dim=0)
    part = attn.float() @ wo.float()
    dense = {"matmul": (x_full @ wqkv).float(),
             "logits": (x_full @ wv).float(),
             "out": comm.all_reduce(part.clone(), "tp").narrow(0, rank * (S // tp), S // tp)}
    scale = {k: float(v.abs().max()) for k, v in dense.items()}
    scale["out"] = max(scale["out"], float(comm.all_reduce(part.abs().amax().reshape(1),
                                                           "tp", op="max")))
    out = {"impl": tmodel.resolve_decode_tp_impl("tp", x.shape, x.dtype)}
    for impl in ("xla", "fused_matmul"):
        got = {"matmul": tmodel.tp_decode_matmul(x, wqkv, "tp", impl=impl),
               "out": tmodel.tp_decode_out_proj(attn, wo, "tp", impl=impl),
               "logits": tmodel.tp_decode_logits(x, wv, "tp", impl=impl)}
        for k, v in got.items():
            out[f"{k}_{impl}"] = float((v.float() - dense[k]).abs().max())
            out[f"{k}_{impl}_bound"] = 2 ** -6 * scale[k]
        full = comm.all_gather(got["logits"].contiguous(), "tp", gather_dim=1)
        greedy = tmodel.tp_greedy_token(got["logits"], "tp")
        out[f"greedy_{impl}"] = bool(torch.equal(greedy.long(), full.float().argmax(-1)))
    return out


def tp_child(rank: int, workdir: Path) -> int:
    """One rank of phase 26's world (workdir/spec.json): (a) trains
    ``steps`` steps at tp 2 from seeded weights (an init closure on the
    card; the engine slices each leaf to this rank's shard), then the
    fused-loss kernels on its vocab shard against their plain versions
    (``tp_loss_shard``), (b) and (c); writes losses, step times, peak
    memory, every kernel's launches and routes on the training steps,
    whether each whole (replicated) leaf equals rank 0's bitwise, and the
    checks' numbers to workdir/out_<rank>.json."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm, zero
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn
    from deepspeed_tpu_torch.models.convert import _nest, param_shapes
    from deepspeed_tpu_torch.ops import flash_attention, fused_adam, fused_loss, quant

    spec = json.loads((workdir / "spec.json").read_text())
    comm.init_distributed(dist_backend=spec["backend"], init_method=f"file://{workdir}/store",
                          rank=rank, world_size=spec["world"], timeout=900)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references: no TF32
    cfg = tp_model(spec)
    dp = spec["world"] // spec["tp"]
    batch = dp_batch(cfg, spec["micro"] * dp, spec["seq"])
    meta = _nest({k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()})
    init = zero.Init(lambda: init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
    engine, *_ = dst.initialize(model=make_loss_fn(TransformerLM(cfg, meta)),
                                model_parameters=init,
                                config=dict(TP_CONFIG, train_micro_batch_size_per_gpu=spec["micro"]))
    kernels = (flash_attention, fused_adam, fused_loss, quant)
    for k in kernels:
        k.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(spec["steps"]):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {}
    for k in kernels:
        launches.update(k.launch_counts)
    routes = {"flash": {k: dict(v) for k, v in flash_attention.route_counts.items()},
              "loss_fwd": dict(fused_loss.fwd_route_counts),
              "loss_bwd": dict(fused_loss.route_counts)}
    peak = torch.cuda.max_memory_allocated()
    same, n_params = True, 0
    for p, d in zip(engine._masters, engine._tp_dims):
        n_params += p.numel() * (1 if d is None else spec["tp"])
        if d is None:
            same &= torch.equal(p, comm.broadcast(p.detach().clone(), src=0))
    same = torch.tensor([int(same)], device="cuda")
    comm.all_reduce(same, op="min")
    vloc = [p.shape for path, p in zip(engine._paths, engine._masters)
            if path == "lm_head/kernel"][0][1]
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    out = {"losses": losses, "times": times, "launches": launches, "routes": routes,
           "peak": peak, "replicated_equal": bool(same.item()), "params": n_params,
           "vocab_shard": vloc, "tp_rank": comm.axis_index("tp")}
    out["loss_shard"] = tp_loss_shard(rank, spec["tp"], spec["micro"] * spec["seq"],
                                      cfg.hidden_size, vloc)
    out["rings"] = tp_rings(rank, spec["tp"])
    out["decode"] = tp_decode(rank, spec["tp"])
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    comm.barrier()
    comm.destroy_process_group()
    return 0


def tp_phase(card):
    """Phase 26: TP_SPEC's world (tp_child) and its gates, and the first
    loss against a tp 1 run of the same weights and batches in this
    process. Returns the world's kernel launches on rank 0 ((a)'s, and
    (b)'s quant launches)."""
    import shutil

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import TransformerLM, init_params, make_loss_fn
    from deepspeed_tpu_torch.ops.fused_loss import chunk_width

    spec = TP_SPEC
    workdir = REPO / "build" / "tp_smoke"
    t0 = time.perf_counter()
    ranks = run_dp_world(spec, workdir, child="--tp-child")
    wall = time.perf_counter() - t0
    cfg = tp_model(spec)
    gas, steps = TP_CONFIG["gradient_accumulation_steps"], spec["steps"]
    r0 = ranks[0]
    # the tp 1 reference: the same weights and batches in one process
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    ref_cfg = dataclasses.replace(cfg, vocab_parallel_loss=False)
    engine, *_ = dst.initialize(
        model=make_loss_fn(TransformerLM(ref_cfg, params)), model_parameters=params,
        config=dict(TP_CONFIG, tensor_parallel={"enabled": False},
                    train_micro_batch_size_per_gpu=spec["micro"]))
    batch = dp_batch(cfg, spec["micro"], spec["seq"])
    ref = float(engine.train_batch(batch))
    del engine, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    tokens = gas * spec["micro"] * spec["seq"] * (spec["world"] // spec["tp"])
    vloc = r0["vocab_shard"]
    chunks = -(-vloc // chunk_width(spec["micro"] * spec["seq"], vloc, 2))
    want = {k: cfg.num_layers * gas * steps for k in FLASH_NAMES}
    want.update(fused_adam=steps, fused_loss_fwd=gas * steps,
                fused_loss_fwd_combine=gas * steps)
    for k in ("fused_loss_dlogits", "fused_loss_dh", "fused_loss_dk"):
        want[k] = gas * steps * chunks
    losses = r0["losses"]
    step_s = sum(r0["times"][1:]) / (steps - 1)
    p_full = r0["params"]
    rings, dec = [r["rings"] for r in ranks], [r["decode"] for r in ranks]
    checks = {
        "losses finite, falling, one value on both ranks": (
            all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and all(r["losses"] == losses for r in ranks)),
        f"first loss within 1e-3 |ref| of the tp 1 run ({ref:.6f})": (
            abs(losses[0] - ref) <= 1e-3 * abs(ref)),
        "every replicated leaf bitwise equal on both ranks": all(
            r["replicated_equal"] for r in ranks),
        f"launches a rank exactly {want}": all(
            r["launches"][k] == w for r in ranks for k, w in want.items()),
        "flash and the fused loss on wgmma": all(
            r["routes"]["flash"][k]["mma_sync"] == 0 and r["routes"]["flash"][k]["wgmma"] > 0
            for r in ranks for k in FLASH_NAMES) and all(
            r["routes"]["loss_fwd"]["mma_sync"] == r["routes"]["loss_bwd"]["mma_sync"] == 0
            and r["routes"]["loss_bwd"]["wgmma"] == 3 * gas * steps * chunks for r in ranks),
        f"the head is a vocab shard of {cfg.vocab_size // spec['tp']}": (
            vloc == cfg.vocab_size // spec["tp"]),
        "(a) fused-loss kernels on the shard with shifted ids against their plain "
        "versions (lse / tgt / NLL rel 1e-4, dl / dh / dK rel 2e-2), on wgmma": all(
            all(r["loss_shard"]["errs"][k][1] <= (1e-4 if k in ("lse", "tgt", "nll") else 2e-2)
                for k in r["loss_shard"]["errs"]) and r["loss_shard"]["route"] == "wgmma"
            for r in ranks),
        "(a) the target logit of every out-of-shard id is 0 (rank 1: negative ids)": all(
            r["loss_shard"]["tgt_zero_outside"] and r["loss_shard"]["outside"] > 0
            for r in ranks) and ranks[1]["loss_shard"]["negative"] > 0,
        "(b) rings exact within bf16 rounding, int8 within the block-quant bound": all(
            r[f"{op}_{w}"] <= r[f"{op}_{w}_bound"] for r in rings
            for op in ("ag", "rs") for w in ("exact", "int8")),
        "(b) the int8 wire launched the quant kernels": all(
            r["quant_launches"]["quantize_int8"] > 0 and r["quant_launches"]["dequantize_int8"] > 0
            for r in rings),
        "(c) TP decode projections within bf16 rounding of the dense products": all(
            d[f"{k}_{i}"] <= d[f"{k}_{i}_bound"] for d in dec
            for k in ("matmul", "out", "logits") for i in ("xla", "fused_matmul")),
        "(c) tp_greedy_token equals the dense argmax": all(
            d["greedy_xla"] and d["greedy_fused_matmul"] for d in dec),
        "(c) no planner: the decode row gather resolves to xla": all(
            d["impl"] == "xla" for d in dec),
    }
    log(f"tp [{card}]: TinyLlama-1.1B widths, {cfg.num_layers} layers, tp 2 (two ranks on "
        f"cuda:0 over gloo), micro {spec['micro']} x {spec['seq']}, gas {gas}: losses "
        f"{losses}; tp 1 first loss {ref}; step {step_s * 1e3:.1f} ms "
        f"(steps 2-{steps}, times {[round(t, 4) for t in r0['times']]}), "
        f"{tokens / step_s:.1f} tokens/s; peak per rank "
        f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB beside 18P / 2 = "
        f"{18 * p_full / 2 / 2**30:.3f} GiB (P {p_full}); world wall {wall:.1f} s")
    log(f"tp: launches a rank {r0['launches']}; routes {r0['routes']}; vocab shard {vloc}, "
        f"{chunks} backward chunks")
    log("tp (a) fused-loss kernels on the vocab shard, shifted ids: " + "; ".join(
        f"rank {i} route {r['loss_shard']['route']}, {r['loss_shard']['outside']} ids "
        f"outside ({r['loss_shard']['negative']} negative), tgt 0 on them "
        f"{r['loss_shard']['tgt_zero_outside']}, " + ", ".join(
            f"{k} max|err|={a:.3e} (rel {q:.2e})" for k, (a, q) in r["loss_shard"]["errs"].items())
        for i, r in enumerate(ranks)))
    log(f"tp (b) rings at tokens {TP_RING['tokens']}, hidden {TP_RING['hidden']}, ffn "
        f"{TP_RING['ffn']} (bf16): " + "; ".join(
            f"rank {i} {r}" for i, r in enumerate(rings)))
    log(f"tp (c) decode at Llama-2-7B widths ({TP_DECODE}): " + "; ".join(
        f"rank {i} {d}" for i, d in enumerate(dec)))
    log("tp: " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    shutil.rmtree(workdir, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit("tp phase FAILED")
    out = dict(r0["launches"])
    for k in ("quantize_int8", "dequantize_int8"):
        out[k] = out.get(k, 0) + r0["rings"]["quant_launches"][k]
    return out


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
    ap.add_argument("--tp-child", nargs=2, metavar=("RANK", "WORKDIR"),
                    help=argparse.SUPPRESS)   # one rank of phase 26's tp world
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
    if args.tp_child:
        return tp_child(int(args.tp_child[0]), Path(args.tp_child[1]))
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
    for name, cfg in (("phi-3-mini", models["phi-3-mini"]), ("Pythia-1B", models["Pythia-1B"]),
                      ("Pythia-2.8B", models["Pythia-2.8B"]),
                      (MEGATRON_MODEL, megatron_345m_config())):
        cfg = dataclasses.replace(cfg, num_layers=2)
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
    # phase 18: ZeRO-3 at 6 layers, two ranks on one card
    timed("18 zero3 (TinyLlama-1.1B, 6 layers)", zero3_phase, card)
    # phase 19: ZeRO-Offload at full size on one card
    launches.update(timed("19 offload", offload_phase, card, cpu_model))
    # phase 20: the engine's remainder ((d) ran in phase 11's world)
    timed("20 (a) LAMB, dropout, frozen, prefetch (TinyLlama-1.1B)", extras_phase, card,
          (fa, adam, fl))
    timed("20 (b) Lion, Adagrad, SGD, MuAdamW (TinyLlama widths)", other_optimizers_phase,
          card)
    timed("20 (c) remat with dropout (TinyLlama widths)", dropout_remat_phase)
    # phase 21: mixture of experts (no kernel of its own: the trainer and
    # the servers run the flash, fused-loss, Adam and paged kernels)
    timed("21 (a) MoE training (Mixtral-8x7B widths, 2 layers)", moe_train_phase, card,
          (fa, adam, fl))
    timed("21 (b) MoE block bf16 vs fp32 (Mixtral-8x7B widths)", moe_block_phase, card)
    timed("21 (c) MoE serving (Mixtral-8x7B widths at 8 layers, Qwen1.5-MoE-A2.7B)",
          moe_serving_phase, pa, card)
    # phase 22: ALiBi and windowed families loaded from HF-named state dicts
    # and served on the einsum; speculative decoding over the packed kernel
    timed("22 (a) HF families served (BLOOM-1b7, GPT-Neo-1.3B)", hf_serving_phase, pa, card)
    timed("22 (b) family path parity (BLOOM-1b7, GPT-Neo-1.3B, MPT-7B widths, 2 layers)",
          family_parity_phase)
    timed("22 (c) speculative decoding (Llama-2-7B)", spec_phase, pa, card)
    # phase 23: checkpoint interchange ((d) ran in phase 11's world, (e) in
    # phase 3)
    timed("23 (a, b) Megatron GPT-2 345M from two tp shards: served, resharded",
          megatron_phase, pa, card)
    timed("23 (c) Megatron GPT-2 345M at ZeRO 2: trained, consolidated, exported",
          megatron_train_phase, card)
    # phase 24: the serving fleet
    fleet = timed("24 (a) two Llama-2-7B replicas behind the router, chaos, tenancy, canary",
                  fleet_phase, pa, card)
    log(f"fleet launches: {fleet} (phase 4's run: {launches['paged_attention']} / "
        f"{launches['paged_flash_decode']})")
    timed("24 (b) the SDC drill (Llama-2-7B widths, 8 layers)", sdc_phase, card)
    # phase 25: the fleet's warm join
    join = timed("25 (a) the scale arc: FleetManager 1 -> 2 Llama-2-7B replicas under SLA "
                 "pressure, warm join, scale-in", join_phase, pa, card)
    log(f"fleet join launches: {join['launches']} (phase 4's run: "
        f"{launches['paged_attention']} / {launches['paged_flash_decode']})")
    timed("25 (b) a subprocess replica: zero-probe join across a process, streams, "
          "SIGKILL takeover (Llama-2-7B widths, 8 layers)", subproc_phase, pa, card,
          join["impl"])
    # phase 26: tensor parallelism (the tp path's launches add to the rows'
    # counts: the fused loss on a vocab shard, the quant kernels on the
    # rings' int8 wire)
    tp = timed("26 tensor parallelism: TinyLlama-1.1B widths at tp 2, the rings, TP decode",
               tp_phase, card)
    log(f"tp launches added to the kernels line: {tp}")
    for k, n in tp.items():
        if k in launches:
            launches[k] += n

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
