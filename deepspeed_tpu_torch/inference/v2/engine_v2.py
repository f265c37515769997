"""Inference engine v2: continuous ragged batching (FastGen analogue).

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (reference
``InferenceEngineV2``, ``inference/v2/engine_v2.py:30``): ``put(uids,
tokens)`` admits work, each engine step packs prompt chunks + decode tokens
into one forward pass (Dynamic SplitFuse token budgeting), ``query`` /
``can_schedule`` expose scheduling capacity, and ``decode_batch`` /
``decode_stream`` run fused multi-token decode chunks. The host-side
scheduler, allocator, prefix index and packing are the JAX engine's; the
forward runs eagerly on a ``torch.device`` with the paged KV pools updated in
place.

KV storage (``kv_cache_dtype``): ``None`` keeps the pools in the compute
dtype; ``"int8"`` stores quantized rows with per-row scales (quantized on
scatter; prompt chunks attend on the gathered-dequant path, fused decode on
the decode kernel's int8 mode); any float dtype name, such as
``"float8_e4m3fn"``, is a storage cast served on the gathered path. The
resolution of both attention paths follows the JAX engine and is visible in
``attn_impl``, ``decode_attn_impl`` and ``decode_attn_source``: ALiBi and
windowed families (bloom, mpt, falcon-rw, gpt-neo, starcoder2) run both on
the einsum, since the paged kernels compute plain scaled causal attention.
``spec_decode_batch`` is n-gram speculative decoding: drafts from the
sequence's own context, verified in one packed dispatch (``verify_step``).
With a comm planner active (``comm.planner.configure_planner``), the fused
decode path is one of its sites (``decode_attn``): a static planner prices
the paged kernel against the einsum, a measuring one times both on the
card, and the pick is recorded in the comms ledger's plan table.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.transformer import TransformerConfig
from ...ops.paged_attention import _HEAD_DIMS as _PAGED_HEAD_DIMS
from ...utils.logging import logger
from .model import (check_supported, decode_loop, ragged_step,
                    special_attention, verify_step)
from .ragged.kv_cache import BlockedKVCache
from .ragged.prefix_index import ROOT_HASH, chain_hashes, hash_block
from .ragged.ragged_manager import DSStateManager
from .ragged.ragged_wrapper import RaggedBatchWrapper

_BACKENDS = ("auto", "pallas", "einsum")


@dataclass
class RaggedInferenceEngineConfig:
    """Knob vocabulary follows the reference's DSStateManagerConfig /
    RaggedInferenceEngineConfig."""
    token_budget: int = 256         # max tokens per engine step (T)
    max_ragged_sequence_count: int = 16   # sequence slots per step (S)
    max_chunk_size: int = 128       # SplitFuse prompt chunk cap (Q)
    num_kv_blocks: int = 512
    kv_block_size: int = 32
    max_blocks_per_seq: int = 64
    dtype: str = "float32"
    # KV pool storage dtype: None = the compute dtype; "int8" = quantized
    # rows with per-row fp32 scales (ops/quant.py quantize_rows); a float
    # dtype name (e.g. "float8_e4m3fn") = a storage cast, dequantized on the
    # gathered path
    kv_cache_dtype: Optional[str] = None
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # "pallas" (the name of the kernel path, kept from the JAX package):
    # the paged kernels — hand-written Hopper kernels on a CUDA device, their
    # plain versions on the CPU. "einsum": the gathered-page reference path.
    # "auto": the kernel path when the pools hold the compute dtype, else
    # einsum (the packed kernel takes compute-dtype pools only).
    attn_backend: str = "auto"    # auto | pallas | einsum
    # fused-decode attention path (model.decode_loop) specifically:
    # model field > this knob > attn_backend > the kernel path; a pool the
    # decode kernel cannot read (a storage cast other than int8) falls back
    # to einsum with a one-time warning
    decode_attn_backend: str = "auto"   # auto | pallas | einsum
    # decode iterations fused into one decode_batch() call
    decode_chunk: int = 16
    # cap on the per-dispatch fused window (the window buffer is
    # [L, n, S, Hk, D] and its dense attention O(n^2))
    max_fused_window: int = 512
    # content-addressed prefix KV reuse (ragged/prefix_index.py)
    enable_prefix_cache: bool = False
    # n-gram speculative decoding (spec_decode_batch): draft up to k tokens
    # per live sequence from the most recent prior occurrence of its last
    # spec_ngram tokens, verify them in one packed dispatch, commit the
    # accepted prefix and the model's correction. Greedy only. 0 = off.
    spec_decode_k: int = 0
    spec_ngram: int = 2


@dataclass
class ReuseStats:
    """Cumulative prefix-cache / speculative-decode counters (the serving
    tier samples these into ServingMetrics gauges)."""
    prefix_lookups: int = 0          # put() admissions that consulted the index
    prefix_hits: int = 0             # admissions that mapped >= 1 cached block
    prefix_tokens_reused: int = 0    # prompt tokens never re-prefilled
    prefix_blocks_shared: int = 0    # pages mapped shared (blocks saved)
    cow_forks: int = 0               # shared blocks copy-on-write-forked
    spec_steps: int = 0              # verify dispatches
    spec_drafted: int = 0            # draft tokens proposed
    spec_accepted: int = 0           # draft tokens accepted


_WARNED = set()


def _head_dim_bail(head_dim: int) -> Optional[str]:
    """Why the paged kernels cannot serve this head dim, or None: they are
    built for ``ops/paged_attention.py``'s ``_HEAD_DIMS`` only (the JAX
    engine's packed Pallas kernel takes any D; its decode bails to einsum at
    an off-tile D)."""
    if head_dim in _PAGED_HEAD_DIMS:
        return None
    return f"head_dim {head_dim} is not one the paged kernels build {_PAGED_HEAD_DIMS}"


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger.warning(msg)


def kv_storage_dtype(name: Optional[str], dtype: torch.dtype) -> torch.dtype:
    """The pools' storage dtype for ``kv_cache_dtype`` ``name`` (``None``:
    the compute dtype ``dtype``)."""
    if name is None:
        return dtype
    found = getattr(torch, str(name), None)
    if not (isinstance(found, torch.dtype)
            and (found == torch.int8 or found.is_floating_point)):
        raise ValueError(f"kv_cache_dtype={name!r} names neither int8 nor a "
                         "torch float dtype (e.g. 'float8_e4m3fn', 'bfloat16')")
    return found


class InferenceEngineV2:
    """``InferenceEngineV2(cfg, params, config, device="cuda")``: ``cfg`` is
    the port's :class:`TransformerConfig`, ``params`` the flax-layout tree of
    tensors (``models/convert.py``)."""

    def __init__(self, cfg: TransformerConfig, params,
                 config: Optional[RaggedInferenceEngineConfig] = None, *,
                 device="cuda"):
        self.config = config or RaggedInferenceEngineConfig()
        c = self.config
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg)
        # ALiBi / layer_windows families: the einsum path on both steps
        self._special_attn = special_attention(cfg)
        for knob in (c.attn_backend, c.decode_attn_backend, cfg.decode_attn_impl):
            if knob not in _BACKENDS:
                raise ValueError(f"attn backend must be auto|pallas|einsum, "
                                 f"got {knob!r}")
        if c.spec_decode_k < 0 or c.spec_ngram < 1:
            raise ValueError(f"spec_decode_k={c.spec_decode_k} must be >= 0 "
                             f"and spec_ngram={c.spec_ngram} >= 1")
        if c.spec_decode_k > 0 and not c.greedy:
            raise ValueError(
                "spec_decode_k > 0 requires greedy=True: the acceptance rule "
                "compares argmax streams, which has no sampled analogue here")
        if c.attn_backend == "pallas" and self._special_attn:
            raise ValueError(
                "attn_backend='pallas' computes plain scaled causal "
                "attention; ALiBi / layer_windows families "
                "run on the einsum path — use attn_backend='auto'")
        dtype = getattr(torch, c.dtype)
        kv_dtype = kv_storage_dtype(c.kv_cache_dtype, dtype)
        self.params = _cast_tree(params, dtype, self.device)
        self.kv = BlockedKVCache(cfg.num_layers, c.num_kv_blocks,
                                 c.kv_block_size, cfg.kv_heads, cfg.head_dim,
                                 dtype=kv_dtype, device=self.device,
                                 enable_prefix_index=c.enable_prefix_cache)
        self.state_manager = DSStateManager(self.kv)
        self.reuse = ReuseStats()
        self.wrapper = RaggedBatchWrapper(token_budget=c.token_budget,
                                          max_seqs=c.max_ragged_sequence_count,
                                          max_chunk=c.max_chunk_size,
                                          max_blocks_per_seq=c.max_blocks_per_seq)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(c.seed))
        # packed (prompt-chunk) path: the packed kernel takes compute-dtype
        # pools; quantized and storage-cast pools dequantize on the gather,
        # and ALiBi / windowed families and a head dim the paged kernels do
        # not build take the einsum
        if c.attn_backend == "auto":
            reason = None if self._special_attn else _head_dim_bail(cfg.head_dim)
            if reason:
                _warn_once(f"attn_backend='auto' but {reason} — packed prompt "
                           "steps run the gathered-page einsum (one-time notice)")
            self.attn_impl = ("pallas" if kv_dtype == dtype and not reason
                              and not self._special_attn else "einsum")
        elif c.attn_backend == "pallas" and kv_dtype != dtype:
            _warn_once(
                f"attn_backend='pallas' with kv_cache_dtype={c.kv_cache_dtype}: "
                "the packed-step kernel takes compute-dtype pools, so prompt "
                "chunks run the einsum gather; the fused decode path keeps "
                "the pallas kernel (int8 dequant fused in-kernel)")
            self.attn_impl = "einsum"
        else:
            self.attn_impl = c.attn_backend
        self.decode_attn_impl, self.decode_attn_source = \
            self._resolve_decode_attn(kv_dtype, dtype)
        self._record_decode_plan(kv_dtype)
        self.steps = 0
        self.last_num_scheduled = 0

    # ------------------------------------------------------------------
    # decode-attention resolution (model field > serving/engine config >
    # planner > heuristic — the resolve_loss_impl order)
    # ------------------------------------------------------------------
    def _decode_attn_site(self, kv_dtype):
        """The planner-IR site for this engine's fused-decode attention:
        ``shape`` is the gathered pool view one decode step would
        materialize on the einsum path ([S, B*bs, Hk, D], ONE pool) in the
        STORAGE dtype — the cost model's decode-shape regime prices both
        impls from it."""
        from ...comm.planner.ir import make_site

        c = self.config
        return make_site(op="decode_attn",
                         shape=(c.max_ragged_sequence_count,
                                c.max_blocks_per_seq * c.kv_block_size,
                                self.cfg.kv_heads, self.cfg.head_dim),
                         dtype=kv_dtype, axes=(), consumer="decode")

    def _decode_structural_bail(self, kv_dtype, dtype) -> Optional[str]:
        """Why the decode kernel cannot serve this model and pool, or None.
        It computes plain scaled causal attention over compute-dtype or int8
        ``(values, scales)`` pools."""
        if self.cfg.position == "alibi":
            return "the ALiBi per-head bias rides the logits"
        if self.cfg.layer_windows is not None:
            return "per-layer attention windows mask the logits"
        if kv_dtype != dtype and kv_dtype != torch.int8:
            return (f"kv_cache_dtype={self.config.kv_cache_dtype} "
                    "storage-cast pools dequantize on the gather path")
        return None

    def _resolve_decode_attn(self, kv_dtype, dtype) -> Tuple[str, str]:
        """Fused-decode attention path as ``(impl, source)``: the model field
        (``"model"``) > ``decode_attn_backend``, then ``attn_backend``
        (``"config"``) > a planner decision (``"planner"``, when a planner
        is active) > the kernel path (``"heuristic"``). A structural bail
        demotes a kernel pick to einsum with a one-time warning
        (``"fallback"``); a head dim the paged kernels do not build demotes
        only the planner's and the heuristic pick, so an explicit
        ``"pallas"`` reaches the kernel (which raises on the card). A
        planner that fails is passed over with a one-time warning, except
        for a probe that failed on the card (``ProbeError``), which
        raises."""
        c = self.config
        want, source = "auto", "heuristic"
        if self.cfg.decode_attn_impl != "auto":
            want, source = self.cfg.decode_attn_impl, "model"
        elif c.decode_attn_backend != "auto":
            want, source = c.decode_attn_backend, "config"
        elif c.attn_backend != "auto":
            want, source = c.attn_backend, "config"
        if want == "auto":
            from ...comm.planner.microbench import ProbeError

            try:
                from ...comm.planner import get_planner, planner_active

                if planner_active():
                    d = get_planner().resolve(self._decode_attn_site(kv_dtype))
                    if d.impl in ("pallas", "einsum"):
                        want, source = d.impl, "planner"
            except ProbeError:
                raise  # a kernel that fails its probe on the card would fail serving too
            except Exception as e:  # planning must never block engine bring-up
                _warn_once(f"decode_attn: the comm planner failed ({e!r}); "
                           "resolving without it (one-time notice)")
        if want == "auto":
            want, source = "pallas", "heuristic"
        if want == "pallas":
            reason = self._decode_structural_bail(kv_dtype, dtype)
            if reason is None and source in ("heuristic", "planner"):
                reason = _head_dim_bail(self.cfg.head_dim)
            if reason:
                _warn_once(
                    f"decode_attn='pallas' ({source}) but {reason} — fused "
                    "decode falls back to the gathered-page einsum "
                    "reference (one-time notice)")
                return "einsum", "fallback"
        return want, source

    def _record_decode_plan(self, kv_dtype) -> None:
        """Plan-table row for the resolved decode path: planner-sourced
        decisions were already recorded by ``resolve()``; every other
        source records here, so ``comm.log_summary()``'s plan table always
        names which decode attention implementation serves this engine."""
        if self.decode_attn_source == "planner":
            return
        from ...comm import get_comms_logger

        site = self._decode_attn_site(kv_dtype)
        get_comms_logger().record_plan(site.signature(), {
            "consumer": "decode", "op": "decode_attn",
            "shape": "x".join(str(d) for d in site.shape),
            "axes": "", "impl": self.decode_attn_impl, "block": None,
            "source": self.decode_attn_source, "est_us": None,
            "mode": "engine"})

    # ------------------------------------------------------------------
    # admission (reference put/query/can_schedule)
    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Unallocated KV pages (reference ``engine_v2.free_blocks``)."""
        return self.kv.free_blocks

    @property
    def uncommitted_free_blocks(self) -> int:
        """Free pages not yet promised to admitted sequences — what
        admission can actually spend."""
        return self.kv.free_blocks - self._outstanding_blocks()

    def get_remaining_block_capacity(self, uid: int) -> int:
        """Tokens a sequence can still append before needing a new page."""
        seq = self.state_manager.get(uid)
        if seq is None:
            return 0
        return (-seq.seen_tokens) % self.config.kv_block_size

    def put(self, uids: Sequence[int], tokens_list: Sequence[np.ndarray],
            max_new_tokens: int = 256, eos_token_id: Optional[int] = None):
        """Admit new sequences (prompts are scheduled incrementally)."""
        for uid, toks in zip(uids, tokens_list):
            toks = np.asarray(toks, np.int32).reshape(-1)
            ok, why = self.can_schedule(len(toks), max_new_tokens)
            if not ok:
                raise RuntimeError(f"cannot schedule uid={uid}: {why}")
            seq = self.state_manager.create(uid, toks,
                                            max_new_tokens=max_new_tokens,
                                            eos_token_id=eos_token_id)
            self._map_cached_prefix(seq)

    def _map_cached_prefix(self, seq) -> None:
        """Prefix-cache admission: map the longest chain of registered full
        blocks over the prompt SHARED into the sequence's block table and
        advance ``seen_tokens`` so only the uncached tail is prefilled. A
        fully-covered prompt re-runs its final token into a copy-on-write
        fork of the last matched page."""
        idx = self.kv.index
        if idx is None:
            return
        bs = self.config.kv_block_size
        self.reuse.prefix_lookups += 1
        hashes = chain_hashes(seq.prompt_tokens, bs)
        pages = idx.lookup(hashes)
        if not pages:
            return
        m = len(pages)
        plen = len(seq.prompt_tokens)
        self.kv.share(pages)
        seq.blocks = list(pages)
        seq.hash_chain = hashes[:m]
        seq.seen_tokens = m * bs
        shared = m
        if seq.seen_tokens >= plen:
            seq.seen_tokens = plen - 1
            src = seq.blocks[-1]
            fork = self.kv.cow_fork(src)
            seq.blocks[-1] = fork
            self.kv.release(src)
            shared -= 1
            self.reuse.cow_forks += 1
        seq.prefix_reused_tokens = seq.seen_tokens
        self.reuse.prefix_hits += 1
        self.reuse.prefix_tokens_reused += seq.seen_tokens
        self.reuse.prefix_blocks_shared += shared

    def _register_full_blocks(self, seq) -> None:
        """Publish this sequence's newly-FILLED full blocks into the prefix
        index (first writer wins). Only tokens whose KV is committed are
        hashable: ``seen_tokens`` bounds written rows, prompt+generated
        bounds known content."""
        idx = self.kv.index
        if idx is None:
            return
        bs = self.config.kv_block_size
        committed = len(seq.prompt_tokens) + len(seq.generated)
        n_full = min(min(seq.seen_tokens, committed) // bs, len(seq.blocks))
        chain = seq.hash_chain
        if n_full <= len(chain):
            return
        tokens = np.concatenate(
            [seq.prompt_tokens, np.asarray(seq.generated, np.int32)]) \
            if seq.generated else seq.prompt_tokens
        while len(chain) < n_full:
            i = len(chain)
            digest = hash_block(chain[-1] if chain else ROOT_HASH,
                                tokens[i * bs:(i + 1) * bs])
            chain.append(digest)
            idx.register(digest, seq.blocks[i])

    def _outstanding_blocks(self) -> int:
        """Worst-case blocks already promised to admitted sequences but not
        yet allocated — admission must not over-commit the pool."""
        bs = self.config.kv_block_size
        total = 0
        for seq in self.state_manager.all():
            if seq.done:
                continue
            worst = -(-(len(seq.prompt_tokens) + seq.max_new_tokens) // bs)
            total += max(0, worst - len(seq.blocks))
        return total

    def can_schedule(self, prompt_len: int, max_new_tokens: int) -> Tuple[bool, str]:
        total_len = prompt_len + max_new_tokens
        if total_len > self.cfg.max_seq_len:
            return False, (f"prompt {prompt_len} + max_new {max_new_tokens} exceeds "
                           f"the model's max_seq_len {self.cfg.max_seq_len}")
        blocks_needed = -(-total_len // self.config.kv_block_size)
        if blocks_needed > self.config.max_blocks_per_seq:
            return False, (f"sequence needs {blocks_needed} blocks > "
                           f"max_blocks_per_seq {self.config.max_blocks_per_seq}")
        available = self.uncommitted_free_blocks
        if blocks_needed > available:
            return False, (f"KV pool has {available} uncommitted free blocks "
                           f"(of {self.kv.free_blocks} free), need {blocks_needed}")
        return True, ""

    def query(self, uid: int):
        """(done, generated tokens so far) for a tracked uid."""
        seq = self.state_manager.get(uid)
        if seq is None:
            raise KeyError(f"unknown uid {uid}")
        return seq.done, np.array(seq.generated, np.int32)

    def flush(self, uid: int):
        """Release a sequence's KV blocks and tracking state."""
        self.state_manager.release(uid)

    def has_work(self) -> bool:
        return any((s.in_prefill or (not s.done)) for s in self.state_manager.all())

    def _slice_block_table(self, bt: np.ndarray, pos0: np.ndarray,
                           n: int) -> np.ndarray:
        """Slice the table to the pages this decode window can touch (the
        gathered-page path reads EVERY column; a power-of-two width keeps
        the einsum shapes to log2(max_blocks_per_seq) distinct sizes)."""
        bs = self.config.kv_block_size
        b_need = max(1, -(-(int(pos0.max()) + n) // bs))
        b_need = 1 << (b_need - 1).bit_length()
        return bt[:, :min(bt.shape[1], b_need)]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # one engine step: schedule -> pack -> forward -> sample
    # ------------------------------------------------------------------
    def schedule(self) -> List:
        """Dynamic SplitFuse: decode tokens first (latency), then fill the
        remaining budget with prompt chunks."""
        c = self.config
        budget = c.token_budget
        slots = c.max_ragged_sequence_count
        scheduled = []
        decodes = [s for s in self.state_manager.all()
                   if not s.done and not s.in_prefill and s.generated]
        prefills = [s for s in self.state_manager.all() if s.in_prefill]
        for seq in decodes:
            if budget < 1 or slots < 1:
                break
            toks = seq.next_tokens(1)
            if len(toks):
                self.kv.reserve(seq, len(toks))
                scheduled.append((seq, toks))
                budget -= len(toks)
                slots -= 1
        for seq in prefills:
            if budget < 1 or slots < 1:
                break
            n = min(budget, c.max_chunk_size)
            toks = seq.next_tokens(n)
            if len(toks):
                self.kv.reserve(seq, len(toks))
                scheduled.append((seq, toks))
                budget -= len(toks)
                slots -= 1
        return scheduled

    def step(self) -> Dict[int, int]:
        """Run one packed forward; returns {uid: sampled token} for sequences
        that produced a token this step."""
        scheduled = self.schedule()
        self.last_num_scheduled = len(scheduled)
        if not scheduled:
            return {}
        batch = self.wrapper.pack(scheduled, self.config.kv_block_size)
        kv_k, kv_v = self.kv.pool_args()
        d = self._dev
        sampled, new_k, new_v = ragged_step(
            self.params, self.cfg, kv_k, kv_v, d(batch.tokens),
            d(batch.positions), d(batch.gather_idx), d(batch.block_table),
            d(batch.kv_len), d(batch.logits_idx), d(batch.start_pos),
            d(batch.chunk_len), self._generator, self.config.temperature,
            attn_impl=self.attn_impl, greedy=self.config.greedy)
        self.kv.update(new_k, new_v)
        sampled = sampled.cpu().numpy()    # [S] int32 — the only D2H transfer
        out: Dict[int, int] = {}
        for seq, toks in scheduled:
            seq.seen_tokens += len(toks)
        for s in batch.sample_slots:
            seq, _ = scheduled[s]
            tok = int(sampled[s])
            seq.generated.append(tok)
            out[seq.uid] = tok
            if ((seq.eos_token_id is not None and tok == seq.eos_token_id)
                    or len(seq.generated) >= seq.max_new_tokens):
                seq.done = True
        for seq, _ in scheduled:
            self._register_full_blocks(seq)
        self.steps += 1
        return out

    def _run_decode(self, seqs, n: int) -> np.ndarray:
        """Reserve ``n`` tokens for each live sequence and run one fused
        decode chunk; returns the sampled tokens [S, n]."""
        c = self.config
        S, B = c.max_ragged_sequence_count, c.max_blocks_per_seq
        tokens0 = np.zeros((S,), np.int32)
        pos0 = np.zeros((S,), np.int32)
        bt = np.zeros((S, B), np.int32)
        active = np.zeros((S,), bool)
        for slot, seq in enumerate(seqs):
            self.kv.reserve(seq, n)
            tokens0[slot] = seq.generated[-1]
            pos0[slot] = seq.seen_tokens
            bt[slot, :len(seq.blocks)] = seq.blocks
            active[slot] = True
        bt = self._slice_block_table(bt, pos0, n)
        kv_k, kv_v = self.kv.pool_args()
        d = self._dev
        toks, new_k, new_v = decode_loop(
            self.params, self.cfg, kv_k, kv_v, d(tokens0), d(pos0), d(bt),
            d(active), self._generator, c.temperature, n_steps=n,
            attn_impl=self.decode_attn_impl, greedy=c.greedy)
        self.kv.update(new_k, new_v)
        self.steps += 1
        return toks.cpu().numpy()

    def _accept(self, seqs, toks: np.ndarray, n: int) -> Dict[int, List[int]]:
        """Commit each sequence's tokens up to its EOS / budget; all ``n``
        decoded tokens entered the KV cache."""
        out: Dict[int, List[int]] = {}
        for slot, seq in enumerate(seqs):
            accepted: List[int] = []
            for t in toks[slot, :n]:
                accepted.append(int(t))
                if ((seq.eos_token_id is not None and int(t) == seq.eos_token_id)
                        or len(seq.generated) + len(accepted) >= seq.max_new_tokens):
                    seq.done = True
                    break
            seq.generated.extend(accepted)
            seq.seen_tokens += n
            self._register_full_blocks(seq)
            out[seq.uid] = accepted
        return out

    def _live_decoders(self, what: str):
        c = self.config
        seqs = [s for s in self.state_manager.all() if not s.done]
        if any(s.in_prefill or not s.generated for s in seqs):
            raise RuntimeError(f"{what} requires every active sequence "
                               "past prefill with a first sampled token")
        if len(seqs) > c.max_ragged_sequence_count:
            raise RuntimeError(f"{len(seqs)} active sequences > "
                               f"max_ragged_sequence_count {c.max_ragged_sequence_count}")
        return seqs

    def decode_batch(self, n_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Fused multi-token decode: ``n`` forward+sample iterations for every
        active sequence in one ``model.decode_loop`` call. Requires all
        active sequences to be past prefill. Returns {uid: accepted tokens}."""
        seqs = self._live_decoders("decode_batch")
        if not seqs:
            return {}
        n = min(n_steps or self.config.decode_chunk,
                min(s.max_new_tokens - len(s.generated) for s in seqs))
        if n < 1:
            return {}
        return self._accept(seqs, self._run_decode(seqs, n), n)

    def _ngram_propose(self, seq, k: int) -> List[int]:
        """Draft up to ``k`` tokens by n-gram lookup: the tokens that
        followed the most recent PRIOR occurrence of the sequence's last
        ``spec_ngram`` tokens in prompt + generated. Host work only."""
        n = self.config.spec_ngram
        ctx = (np.concatenate([seq.prompt_tokens,
                               np.asarray(seq.generated, np.int32)])
               if seq.generated else seq.prompt_tokens)
        L = len(ctx)
        if k < 1 or L <= n:
            return []
        key = ctx[L - n:]
        for start in range(L - n - 1, -1, -1):
            if np.array_equal(ctx[start:start + n], key):
                return [int(t) for t in ctx[start + n:start + n + k]]
        return []

    def spec_decode_batch(self, k: Optional[int] = None) -> Dict[int, List[int]]:
        """N-gram speculative decode: per live sequence, pack the chunk
        ``[last sampled] + drafts`` and verify every position in one packed
        dispatch (``model.verify_step``: the greedy argmax after each input
        token). The accepted drafts plus the model's own token at the first
        mismatch are committed; ``seen_tokens`` rewinds past the rejected
        suffix (those rows are masked by ``kv_len`` and rewritten when their
        positions are reached). Every committed token is an argmax the
        sequential path would produce, so the stream is ``decode_batch``'s.
        A sequence without a match rides along as a 1-token chunk. Same
        preconditions as ``decode_batch``; returns {uid: committed tokens}."""
        c = self.config
        if not c.greedy:
            raise RuntimeError("spec_decode_batch requires greedy=True (the "
                               "acceptance rule compares argmax streams)")
        k = c.spec_decode_k if k is None else int(k)
        seqs = self._live_decoders("spec_decode_batch")
        if not seqs:
            return {}
        bs = c.kv_block_size
        share = max(1, c.token_budget // len(seqs))
        scheduled: List[Tuple] = []
        drafted: List[List[int]] = []
        for seq in seqs:
            # 1 + k_i inputs must fit the chunk cap and the budget share,
            # k_i + 1 commits must not overrun max_new_tokens, and every
            # input's KV row must fit the block table
            cap = min(k, c.max_chunk_size - 1, share - 1,
                      seq.max_new_tokens - len(seq.generated) - 1,
                      c.max_blocks_per_seq * bs - seq.seen_tokens - 1)
            drafts = self._ngram_propose(seq, cap) if cap > 0 else []
            toks = np.asarray([seq.generated[-1]] + drafts, np.int32)
            self.kv.reserve(seq, len(toks))
            scheduled.append((seq, toks))
            drafted.append(drafts)
        batch = self.wrapper.pack(scheduled, bs)
        kv_k, kv_v = self.kv.pool_args()
        d = self._dev
        nexts, new_k, new_v = verify_step(
            self.params, self.cfg, kv_k, kv_v, d(batch.tokens), d(batch.positions),
            d(batch.gather_idx), d(batch.block_table), d(batch.kv_len),
            d(batch.start_pos), d(batch.chunk_len), attn_impl=self.attn_impl)
        self.kv.update(new_k, new_v)
        nexts = nexts.cpu().numpy()        # [T] int32 — the only D2H transfer
        out: Dict[int, List[int]] = {}
        cursor = 0
        for (seq, toks), drafts in zip(scheduled, drafted):
            preds = nexts[cursor:cursor + len(toks)]
            cursor += len(toks)
            j = 0
            while j < len(drafts) and int(preds[j]) == drafts[j]:
                j += 1
            self.reuse.spec_drafted += len(drafts)
            self.reuse.spec_accepted += j
            accepted: List[int] = []
            for t in drafts[:j] + [int(preds[j])]:
                accepted.append(int(t))
                if ((seq.eos_token_id is not None and int(t) == seq.eos_token_id)
                        or len(seq.generated) + len(accepted) >= seq.max_new_tokens):
                    seq.done = True
                    break
            seq.generated.extend(accepted)
            # the inputs [last] + drafts[:j] are committed content with
            # their KV written; the rejected suffix is rewound
            seq.seen_tokens += 1 + j
            self._register_full_blocks(seq)
            out[seq.uid] = accepted
        self.reuse.spec_steps += 1
        self.steps += 1
        return out

    def decode_stream(self, total_steps: int) -> Dict[int, List[int]]:
        """Fused decode of ``min(total_steps, min remaining)`` tokens, in
        windows of at most ``max_fused_window``. Each window's step count is
        rounded UP to a ``decode_chunk`` multiple when KV capacity allows;
        tokens past a sequence's EOS or ``max_new_tokens`` are discarded."""
        c = self.config
        if total_steps > c.max_fused_window:
            live = [s for s in self.state_manager.all() if not s.done]
            if not live:
                return {}
            total = min(total_steps,
                        min(s.max_new_tokens - len(s.generated) for s in live))
            out: Dict[int, List[int]] = {}
            produced = 0
            while produced < total:
                got = self.decode_stream(min(c.max_fused_window, total - produced))
                if not got:
                    break
                for uid, toks in got.items():
                    out.setdefault(uid, []).extend(toks)
                step_n = max(len(toks) for toks in got.values())
                if step_n == 0:
                    break
                produced += step_n
            return out
        seqs = self._live_decoders("decode_stream")
        if not seqs:
            return {}
        total = min(total_steps,
                    min(s.max_new_tokens - len(s.generated) for s in seqs))
        if total < 1:
            return {}
        bs = c.kv_block_size
        bucket = -(-total // c.decode_chunk) * c.decode_chunk
        cap = min(c.max_blocks_per_seq * bs - s.seen_tokens for s in seqs)
        n = min(bucket, cap)
        need = sum(s.blocks_needed(n, bs) for s in seqs)
        if need > self.kv.free_blocks:
            n = total
        return self._accept(seqs, self._run_decode(seqs, n), n)

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None) -> List[np.ndarray]:
        """Convenience batch API over the continuous engine: SplitFuse steps
        through prefill, then fused decode chunks."""
        uids = list(range(len(prompts)))
        self.put(uids, prompts, max_new_tokens=max_new_tokens,
                 eos_token_id=eos_token_id)
        while any(s.in_prefill for s in self.state_manager.all() if not s.done):
            self.step()
            if self.last_num_scheduled == 0:
                break
        while any(not self.query(u)[0] for u in uids):
            if eos_token_id is None:
                if not self.decode_stream(max_new_tokens):
                    break
            elif not self.decode_batch():
                break
        outs = [self.query(u)[1] for u in uids]
        for u in uids:
            self.flush(u)
        return outs


def _cast_tree(tree, dtype, device):
    """Float leaves to ``dtype`` on ``device`` (other leaves only moved)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype) if t.is_floating_point() \
        else t.to(device)
