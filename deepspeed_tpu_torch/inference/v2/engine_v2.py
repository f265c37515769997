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

Left out of this slice (ROADMAP.md): speculative decoding
(``spec_decode_batch``), quantized or storage-cast KV pools, the collective
planner's decode-attention hook.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.transformer import TransformerConfig
from .model import check_supported, decode_loop, ragged_step
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
    # KV pool storage dtype; only None (= the compute dtype) in this slice
    kv_cache_dtype: Optional[str] = None
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # "auto" and "pallas" (the name of the kernel path, kept from the JAX
    # package): the paged kernels — hand-written Hopper kernels on a CUDA
    # device, their plain versions on the CPU. "einsum": the gathered-page
    # reference path, only when asked for.
    attn_backend: str = "auto"    # auto | pallas | einsum
    # fused-decode attention path (model.decode_loop) specifically:
    # model field > this knob > attn_backend > the kernel path
    decode_attn_backend: str = "auto"   # auto | pallas | einsum
    # decode iterations fused into one decode_batch() call
    decode_chunk: int = 16
    # cap on the per-dispatch fused window (the window buffer is
    # [L, n, S, Hk, D] and its dense attention O(n^2))
    max_fused_window: int = 512
    # content-addressed prefix KV reuse (ragged/prefix_index.py)
    enable_prefix_cache: bool = False


@dataclass
class ReuseStats:
    """Cumulative prefix-cache counters (the serving tier samples these into
    ServingMetrics gauges)."""
    prefix_lookups: int = 0          # put() admissions that consulted the index
    prefix_hits: int = 0             # admissions that mapped >= 1 cached block
    prefix_tokens_reused: int = 0    # prompt tokens never re-prefilled
    prefix_blocks_shared: int = 0    # pages mapped shared (blocks saved)
    cow_forks: int = 0               # shared blocks copy-on-write-forked


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
        if c.kv_cache_dtype is not None:
            raise NotImplementedError(
                f"kv_cache_dtype={c.kv_cache_dtype!r}: quantized and "
                "storage-cast KV pools are not in this slice (ROADMAP.md, "
                "int8/fp8 KV)")
        for knob in (c.attn_backend, c.decode_attn_backend, cfg.decode_attn_impl):
            if knob not in _BACKENDS:
                raise ValueError(f"attn backend must be auto|pallas|einsum, "
                                 f"got {knob!r}")
        dtype = getattr(torch, c.dtype)
        self.params = _cast_tree(params, dtype, self.device)
        self.kv = BlockedKVCache(cfg.num_layers, c.num_kv_blocks,
                                 c.kv_block_size, cfg.kv_heads, cfg.head_dim,
                                 dtype=dtype, device=self.device,
                                 enable_prefix_index=c.enable_prefix_cache)
        self.state_manager = DSStateManager(self.kv)
        self.reuse = ReuseStats()
        self.wrapper = RaggedBatchWrapper(token_budget=c.token_budget,
                                          max_seqs=c.max_ragged_sequence_count,
                                          max_chunk=c.max_chunk_size,
                                          max_blocks_per_seq=c.max_blocks_per_seq)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(c.seed))
        self.attn_impl = "einsum" if c.attn_backend == "einsum" else "pallas"
        self.decode_attn_impl = self._resolve_decode_attn()
        self.steps = 0
        self.last_num_scheduled = 0

    def _resolve_decode_attn(self) -> str:
        """Fused-decode attention path: model field > decode_attn_backend >
        attn_backend > the kernel path."""
        c = self.config
        for knob in (self.cfg.decode_attn_impl, c.decode_attn_backend,
                     c.attn_backend):
            if knob != "auto":
                return knob
        return "pallas"

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
