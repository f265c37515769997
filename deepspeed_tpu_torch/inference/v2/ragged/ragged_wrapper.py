"""Ragged batch packing into fixed-shape device metadata.

Reference ``RaggedBatchWrapper`` (``inference/v2/ragged/ragged_wrapper.py:31``)
packs prompt chunks + decode tokens into host buffers for the ragged
kernels. Every buffer is a *static-shape* numpy array (token budget ``T``,
sequence slots ``S``, chunk cap ``Q``, blocks-per-seq ``B``), the same arrays
the JAX package packs, so both packages see identical batch metadata;
padding is masked with the trash-block convention (see
``blocked_allocator``)."""

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class RaggedBatch:
    """Static-shape packed batch. ``gather_idx[s, q] == T`` marks padding
    (row T of the token buffer is a zero pad row)."""
    tokens: np.ndarray        # [T] int32
    positions: np.ndarray     # [T] int32, absolute position in its sequence
    gather_idx: np.ndarray    # [S, Q] int32 into [0, T]; T = pad
    block_table: np.ndarray   # [S, B] int32; 0 (trash) when unused
    kv_len: np.ndarray        # [S] int32: cached+new tokens after this step
    logits_idx: np.ndarray    # [S] int32 into [0, T]: token to sample from (T = none)
    start_pos: np.ndarray     # [S] int32: absolute position of chunk token 0
    chunk_len: np.ndarray     # [S] int32: scheduled tokens this step (0 = pad slot)
    uids: List[int]           # seq slot -> uid (len <= S)
    num_tokens: int
    sample_slots: List[int]   # seq slots that produce a next token this step


class RaggedBatchWrapper:
    def __init__(self, token_budget: int = 256, max_seqs: int = 16,
                 max_chunk: int = 128, max_blocks_per_seq: int = 32):
        self.T = token_budget
        self.S = max_seqs
        self.Q = min(max_chunk, token_budget)
        self.B = max_blocks_per_seq

    def pack(self, scheduled, block_size: int) -> RaggedBatch:
        """``scheduled``: list of (seq_descriptor, np.ndarray new_tokens)."""
        T, S, Q, B = self.T, self.S, self.Q, self.B
        if len(scheduled) > S:
            raise ValueError(f"{len(scheduled)} sequences > max_seqs {S}")
        tokens = np.zeros((T,), np.int32)
        positions = np.zeros((T,), np.int32)
        gather_idx = np.full((S, Q), T, np.int32)
        block_table = np.zeros((S, B), np.int32)
        kv_len = np.zeros((S,), np.int32)
        logits_idx = np.full((S,), T, np.int32)
        start_pos = np.zeros((S,), np.int32)
        chunk_len = np.zeros((S,), np.int32)
        uids, sample_slots = [], []
        cursor = 0
        for s, (seq, new_toks) in enumerate(scheduled):
            n = len(new_toks)
            if n > Q:
                raise ValueError(f"chunk {n} > max_chunk {Q}")
            if cursor + n > T:
                raise ValueError("token budget overflow")
            if len(seq.blocks) > B:
                raise ValueError(f"sequence needs {len(seq.blocks)} blocks > "
                                 f"max_blocks_per_seq {B} (raise it or max_seq_len)")
            tokens[cursor:cursor + n] = new_toks
            positions[cursor:cursor + n] = np.arange(seq.seen_tokens,
                                                     seq.seen_tokens + n)
            gather_idx[s, :n] = np.arange(cursor, cursor + n)
            block_table[s, :len(seq.blocks)] = seq.blocks
            kv_len[s] = seq.seen_tokens + n
            start_pos[s] = seq.seen_tokens
            chunk_len[s] = n
            uids.append(seq.uid)
            # sample only when this chunk finishes the prompt (or is decode)
            if seq.seen_tokens + n >= len(seq.prompt_tokens):
                logits_idx[s] = cursor + n - 1
                sample_slots.append(s)
            cursor += n
        return RaggedBatch(tokens=tokens, positions=positions,
                           gather_idx=gather_idx, block_table=block_table,
                           kv_len=kv_len, logits_idx=logits_idx,
                           start_pos=start_pos, chunk_len=chunk_len, uids=uids,
                           num_tokens=cursor, sample_slots=sample_slots)
