// The paged-attention kernels on Hopper's tensor-core path (sm_90a): wgmma
// from shared memory that TMA fills page by page through the block table,
// with long contexts split across blocks. The CUDA-core tile of each
// (fp32, and pages or shapes the rule excludes) is in paged_attention.cu;
// ops/paged_attention.py::paged_route chooses.
//
// Replaces the two TPU kernels of deepspeed_tpu/ops/pallas/paged_attention.py:
//   _kernel        SplitFuse packed chunks over one layer's [N, Hk, bs, D] pool
//   _decode_kernel one query per sequence over the resident [L, N, Hk, bs, D]
//                  pool, bf16 here, its int8 mode (quantized=True) in
//                  paged_attention_sm90_int8.cu
// What they compute is stated at the top of paged_attention.cu: for query row
// (token i, head hq) of sequence s at position start[s] + i, attention over
// the slots j <= position, j < kv_len[s] of the sequence's pages; masked
// slots contribute an exact 0; a row with no live slot gives o = 0, m =
// -1e30, l = 0; logits are fp32 dots times sm_scale; P is rounded to bf16
// before the fp32-accumulated PV product. The softmax runs in base 2 (as the
// flash kernels'); the returned m is converted back to natural-log units.
//
// What bounds them on an H100: decode reads every live K/V page once for 4 D
// flops per (query row, slot): memory-bound, its bound the live-page bytes
// over 3.35 TB/s. A prompt chunk of the packed kernel does up to 128 flops
// per page byte, still below the card's ~295 flops per byte on the tensor
// cores, so the packed kernel is memory-bound too: reaching that needs the
// tensor cores for the arithmetic (the CUDA-core tile made prompt chunks
// operation-bound) and enough page bytes in flight on every SM.
//
// Design (paged_attention_sm90.cuh):
//   * A work item is (sequence, kv head, row tile of 64 query rows, KV
//     split). Rows are taken head-major as in the TPU kernel: row i G + g is
//     token i, query head h G + g, so one page read serves the group's G
//     heads of every token. A decode row (a sequence with chunk 1: the whole
//     decode kernel, and the chunk-1 sequences of a packed step) splits its
//     context into runs of split_tiles 64-slot tiles, one block each; every
//     other item is one block over all its tiles. The grid comes from host
//     shapes only (S, Q, G, the table's width B): S Hk (row tiles + splits -
//     1) blocks, and a block whose item has no live tile exits at once, so
//     the host never reads kv_len, chunk_len or start_pos.
//   * Block: one consumer warpgroup and one producer warp (160 threads), two
//     blocks per SM at D 80, 96 and 128, three at D 64 and one at D 256 (the
//     decode kernel at GQA groups of at most 8 heads: an instantiation
//     without the 64-row consumer, three, four and one, with fewer stages;
//     PCfg). The producer resolves each
//     page through the block-table row (32 entries per load, broadcast by
//     shuffle) and stages a 64-slot tile per ring stage: 64 / bs pages, each
//     a TMA box of bs rows x 64 d of the pool viewed as rows [L N Hk bs, D]
//     (the layer and page folded into the row coordinate; one tensor map per
//     pool, encoded once and kept by pointer), 128-byte swizzle, K and V.
//     Pages past the live ones repeat the last live page (masked), so every
//     stage is whole. The int8 mode copies each page's int8 K and V rows and
//     their bs fp32 scales with the bulk-copy engine.
//   * Head dims (paged_head_dims.cuh): 64, 80, 96, 128 and 256. A tile is
//     whole 64-wide boxes along D: D 80 and 96 take two, the second padded
//     (TMA zero-fills it past D; the map's extent is D), and the products
//     over D stop at D's last 16-wide slice, P V runs m64n80 / m64n96, the
//     decode items' O^T a second 64-row block of D whose rows past D are
//     dropped: the flash kernels' answer (flash_attention_sm90.cu). D 256
//     takes four boxes; its stage of K and V is 64 KB and the 64-row
//     consumer's O 128 registers a thread, so one block runs per SM and
//     that consumer reads Q from a shared tile (S = Q K^T with both
//     operands in shared memory), as the flash forward does at D 256.
//   * The consumer holds its 64 rows of Q as bf16 A fragments in registers
//     (D 256: in shared memory; rows without a valid query are zero) and
//     per tile runs S = Q K^T on
//     wgmma (K read K-major), the mask (slot <= position, slot < kv_len; only
//     on tiles that reach a row's limit), the base-2 online softmax in
//     registers, and O += P V with P re-packed as bf16 A fragments and V read
//     MN-major. The int8 mode dequantizes each int8 tile into one bf16 K or
//     V tile in the same swizzled layout (bf16(float(v8) * scale), the
//     dequant_rows_tile arithmetic): V of tile i while S of tile i runs, K
//     of tile i + 1 while P V of tile i runs, a named barrier after each
//     product.
//   * An item with at most 8 valid rows (a decode item: the G heads of one
//     token) turns the products around, so that the tile's 64 slots, not
//     the rows, fill wgmma's 64 lanes: S^T = K Q^T and O^T += V^T P^T on
//     m64n8k16, K read K-major, V MN-major, Q and P staged as small
//     swizzled [8, D] and [8, 64] tiles. Each thread holds two slots of two
//     rows of S^T and the same two rows of O^T: its softmax needs the other
//     warps' row maxima only (one named barrier), its rescale no shuffle.
//     The 64-row products would be 7/8 or more padding, and their softmax
//     ran over 64 rows for one. Dots on the CUDA cores from the staged tile
//     (int8 dequantized in registers) measured slower than these products.
//   * The host sizes the splits from shapes alone (split_tiles_for): for a
//     launch of one query per sequence as many as give the (sequence, kv
//     head) pairs one wave of blocks, none when the pairs fill it, as at the
//     serving shape; none for a launch that may hold prompt chunks, whose
//     items set its time. A split writes its rows' unnormalised acc, m (base 2)
//     and l to a workspace the wrapper allocates; paged_combine, launched
//     right after by the same entry, merges each row's splits in split
//     order. No float atomics, so two launches are bitwise equal. With one
//     split the items write o, m and l directly.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t. Each entry returns 0, a cudaError_t from the launch,
// or 10000 + the CUresult of a tensor map that could not be encoded.

#include "paged_attention_sm90.cuh"

// Both kernels over bf16 pools: q [S, Q, Hq, D] (decode: Q 1), the pools as
// `rows` rows of D from k_pool / v_pool, the layer's first row row0; chunk
// null for decode (every query valid); ws: the split workspace when
// n_splits > 1, n_splits S Hk G (D + 2) floats; item_rows, tile_slots and
// blocks: the host's copy of the work items (paged_shape_ok).
extern "C" int paged_attention_sm90_fwd(const void* q, const void* k_pool, const void* v_pool,
                                        void* o, float* m, float* l, const int* block_table,
                                        const int* start, const int* chunk, const int* kv_len,
                                        float* ws, int S, int Q, int Hq, int Hk, int D, int bs,
                                        int B, long long rows, long long row0, int split_tiles,
                                        int n_splits, int item_rows, int tile_slots, int blocks,
                                        float sm_scale, void* stream) {
  if (!paged_shape_ok(S, Q, Hq, Hk, D, bs, B, rows, split_tiles, n_splits, item_rows,
                      tile_slots, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedParams p = paged_params(q, o, m, l, block_table, start, chunk, kv_len, ws, S, Q,
                                     Hq, Hk, bs, B, row0, split_tiles, n_splits, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_paged_head_dim(D, [&](auto dim) {
    return launch_paged<decltype(dim)::value, false>(p, k_pool, v_pool, rows, st);
  });
}

// blocks per SM of the instantiation a launch takes (blocks_per_sm)
extern "C" int paged_sm90_blocks_per_sm(int D, int G, int decode) {
  return blocks_per_sm<false>(D, G, decode != 0);
}
