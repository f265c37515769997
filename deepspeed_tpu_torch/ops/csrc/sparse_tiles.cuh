// What both block-sparse forward sources build and how they cut a key tile:
// sparse_attention.cu (mma.sync in bf16, the CUDA cores in fp32) and
// sparse_attention_sm90.cu (wgmma + TMA). Each entry instantiates exactly
// the head dims of SPARSE_HEAD_DIMS, through with_sparse_head_dim, and takes
// exactly the layout blocks of SPARSE_BLOCKS; it refuses any other with
// cudaErrorInvalidValue. ops/sparse_attention.py's _HEAD_DIMS and _BLOCKS
// list the same ones: head dims 64 (TinyLlama), 80 (Pythia-2.8B), 96
// (phi-3-mini), 128 (Llama-2) and 256 (Pythia-1B); blocks 16 (DeepSpeed's
// SparsityConfig default), 32, 64, 128 and 256.
//
// A work item is a tile of query rows (64, or 32 on the fp32 tile), and it
// walks key tiles of as many keys. At a block no smaller than the tile, the
// item lies in one q-block and walks that q-block's column list, each
// column block / keys tiles of consecutive keys. At a smaller block the
// item spans R = rows / block q-blocks: it walks the ascending union of
// their column lists (made on the host, ops/sparse_attention.py,
// union_columns), G = keys / block union columns per tile, each column an
// entry of `block` keys, and beside each column an R-bit mask whose bit r
// says that q-block r lists it. A tile's mask word holds entry g's bits at
// 4 g .. 4 g + R - 1 (G, R <= 4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SPARSE_HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(256)
#define SPARSE_BLOCKS(X) X(16) X(32) X(64) X(128) X(256)

namespace {

// f(std::integral_constant<int, D>{}) for a D of SPARSE_HEAD_DIMS; any other
// D is refused with cudaErrorInvalidValue, never served by another D's kernel
template <class F>
int with_sparse_head_dim(int D, F&& f) {
#define SPARSE_CASE(DIM) \
  case DIM:              \
    return f(std::integral_constant<int, DIM>{});
  switch (D) {
    SPARSE_HEAD_DIMS(SPARSE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPARSE_CASE
}

// whether the kernels take layout block `block`
inline bool sparse_block_built(int block) {
#define SPARSE_BLOCK_IS(B) || block == B
  return false SPARSE_BLOCKS(SPARSE_BLOCK_IS);
#undef SPARSE_BLOCK_IS
}

// log2 of the keys of one entry of a tile of `keys` keys: min(block, keys)
__host__ __device__ __forceinline__ int sparse_entry_shift(int block, int keys) {
  int shift = 0;
  while ((2 << shift) <= (block < keys ? block : keys)) ++shift;
  return shift;
}

// whether some q-block of the item does not list some entry of a tile: its
// R x G bits are not all set (a padding entry has none)
__device__ __forceinline__ bool sparse_bits_partial(int bits, int G, int R) {
  int full = 0;
  for (int g = 0; g < G; ++g) full |= ((1 << R) - 1) << (4 * g);
  return bits != full;
}

// The live words of the thread at lane `lane` of warp w (rows q0 + 16 w +
// lane / 4 and + 8) in a 64-key tile, in the accumulator layout that the
// mma.sync m16n8 tiles and the wgmma m64nN tiles share: bit 4 j + e for its
// logit 4 j + e (row + 8 (e >> 1), tile column 8 j + 2 (lane % 4) + (e & 1),
// so entry (8 j) >> shift, of 1 << shift keys). One word, so that the
// registers holding O, S and P take no more than it.
//
// Under causal, over a causal-intersected layout, a key lies past its row
// only in the entry that starts where the row's aligned block of 1 << shift
// rows starts (its diagonal): there the key's offset in the entry must not
// pass the row's offset in the block. Entries before it lie wholly at or
// before the row; entries after it lie past it (below block 64 no q-block
// of the row lists them). sparse_triangle is the diagonal entry's pattern
// in the thread's bits, the same for every tile: made once per kernel.
__device__ __forceinline__ uint32_t sparse_triangle(int w, int lane, int shift) {
  const int seg = 1 << shift;
  const int row = ((16 * w) & (seg - 1)) + (lane >> 2), t = lane & 3;
  uint32_t tri = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j < seg && 8 * j + 2 * t + (e & 1) <= row + 8 * (e >> 1)) tri |= 1u << (4 * j + e);
    }
  }
  return tri;
}

// the live word of a tile that masks some key: a key is live when the rows'
// q-block ((16 w) >> shift) lists its entry (bits: 4 g + r) and, where the
// tile crosses the item's first row q0 under causal, it lies at or before
// the row (the entries' first keys k0 against the rows' block start)
__device__ __forceinline__ uint32_t sparse_live_word(int w, int q0, const int (&k0)[4], int bits,
                                                     int G, bool crossing, int shift,
                                                     uint32_t tri) {
  const int per_entry = 1 << (shift - 1);  // word bits per entry: 4 per 8 keys
  const uint32_t full = per_entry == 32 ? ~0u : (1u << per_entry) - 1u;
  const int r = (16 * w) >> shift;
  const int start = q0 + (r << shift);     // the rows' block start
  uint32_t word = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g < G && ((bits >> (4 * g + r)) & 1)) {
      const uint32_t part = !crossing || k0[g] < start ? full : k0[g] == start ? tri : 0u;
      word |= part << (g * per_entry);
    }
  }
  return word;
}

}  // namespace
