// The paged-attention kernels on Hopper's tensor-core path (sm_90a): the
// packed SplitFuse kernel and the decode kernel over bf16 pools
// (paged_attention_sm90.cu), and the decode kernel's int8 mode
// (paged_attention_sm90_int8.cu), as one design. Its notes are at the top of
// paged_attention_sm90.cu; the wgmma, TMA and softmax helpers are shared with
// the flash kernels (sm90_tiles.cuh).

#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "int8_rows.cuh"
#include "paged_head_dims.cuh"
#include "sm90_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;       // slots per tile (one ring stage): 64 / bs pages
constexpr int kRows = 64;       // query rows per work item: one warpgroup's wgmma rows
constexpr int kThreads = 160;   // one consumer warpgroup, one producer warp
constexpr int kConsumers = 128;

// the tiles' width along D: whole 64-wide boxes. D 80 and 96 pad their last
// box, which TMA fills with zeros past D (the pool map's extent is D) and
// which dequant_tile leaves unwritten past D; the products over D stop at
// D's last 16-wide slice, P V runs m64n80 / m64n96 and reads the last box
// in part, and the decode items' O^T products run a second, partly padded
// 64-row block of D whose rows past D are never stored
__host__ __device__ constexpr int pad64(int D) { return (D + 63) / 64 * 64; }

// DECODE: the decode kernel's instantiation for GQA groups of at most 8
// heads, whose items all take decode_rows; without the 64-row consumer's
// registers it fits more blocks on an SM, each with fewer stages. At D 256
// a stage of bf16 K and V is 64 KB and the 64-row consumer's O alone 128
// registers a thread: one block per SM, and that consumer keeps its Q in a
// shared tile (kQSmem) read by wgmma, not as A fragments in registers.
template <int D, bool INT8, bool DECODE = false> struct PCfg {
  static constexpr int kBoxes = pad64(D) / 64;         // 64-wide boxes along D
  static constexpr int kBox = kKeys * kRowBytes;       // 8 KB: 64 slots x 128 bytes
  static constexpr int kTile = kBoxes * kBox;          // one bf16 K or V tile
  static constexpr int kInt8Tile = kKeys * D;          // one int8 K or V tile
  // bf16: the K tile, then the V tile; int8: K, V, then 64 K and 64 V scales
  static constexpr int kStageBytes = INT8 ? 2 * kInt8Tile + 2 * kKeys * 4 : 2 * kTile;
  static constexpr bool kWide = D > 128;
  static constexpr int kStages =
      DECODE ? (D == 64 ? 3 : (kWide && INT8 ? 4 : 2))
             : (kWide ? (INT8 ? 3 : 2) : (INT8 || D == 64 ? 4 : 3));
  static constexpr int kConvBytes = INT8 ? 2 * kTile : 0;  // the dequantized K and V tiles
  // the 64-row consumer's Q as a K-major [64, D] tile (D 256 only)
  static constexpr bool kQSmem = !DECODE && kWide;
  static constexpr int kQBytes = kQSmem ? kBoxes * kRows * kRowBytes : 0;
  // decode items: Q [8, D] (1 KB per box, at least 2 KB), then P [8, 64]
  // bf16 (1 KB; both swizzled), then the warps' row maxima
  static constexpr int kQ8Bytes = 1024 * (kBoxes > 2 ? kBoxes : 2);
  static constexpr int kSmallBytes = kQ8Bytes + 2048;
  static constexpr int kSmemBytes =
      1024 + kConvBytes + kQBytes + kSmallBytes + kStages * kStageBytes + 16 * kStages;
  static constexpr int kBlocksPerSM =
      kWide ? 1 : DECODE ? (D == 64 ? 4 : 3) : (D == 64 ? 3 : 2);
  static_assert(kBlocksPerSM * (kSmemBytes + 1024) <= 233472, "shared memory per SM");
};

struct PagedParams {
  const bf16* q;            // [S, Q, Hq, D]
  bf16* o;                  // [S, Q, Hq, D]
  float* m_out;             // [S, Q, Hq] or null
  float* l_out;
  const int8_t* k8;         // int8 mode: pool rows [rows, D]
  const int8_t* v8;
  const float* ks;          // int8 mode: their scales [rows]
  const float* vs;
  const int* block_table;   // [S, B]
  const int* start;         // [S] position of query token 0
  const int* chunk;         // [S] valid query tokens, or null: all Q valid
  const int* kv_len;        // [S]
  float* ws;                // split partials: acc [n_splits, S, Hk, G, D], then (m, l)
  long long row0;           // pool row of (layer, page 0, head 0, slot 0)
  int S, Q, Hq, Hk, G, bs, B;
  int row_tiles;            // ceil(Q G / 64)
  int split_tiles;          // tiles per split of a decode row's context
  int n_splits;             // 1: no split
  float c;                  // sm_scale * log2(e)
};

// A work item: (sequence s, kv head h, row tile t, split k). Row r of tile t
// is query row r0 + r = i G + g of the (sequence, kv head): token i, query
// head h G + g. A sequence with chunk 1 (a decode row) splits its context's
// tiles into runs of split_tiles when n_splits > 1; every other item is one
// block over all its tiles (k 0).
struct Item {
  int s, h, k, r0;
  int nrows;       // rows with a valid query (the first ones of the tile)
  int rows_here;   // rows of the tile inside Q G
  int start, kv_len;
  int t_begin, t_end;
  bool partial;    // writes split partials for paged_combine
  bool skip;       // nothing to do
};

// the live tiles of (sequence s, rows r0 .. r0 + nrows - 1): slots up to the
// last valid row's position, below kv_len and the table's width
__device__ __forceinline__ int live_end(const PagedParams& p, int start, int kv_len, int r0,
                                        int nrows) {
  if (nrows <= 0) return 0;
  return max(0, min(min(kv_len, start + (r0 + nrows - 1) / p.G + 1), p.B * p.bs));
}

__device__ __forceinline__ Item item_of(const PagedParams& p, int id) {
  Item w;
  const int heads = p.S * p.Hk, first = heads * p.row_tiles;
  int t, sh;
  if (id < first) {
    w.k = 0;
    t = id / heads;
    sh = id % heads;
  } else {
    w.k = 1 + (id - first) / heads;
    t = 0;
    sh = (id - first) % heads;
  }
  w.s = sh / p.Hk;
  w.h = sh % p.Hk;
  w.r0 = t * kRows;
  const int chunk = p.chunk != nullptr ? p.chunk[w.s] : p.Q;
  w.start = p.start[w.s];
  w.kv_len = p.kv_len[w.s];
  w.nrows = max(0, min(kRows, chunk * p.G - w.r0));
  w.rows_here = min(kRows, p.Q * p.G - w.r0);
  const int n_tiles = (live_end(p, w.start, w.kv_len, w.r0, w.nrows) + kKeys - 1) / kKeys;
  w.partial = p.n_splits > 1 && chunk == 1;
  if (w.partial) {
    w.t_begin = min(n_tiles, w.k * p.split_tiles);
    w.t_end = min(n_tiles, w.t_begin + p.split_tiles);
  } else {
    w.t_begin = 0;
    w.t_end = n_tiles;
  }
  // block 0 of an item always runs: it writes the item's empty rows
  w.skip = w.k > 0 && (!w.partial || w.t_begin >= w.t_end);
  return w;
}

// row r of item w in the [S, Q, Hq] row space of q, o, m and l
__device__ __forceinline__ long long out_row(const PagedParams& p, int s, int h, int row) {
  return (static_cast<long long>(s) * p.Q + row / p.G) * p.Hq + h * p.G + row % p.G;
}

// slots at or past lim[row] to -inf: a tile whose keys are all masked for a
// row leaves its max and sums unchanged in online_softmax (p = 0)
__device__ __forceinline__ void mask_tile(float (&st)[32], const int (&lim)[2], int k0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + 8 * j + 2 * t + (e & 1) >= lim[e >> 1]) st[4 * j + e] = __int_as_float(0xff800000);
    }
  }
}

// int8 mode: the int8 K (half 0) or V (half 1) tile of a stage dequantized
// into the bf16 tile at dst in wgmma's 128-byte-swizzled layout (16-byte
// chunk x of row r at chunk x ^ (r % 8)), the box layout of the bf16 tiles
// (columns past D of a padded box left unwritten: no product reads them
// into a stored value), each value the dequant_rows_tile arithmetic:
// bf16(float(v8) * scale[row]), one fp32 product rounded once
template <int D>
__device__ __forceinline__ void dequant_tile(const unsigned char* stage, int half,
                                            unsigned char* dst) {
  using C = PCfg<D, true>;
  constexpr int kPerRow = D / 16;            // 16-value chunks of an int8 row
  const unsigned char* const src = stage + half * C::kInt8Tile;
  const float* const scales =
      reinterpret_cast<const float*>(stage + 2 * C::kInt8Tile) + half * kKeys;
  constexpr int kChunks = kKeys * kPerRow;
#pragma unroll
  for (int it = 0; it < (kChunks + kConsumers - 1) / kConsumers; ++it) {
    const int c = it * kConsumers + threadIdx.x;
    if (kChunks % kConsumers != 0 && c >= kChunks) break;
    const int r = c / kPerRow, d0 = (c % kPerRow) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c * 16);
    const float sc = scales[r];
    float f[16];
    s8x4_to_floats(raw.x, f);
    s8x4_to_floats(raw.y, f + 4);
    s8x4_to_floats(raw.z, f + 8);
    s8x4_to_floats(raw.w, f + 12);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = pack_bf16(f[2 * e] * sc, f[2 * e + 1] * sc);
    unsigned char* row = dst + (d0 / 64) * C::kBox + r * kRowBytes;
    const int x = (d0 % 64) / 8;
    *reinterpret_cast<uint4*>(row + ((x ^ (r & 7)) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(row + (((x + 1) ^ (r & 7)) << 4)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// S = Q K^T over D for the item's 64 rows and the 64 slots of the bf16 K
// tile at kt (read K-major), issued and committed: Q as the A fragments
// qa, or (kQSmem: D 256, whose O leaves no registers for them) as the
// K-major [64, D] tile at qs
template <int D, bool kQSmem, int NQ>
__device__ __forceinline__ void issue_qk(float (&st)[32], const uint32_t (&qa)[NQ][4],
                                         uint32_t qs, uint32_t kt) {
  if constexpr (!kQSmem) zero(st);
  wgmma_fence();
  fence_regs(st);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t kd = desc(kt + (kk / 4) * kKeys * kRowBytes + (kk % 4) * 32, 16);
    if constexpr (kQSmem)
      wgmma_ss(st, desc(qs + (kk / 4) * kRows * kRowBytes + (kk % 4) * 32, 16), kd, kk > 0);
    else
      wgmma_rs<0>(st, qa[kk], kd);
  }
  wgmma_commit();
}

// O += P V for the bf16 V tile at vt (read MN-major), P the bf16 A
// fragments, issued and committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kKeys / 16][4],
                                         uint32_t vt) {
  wgmma_fence();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs(o, pa[kk], desc(vt + kk * 16 * kRowBytes, kKeys * kRowBytes));
  wgmma_commit();
}

// one tile's softmax: the mask where the tile (slots k0 ..) reaches a row's
// limit, the base-2 online softmax, O rescaled, P re-packed as bf16 A
// fragments
template <int N>
__device__ __forceinline__ void tile_softmax(float (&st)[32], uint32_t (&pa)[kKeys / 16][4],
                                             float (&o)[N], float (&m)[2], float (&l)[2],
                                             const int (&lim)[2], int k0, int mask_from,
                                             float c) {
  float alpha[2];
  if (k0 + kKeys > mask_from) mask_tile(st, lim, k0);
  online_softmax(st, m, l, alpha, c);
  rescale(o, alpha);
  to_a(pa, st);
}

// d (+)= A (64 x 16) B (16 x 8), both from shared memory, B K-major; A
// K-major (kTransA 0) or MN-major (kTransA 1)
template <int kTransA>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "%7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA));
}

// The consumer of an item with at most 8 valid rows (a decode item: G rows
// of one token). The products are turned around so that the 64 slots of a
// tile, not the rows, fill wgmma's 64 lanes: S^T = K Q^T (m64n8, K read
// K-major, Q staged as an [8, D] tile) and O^T += V^T P^T (m64n8 per 64
// columns of D, V read MN-major, P staged as an [8, 64] bf16 tile). Each
// thread holds two slots of two rows of S^T and the same two rows of O^T,
// so its softmax needs the row maxima of the other warps only (one named
// barrier) and no shuffle for the rescale.
template <int D, bool INT8, bool DECODE>
__device__ __forceinline__ void decode_rows(const Item& w, const PagedParams& p,
                                            unsigned char* base_ptr, uint32_t base,
                                            uint32_t small, uint32_t stages, uint32_t bars) {
  using C = PCfg<D, INT8, DECODE>;
  constexpr int kBoxes = C::kBoxes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t qs = small, ps = small + C::kQ8Bytes;
  float* const red =
      reinterpret_cast<float*>(base_ptr + (ps - base) + 1024);  // [4][8]
  auto stage = [&](int s) { return stages + static_cast<uint32_t>(s) * C::kStageBytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  // Q rows 0..7 (zero past nrows) into the swizzled [8, D] tile: 16-byte
  // chunk x of row r of box b at qs + 1024 b + 128 r + 16 (x ^ r); a padded
  // box's chunks past D are not written (the products stop at D)
  for (int c = threadIdx.x; c < 8 * D / 8; c += kConsumers) {
    const int r = c / (D / 8), x = c % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < w.nrows)
      v = __ldg(reinterpret_cast<const uint4*>(p.q + out_row(p, w.s, w.h, w.r0 + r) * D) + x);
    *reinterpret_cast<uint4*>(base_ptr + (qs - base) + (x / 8) * 1024 + r * 128 +
                              (((x % 8) ^ r) << 4)) = v;
  }
  fence_proxy_async();
  named_sync(1, kConsumers);
  // this thread's rows 2t, 2t + 1 and their limits; its slots 16 warp + g
  // and + 8 of each tile
  int lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * t + e;
    lim[e] = r < w.nrows ? min(w.kv_len, w.start + (w.r0 + r) / p.G + 1) : 0;
  }
  const int key0 = 16 * warp + g;
  float o[kBoxes][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int b = 0; b < kBoxes; ++b) zero(o[b]);
  int s = 0;
  uint32_t phase = 0;
  unsigned char* const stage_ptr = base_ptr + (stages - base);
  if (INT8 && w.t_begin < w.t_end) {
    mbar_wait(full(s), phase);
    dequant_tile<D>(stage_ptr + s * C::kStageBytes, 0, base_ptr);
    fence_proxy_async();
    named_sync(1, kConsumers);
  }
  for (int tile = w.t_begin; tile < w.t_end; ++tile) {
    uint32_t kt = base, vt = base + C::kTile;
    if constexpr (!INT8) {
      mbar_wait(full(s), phase);
      kt = stage(s);
      vt = stage(s) + C::kTile;
    }
    // S^T = K Q^T over D
    float st[4] = {0.f, 0.f, 0.f, 0.f};
    wgmma_fence();
    fence_regs(st);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n8<0>(st, desc(kt + (kk / 4) * C::kBox + (kk % 4) * 32, 16),
                  desc(qs + (kk / 4) * 1024 + (kk % 4) * 32, 16));
    wgmma_commit();
    if constexpr (INT8) {
      // V of this tile under S; the stage's int8 tiles are then read
      dequant_tile<D>(stage_ptr + s * C::kStageBytes, 1, base_ptr + C::kTile);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    wgmma_wait<0>();
    fence_regs(st);
    // mask, then each row's maximum over the warp's 16 slots and the 4 warps
    const int k0 = tile * kKeys + key0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * (e >> 1) >= lim[e & 1]) st[e] = __int_as_float(0xff800000);
    float mx[2] = {fmaxf(st[0], st[2]), fmaxf(st[1], st[3])};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o2));
    }
    if (g == 0) {
      red[warp * 8 + 2 * t] = mx[0];
      red[warp * 8 + 2 * t + 1] = mx[1];
    }
    named_sync(1, kConsumers);
    float alpha[2], pv[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float tm = red[2 * t + e];
#pragma unroll
      for (int v = 1; v < 4; ++v) tm = fmaxf(tm, red[v * 8 + 2 * t + e]);
      const float m_new = fmaxf(m[e], tm * p.c);
      alpha[e] = ex2(m[e] - m_new);
      m[e] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[e] = ex2(fmaf(st[e], p.c, -m[e & 1]));
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = fmaf(l[e], alpha[e], pv[e] + pv[e + 2]);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[b][e] *= alpha[e & 1];
    }
    // P in bf16 into the swizzled [8, 64] tile: row r, slot j at
    // ps + 128 r + 16 ((j / 8) ^ r) + 2 (j % 8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1), j = key0 + 8 * (e >> 1);
      *reinterpret_cast<bf16*>(base_ptr + (ps - base) + r * 128 + (((j / 8) ^ r) << 4) +
                               (j % 8) * 2) = __float2bfloat16(pv[e]);
    }
    fence_proxy_async();
    named_sync(1, kConsumers);
    // O^T += V^T P^T over the tile's 64 slots
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) fence_regs(o[b]);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int b = 0; b < kBoxes; ++b)
        wgmma_n8<1>(o[b], desc(vt + b * C::kBox + kk * 16 * kRowBytes, C::kBox),
                    desc(ps + kk * 32, 16));
    }
    wgmma_commit();
    if (++s == C::kStages) {
      s = 0;
      phase ^= 1u;
    }
    if constexpr (INT8) {
      // K of the next tile under P V
      if (tile + 1 < w.t_end) {
        mbar_wait(full(s), phase);
        dequant_tile<D>(stage_ptr + s * C::kStageBytes, 0, base_ptr);
        fence_proxy_async();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) fence_regs(o[b]);
    if constexpr (!INT8) {
      if (lane == 0) mbar_arrive(empty(s == 0 ? C::kStages - 1 : s - 1));
    } else {
      named_sync(1, kConsumers);
    }
  }
  // each row's sum over the 64 slot lanes (8 lanes of a warp, then 4 warps)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int o2 = 4; o2 < 32; o2 <<= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], o2);
  }
  named_sync(1, kConsumers);   // the last tile's maxima are read
  if (g == 0) {
    red[warp * 8 + 2 * t] = l[0];
    red[warp * 8 + 2 * t + 1] = l[1];
  }
  named_sync(1, kConsumers);
  // O^T: this thread's columns 64 b + 16 warp + g and + 8 of rows 2t, 2t + 1
  // (those past D, in a padded box's block, are not stored)
  const int col = 16 * warp + g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * t + e;
    const float lsum = red[r] + red[8 + r] + red[16 + r] + red[24 + r];
    if (r >= w.nrows) continue;
    const long long orow = out_row(p, w.s, w.h, w.r0 + r);
    if (w.partial) {
      const long long at =
          ((static_cast<long long>(w.k) * p.S + w.s) * p.Hk + w.h) * p.G + r;
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
        if (64 * b + col < D) p.ws[at * D + 64 * b + col] = o[b][e];
        if (64 * b + col + 8 < D) p.ws[at * D + 64 * b + col + 8] = o[b][e + 2];
      }
      if (warp == 0 && g == 0) {
        float* ml = p.ws + static_cast<long long>(p.n_splits) * p.S * p.Hk * p.G * D;
        *reinterpret_cast<float2*>(ml + 2 * at) = make_float2(m[e], lsum);
      }
      continue;
    }
    const float f = 1.f / (lsum == 0.f ? 1.f : lsum);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
      if (64 * b + col < D) p.o[orow * D + 64 * b + col] = __float2bfloat16(o[b][e] * f);
      if (64 * b + col + 8 < D)
        p.o[orow * D + 64 * b + col + 8] = __float2bfloat16(o[b][e + 2] * f);
    }
    if (warp == 0 && g == 0 && p.m_out != nullptr) {
      p.m_out[orow] = lsum != 0.f ? m[e] * kLn2 : kNegInf;
      p.l_out[orow] = lsum;
    }
  }
  // rows of the tile without a valid query, written empty by block 0
  if (w.k == 0) {
    const int empty_rows = w.rows_here - w.nrows;
    for (int c = threadIdx.x; c < empty_rows * (D / 8); c += kConsumers) {
      const int r = w.nrows + c / (D / 8), x = c % (D / 8);
      const long long orow = out_row(p, w.s, w.h, w.r0 + r);
      reinterpret_cast<uint4*>(p.o + orow * D)[x] = make_uint4(0u, 0u, 0u, 0u);
      if (x == 0 && p.m_out != nullptr) {
        p.m_out[orow] = kNegInf;
        p.l_out[orow] = 0.f;
      }
    }
  }
}

template <int D, bool INT8, bool DECODE>
__global__ void __launch_bounds__(kThreads, PCfg<D, INT8, DECODE>::kBlocksPerSM)
    paged_sm90(const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const PagedParams p) {
  using C = PCfg<D, INT8, DECODE>;
  const Item w = item_of(p, blockIdx.x);
  if (w.skip) return;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t qsm = base + C::kConvBytes;   // the 64-row consumer's Q (kQSmem)
  const uint32_t small = qsm + C::kQBytes;
  const uint32_t stages = small + C::kSmallBytes;
  const uint32_t bars = stages + C::kStages * C::kStageBytes;
  auto stage = [&](int s) { return stages + static_cast<uint32_t>(s) * C::kStageBytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= kConsumers) {
    // producer warp: lane 0 stages each tile's 64 / bs pages; the warp reads
    // the block-table row 32 pages at a time
    if constexpr (!INT8) {
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v))
                     : "memory");
      }
    }
    const int per_tile = kKeys / p.bs;
    const int n_pages = (live_end(p, w.start, w.kv_len, w.r0, w.nrows) + p.bs - 1) / p.bs;
    const int* const bt = p.block_table + static_cast<long long>(w.s) * p.B;
    int window = -1, phys_lane = 0, s = 0;
    uint32_t phase = 0;
    for (int tile = w.t_begin; tile < w.t_end; ++tile) {
      mbar_wait(empty(s), phase ^ 1u);
      if (lane == 0) mbar_expect_tx(full(s), C::kStageBytes);
      for (int j = 0; j < per_tile; ++j) {
        // pages past the live ones repeat the last live page: their slots
        // are masked, and the stage is always whole
        const int page = min(tile * per_tile + j, n_pages - 1);
        if ((page & ~31) != window) {
          window = page & ~31;
          phys_lane = window + lane < n_pages ? bt[window + lane] : 0;
        }
        const int phys = __shfl_sync(0xffffffffu, phys_lane, page - window);
        const long long row = p.row0 + (static_cast<long long>(phys) * p.Hk + w.h) * p.bs;
        if (lane == 0) {
          if constexpr (INT8) {
            const uint32_t st = stage(s);
            const uint32_t kb = j * p.bs * D, sb = 2 * C::kInt8Tile + j * p.bs * 4;
            bulk_load(st + kb, p.k8 + row * D, p.bs * D, full(s));
            bulk_load(st + C::kInt8Tile + kb, p.v8 + row * D, p.bs * D, full(s));
            bulk_load(st + sb, p.ks + row, p.bs * 4, full(s));
            bulk_load(st + sb + kKeys * 4, p.vs + row, p.bs * 4, full(s));
          } else {
#pragma unroll
            for (int b = 0; b < C::kBoxes; ++b) {
              const uint32_t at = b * C::kBox + j * p.bs * kRowBytes;
              tma_load_2d(stage(s) + at, &map_k, 64 * b, static_cast<int>(row), full(s));
              tma_load_2d(stage(s) + C::kTile + at, &map_v, 64 * b, static_cast<int>(row),
                          full(s));
            }
          }
        }
      }
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  if (DECODE || w.nrows <= 8) {
    decode_rows<D, INT8, DECODE>(w, p, base_ptr, base, small, stages, bars);
    return;
  }
  // consumer warpgroup: the item's 64 rows, Q as bf16 A fragments in
  // registers, or at D 256 as a swizzled K-major tile in shared memory
  // (rows without a valid query are zero)
  const int warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rr[2] = {16 * warp + g, 16 * warp + g + 8};
  uint32_t qa[C::kQSmem ? 1 : D / 16][4];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rr[i] < w.nrows;
    lim[i] = in ? min(w.kv_len, w.start + (w.r0 + rr[i]) / p.G + 1) : 0;
    if constexpr (!C::kQSmem) {
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          p.q + (in ? out_row(p, w.s, w.h, w.r0 + rr[i]) : 0) * D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][i] = in ? __ldg(qp + 8 * kk + t) : 0u;
        qa[kk][i + 2] = in ? __ldg(qp + 8 * kk + 4 + t) : 0u;
      }
    }
  }
  if constexpr (C::kQSmem) {
    // 16-byte chunk x of row r of box b at qsm + 8 KB b + 128 r + 16 (x ^ (r % 8))
    for (int c = threadIdx.x; c < kRows * (D / 8); c += kConsumers) {
      const int r = c / (D / 8), x = c % (D / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < w.nrows)
        v = __ldg(reinterpret_cast<const uint4*>(p.q + out_row(p, w.s, w.h, w.r0 + r) * D) + x);
      *reinterpret_cast<uint4*>(base_ptr + (qsm - base) + (x / 8) * (kRows * kRowBytes) +
                                r * kRowBytes + (((x % 8) ^ (r & 7)) << 4)) = v;
    }
    fence_proxy_async();
    named_sync(1, kConsumers);
  }
  // the first slot that some valid row of the item does not see
  const int mask_from = w.nrows > 0 ? min(w.kv_len, w.start + w.r0 / p.G + 1) : 0;
  const bool signals = lane == 0;
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  int s = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++s == C::kStages) {
      s = 0;
      phase ^= 1u;
    }
  };
  if constexpr (!INT8) {
    for (int tile = w.t_begin; tile < w.t_end; ++tile) {
      mbar_wait(full(s), phase);
      float st[32];
      uint32_t pa[kKeys / 16][4];
      issue_qk<D, C::kQSmem>(st, qa, qsm, stage(s));
      wgmma_wait<0>();
      fence_regs(st);
      tile_softmax(st, pa, o, m, l, lim, tile * kKeys, mask_from, p.c);
      issue_pv<D>(o, pa, stage(s) + C::kTile);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (signals) mbar_arrive(empty(s));
      next();
    }
  } else {
    // the stage's int8 tiles are dequantized into one bf16 K and one bf16 V
    // tile at base: V of tile i under S of tile i, K of tile i + 1 under P V
    // of tile i; a named barrier after each product hands the tile written
    // under it to wgmma and frees the one it read
    unsigned char* const stage_ptr = base_ptr + (stages - base);
    const uint32_t kt = base, vt = base + C::kTile;
    if (w.t_begin < w.t_end) {
      mbar_wait(full(s), phase);
      dequant_tile<D>(stage_ptr + s * C::kStageBytes, 0, base_ptr);
      fence_proxy_async();
      named_sync(1, kConsumers);
    }
    for (int tile = w.t_begin; tile < w.t_end; ++tile) {
      float st[32];
      uint32_t pa[kKeys / 16][4];
      issue_qk<D, C::kQSmem>(st, qa, qsm, kt);
      dequant_tile<D>(stage_ptr + s * C::kStageBytes, 1, base_ptr + C::kTile);
      fence_proxy_async();
      __syncwarp();
      if (signals) mbar_arrive(empty(s));   // both int8 tiles of the stage are read
      wgmma_wait<0>();
      fence_regs(st);
      named_sync(1, kConsumers);
      tile_softmax(st, pa, o, m, l, lim, tile * kKeys, mask_from, p.c);
      issue_pv<D>(o, pa, vt);
      next();
      if (tile + 1 < w.t_end) {
        mbar_wait(full(s), phase);
        dequant_tile<D>(stage_ptr + s * C::kStageBytes, 0, base_ptr);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      named_sync(1, kConsumers);
    }
  }

  // rows of this thread: split partials (unnormalised acc, m in base 2, l),
  // or o, m (natural log) and l; rows without a valid query are written
  // empty by block 0 of the item
  float lsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = quad_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rr[i];
    if (r >= w.rows_here) continue;
    const bool valid = r < w.nrows;
    if (valid && w.partial) {
      const long long at =
          ((static_cast<long long>(w.k) * p.S + w.s) * p.Hk + w.h) * p.G + r;
      float* acc = p.ws + at * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(acc + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (t == 0) {
        float* ml = p.ws + static_cast<long long>(p.n_splits) * p.S * p.Hk * p.G * D;
        *reinterpret_cast<float2*>(ml + 2 * at) = make_float2(m[i], lsum[i]);
      }
      continue;
    }
    if (!valid && w.k != 0) continue;
    const long long orow = out_row(p, w.s, w.h, w.r0 + r);
    const float f = 1.f / (lsum[i] == 0.f ? 1.f : lsum[i]);
    bf16* const dst = p.o + orow * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
          valid ? pack_bf16(o[4 * j + 2 * i] * f, o[4 * j + 2 * i + 1] * f) : 0u;
    if (t == 0 && p.m_out != nullptr) {
      const bool live = valid && lsum[i] != 0.f;
      p.m_out[orow] = live ? m[i] * kLn2 : kNegInf;
      p.l_out[orow] = live ? lsum[i] : 0.f;
    }
  }
}

// The split partials of each decode row merged in split order (a fixed
// order: two launches are bitwise equal), one thread per column of D (at D
// 80 the last warp is half full; nothing here is warp-wide):
// o = sum_k acc_k 2^(m_k - M) / l, l = sum_k l_k 2^(m_k - M), M = max_k m_k,
// m = M ln 2; a row with no live slot gets o = 0, m = -1e30, l = 0.
template <int D>
__global__ void __launch_bounds__(D) paged_combine(const PagedParams p) {
  const int s = blockIdx.x / p.Hk, h = blockIdx.x % p.Hk;
  const int chunk = p.chunk != nullptr ? p.chunk[s] : p.Q;
  if (chunk != 1) return;
  const int n_tiles = (live_end(p, p.start[s], p.kv_len[s], 0, p.G) + kKeys - 1) / kKeys;
  const int n_used = (n_tiles + p.split_tiles - 1) / p.split_tiles;
  const long long per_split = static_cast<long long>(p.S) * p.Hk * p.G;
  const float* ml = p.ws + p.n_splits * per_split * D;
  const int d = threadIdx.x;
  for (int r = 0; r < p.G; ++r) {
    const long long at = (static_cast<long long>(s) * p.Hk + h) * p.G + r;
    float mx = kNegInf;
    for (int k = 0; k < n_used; ++k) mx = fmaxf(mx, ml[2 * (k * per_split + at)]);
    float lsum = 0.f, a = 0.f;
    for (int k = 0; k < n_used; ++k) {
      const long long ak = k * per_split + at;
      const float e = ex2(ml[2 * ak] - mx);
      lsum = fmaf(ml[2 * ak + 1], e, lsum);
      a = fmaf(p.ws[ak * D + d], e, a);
    }
    const long long orow = out_row(p, s, h, r);
    p.o[orow * D + d] = __float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));
    if (d == 0 && p.m_out != nullptr) {
      p.m_out[orow] = lsum != 0.f ? mx * kLn2 : kNegInf;
      p.l_out[orow] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A bf16 pool of `rows` rows of D as a 2-D map (d, row) read in boxes of 64 d
// x bs rows (one page of one kv head, 64 bf16 = the 128-byte swizzle; at D
// 80 and 96 the second box reaches past D and TMA zero-fills it). The
// pools are allocated once, so each map is encoded once and kept by its
// (pointer, rows, D, bs).
int pool_map(CUtensorMap* out, const void* ptr, long long rows, int D, int bs) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, long long, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(ptr), rows, D, bs);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  int err = 0;
  EncodeTiled encode = encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(bs)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  if (cache.size() >= 1024) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

// what the kernels take: a D of PAGED_HEAD_DIMS, pages of 16, 32 or 64
// slots, GQA groups of at most 64 heads, pool rows inside TMA's int32
// coordinates. The host
// sizes its launch from its own copy of the work items
// (ops/paged_attention.py, SM90_ROWS, SM90_TILE_SLOTS and sm90_grid); a
// launch whose tiles or block count differ from the decode here is refused,
// so copies that drift apart raise instead of leaving rows unwritten.
inline bool paged_shape_ok(int S, int Q, int Hq, int Hk, int D, int bs, int B, long long rows,
                           int split_tiles, int n_splits, int item_rows, int tile_slots,
                           int blocks) {
  if (!(S > 0 && Q > 0 && Hk > 0 && Hq % Hk == 0 && Hq / Hk <= kRows &&
        paged_head_dim_built(D) && (bs == 16 || bs == 32 || bs == 64) && B > 0 && rows > 0 &&
        rows < (1ll << 31) && split_tiles > 0 && n_splits > 0 && item_rows == kRows &&
        tile_slots == kKeys))
    return false;
  const long long row_tiles = (static_cast<long long>(Q) * (Hq / Hk) + kRows - 1) / kRows;
  return blocks == static_cast<long long>(S) * Hk * (row_tiles + n_splits - 1);
}

template <int D, bool INT8, bool DECODE>
int launch_kernel(const PagedParams& p, const CUtensorMap& mk, const CUtensorMap& mv,
                  cudaStream_t st) {
  using C = PCfg<D, INT8, DECODE>;
  auto kern = paged_sm90<D, INT8, DECODE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.S * p.Hk * (p.row_tiles + p.n_splits - 1), kThreads, C::kSmemBytes, st>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// the decode kernel (chunk null) at GQA groups of at most 8 heads takes the
// DECODE instantiation; everything else the one with both consumers
inline bool decode_instantiation(bool decode, int G) { return decode && G <= 8; }

// blocks per SM of the instantiation that a launch at head dim D and GQA
// group G takes (decode: a launch of the decode kernel), 0 at an unbuilt D.
// The host sizes its KV splits by it (ops/paged_attention.py,
// split_tiles_for), reading it from the library that holds the kernel.
template <bool INT8>
int blocks_per_sm(int D, int G, bool decode) {
  if (!paged_head_dim_built(D)) return 0;
  return with_paged_head_dim(D, [&](auto dim) {
    constexpr int d = decltype(dim)::value;
    return decode_instantiation(decode, G) ? PCfg<d, INT8, true>::kBlocksPerSM
                                           : PCfg<d, INT8, false>::kBlocksPerSM;
  });
}

template <int D, bool INT8>
int launch_paged(const PagedParams& p, const void* k_pool, const void* v_pool, long long rows,
                 cudaStream_t st) {
  CUtensorMap mk{}, mv{};
  if constexpr (!INT8) {
    int err = pool_map(&mk, k_pool, rows, D, p.bs);
    if (err == 0) err = pool_map(&mv, v_pool, rows, D, p.bs);
    if (err != 0) return err;
  }
  const int err = decode_instantiation(p.chunk == nullptr, p.G)
                      ? launch_kernel<D, INT8, true>(p, mk, mv, st)
                      : launch_kernel<D, INT8, false>(p, mk, mv, st);
  if (err != 0 || p.n_splits == 1) return err;
  paged_combine<D><<<p.S * p.Hk, D, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the common fields of both kernels' parameters
inline PagedParams paged_params(const void* q, void* o, float* m, float* l,
                                const int* block_table, const int* start, const int* chunk,
                                const int* kv_len, float* ws, int S, int Q, int Hq, int Hk,
                                int bs, int B, long long row0, int split_tiles, int n_splits,
                                float sm_scale) {
  PagedParams p{};
  p.q = static_cast<const bf16*>(q);
  p.o = static_cast<bf16*>(o);
  p.m_out = m;
  p.l_out = l;
  p.block_table = block_table;
  p.start = start;
  p.chunk = chunk;
  p.kv_len = kv_len;
  p.ws = ws;
  p.row0 = row0;
  p.S = S;
  p.Q = Q;
  p.Hq = Hq;
  p.Hk = Hk;
  p.G = Hq / Hk;
  p.bs = bs;
  p.B = B;
  p.row_tiles = (Q * p.G + kRows - 1) / kRows;
  p.split_tiles = split_tiles;
  p.n_splits = n_splits;
  p.c = sm_scale * kLog2e;
  return p;
}

}  // namespace
