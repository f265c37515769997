// Block-sparse attention forward on Hopper's tensor-core path (sm_90a):
// wgmma from shared memory that TMA fills, in warp-specialised blocks that
// walk the compacted column lists of a static layout. The other route
// (mma.sync in bf16, the CUDA cores in fp32) is in sparse_attention.cu.
//
// Replaces the TPU kernel of deepspeed_tpu/ops/pallas/sparse_attention.py:
//   sparse_attention_fwd_sm90  <- _kernel (flash forward over the compacted
//                                          nonzero blocks of a static layout)
//
// What it computes is sparse_attention.cu's function (see its notes), for
// bf16 q, k, v, o [B, S, H, D] read and written in place: query row i of
// head h lies in q-block i / block and attends to the keys of the layout
// columns cols[h, iq, 0 .. cnt[h, iq]); s = (q . k) * sm_scale in fp32, keys
// past i masked under causal, the online softmax in fp32 (base 2), P
// rounded to bf16 before the fp32-accumulated PV product, o = acc / l, and
// exact zeros for a row with no live key.
//
// What bounds it on an H100: q, k, v read once and o written once (at the
// main shape, B 1, S 4096, H 32, D 128, bigbird at block 64, 134 MB:
// 0.040 ms at 3.35 TB/s; the same bytes at block 16) against 4 D flops per
// (query, key) pair of each live block (14.6 GFLOP at block 64: 0.015 ms at
// 989 TFLOP/s), so bytes. K and V tiles are read once per item that walks
// them; a head's K and V stay in L2 between the query tiles that share its
// columns.
//
// Design (the Q-stationary flash forward of flash_attention_sm90.cu, its
// causal loop over key tiles replaced by a walk of a column list, as the
// paged kernels walk a block table; the walk is set out in
// sparse_tiles.cuh):
//   * Work item: (batch, head, 64-row query tile) = one consumer warpgroup's
//     wgmma rows, item u = (b H + h) ceil(S / 64) + t. At block 64 and more
//     the item lies in one q-block and walks its column list, each column
//     block / 64 key tiles of 64. At block 16 and 32 it spans R = 64 / block
//     q-blocks and walks the union of their lists, G = 64 / block union
//     columns per 64-key tile, each column's keys one TMA box of `block`
//     rows of K (and of V) stacked in the tile: a 16-row box is two 8-row
//     atoms of the 128-byte swizzle, whose pattern repeats every 1024 bytes,
//     so G boxes at 2048-byte (4096) steps are the 64-row tile that
//     qk_product and pv_product read. At block 16 warp w's 16 rows are
//     q-block w; at block 32 warps 2 r and 2 r + 1 are q-block r.
//   * Block: 160 threads, one consumer warpgroup and one producer warp;
//     blocks per SM by D (3 at D 64, 2 at D 80 / 96 / 128, 1 at D 256). The
//     host passes offsets and item ids: each block computes its items in
//     order, each from start to end, so no float atomics and the result does
//     not depend on the schedule (two launches are bitwise equal).
//     Persistent blocks are dealt longest first (ops/flash_attention.py,
//     schedule).
//   * Producer warp: reads the item's count and its list (32 entries at a
//     time, one per lane, shuffled out), counts its key tiles (at block 64
//     and more, under causal, the tiles wholly above the item's last row are
//     dropped: only the diagonal column's later tiles at block 128 / 256,
//     since the list ascends and lies at or below the diagonal; below block
//     64 no union column lies above the item), writes that count beside the
//     item's Q buffer (and, at block 64 and more, whether its last tile is
//     the diagonal one), loads Q by TMA into one of two buffers and then K
//     and V of each tile through a ring of stages guarded by full / empty
//     mbarriers. Below block 64 it writes beside each stage whether the tile
//     masks any key and, if it does, one live word per consumer thread
//     (sparse_tiles.cuh, sparse_live_word), so that the consumers' registers
//     take one word for the mask. The producer is instantiated once per walk
//     (kUnion): with both walks in one loop, blocks 64 and 128 ran 3-5%
//     slower. The ring runs on across items, so the next item's Q and first
//     tiles land while this one's last products and epilogue run.
//   * Consumer warpgroup: S = Q K^T on wgmma m64n64k16 (Q and K K-major in
//     shared memory; over D's 16-wide slices only, so a padded box's zero
//     columns are skipped), the online softmax in registers, P re-packed as
//     bf16 A fragments, O += P V on m64nDk16 with V read MN-major; S of the
//     next tile is issued with P V of this one and the softmax runs under
//     P V (the flash forward's overlap). A tile that masks any key (an entry
//     the row's q-block does not list, a padding entry, a key past the row
//     under causal; at block 64 and more only the diagonal tile, masked from
//     its fixed pattern) sets those logits to -1e30, and the softmax gives
//     them an exact 0 whatever the running max: below block 64 a row can
//     meet a tile, or a whole item, with no live key, where 2^(s - m) alone
//     would give 1. A row with no live key ends with l = 0 and writes zeros;
//     an item with no tile writes zeros without a product.
//   * TMA maps [B, S, H, D] as 4-D (d, head, s, b): Q in 64-row boxes, K and
//     V in boxes of min(block, 64) rows, of 64 d each (the 128-byte
//     swizzle); D 80 and 96 pad a second box (TMA zero-fills past D), D 128
//     is two boxes, D 256 four. Rows of Q past S (S need not be a multiple
//     of 64 below block 64) zero-fill and are not stored.
//   * Launch check: the host passes the number of items it dealt, counted
//     from its own copy of the item rows (ops/sparse_attention.py,
//     SM90_ROWS), and below block 64 the rows and width of its union table;
//     a launch whose counts differ from B H ceil(S / 64) and ceil(S / 64),
//     or whose width is not a whole number of tiles, is refused, so copies
//     that drift apart raise instead of leaving rows unwritten.
// TMA needs 16-byte-aligned bases and rows: the wrapper
// (ops/sparse_attention.py, sparse_route) sends bf16 tensors that satisfy
// that here and everything else to sparse_attention.cu.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t. The entry returns 0, a cudaError_t from the
// launch, or 10000 + the CUresult of a tensor map that could not be encoded.

#include "sm90_tiles.cuh"
#include "sparse_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // query rows per work item
constexpr int kKeys = 64;       // keys per streamed tile
constexpr int kConsumers = 128; // one consumer warpgroup
constexpr int kThreads = 160;   // and one producer warp
constexpr int kMaxEntries = 4;  // list entries per tile (G at block 16)
// a stage's tile description: one live word per consumer thread, then
// whether the tile masks any key
constexpr int kMeta = kConsumers + 4;

__host__ __device__ constexpr int pad64(int D) { return (D + 63) / 64 * 64; }

template <int D> struct Cfg {
  static constexpr int kBoxes = pad64(D) / 64;          // 64-wide boxes along D
  static constexpr int kQBox = kRows * kRowBytes;       // 8 KB
  static constexpr int kKBox = kKeys * kRowBytes;       // 8 KB
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kKBox;          // one of K, V
  static constexpr int kStageBytes = 2 * kTile;         // K, then V
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBlocksPerSM = D == 64 ? 3 : (D > 128 ? 1 : 2);
  // two Q buffers, the ring, 2 kStages + 4 barriers, the two items' tile
  // counts and the stages' tile descriptions (528 bytes each)
  static constexpr int kSmemBytes = 1024 + 2 * kQBytes + kStages * kStageBytes +
                                    8 * (2 * kStages + 4) + 8 + 4 * kMeta * kStages;
};

struct Params {
  bf16* out;           // [B, S, H, D]
  const int* cols;     // block >= 64: [H, nq, nj] ascending live columns per (head, q-block)
  const int* cnt;      // [H, nq]
  const int* ucols;    // block < 64: [H, nt, nu] each item's ascending union of columns
  const int* umask;    // [H, nt, nu] beside each, the item's q-blocks that list it
  const int* ucnt;     // [H, nt]
  const int* sched;    // [gridDim.x + 1] offsets into the item ids that follow
  int B, S, H, block, nq, nj, nu;
  int nt;              // query tiles of kRows over S
  int shift;           // log2 of an entry's keys, min(block, kKeys)
  int causal;
  float c;             // sm_scale * log2(e)
};

struct Item {
  int b, h, q0;
};

__device__ __forceinline__ Item item_of(const Params& p, int u) {
  Item w;
  const int bh = u / p.nt;
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.q0 = (u % p.nt) * kRows;
  return w;
}

// shared memory: two Q buffers, the ring of K / V stages, the barriers, per
// Q buffer its item's tile count, and per stage its tile's description
template <int D> struct Smem {
  using C = Cfg<D>;
  uint32_t base, bars;
  int* info;
  int* meta;
  __device__ Smem(uint32_t b, unsigned char* b_ptr)
      : base(b), bars(b + 2 * C::kQBytes + C::kStages * C::kStageBytes) {
    info = reinterpret_cast<int*>(b_ptr + (bars - base) + 8 * (2 * C::kStages + 4));
    meta = info + 2;
  }
  __device__ uint32_t q(int qb) const { return base + qb * C::kQBytes; }
  __device__ uint32_t k(int s) const { return base + 2 * C::kQBytes + s * C::kStageBytes; }
  __device__ uint32_t v(int s) const { return k(s) + C::kTile; }
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (C::kStages + s); }
  __device__ uint32_t q_full(int qb) const { return bars + 8u * (2 * C::kStages + qb); }
  __device__ uint32_t q_empty(int qb) const { return bars + 8u * (2 * C::kStages + 2 + qb); }
};

// S = Q K^T over D for the warpgroup's 64 rows (Q tile at a, K tile at b,
// both K-major); the last slice is D's, so a padded box's zero columns are
// skipped
template <int D>
__device__ __forceinline__ void qk_product(float (&d)[kKeys / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * (kRows * kRowBytes) + (kk % 4) * 32;
    const uint32_t bt = (kk / 4) * (kKeys * kRowBytes) + (kk % 4) * 32;
    wgmma_ss(d, desc(a + at, 16), desc(b + bt, 16), kk > 0);
  }
}

// O += P V over the tile's 64 keys, P the bf16 A fragments, V at b read
// MN-major
template <int D>
__device__ __forceinline__ void pv_product(float (&d)[D / 2], const uint32_t (&a)[kKeys / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs(d, a[kk], desc(b + kk * 16 * kRowBytes, kKeys * kRowBytes));
}

// the diagonal tile at block 64 and more (its first key is the item's first
// row): keys past the row to -1e30
__device__ __forceinline__ void mask_diagonal(float (&st)[kKeys / 2]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t + (e & 1) > r0 + 8 * (e >> 1)) st[4 * j + e] = kNegInf;
    }
  }
}

// the logits of a union tile that masks some key that the thread's live
// word clears, to -1e30
__device__ __forceinline__ void mask_tile(float (&st)[kKeys / 2], uint32_t live) {
#pragma unroll
  for (int x = 0; x < kKeys / 2; ++x) {
    if (!((live >> x) & 1u)) st[x] = kNegInf;
  }
}

// the producer warp: each item's tiles, its Q and the K / V tiles. kUnion:
// the launch's block is under 64 (tiles of G union columns); instantiated
// apart so that the walk of column lists keeps the loop it had alone
template <int D, bool kUnion>
__device__ __forceinline__ void producer(const Smem<D>& sm, const Params& p, int i_begin,
                                         int i_end, const int* ids,
                                         const CUtensorMap* map_q, const CUtensorMap* map_k,
                                         const CUtensorMap* map_v) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  const int G = kUnion ? kKeys >> p.shift : 1;  // entries per tile
  const int R = kRows >> p.shift;          // q-blocks per item (kUnion)
  const int per = p.block / kKeys;         // key tiles per layout column (!kUnion)
  uint32_t tri[kConsumers / 32] = {};      // each consumer warp's diagonal pattern (kUnion)
  if (kUnion) {
#pragma unroll
    for (int x = 0; x < kConsumers / 32; ++x) tri[x] = sparse_triangle(x, lane, p.shift);
  }
  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_q)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_v)) : "memory");
  }
  int s = 0;
  uint32_t phase = 0;
  for (int i = i_begin; i < i_end; ++i) {
    const Item w = item_of(p, ids[i]);
    const int n_item = i - i_begin, qb = n_item & 1;
    int cnt, n, width;
    const int* cols;
    const int* masks = nullptr;
    if (kUnion) {
      const long long urow = static_cast<long long>(w.h) * p.nt + w.q0 / kRows;
      cnt = p.ucnt[urow];
      cols = p.ucols + urow * p.nu;
      masks = p.umask + urow * p.nu;
      n = (cnt + G - 1) / G;
      width = p.nu;  // padded to whole tiles
    } else {
      const long long lrow = static_cast<long long>(w.h) * p.nq + w.q0 / p.block;
      cnt = p.cnt[lrow];
      cols = p.cols + lrow * p.nj;
      n = cnt * per;
      if (p.causal) {
        while (n > 0 && cols[(n - 1) / per] * p.block + ((n - 1) % per) * kKeys > w.q0 + kRows - 1)
          --n;
      }
      width = cnt;
    }
    // block 64 and more: whether the last tile is the diagonal one (its first
    // key the item's first row), which the consumer masks itself
    const bool diag = !kUnion && p.causal && n > 0 &&
                      cols[(n - 1) / per] * p.block + ((n - 1) % per) * kKeys + kKeys - 1 > w.q0;
    mbar_wait(sm.q_empty(qb), ((n_item >> 1) & 1) ^ 1u);
    if (lane == 0) {
      sm.info[qb] = 2 * n + (diag ? 1 : 0);
      if (n > 0) {
        mbar_expect_tx(sm.q_full(qb), C::kQBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sm.q(qb) + x * C::kQBox, map_q, 64 * x, w.h, w.q0, w.b, sm.q_full(qb));
      } else {
        mbar_arrive(sm.q_full(qb));  // nothing to load: the consumer writes zeros
      }
    }
    int window = -1, col_lane = 0, mask_lane = 0;
    for (int j = 0; j < n; ++j) {
      const int e0 = kUnion ? j * G : j / per;  // the tile's first list entry (G divide 32)
      if ((e0 & ~31) != window) {
        window = e0 & ~31;
        const bool in = window + lane < width;
        col_lane = in ? cols[window + lane] : 0;
        mask_lane = in && kUnion ? masks[window + lane] : 0;
      }
      int k0[kMaxEntries], bits = 0, last = 0;
#pragma unroll
      for (int g = 0; g < kMaxEntries; ++g) {
        k0[g] = 0;
        if (g < G) {  // G is the warp's: every lane shuffles
          const int src = (e0 - window + g) & 31;
          k0[g] = __shfl_sync(0xffffffffu, col_lane, src) * p.block;
          if (kUnion) bits |= __shfl_sync(0xffffffffu, mask_lane, src) << (4 * g);
          last = k0[g] + p.block - 1;  // the ascending list's last key so far
        }
      }
      if (!kUnion) k0[0] += (j % per) * kKeys;
      // a union tile that masks some key: the consumers' live words, made
      // before the wait, off the loads' path
      bool masked = false;
      uint32_t live[kConsumers / 32];
      if (kUnion) {
        const bool crossing = p.causal && last > w.q0;  // a key past the item's first row
        masked = crossing || sparse_bits_partial(bits, G, R);
#pragma unroll
        for (int x = 0; x < kConsumers / 32; ++x)
          live[x] = masked ? sparse_live_word(x, w.q0, k0, bits, G, crossing, p.shift, tri[x]) : ~0u;
      }
      mbar_wait(sm.empty(s), phase ^ 1u);
      if (kUnion) {
        int* const meta = sm.meta + kMeta * s;
        if (masked) {
#pragma unroll
          for (int x = 0; x < kConsumers / 32; ++x) meta[32 * x + lane] = static_cast<int>(live[x]);
        }
        if (lane == 0) meta[kConsumers] = masked;
        __syncwarp();  // the lanes' words are ordered before lane 0's arrival releases them
      }
      if (lane == 0) {
        mbar_expect_tx(sm.full(s), C::kStageBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
#pragma unroll
          for (int g = 0; g < kMaxEntries; ++g) {
            if (g < G) {
              const uint32_t at = x * C::kKBox + (g << p.shift) * kRowBytes;
              tma_load(sm.k(s) + at, map_k, 64 * x, w.h, k0[g], w.b, sm.full(s));
              tma_load(sm.v(s) + at, map_v, 64 * x, w.h, k0[g], w.b, sm.full(s));
            }
          }
        }
      }
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }
}

// the consumer warpgroup: o of each item's 64 rows. S of tile kt is issued
// with P V of tile kt - 1; its softmax runs while P V is in flight, and O is
// rescaled after P V lands (straight-line code, so ptxas can match each wait
// to its commit group).
template <int D>
__device__ __forceinline__ void consumer(const Smem<D>& sm, const Params& p, int i_begin,
                                         int i_end, const int* ids) {
  using C = Cfg<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bool signals = lane == 0;
  const long long rs = static_cast<long long>(p.H) * D;
  int s = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++s == C::kStages) {
      s = 0;
      phase ^= 1u;
    }
  };
  const volatile int* const meta = sm.meta;
  const bool uni = p.block < kKeys;
  for (int i = i_begin; i < i_end; ++i) {
    const Item w = item_of(p, ids[i]);
    const int n_item = i - i_begin, qb = n_item & 1;
    const int row[2] = {w.q0 + 16 * warp + (lane >> 2), w.q0 + 16 * warp + (lane >> 2) + 8};
    bf16* const dst = p.out + (static_cast<long long>(w.b) * p.S * p.H + w.h) * D;
    mbar_wait(sm.q_full(qb), (n_item >> 1) & 1);
    const int info = *static_cast<volatile int*>(sm.info + qb);
    const int n = info >> 1;
    const bool diag = info & 1;
    if (n == 0) {  // no live column for these rows: o = 0
      __syncwarp();
      if (signals) mbar_arrive(sm.q_empty(qb));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= p.S) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + row[r] * rs + 8 * j + 2 * t) = 0u;
      }
      continue;
    }
    const uint32_t qa = sm.q(qb);
    float o[D / 2], st[kKeys / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[kKeys / 16][4];
    zero(o);
    mbar_wait(sm.full(s), phase);
    // a union tile's description, read before its products are issued (the
    // word is read whatever the flag, and used only under it)
    int masked = 0;
    uint32_t live = ~0u;
    if (uni) {
      masked = meta[kMeta * s + kConsumers];
      live = meta[kMeta * s + threadIdx.x];
    }
    zero(st);
    wgmma_fence();
    fence_regs(st);
    qk_product<D>(st, qa, sm.k(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if (masked) mask_tile(st, live);
    if (diag && n == 1) mask_diagonal(st);
    online_softmax<true>(st, m, l, alpha, p.c);
    to_a(pa, st);
    int sp = s;
    next();
    for (int kt = 1; kt < n; ++kt) {
      mbar_wait(sm.full(s), phase);
      if (uni) {
        masked = meta[kMeta * s + kConsumers];
        live = meta[kMeta * s + threadIdx.x];
      }
      zero(st);
      wgmma_fence();
      fence_regs(st);
      fence_regs(o);
      qk_product<D>(st, qa, sm.k(s));
      wgmma_commit();
      pv_product<D>(o, pa, sm.v(sp));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      if (masked) mask_tile(st, live);
      if (diag && kt == n - 1) mask_diagonal(st);
      online_softmax<true>(st, m, l, alpha, p.c);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (signals) mbar_arrive(sm.empty(sp));
      rescale(o, alpha);
      to_a(pa, st);
      sp = s;
      next();
    }
    if (signals) mbar_arrive(sm.q_empty(qb));  // every S of this item has landed
    wgmma_fence();
    fence_regs(o);
    pv_product<D>(o, pa, sm.v(sp));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (signals) mbar_arrive(sm.empty(sp));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / (sum == 0.f ? 1.f : sum);
      if (row[r] >= p.S) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + row[r] * rs + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kBlocksPerSM)
    sparse_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Smem<D> sm(base, smem_raw + (base - smem_u32(smem_raw)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumers / 32);
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(sm.q_full(qb), 1);
      mbar_init(sm.q_empty(qb), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int i_begin = p.sched[blockIdx.x], i_end = p.sched[blockIdx.x + 1];
  const int* const ids = p.sched + gridDim.x + 1;
  if (threadIdx.x >= kConsumers) {
    if (p.block < kKeys)
      producer<D, true>(sm, p, i_begin, i_end, ids, &map_q, &map_k, &map_v);
    else
      producer<D, false>(sm, p, i_begin, i_end, ids, &map_q, &map_k, &map_v);
  } else {
    consumer<D>(sm, p, i_begin, i_end, ids);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p, int grid,
           cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  int err = bshd_map(&mq, q, p.B, p.S, p.H, D, kRows);
  if (err == 0) err = bshd_map(&mk, k, p.B, p.S, p.H, D, 1 << p.shift);
  if (err == 0) err = bshd_map(&mv, v, p.B, p.S, p.H, D, 1 << p.shift);
  if (err != 0) return err;
  auto kern = sparse_fwd_sm90<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, C::kSmemBytes, st>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o [B, S, H, D] bf16 from bf16 q, k, v [B, S, H, D] (D of SPARSE_HEAD_DIMS)
// over a layout of block `block` (SPARSE_BLOCKS, dividing S, nq = S /
// block). At block 64 and more: cols int32 [H, nq, nj], cnt int32 [H, nq]
// (the compacted layout); below it: ucols, umask int32 [H, ut, nu] and ucnt
// int32 [H, ut] (the union of each item's q-blocks' columns, ut = ceil(S /
// 64), nu a multiple of 64 / block). sched: grid + 1 offsets, then the item
// ids (ops/sparse_attention.py, sm90_plan), one block per offset pair;
// items: how many the host dealt, refused unless B H ceil(S / 64)
extern "C" int sparse_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                         const int* cols, const int* cnt, const int* ucols,
                                         const int* umask, const int* ucnt, const int* sched,
                                         int grid, int items, int B, int S, int H, int D,
                                         int block, int nq, int nj, int ut, int nu, float scale,
                                         int causal, void* stream) {
  const int nt = (S + kRows - 1) / kRows;
  const bool uni = block < kKeys;
  if (B <= 0 || H <= 0 || S <= 0 || grid <= 0 || !sparse_block_built(block) ||
      S % block != 0 || nq != S / block || items != static_cast<long long>(B) * H * nt ||
      (uni ? (ut != nt || nu <= 0 || nu % (kKeys / block) != 0 || !ucols || !umask || !ucnt)
           : (nj <= 0 || !cols || !cnt)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.out = static_cast<bf16*>(o);
  p.cols = cols;
  p.cnt = cnt;
  p.ucols = ucols;
  p.umask = umask;
  p.ucnt = ucnt;
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.H = H;
  p.block = block;
  p.nq = nq;
  p.nj = nj;
  p.nu = nu;
  p.nt = nt;
  p.shift = sparse_entry_shift(block, kKeys);
  p.causal = causal;
  p.c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_sparse_head_dim(D, [&](auto d) { return launch<decltype(d)::value>(q, k, v, p, grid, st); });
}
