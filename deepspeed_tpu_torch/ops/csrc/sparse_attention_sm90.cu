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
// exact zeros for a query tile with no live column.
//
// What bounds it on an H100: q, k, v read once and o written once (at the
// main shape, B 1, S 4096, H 32, D 128, bigbird at block 64, 134 MB:
// 0.040 ms at 3.35 TB/s) against 4 D flops per (query, key) pair of each
// live block (14.6 GFLOP: 0.015 ms at 989 TFLOP/s), so bytes. K and V tiles
// are read once per live (q-block, column) pair; a head's 2 MB of K and V
// stays in L2 between the query tiles that share its columns.
//
// Design (the Q-stationary flash forward of flash_attention_sm90.cu, its
// causal loop over key tiles replaced by a walk of the column list, as the
// paged kernels walk a block table):
//   * Work item: (batch, head, 64-row query tile) = one consumer warpgroup's
//     wgmma rows, item u = (b H + h) (S / 64) + t. At block 128 the two
//     items of a q-block share its column list; each column gives block / 64
//     key tiles of 64.
//   * Block: 160 threads, one consumer warpgroup and one producer warp;
//     several blocks per SM (3 at D 64, 2 at D 128). The host passes
//     offsets and item ids: each block computes its items in order, each
//     from start to end, so no float atomics and the result does not depend
//     on the schedule (two launches are bitwise equal). Persistent blocks
//     are dealt longest first (ops/flash_attention.py, schedule); the other
//     schedule gives every item a block of its own.
//   * Producer warp: reads the item's cnt and its columns (32 at a time,
//     one per lane, shuffled out), counts its live key tiles (under causal
//     the tiles wholly above the item's last row are dropped: only the
//     diagonal column's later tile at block 128, since the list ascends and
//     lies at or below the diagonal), writes that count and whether the
//     last tile is the diagonal one beside the item's Q buffer, loads Q by
//     TMA into one of two buffers and then K and V of each live tile through
//     a ring of stages guarded by full / empty mbarriers. The ring runs on
//     across items, so the next item's Q and first tiles land while this
//     one's last products and epilogue run.
//   * Consumer warpgroup: S = Q K^T on wgmma m64n64k16 (Q and K K-major in
//     shared memory), the online softmax in registers, P re-packed as bf16
//     A fragments, O += P V on m64nDk16 with V read MN-major; S of the next
//     tile is issued with P V of this one and the softmax runs under P V
//     (the flash forward's overlap). Only the diagonal tile (key tile start
//     = query tile start) is masked, so no row meets a fully masked tile.
//     An item with no live tile writes zeros.
//   * TMA maps [B, S, H, D] as 4-D (d, head, s, b) in 64-row boxes of 64 d
//     (the 128-byte swizzle; D 128 is two boxes). S is a multiple of the
//     block, so every box is whole.
//   * Launch check: the host passes the number of items it dealt, counted
//     from its own copy of the item rows (ops/sparse_attention.py,
//     SM90_ROWS); a launch whose count differs from B H (S / 64) is
//     refused, so copies that drift apart raise instead of leaving rows
//     unwritten.
// TMA needs 16-byte-aligned bases and rows: the wrapper
// (ops/sparse_attention.py, sparse_route) sends bf16 tensors that satisfy
// that at D 64 or 128 here and everything else to sparse_attention.cu.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t. The entry returns 0, a cudaError_t from the
// launch, or 10000 + the CUresult of a tensor map that could not be encoded.

#include "sm90_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // query rows per work item
constexpr int kKeys = 64;       // keys per streamed tile
constexpr int kConsumers = 128; // one consumer warpgroup
constexpr int kThreads = 160;   // and one producer warp

template <int D> struct Cfg {
  static constexpr int kBoxes = D / 64;                 // 64-wide boxes along D
  static constexpr int kQBox = kRows * kRowBytes;       // 8 KB
  static constexpr int kKBox = kKeys * kRowBytes;       // 8 KB
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kKBox;          // one of K, V
  static constexpr int kStageBytes = 2 * kTile;         // K, then V
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBlocksPerSM = D == 64 ? 3 : 2;
  // two Q buffers, the ring, 2 kStages + 4 barriers and the two items' info
  static constexpr int kSmemBytes =
      1024 + 2 * kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 4) + 8;
};

struct Params {
  bf16* out;         // [B, S, H, D]
  const int* cols;   // [H, nq, nj] ascending live columns per (head, q-block)
  const int* cnt;    // [H, nq]
  const int* sched;  // [gridDim.x + 1] offsets into the item ids that follow
  int B, S, H, block, nq, nj;
  int nt;            // query tiles of kRows over S
  int causal;
  float c;           // sm_scale * log2(e)
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

// shared memory: two Q buffers, the ring of K / V stages, the barriers, and
// per Q buffer its item's live tiles (2 n + 1 when the last is diagonal)
template <int D> struct Smem {
  using C = Cfg<D>;
  uint32_t base, bars;
  int* info;
  __device__ Smem(uint32_t b, unsigned char* b_ptr)
      : base(b), bars(b + 2 * C::kQBytes + C::kStages * C::kStageBytes) {
    info = reinterpret_cast<int*>(b_ptr + (bars - base) + 8 * (2 * C::kStages + 4));
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
// both K-major)
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

// the diagonal tile (its first key is the item's first row): keys past the
// row to -1e30 (their p is 0)
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

// the producer warp: each item's live tiles, its Q and the K / V tiles
template <int D>
__device__ __forceinline__ void producer(const Smem<D>& sm, const Params& p, int i_begin,
                                         int i_end, const int* ids,
                                         const CUtensorMap* map_q, const CUtensorMap* map_k,
                                         const CUtensorMap* map_v) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  const int per = p.block / kKeys;  // key tiles per layout column
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
    const long long lrow = static_cast<long long>(w.h) * p.nq + w.q0 / p.block;
    const int cnt = p.cnt[lrow];
    const int* const cols = p.cols + lrow * p.nj;
    auto tile_k0 = [&](int j) { return cols[j / per] * p.block + (j % per) * kKeys; };
    int n = cnt * per;
    if (p.causal) {
      while (n > 0 && tile_k0(n - 1) > w.q0 + kRows - 1) --n;
    }
    const bool diag = p.causal && n > 0 && tile_k0(n - 1) + kKeys - 1 > w.q0;
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
    int window = -1, col_lane = 0;
    for (int j = 0; j < n; ++j) {
      const int ci = j / per;
      if ((ci & ~31) != window) {
        window = ci & ~31;
        col_lane = window + lane < cnt ? cols[window + lane] : 0;
      }
      const int k0 = __shfl_sync(0xffffffffu, col_lane, ci - window) * p.block + (j % per) * kKeys;
      mbar_wait(sm.empty(s), phase ^ 1u);
      if (lane == 0) {
        mbar_expect_tx(sm.full(s), C::kStageBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(sm.k(s) + x * C::kKBox, map_k, 64 * x, w.h, k0, w.b, sm.full(s));
          tma_load(sm.v(s) + x * C::kKBox, map_v, 64 * x, w.h, k0, w.b, sm.full(s));
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
    zero(st);
    wgmma_fence();
    fence_regs(st);
    qk_product<D>(st, qa, sm.k(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if (diag && n == 1) mask_diagonal(st);
    online_softmax(st, m, l, alpha, p.c);
    to_a(pa, st);
    int sp = s;
    next();
    for (int kt = 1; kt < n; ++kt) {
      mbar_wait(sm.full(s), phase);
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
      if (diag && kt == n - 1) mask_diagonal(st);
      online_softmax(st, m, l, alpha, p.c);
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
    producer<D>(sm, p, i_begin, i_end, ids, &map_q, &map_k, &map_v);
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
  if (err == 0) err = bshd_map(&mk, k, p.B, p.S, p.H, D, kKeys);
  if (err == 0) err = bshd_map(&mv, v, p.B, p.S, p.H, D, kKeys);
  if (err != 0) return err;
  auto kern = sparse_fwd_sm90<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, C::kSmemBytes, st>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o [B, S, H, D] bf16 from bf16 q, k, v [B, S, H, D] (D 64 or 128) over the
// compacted layout cols int32 [H, nq, nj], cnt int32 [H, nq] (block 64 or
// 128 dividing S, nq = S / block); sched: grid + 1 offsets, then the item
// ids (ops/sparse_attention.py, sm90_plan), one block per offset pair;
// items: how many the host dealt, refused unless B H (S / 64)
extern "C" int sparse_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                         const int* cols, const int* cnt, const int* sched,
                                         int grid, int items, int B, int S, int H, int D,
                                         int block, int nq, int nj, float scale, int causal,
                                         void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || grid <= 0 || nj <= 0 || (block != 64 && block != 128) ||
      S % block != 0 || nq != S / block ||
      items != static_cast<long long>(B) * H * (S / kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.out = static_cast<bf16*>(o);
  p.cols = cols;
  p.cnt = cnt;
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.H = H;
  p.block = block;
  p.nq = nq;
  p.nj = nj;
  p.nt = S / kRows;
  p.causal = causal;
  p.c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, p, grid, st);
  if (D == 128) return launch<128>(q, k, v, p, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
