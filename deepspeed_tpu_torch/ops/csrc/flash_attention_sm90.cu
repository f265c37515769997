// The flash-attention kernels on Hopper's tensor-core path (sm_90a): wgmma
// from shared memory that TMA fills, in persistent, warp-specialised blocks.
// Three kernels share the machinery below: the forward and dQ, which hold a
// query tile and stream the key tiles (Q-stationary), and dK/dV, which holds
// a key tile and streams the query tiles (KV-stationary). The other route of
// each (mma.sync in bf16, the CUDA cores in fp32) is in flash_attention.cu.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py: _fwd_kernel (O and
// the logsumexp L), _bwd_dkdv_kernel (dK, dV) and _bwd_dq_kernel (dQ).
// What they compute, on the public [B, S, H, D] layout (K/V [B, S, Hk, D],
// GQA: query head h reads kv head h / (H / Hk)), bf16 in and out, D 64, 80,
// 96, 128 or 256, s = (q . k) * sm_scale in fp32, causal mask (key j visible to query
// i iff j <= i), softmax in base 2:
//   forward   online softmax over the key tiles; P rounded to bf16 before
//             O += P V; O = acc / l (l == 0 divides by 1) and L = m ln 2 +
//             ln l as fp32 [B, H, S].
//   dK, dV    p = exp(s - L); dV += P^T dO with P rounded to bf16;
//             dS = p * (dO V^T - delta) * sm_scale rounded to bf16;
//             dK += dS^T Q. The query heads of a kv head's group are summed
//             in fp32 in registers, so dK and dV are written once, in bf16.
//   dQ        dS = p * (dO V^T - delta) rounded to bf16; dQ += dS K;
//             dQ * sm_scale at the end.
// delta = rowsum(fp32(dO) fp32(O)) and L come from the wrapper as fp32
// [B, H, S].
//
// What bounds them on an H100: 2 D flops per visible (query, key) pair and
// head for each product, two in the forward (S, PV), four in dK/dV (S^T,
// dP^T, dV, dK), three in dQ (S, dP, dQ): at TinyLlama's shape (B 4, S
// 2048, 32 / 4 heads, D 64, causal) 69, 137 and 103 GFLOP over ~20-30 MB
// of operands, so the tensor cores' 989 TFLOP/s bound them (0.070, 0.139
// and 0.104 ms). Only wgmma reaches that rate.
//
// Design (FlashAttention-3's layout; dQ its own kernel, not atomics):
//   * Block: 384 threads. Warpgroups 0-1 consume, each owning 64 rows of
//     the block's 128-row stationary tile; one producer thread (warp 8)
//     issues the TMA loads; setmaxnreg moves registers from the producer
//     warpgroup (40) to the consumers (232).
//   * The producer loads a unit's stationary tile once, then streams its
//     items through a ring of stages guarded by full / empty mbarriers.
//   * Schedule: the host orders each kernel's units longest first and deals
//     them to one persistent block per SM, each unit to the least-loaded
//     block (ops/flash_attention.py, schedule), so no SM carries much more
//     than the mean. A unit is computed by one block from start to end, so
//     the result does not depend on the schedule and repeats bitwise: no
//     float atomics. The host passes the count of units it dealt and of
//     their items; a launch whose counts differ from the kernel's own
//     decode of the units is refused (check_units).
//   * TMA maps over [B, S, heads, D] rows as 4-D tensors (d, head, s, b), so
//     a box past S zero-fills inside its batch; keys past S are masked in s
//     (a zero-filled key gives logit 0, not -inf), rows past S never
//     written. 128-byte swizzle; D 128 is two 64-wide boxes, D 256 four.
//     D 80 and 96 take two boxes, the second one padded: TMA zero-fills
//     its columns past D without reading them, the products over D stop
//     at D's last 16-wide slice, and the products whose N is D (P V, dS K,
//     P^T dO, dS^T Q) run m64n80k16 / m64n96k16, which read the second box
//     in part: no tensor work past D, one tile layout and one descriptor
//     form for every D, at the price of shared memory for 128 columns.
//     The same tile is read K-major as one product's operand and MN-major
//     as another's.
//   * Forward and dQ (Q-stationary): a unit is (batch, query head, 128-query
//     tile); the producer loads Q (and dO for dQ) into one of two buffers,
//     so the next unit's tile lands while this one is computed, and streams
//     K and V of every key tile at or below the diagonal. The forward runs S
//     = Q K^T on wgmma m64n128k16 (both operands K-major), the online
//     softmax in registers, re-packs P as bf16 A fragments and runs O += P V
//     with V read MN-major, in FlashAttention-3's intra-warpgroup overlap: S
//     of the next key tile is issued with P V of this one, and the softmax
//     runs under P V (PERF.md, Findings, has its time against the schedule
//     that waits for each product). dQ runs S
//     = Q K^T and dP = dO V^T, dS in registers, dQ += dS K with K read
//     MN-major; past D 64 its key tiles are 64 wide, so S, dP and a 64 x 128
//     dQ fit the registers. At D 256 (a 64 x 256 O or dQ is 128 registers
//     a thread) the forward streams 64-key tiles and dQ 32-key ones, and a
//     unit's Q (and dO: 128 KB) has one buffer, not two, so that two (dQ:
//     three) K / V stages fit beside it. L and delta of the warpgroup's
//     rows are read into registers while the unit's Q lands. A key tile
//     wholly above a warpgroup's diagonal is skipped.
//   * dK/dV (KV-stationary): a unit is (batch, kv head, 128-key tile); the
//     producer streams the (Q, dO) tiles of 64 queries of every (query head
//     of the group, query tile at or below the diagonal); its 32 lanes copy
//     the tile's L and delta into the stage beside them with cp.async, which
//     arrives on the stage's full barrier when done. Per item each consumer
//     warpgroup runs S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16 from
//     shared memory, computes p and dS in registers, re-packs P^T and dS^T
//     as bf16 A fragments, and runs dV += P^T dO and dK += dS^T Q with the
//     SAME Q and dO tiles read as MN-major B. dK and dV stay in registers
//     across the unit. At D 256 the two 64 x 256 accumulators would not fit
//     a warpgroup's registers: a unit is 64 keys, both warpgroups compute
//     its S^T and dP^T in full, and each keeps dK and dV of half of D's
//     columns, at 1.5x the products' work. (Splitting the products into
//     commit groups, so that p is computed under dP^T and dS under dV,
//     measured slower on an H100: PERF.md, Findings.)
// TMA needs 16-byte-aligned bases and row strides: the wrapper
// (ops/flash_attention.py, flash_route) sends bf16 tensors that satisfy that
// here and everything else to flash_attention.cu.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t. Each entry returns 0, a cudaError_t from the
// launch, or 10000 + the CUresult of a tensor map that could not be encoded.

#include "flash_head_dims.cuh"
#include "sm90_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;           // queries per work item
constexpr int kThreads = 384;    // 2 consumer warpgroups + 1 producer
constexpr int kConsumerWarps = 8;

// the tiles' width along D: whole 64-wide boxes. D 80 and 96 pad their last
// box, which TMA fills with zeros past D (and reads nothing for); the
// products over D stop at D's last 16-wide slice, and the products whose N
// is D run m64n80 / m64n96, reading the last box in part, so no product
// does work past D.
__host__ __device__ constexpr int pad64(int D) { return (D + 63) / 64 * 64; }

template <int D> struct Cfg {
  static constexpr int kDP = pad64(D);
  // up to D 128 each consumer warpgroup owns 64 of a unit's 128 keys and dK,
  // dV over all of D; at D 256 (two 64 x 256 fp32 accumulators would not fit
  // a warpgroup's registers) both share the unit's 64 keys, each computing
  // S^T and dP^T in full and holding dK, dV for its half of D's columns
  static constexpr bool kSplitD = D > 128;
  static constexpr int kKeys = kSplitD ? 64 : 128;    // keys per unit
  static constexpr int kCols = kSplitD ? D / 2 : D;  // dK, dV columns per warpgroup
  static constexpr int kBoxes = kDP / 64;             // 64-wide boxes along D
  static constexpr int kKVBox = kKeys * kRowBytes;    // 16 KB (8 KB at D 256)
  static constexpr int kQBox = BQ * kRowBytes;        // 8 KB
  static constexpr int kKVBytes = kBoxes * kKVBox;    // one of K, V
  static constexpr int kQBytes = kBoxes * kQBox;      // one of Q, dO
  static constexpr int kStages = D == 64 ? 4 : (kSplitD ? 2 : 3);
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kVecFloats = 2 * BQ;           // L and delta of a stage
  static constexpr int kSmemBytes =
      1024 + 2 * kKVBytes + kStages * (kStageBytes + kVecFloats * 4) + 8 * (2 * kStages + 2);
};

struct Params {
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  bf16* dk;            // [B, S, Hk, D]
  bf16* dv;
  const int* sched;    // [gridDim.x + 1] offsets into the unit ids that follow
  int B, S, H, Hk, G, nq;
  float scale;
  int causal;
};

// a work unit: (batch, kv head, key tile) and its items (query head of the
// group, query tile), the query tiles from the first one that reaches the
// key tile
struct Unit {
  int b, hk, k0, iq0, per_head, items;
};

template <int kKeys>
__host__ __device__ __forceinline__ Unit unit(const Params& p, int u) {
  Unit w;
  const int bh = u % (p.B * p.Hk);
  w.b = bh / p.Hk;
  w.hk = bh % p.Hk;
  w.k0 = u / (p.B * p.Hk) * kKeys;
  w.iq0 = p.causal ? w.k0 / BQ : 0;
  w.per_head = p.nq - w.iq0;
  w.items = p.G * w.per_head;
  return w;
}

// ---------------------------------------------------------------------------
// dK/dV: the KV-stationary kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkdv_sm90(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const Params p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + C::kKVBytes;
  const uint32_t stages = v_s + C::kKVBytes;
  float* const vecs = reinterpret_cast<float*>(base_ptr + 2 * C::kKVBytes +
                                               C::kStages * C::kStageBytes);
  const uint32_t bars = stages + C::kStages * (C::kStageBytes + C::kVecFloats * 4);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  const uint32_t kv_full = bars + 16u * C::kStages, kv_empty = kv_full + 8u;
  auto q_tile = [&](int s) { return stages + static_cast<uint32_t>(s) * C::kStageBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + C::kQBytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 33);  // the producer lanes' copies, and lane 0 with the tx count
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int u_begin = p.sched[blockIdx.x], u_end = p.sched[blockIdx.x + 1];
  const int* const ids = p.sched + gridDim.x + 1;
  if (wg == 2) {
    // producer: warp 8 (its lane 0 issues the TMA loads); warps 9-11 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 288) return;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_q))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_do))
                   : "memory");
    }
    int s = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int i = u_begin; i < u_end; ++i) {
      const Unit w = unit<C::kKeys>(p, ids[i]);
      mbar_wait(kv_empty, kv_phase ^ 1u);
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_load(k_s + j * C::kKVBox, &map_k, 64 * j, w.hk, w.k0, w.b, kv_full);
          tma_load(v_s + j * C::kKVBox, &map_v, 64 * j, w.hk, w.k0, w.b, kv_full);
        }
      }
      kv_phase ^= 1u;
      for (int it = 0; it < w.items; ++it) {
        const int h = w.hk * p.G + it / w.per_head;
        const int q0 = (w.iq0 + it % w.per_head) * BQ;
        mbar_wait(empty(s), phase ^ 1u);
        // L and delta of the tile's queries beside it (0 past S)
        const uint32_t vec = smem_u32(vecs + s * C::kVecFloats);
        const long long row = (static_cast<long long>(w.b) * p.H + h) * p.S + q0;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < p.S;
          cp_async4(vec + 4 * r, p.lse + (in ? row + r : 0), in);
          cp_async4(vec + 4 * (BQ + r), p.delta + (in ? row + r : 0), in);
        }
        cp_async_arrive(full(s));
        if (lane == 0) {
          mbar_expect_tx(full(s), C::kStageBytes);
#pragma unroll
          for (int j = 0; j < C::kBoxes; ++j) {
            tma_load(q_tile(s) + j * C::kQBox, &map_q, 64 * j, h, q0, w.b, full(s));
            tma_load(do_tile(s) + j * C::kQBox, &map_do, 64 * j, h, q0, w.b, full(s));
          }
        }
        if (++s == C::kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 of each unit (at D
  // 256: all 64 keys, dK and dV columns 128 wg .. + 127)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool signals = lane == 0;
  const float c = p.scale * kLog2e;
  const int kw = C::kSplitD ? 0 : 64 * wg;           // this warpgroup's keys in the unit
  const int col0 = C::kSplitD ? C::kCols * wg : 0;   // and its first dK / dV column
  const uint32_t ka = k_s + kw * kRowBytes, va = v_s + kw * kRowBytes;
  const uint32_t cols = (col0 / 64) * C::kQBox;      // that column's box in Q and dO
  int s = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int i = u_begin; i < u_end; ++i) {
    const Unit w = unit<C::kKeys>(p, ids[i]);
    const int kw0 = w.k0 + kw;
    float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
    for (int j = 0; j < C::kCols / 2; ++j) dk[j] = dv[j] = 0.f;
    mbar_wait(kv_full, kv_phase);
    kv_phase ^= 1u;
    for (int it = 0; it < w.items; ++it) {
      const int q0 = (w.iq0 + it % w.per_head) * BQ;
      mbar_wait(full(s), phase);
      // a tile whose queries all precede this warpgroup's keys adds nothing
      if (!(p.causal && kw0 > q0 + BQ - 1)) {
        const uint32_t qa = q_tile(s), oa = do_tile(s);
        float st[32], dpt[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, over D
        wgmma_fence();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * C::kKVBox + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * C::kQBox + (kk % 4) * 32;
          wgmma_ss(st, desc(ka + ko, 16), desc(qa + qo, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * C::kKVBox + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * C::kQBox + (kk % 4) * 32;
          wgmma_ss(dpt, desc(va + ko, 16), desc(oa + qo, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        const float* vec = vecs + s * C::kVecFloats;
        if ((p.causal && kw0 + 63 > q0) || q0 + BQ > p.S || kw0 + 64 > p.S) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kw0 + 16 * warp + g + 8 * (e >> 1);
              const int query = q0 + 8 * j + 2 * t + (e & 1);
              if (key >= p.S || query >= p.S || (p.causal && key > query)) st[4 * j + e] = kNegInf;
            }
          }
        }
        // p = exp(s * scale - L); dS = p * (dP - delta) * scale (the dK form)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            const float pv = ex2(fmaf(st[4 * j + e], c, -vec[qc] * kLog2e));
            dpt[4 * j + e] = pv * (dpt[4 * j + e] - vec[BQ + qc]) * p.scale;
            st[4 * j + e] = pv;
          }
        }
        // dV += P^T dO and dK += dS^T Q over this warpgroup's columns, P^T
        // and dS^T rounded to bf16 in the A fragments, dO and Q read MN-major
        // from the same tiles
        uint32_t pa[4][4], sa[4][4];
        to_a(pa, st);
        to_a(sa, dpt);
        wgmma_fence();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dv, pa[kk], desc(oa + cols + kk * 16 * kRowBytes, C::kQBox));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dk, sa[kk], desc(qa + cols + kk * 16 * kRowBytes, C::kQBox));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
      }
      if (signals) mbar_arrive(empty(s));
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (signals) mbar_arrive(kv_empty);  // K and V of this unit are read
    const long long ks = static_cast<long long>(p.Hk) * D;
    bf16* const dkg = p.dk + (static_cast<long long>(w.b) * p.S * p.Hk + w.hk) * D;
    bf16* const dvg = p.dv + (static_cast<long long>(w.b) * p.S * p.Hk + w.hk) * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kw0 + 16 * warp + g + 8 * hh;
      if (key >= p.S) continue;
#pragma unroll
      for (int j = 0; j < C::kCols / 8; ++j) {
        const long long at = key * ks + col0 + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dkg + at) = pack_bf16(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward and dQ: the Q-stationary kernel
// ---------------------------------------------------------------------------

constexpr int QT = 128;  // queries per unit: 64 per consumer warpgroup

template <int D, bool kDq> struct QCfg {
  static constexpr int kDP = pad64(D);
  // keys per item. dQ holds S, dP and a 64 x D dQ per warpgroup, so its key
  // tiles are 64 wide past D 64; at D 256 32 wide, so that Q and dO (128 KB)
  // and three stages fit in shared memory. The forward's O takes 128
  // registers at D 256, so S there covers 64 keys.
  static constexpr int kKeys = kDq ? (D == 64 ? 128 : D > 128 ? 32 : 64) : (D > 128 ? 64 : 128);
  static constexpr int kQBufs = D > 128 ? 1 : 2;        // buffers of a unit's Q (and dO)
  static constexpr int kBoxes = kDP / 64;               // 64-wide boxes along D
  static constexpr int kQBox = QT * kRowBytes;          // 16 KB
  static constexpr int kQBytes = kBoxes * kQBox;        // one of Q, dO
  static constexpr int kQBuf = (kDq ? 2 : 1) * kQBytes; // a unit's resident tiles
  static constexpr int kKVBox = kKeys * kRowBytes;
  static constexpr int kKVBytes = kBoxes * kKVBox;      // one of K, V
  static constexpr int kStageBytes = 2 * kKVBytes;      // K, then V
  static constexpr int kStages = D == 64 ? 4 : (kDq ? 3 : 2);
  static constexpr int kSmemBytes =
      1024 + kQBufs * kQBuf + kStages * kStageBytes + 8 * (2 * kStages + 4);
};

struct QParams {
  float* lse;          // [B, H, S]: written by the forward, read by dQ
  const float* delta;  // [B, H, S] (dQ)
  bf16* out;           // O or dQ, [B, S, H, D]
  const int* sched;    // [gridDim.x + 1] offsets into the unit ids that follow
  int B, S, H, G, nk;  // nk: key tiles over S
  float scale;
  int causal;
};

// a work unit: (batch, query head, query tile) and its items, the key tiles
// at or below the diagonal (all of them when not causal)
struct QUnit {
  int b, h, q0, n;
};

template <int kKeys>
__host__ __device__ __forceinline__ QUnit q_unit(const QParams& p, int u) {
  QUnit w;
  const int bh = u % (p.B * p.H);
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.q0 = u / (p.B * p.H) * QT;
  const int last = (w.q0 + QT - 1) / kKeys + 1;  // key tiles up to the diagonal
  w.n = p.causal && last < p.nk ? last : p.nk;
  return w;
}

// shared memory: the buffers of a unit's Q (and dO), the ring of K / V
// stages, the barriers. Unit n of a block takes buffer n % kQBufs, with
// phase (n / kQBufs) & 1.
template <int D, bool kDq> struct QSmem {
  using C = QCfg<D, kDq>;
  uint32_t base, bars;
  __device__ explicit QSmem(uint32_t b)
      : base(b), bars(b + C::kQBufs * C::kQBuf + C::kStages * C::kStageBytes) {}
  __device__ uint32_t q(int qb) const { return base + qb * C::kQBuf; }  // dO at + kQBytes
  __device__ uint32_t k(int s) const {
    return base + C::kQBufs * C::kQBuf + s * C::kStageBytes;
  }
  __device__ uint32_t v(int s) const { return k(s) + C::kKVBytes; }
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (C::kStages + s); }
  __device__ uint32_t q_full(int qb) const { return bars + 8u * (2 * C::kStages + qb); }
  __device__ uint32_t q_empty(int qb) const { return bars + 8u * (2 * C::kStages + 2 + qb); }
};

// d (+)= A B^T over D for a warpgroup's 64 rows of A (a K-major tile of QT
// rows at a) and the kKeys rows of B (a K-major tile at b): S = Q K^T, dP =
// dO V^T. The last slice is D's: a padded box's zero columns are skipped.
template <int D, int kKeys>
__device__ __forceinline__ void qs_product(float (&d)[kKeys / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * (QT * kRowBytes) + (kk % 4) * 32;
    const uint32_t bt = (kk / 4) * (kKeys * kRowBytes) + (kk % 4) * 32;
    wgmma_ss(d, desc(a + at, 16), desc(b + bt, 16), kk > 0);
  }
}

// d += A B over the kKeys keys, A the bf16 fragments of P or dS, B a tile of
// kKeys rows of D at b read MN-major: O += P V, dQ += dS K
template <int D, int kKeys>
__device__ __forceinline__ void pv_product(float (&d)[D / 2], const uint32_t (&a)[kKeys / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs(d, a[kk], desc(b + kk * 16 * kRowBytes, kKeys * kRowBytes));
}

// keys past S, and with causal keys past the row, to -1e30 (their p is 0)
template <int N>
__device__ __forceinline__ void mask_keys(float (&st)[N], const int (&row)[2], int k0,
                                          const QParams& p) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      if (key >= p.S || (p.causal && key > row[e >> 1])) st[4 * j + e] = kNegInf;
    }
  }
}

// a warpgroup's 64 x D accumulator, row r times f[r], into the rows of
// [B, S, H, D] bf16 at dst (row stride H D); rows past S not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2],
                                           const int (&row)[2], const float (&f)[2],
                                           const QParams& p) {
  const int t = threadIdx.x & 3;
  const long long rs = static_cast<long long>(p.H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + row[i] * rs + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * i] * f[i], acc[4 * j + 2 * i + 1] * f[i]);
    }
  }
}

// the forward's consumer warpgroup: O and L of its 64 rows of each unit.
// S of key tile kt is issued with P V of key tile kt - 1; its softmax runs
// while P V is in flight, and O is rescaled after P V lands. The steady
// state is straight-line code, so ptxas can match each wait to its commit
// group.
template <int D>
__device__ __forceinline__ void fwd_consumer(const QSmem<D, false>& sm, const QParams& p,
                                             int u_begin, int u_end, const int* ids) {
  using C = QCfg<D, false>;
  constexpr int K = C::kKeys;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool signals = lane == 0;
  const float c = p.scale * kLog2e;
  int s = 0;
  uint32_t phase = 0;
  for (int i = u_begin; i < u_end; ++i) {
    const QUnit w = q_unit<K>(p, ids[i]);
    const int n = i - u_begin, qb = n % C::kQBufs;
    const int qw0 = w.q0 + 64 * wg;
    const int row[2] = {qw0 + 16 * warp + (lane >> 2), qw0 + 16 * warp + (lane >> 2) + 8};
    const uint32_t qa = sm.q(qb) + wg * 64 * kRowBytes;
    float o[D / 2], st[K / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[K / 16][4];
    zero(o);
    mbar_wait(sm.q_full(qb), (n / C::kQBufs) & 1);
    mbar_wait(sm.full(s), phase);
    zero(st);
    wgmma_fence();
    fence_regs(st);
    qs_product<D, K>(st, qa, sm.k(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if ((p.causal && K - 1 > qw0) || K > p.S) mask_keys(st, row, 0, p);
    online_softmax(st, m, l, alpha, c);
    to_a(pa, st);
    int sp = s;
    if (++s == C::kStages) {
      s = 0;
      phase ^= 1u;
    }
    for (int kt = 1; kt < w.n; ++kt) {
      const int k0 = kt * K;
      mbar_wait(sm.full(s), phase);
      zero(st);
      wgmma_fence();
      fence_regs(st);
      fence_regs(o);
      qs_product<D, K>(st, qa, sm.k(s));
      wgmma_commit();
      pv_product<D, K>(o, pa, sm.v(sp));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      if ((p.causal && k0 + K - 1 > qw0) || k0 + K > p.S) mask_keys(st, row, k0, p);
      online_softmax(st, m, l, alpha, c);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (signals) mbar_arrive(sm.empty(sp));
      rescale(o, alpha);
      to_a(pa, st);
      sp = s;
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
    wgmma_fence();
    fence_regs(o);
    pv_product<D, K>(o, pa, sm.v(sp));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (signals) mbar_arrive(sm.empty(sp));
    if (signals) mbar_arrive(sm.q_empty(qb));  // Q of this unit is read
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float safe = sum == 0.f ? 1.f : sum;
      inv[r] = 1.f / safe;
      if ((lane & 3) == 0 && row[r] < p.S)
        p.lse[(static_cast<long long>(w.b) * p.H + w.h) * p.S + row[r]] = m[r] * kLn2 + logf(safe);
    }
    store_rows<D>(p.out + (static_cast<long long>(w.b) * p.S * p.H + w.h) * D, o, row, inv, p);
  }
}

// the dQ consumer warpgroup: dQ of its 64 rows of each unit
template <int D>
__device__ __forceinline__ void dq_consumer(const QSmem<D, true>& sm, const QParams& p,
                                            int u_begin, int u_end, const int* ids) {
  using C = QCfg<D, true>;
  constexpr int K = C::kKeys;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool signals = lane == 0;
  const float c = p.scale * kLog2e;
  const float scale[2] = {p.scale, p.scale};
  int s = 0;
  uint32_t phase = 0;
  for (int i = u_begin; i < u_end; ++i) {
    const QUnit w = q_unit<K>(p, ids[i]);
    const int n = i - u_begin, qb = n % C::kQBufs;
    const int qw0 = w.q0 + 64 * wg;
    const int row[2] = {qw0 + 16 * warp + (lane >> 2), qw0 + 16 * warp + (lane >> 2) + 8};
    // L (in base 2) and delta of this thread's rows, read while Q lands
    const long long vec = (static_cast<long long>(w.b) * p.H + w.h) * p.S;
    float L2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < p.S;
      L2[r] = in ? p.lse[vec + row[r]] * kLog2e : 0.f;
      dl[r] = in ? p.delta[vec + row[r]] : 0.f;
    }
    const uint32_t qa = sm.q(qb) + wg * 64 * kRowBytes, oa = qa + C::kQBytes;
    float dq[D / 2];
    zero(dq);
    mbar_wait(sm.q_full(qb), (n / C::kQBufs) & 1);
    for (int kt = 0; kt < w.n; ++kt) {
      const int k0 = kt * K;
      mbar_wait(sm.full(s), phase);
      // a key tile past every query of this warpgroup adds nothing
      if (!(p.causal && k0 > qw0 + 63)) {
        float st[K / 2], dp[K / 2];
        zero(st);
        zero(dp);
        wgmma_fence();
        fence_regs(st);
        fence_regs(dp);
        qs_product<D, K>(st, qa, sm.k(s));
        qs_product<D, K>(dp, oa, sm.v(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        if ((p.causal && k0 + K - 1 > qw0) || k0 + K > p.S) mask_keys(st, row, k0, p);
        // dS = p (dP - delta), rounded to bf16 in the A fragments
#pragma unroll
        for (int j = 0; j < K / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = ex2(fmaf(st[4 * j + e], c, -L2[e >> 1]));
            dp[4 * j + e] = pv * (dp[4 * j + e] - dl[e >> 1]);
          }
        }
        uint32_t sa[K / 16][4];
        to_a(sa, dp);
        wgmma_fence();
        fence_regs(dq);
        pv_product<D, K>(dq, sa, sm.k(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(sa);
      }
      if (signals) mbar_arrive(sm.empty(s));
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (signals) mbar_arrive(sm.q_empty(qb));  // Q and dO of this unit are read
    store_rows<D>(p.out + (static_cast<long long>(w.b) * p.S * p.H + w.h) * D, dq, row, scale, p);
  }
}

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
    flash_q_sm90(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do, const QParams p) {
  using C = QCfg<D, kDq>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  const QSmem<D, kDq> sm((smem_u32(smem_raw) + 1023u) & ~1023u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(sm.q_full(qb), 1);
      mbar_init(sm.q_empty(qb), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int u_begin = p.sched[blockIdx.x], u_end = p.sched[blockIdx.x + 1];
  const int* const ids = p.sched + gridDim.x + 1;
  if (threadIdx.x >= 256) {
    // producer: thread 256 issues the TMA loads; the rest of its warpgroup leaves
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_q))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v))
                 : "memory");
    if constexpr (kDq)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_do))
                   : "memory");
    int s = 0;
    uint32_t phase = 0;
    for (int i = u_begin; i < u_end; ++i) {
      const QUnit w = q_unit<C::kKeys>(p, ids[i]);
      const int n = i - u_begin, qb = n % C::kQBufs, hk = w.h / p.G;
      mbar_wait(sm.q_empty(qb), ((n / C::kQBufs) & 1) ^ 1u);
      mbar_expect_tx(sm.q_full(qb), C::kQBuf);
#pragma unroll
      for (int j = 0; j < C::kBoxes; ++j) {
        tma_load(sm.q(qb) + j * C::kQBox, &map_q, 64 * j, w.h, w.q0, w.b, sm.q_full(qb));
        if constexpr (kDq)
          tma_load(sm.q(qb) + C::kQBytes + j * C::kQBox, &map_do, 64 * j, w.h, w.q0, w.b,
                   sm.q_full(qb));
      }
      for (int kt = 0; kt < w.n; ++kt) {
        mbar_wait(sm.empty(s), phase ^ 1u);
        mbar_expect_tx(sm.full(s), C::kStageBytes);
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_load(sm.k(s) + j * C::kKVBox, &map_k, 64 * j, hk, kt * C::kKeys, w.b, sm.full(s));
          tma_load(sm.v(s) + j * C::kKVBox, &map_v, 64 * j, hk, kt * C::kKeys, w.b, sm.full(s));
        }
        if (++s == C::kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries q0 + 64 wg .. + 63 of each unit
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if constexpr (kDq) {
    dq_consumer<D>(sm, p, u_begin, u_end, ids);
  } else {
    fwd_consumer<D>(sm, p, u_begin, u_end, ids);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The host deals the units that it counts from its own copy of the tiles
// (ops/flash_attention.py, SM90_TILES and unit_lengths); the kernel decodes
// them with the tiles here. A schedule of another number of units, or of
// items in all, is refused, so tiles that drift apart raise on the host
// instead of leaving rows unwritten. items_of(u): the items of unit u.
template <class ItemsOf>
int check_units(long long want_units, int units, int items, ItemsOf items_of) {
  if (units != want_units) return static_cast<int>(cudaErrorInvalidValue);
  long long sum = 0;
  for (int u = 0; u < units; ++u) sum += items_of(u);
  return sum == items ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, Params p, int grid,
           int units, int items, cudaStream_t st) {
  constexpr int kKeys = Cfg<D>::kKeys;
  int err = check_units(static_cast<long long>((p.S + kKeys - 1) / kKeys) * p.B * p.Hk, units,
                        items, [&](int u) { return unit<kKeys>(p, u).items; });
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mdo;
  err = bshd_map(&mq, q, p.B, p.S, p.H, D, BQ);
  if (err == 0) err = bshd_map(&mk, k, p.B, p.S, p.Hk, D, kKeys);
  if (err == 0) err = bshd_map(&mv, v, p.B, p.S, p.Hk, D, kKeys);
  if (err == 0) err = bshd_map(&mdo, dout, p.B, p.S, p.H, D, BQ);
  if (err != 0) return err;
  auto kern = flash_dkdv_sm90<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Cfg<D>::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, Cfg<D>::kSmemBytes, st>>>(mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDq>
int launch_q(const void* q, const void* k, const void* v, const void* dout, int Hk, QParams p,
             int grid, int units, int items, cudaStream_t st) {
  using C = QCfg<D, kDq>;
  p.nk = (p.S + C::kKeys - 1) / C::kKeys;
  int err = check_units(static_cast<long long>((p.S + QT - 1) / QT) * p.B * p.H, units, items,
                        [&](int u) { return q_unit<C::kKeys>(p, u).n; });
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mdo;
  err = bshd_map(&mq, q, p.B, p.S, p.H, D, QT);
  if (err == 0) err = bshd_map(&mk, k, p.B, p.S, Hk, D, C::kKeys);
  if (err == 0) err = bshd_map(&mv, v, p.B, p.S, Hk, D, C::kKeys);
  if (err == 0) err = kDq ? bshd_map(&mdo, dout, p.B, p.S, p.H, D, QT) : 0;
  if (err != 0) return err;
  if (!kDq) mdo = mq;  // unread
  auto kern = flash_q_sm90<D, kDq>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, C::kSmemBytes, st>>>(mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

// the forward (dq 0) or dQ (dq 1) at head dim D
int run_q(const void* q, const void* k, const void* v, const void* dout, int Hk, int D, int dq,
          QParams p, int grid, int units, int items, cudaStream_t st) {
  if (p.B <= 0 || Hk <= 0 || p.H % Hk != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / Hk;
#define FLASH_Q(DIM)                                                                \
  if (D == DIM)                                                                     \
    return dq ? launch_q<DIM, true>(q, k, v, dout, Hk, p, grid, units, items, st)   \
              : launch_q<DIM, false>(q, k, v, dout, Hk, p, grid, units, items, st);
  FLASH_HEAD_DIMS(FLASH_Q)
#undef FLASH_Q
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// O [B, S, H, D] bf16 and L fp32 [B, H, S] for bf16 q [B, S, H, D] and k, v
// [B, S, Hk, D] (D 64, 80, 96, 128 or 256); sched, units and items as for dK/dV over the
// forward's units (ops/flash_attention.py, unit_lengths)
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                        float* lse, const int* sched, int grid, int units,
                                        int items, int B, int S, int H, int Hk, int D,
                                        float scale, int causal, void* stream) {
  QParams p{};
  p.lse = lse;
  p.out = static_cast<bf16*>(o);
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.H = H;
  p.scale = scale;
  p.causal = causal;
  return run_q(q, k, v, nullptr, Hk, D, 0, p, grid, units, items,
               static_cast<cudaStream_t>(stream));
}

// dQ [B, S, H, D] bf16 from bf16 q, dO and k, v, fp32 L and delta [B, H, S]
extern "C" int flash_attention_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dq, const int* sched,
                                           int grid, int units, int items, int B, int S, int H,
                                           int Hk, int D, float scale, int causal, void* stream) {
  QParams p{};
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.out = static_cast<bf16*>(dq);
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.H = H;
  p.scale = scale;
  p.causal = causal;
  return run_q(q, k, v, dout, Hk, D, 1, p, grid, units, items,
               static_cast<cudaStream_t>(stream));
}

// dK, dV for bf16 q, dO [B, S, H, D] and k, v [B, S, Hk, D] (D as above);
// sched: grid + 1 offsets, then the unit ids (ops/flash_attention.py,
// schedule), one block per offset pair; units and items: how many units the
// host dealt and their items in all (check_units)
extern "C" int flash_attention_bwd_dkdv_sm90(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv,
                                             const int* sched, int grid, int units, int items,
                                             int B, int S, int H, int Hk, int D, float scale,
                                             int causal, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.lse = lse;
  p.delta = delta;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hk = Hk;
  p.G = H / Hk;
  p.nq = (S + BQ - 1) / BQ;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DKDV(DIM) \
  if (D == DIM) return launch<DIM>(q, k, v, dout, p, grid, units, items, st);
  FLASH_HEAD_DIMS(FLASH_DKDV)
#undef FLASH_DKDV
  return static_cast<int>(cudaErrorInvalidValue);
}
