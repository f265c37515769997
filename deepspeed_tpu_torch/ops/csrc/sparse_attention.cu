// Block-sparse attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/pallas/sparse_attention.py:
//   sparse_attention_fwd  <- _kernel (flash forward over the compacted
//                                      nonzero blocks of a static layout)
//
// What it computes, on the public [B, S, H, D] layout, read in place through
// its row stride H * D (the JAX wrapper's transpose to [B, H, S, D] is not
// made): query row i of head h lies in q-block iq = i / block and attends to
// the keys of the layout columns cols[h, iq, 0 .. cnt[h, iq]) in ascending
// order. s = (q . k) * sm_scale in fp32; keys the row's q-block does not list
// and, under causal, keys past i are masked with -1e30 and contribute an
// exact 0; the online softmax runs in fp32; P is rounded to V's dtype before
// the fp32-accumulated PV product; o = acc / l, and o = 0 for a row with no
// live key. cols and cnt come from the wrapper's compaction of the
// causal-intersected layout (int32 [H, NQ, NJ] and [H, NQ]), so no listed
// column lies above the diagonal.
//
// What bounds it on an H100: 4 * D flops per (query, key) pair of each live
// (q-block, column) block against q, k, v and o moved once: at block 64 and
// a few live columns per row that is ~100-300 flops per byte, near the
// card's ridge (~295 bf16 flops per byte), so neither bound dominates at the
// ideal; this design re-reads K and V once per item that walks them and
// computes on mma.sync, and is far from both. bf16 tensors that TMA can
// describe take the wgmma route instead (sparse_attention_sm90.cu, chosen
// by ops/sparse_attention.py::sparse_route); this one keeps fp32 and the
// rest.
//
// Design: the tile of the port's flash forward (flash_fwd_mma), with its
// causal loop over key tiles replaced by a walk of a column list
// (sparse_tiles.cuh).
//   * bf16: one block of four warps per (64-row query tile, head, batch),
//     each warp 16 rows; Q in registers (read from shared memory for each
//     product past D 128), K/V 64-key tiles double-buffered with cp.async
//     in runs of 16 rows, logits, (m, l) and O in registers, base-2 softmax
//     (attention_tiles.cuh).
//   * fp32: the flash forward's CUDA-core tile (32 x 32 tiles multiplied in
//     shared memory by eight warps), items of 32 query rows.
//   * the walk: at a block no smaller than the item's rows the block reads
//     cnt and cols of its (head, q-block) from device memory, each column
//     block / keys tiles; under causal the key tiles wholly above the query
//     tile's last row (only the diagonal column's later tiles when block >
//     the tile: a suffix of the ascending list) are dropped. At a smaller
//     block (16 and 32 in bf16, 16 in fp32) the item walks the union of its
//     q-blocks' lists with each column's row mask (ucols, umask, ucnt: the
//     wrapper's union_columns), keys / block columns a tile. A tile that
//     masks any key sets those logits to -1e30 and their p to an exact 0,
//     so a row that meets a tile, or a whole item, with no live key keeps
//     l = 0 and writes zeros; a query tile with no tile writes zeros.
//   * blocks and head dims of sparse_tiles.cuh; anything else is refused.
//     Rows past S (S need not be a multiple of the item's rows below it)
//     load as zero and are not written.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; the entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "sparse_tiles.cuh"

namespace {

struct Problem {
  const void* q;      // [B, S, H, D]
  const void* k;      // [B, S, H, D]
  const void* v;      // [B, S, H, D]
  void* o;            // [B, S, H, D]
  const int* cols;    // [H, NQ, NJ] ascending live columns per (head, q-block)
  const int* cnt;     // [H, NQ]
  const int* ucols;   // [H, UT, NU] each item's ascending union of columns
  const int* umask;   // [H, UT, NU] beside each, the item's q-blocks that list it
  const int* ucnt;    // [H, UT]
  int S, H, block, nq, nj, ut, nu;
  float scale;
  int causal;
};

// an item's walk: n key tiles of BK keys, each of G entries of 1 << shift
// keys (G = 1 at a block of BK or more: tile kt is keys (kt % per) BK ..
// of column kt / per)
struct Walk {
  const int* cols;   // the item's list
  const int* masks;  // its union's row masks; null at a block of BK or more
  int n, G, R, shift, per;
};

template <int BQ, int BK>
__device__ __forceinline__ Walk walk_of(const Problem& P, int h, int q0) {
  Walk w;
  w.shift = sparse_entry_shift(P.block, BK);
  w.G = BK >> w.shift;
  w.R = BQ >> w.shift;
  if (P.block < BQ) {
    const long long row = static_cast<long long>(h) * P.ut + q0 / BQ;
    w.cols = P.ucols + row * P.nu;
    w.masks = P.umask + row * P.nu;
    w.per = 1;
    w.n = (P.ucnt[row] + w.G - 1) / w.G;
  } else {
    const long long row = static_cast<long long>(h) * P.nq + q0 / P.block;
    w.cols = P.cols + row * P.nj;
    w.masks = nullptr;
    w.per = P.block / BK;
    w.n = P.cnt[row] * w.per;
    if (P.causal) {
      while (w.n > 0 && w.cols[(w.n - 1) / w.per] * P.block + ((w.n - 1) % w.per) * BK > q0 + BQ - 1)
        --w.n;
    }
  }
  return w;
}

// first key of entry g of tile kt; uni: the walk is a union's (w.masks set)
template <int BK>
__device__ __forceinline__ int entry_key(const Walk& w, const Problem& P, int kt, int g,
                                         bool uni) {
  if (uni) return w.cols[kt * w.G + g] * P.block;
  return w.cols[kt / w.per] * P.block + (kt % w.per) * BK;
}

// first key of the 16-row run i of tile kt (its rows 16 i .. 16 i + 15)
template <int BK>
__device__ __forceinline__ int run_key(const Walk& w, const Problem& P, int kt, int i) {
  return entry_key<BK>(w, P, kt, (16 * i) >> w.shift, true) + ((16 * i) & ((1 << w.shift) - 1));
}

// tile kt: the first key of each of its entries, their row bits (4 g + r:
// q-block r of the item lists entry g), whether it crosses the item's first
// row q0 under causal and whether it masks any key
template <int BK>
__device__ __forceinline__ void describe_tile(const Walk& w, const Problem& P, int kt, int q0,
                                              int (&k0)[4], int& bits, bool& crossing,
                                              bool& masked) {
  int last = 0;
  bits = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    k0[g] = 0;
    if (g < w.G) {
      k0[g] = entry_key<BK>(w, P, kt, g, w.masks != nullptr);
      last = k0[g] + (1 << w.shift) - 1;
      bits |= (w.masks ? w.masks[kt * w.G + g] : 1) << (4 * g);
    }
  }
  crossing = P.causal && last > q0;
  masked = crossing || (w.masks && sparse_bits_partial(bits, w.G, w.R));
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core tile
// ---------------------------------------------------------------------------

template <int D> struct F32Tiles {
  static constexpr int BQ = Tiles<float>::BQ, BK = Tiles<float>::BK;
  static constexpr int LDT = D + Tiles<float>::PAD, LDS = BK + 4;
  static constexpr int LDP = BK + Tiles<float>::PAD, LDO = D + 4;
  static constexpr int bytes =
      (3 * BQ * LDT + BQ * LDS + BQ * LDP + BQ * LDO + 3 * BQ) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) sparse_fwd_f32(Problem P) {
  using TL = F32Tiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK;
  constexpr int LDT = TL::LDT, LDS = TL::LDS, LDP = TL::LDP, LDO = TL::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + BQ * LDT;
  float* v_s = k_s + BK * LDT;
  float* s_s = v_s + BK * LDT;
  float* p_s = s_s + BQ * LDS;
  float* o_s = p_s + BQ * LDP;
  float* m_s = o_s + BQ * LDO;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int S = P.S;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const long long rs = static_cast<long long>(P.H) * D;
  const long long off = (static_cast<long long>(b) * S * P.H + h) * D;
  const float* qg = static_cast<const float*>(P.q) + off;
  const float* kg = static_cast<const float*>(P.k) + off;
  const float* vg = static_cast<const float*>(P.v) + off;
  float* og = static_cast<float*>(P.o) + off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk wk = walk_of<BQ, BK>(P, h, q0);
  const int in_entry = (1 << wk.shift) - 1;

  load_tile<float, D, BQ>(q_s, LDT, qg, rs, q0, S);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) o_s[(i / D) * LDO + i % D] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int kt = 0; kt < wk.n; ++kt) {
    int k0[4], bits;
    bool crossing, masked;
    describe_tile<BK>(wk, P, kt, q0, k0, bits, crossing, masked);
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    if (!wk.masks) {  // BK consecutive keys
      load_tile<float, D, BK>(k_s, LDT, kg, rs, k0[0], S);
      load_tile<float, D, BK>(v_s, LDT, vg, rs, k0[0], S);
    } else {
#pragma unroll 1
      for (int i = 0; i < BK / 16; ++i) {
        const int run = run_key<BK>(wk, P, kt, i);
        load_tile<float, D, 16>(k_s + 16 * i * LDT, LDT, kg, rs, run, S);
        load_tile<float, D, 16>(v_s + 16 * i * LDT, LDT, vg, rs, run, S);
      }
    }
    __syncthreads();
    gemm<float, BQ, BK, D, false, true, false>(q_s, LDT, k_s, LDT, s_s, LDS);
    __syncthreads();
    // online softmax, one warp per row; lane u of the row is the tile's key u
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q0 + r;
      float x[BK / 32];
      bool live[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int col = lane + 32 * u, g = col >> wk.shift;
        const int kpos = (g == 0 ? k0[0] : k0[1]) + (col & in_entry);  // G <= 2 here
        live[u] = !masked || (((bits >> (4 * g + (r >> wk.shift))) & 1) &&
                              !(crossing && kpos > qpos));
        x[u] = live[u] ? s_s[r * LDS + col] * P.scale : kNegInf;
        mx = fmaxf(mx, x[u]);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float pr = live[u] ? expf(x[u] - m_new) : 0.f;
        sum += pr;
        p_s[r * LDP + lane + 32 * u] = pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D;
      o_s[r * LDO + i - r * D] *= a_s[r];
    }
    __syncthreads();
    gemm<float, BQ, D, BK, false, false, true>(p_s, LDP, v_s, LDT, o_s, LDO);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float l = l_s[r];
    if (q0 + r < S) og[(q0 + r) * rs + d] = o_s[r * LDO + d] / (l == 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, register-resident tiles
// ---------------------------------------------------------------------------

template <int D> struct MmaTiles {
  static constexpr int LD = D + 8, BQ = 64, BK = 64;
  // past D 128 the fragments of Q are read from shared memory for each
  // product instead of held in registers beside a 16 x D accumulator
  static constexpr bool kQRegs = D <= 128;
  static constexpr int TILE = 64 * LD;      // elements of a 64-row tile
  static constexpr int bytes = 5 * TILE * 2;  // Q + double-buffered K, V
};

// kUnion: the item walks a union of q-blocks' lists (a block under 64);
// else consecutive keys whose only mask is the diagonal tile's, compiled
// apart so that this walk keeps the registers and code it had alone
template <int D, bool kUnion>
__global__ void __launch_bounds__(kMmaThreads) sparse_fwd_mma(Problem P) {
  using TL = MmaTiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, KD = D / 16, NS = BK / 8, NO = D / 8;
  constexpr int QF = TL::kQRegs ? KD : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + TL::TILE;  // buffer i: K at kv_s + 2i TILE, V at + (2i + 1) TILE

  const int S = P.S;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = static_cast<long long>(P.H) * D;
  const long long off = (static_cast<long long>(b) * S * P.H + h) * D;
  const bf16* qg = static_cast<const bf16*>(P.q) + off;
  const bf16* kg = static_cast<const bf16*>(P.k) + off;
  const bf16* vg = static_cast<const bf16*>(P.v) + off;
  bf16* og = static_cast<bf16*>(P.o) + off;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float c = P.scale * kLog2e;
  const Walk wk = walk_of<BQ, BK>(P, h, q0);
  const int n_kt = wk.n;
  const uint32_t tri = kUnion ? sparse_triangle(warp, lane, wk.shift) : 0u;

  if (n_kt == 0) {  // no live column for these rows: o = 0
    for (int i = threadIdx.x; i < BQ * D / 8; i += kMmaThreads) {
      const int r = i / (D / 8), e = (i - r * (D / 8)) * 8;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(og + (q0 + r) * rs + e) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // the K and V rows of tile kt into buffer `at`: BK consecutive keys at a
  // block of BK or more, else in runs of 16 rows
  auto load_kv = [&](bf16* at, int kt) {
    if (!kUnion) {
      const int k0 = entry_key<BK>(wk, P, kt, 0, false);
      load_rows<D, BK>(at, kg, rs, k0, S);
      load_rows<D, BK>(at + TL::TILE, vg, rs, k0, S);
      return;
    }
#pragma unroll 1  // unrolled, the runs' keys stay live beside O and S (D 64 spills)
    for (int i = 0; i < BK / 16; ++i) {
      const int k0 = run_key<BK>(wk, P, kt, i);
      load_rows<D, 16>(at + 16 * i * LD, kg, rs, k0, S);
      load_rows<D, 16>(at + TL::TILE + 16 * i * LD, vg, rs, k0, S);
    }
  };
  load_rows<D, BQ>(q_s, qg, rs, q0, S);
  load_kv(kv_s, 0);
  cp_commit();
  uint32_t qf[QF][4];
  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // l: this thread's columns

  for (int kt = 0; kt < n_kt; ++kt) {
    const bool prefetch = kt + 1 < n_kt;
    if (prefetch) {  // the next K/V tile lands while this one is used
      load_kv(kv_s + 2 * ((kt + 1) & 1) * TL::TILE, kt + 1);
      cp_commit();
    }
    int k0[4], bits = 1;
    bool crossing, masked;
    if (kUnion) {
      describe_tile<BK>(wk, P, kt, q0, k0, bits, crossing, masked);
    } else {
      k0[0] = entry_key<BK>(wk, P, kt, 0, false);
      crossing = masked = P.causal && k0[0] + BK - 1 > q0;  // the diagonal tile
    }
    const uint32_t live =
        kUnion && masked ? sparse_live_word(warp, q0, k0, bits, wk.G, crossing, wk.shift, tri)
                         : ~0u;
    cp_wait_prefetch(prefetch);
    __syncthreads();
    if (TL::kQRegs && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) a_frag(qf[kk % QF], q_s, LD, warp * 16, kk * 16);
    }
    const bf16* k_s = kv_s + 2 * (kt & 1) * TL::TILE;
    const bf16* v_s = k_s + TL::TILE;
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qs_f[4];
      if (!TL::kQRegs) a_frag(qs_f, q_s, LD, warp * 16, kk * 16);
      const uint32_t(&qk)[4] = TL::kQRegs ? qf[kk % QF] : qs_f;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        b_rows(r, k_s, LD, np * 16, kk * 16);
        mma16816(sc[2 * np], qk, r[0], r[1]);
        mma16816(sc[2 * np + 1], qk, r[2], r[3]);
      }
    }
    if (masked) {  // entries the warp's q-block does not list; keys past the row
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool dead = kUnion ? !((live >> (4 * j + x)) & 1u)
                                   : k0[0] + j * 8 + 2 * t + (x & 1) > row[x >> 1];
          if (dead) sc[j][x] = kNegInf;
        }
      }
    }
    // online softmax on the fragments
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float row_max = quad_max(mx[i]);
      const float m_new = fmaxf(m_r[i], row_max * c);
      // a row that has met no live key yet (its logits here all masked, its
      // max near -1e30, where 2^(s c - m) would be 1) takes p = 2^-inf = 0
      neg_m[i] = kUnion && l_r[i] == 0.f && row_max <= 0.5f * kNegInf
                     ? __int_as_float(0xff800000)
                     : -m_new;
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], c, neg_m[e >> 1]));
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }
    }
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
    // O += P V with P rounded to V's dtype in the A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, sc, kk);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        b_cols(r, v_s, LD, kk * 16, dp * 16);
        mma16816(o[2 * dp], pa, r[0], r[1]);
        mma16816(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = quad_sum(l_r[i]);
    l = l == 0.f ? 1.f : l;
    if (row[i] >= S) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      *reinterpret_cast<uint32_t*>(og + row[i] * rs + d * 8 + 2 * t) =
          pack_bf16(o[d][2 * i] / l, o[d][2 * i + 1] / l);
    }
  }
}

template <void (*KERN)(Problem)>
int start(const Problem& P, dim3 grid, int threads, int bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  KERN<<<grid, threads, bytes, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [B, S, H, D] (fp32 or bf16, D of SPARSE_HEAD_DIMS) over a
// layout of block `block` (SPARSE_BLOCKS, dividing S, nq = S / block). At a
// block no smaller than the item's rows (64 in bf16, 32 in fp32): cols
// int32 [H, nq, nj], cnt int32 [H, nq]; below it: ucols, umask int32 [H, ut,
// nu], ucnt int32 [H, ut] (the union of each item's q-blocks' columns, ut =
// ceil(S / rows), nu a multiple of rows / block)
extern "C" int sparse_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const int* cols, const int* cnt, const int* ucols,
                                    const int* umask, const int* ucnt, int B, int S, int H,
                                    int D, int block, int nq, int nj, int ut, int nu,
                                    float scale, int causal, int is_bf16, void* stream) {
  const int rows = is_bf16 ? MmaTiles<64>::BQ : F32Tiles<64>::BQ;
  const int nt = (S + rows - 1) / rows;
  const bool uni = block < rows;
  if (B <= 0 || H <= 0 || S <= 0 || !sparse_block_built(block) || S % block != 0 ||
      nq != S / block ||
      (uni ? (ut != nt || nu <= 0 || nu % (rows / block) != 0 || !ucols || !umask || !ucnt)
           : (nj <= 0 || !cols || !cnt)))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem P{q, k, v, o, cols, cnt, ucols, umask, ucnt, S, H, block, nq, nj, ut, nu, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nt, H, B);
  return with_sparse_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (is_bf16)
      return uni ? start<sparse_fwd_mma<kD, true>>(P, grid, kMmaThreads, MmaTiles<kD>::bytes, st)
                 : start<sparse_fwd_mma<kD, false>>(P, grid, kMmaThreads, MmaTiles<kD>::bytes, st);
    return start<sparse_fwd_f32<kD>>(P, grid, kThreads, F32Tiles<kD>::bytes, st);
  });
}
