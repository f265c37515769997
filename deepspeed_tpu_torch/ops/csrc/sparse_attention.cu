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
// order. s = (q . k) * sm_scale in fp32; under causal, keys past i are
// masked with -1e30 and contribute an exact 0; the online softmax runs in
// fp32; P is rounded to V's dtype before the fp32-accumulated PV product;
// o = acc / l, and o = 0 for a row with no live column (cnt == 0). cols and
// cnt come from the wrapper's compaction of the causal-intersected layout
// (int32 [H, NQ, NJ] and [H, NQ]), so no listed column lies above the
// diagonal.
//
// What bounds it on an H100: 4 * D flops per (query, key) pair of each live
// (q-block, column) block against q, k, v and o moved once: at block 64 and
// a few live columns per row that is ~100-300 flops per byte, near the
// card's ridge (~295 bf16 flops per byte), so neither bound dominates at the
// ideal; this design re-reads K and V once per live pair and computes on
// mma.sync, and is far from both. bf16 tensors that TMA can describe take
// the wgmma route instead (sparse_attention_sm90.cu, chosen by
// ops/sparse_attention.py::sparse_route); this one keeps fp32 and the rest.
//
// Design: the tile of the port's flash forward (flash_fwd_mma), with its
// causal loop over key tiles replaced by the layout's column list.
//   * bf16: one block of four warps per (64-row query tile, head, batch),
//     each warp 16 rows; Q in registers, K/V 64-key tiles double-buffered
//     with cp.async, logits, (m, l) and O in registers, base-2 softmax
//     (attention_tiles.cuh). Each layout column gives block / 64 key tiles.
//   * fp32: the flash forward's CUDA-core tile (32 x 32 tiles multiplied in
//     shared memory by eight warps), each layout column block / 32 tiles.
//   * the block reads cnt and cols of its (head, q-block) from device
//     memory; under causal the key tiles wholly above the query tile's last
//     row (only the diagonal column's later tiles when block > the tile: a
//     suffix of the ascending list) are dropped, so every row has a live key
//     in every tile it visits and the -1e30 arithmetic never meets a fully
//     masked row; a query tile with no live column writes zeros.
//   * block 64 and 128, D 64 and 128; the wrapper refuses anything else.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; the entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

struct Problem {
  const void* q;    // [B, S, H, D]
  const void* k;    // [B, S, H, D]
  const void* v;    // [B, S, H, D]
  void* o;          // [B, S, H, D]
  const int* cols;  // [H, NQ, NJ] ascending live columns per (head, q-block)
  const int* cnt;   // [H, NQ]
  int S, H, block, nq, nj;
  float scale;
  int causal;
};

// first key of tile j of a column list, each column split into block / BK
// tiles of BK keys
template <int BK>
__device__ __forceinline__ int tile_k0(const int* cols, int block, int j) {
  const int per = block / BK;
  return cols[j / per] * block + (j % per) * BK;
}

// tiles the query tile [q0, q0 + BQ) visits
template <int BQ, int BK>
__device__ __forceinline__ int live_tiles(const Problem& P, const int* cols, int cnt,
                                          int q0) {
  int n = cnt * (P.block / BK);
  if (P.causal) {
    while (n > 0 && tile_k0<BK>(cols, P.block, n - 1) > q0 + BQ - 1) --n;
  }
  return n;
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
  const long long lrow = static_cast<long long>(h) * P.nq + q0 / P.block;
  const int* cols = P.cols + lrow * P.nj;
  const int n_kt = live_tiles<BQ, BK>(P, cols, P.cnt[lrow], q0);

  load_tile<float, D, BQ>(q_s, LDT, qg, rs, q0, S);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) o_s[(i / D) * LDO + i % D] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = tile_k0<BK>(cols, P.block, kt);
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    load_tile<float, D, BK>(k_s, LDT, kg, rs, k0, S);
    load_tile<float, D, BK>(v_s, LDT, vg, rs, k0, S);
    __syncthreads();
    gemm<float, BQ, BK, D, false, true, false>(q_s, LDT, k_s, LDT, s_s, LDS);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q0 + r;
      float x[BK / 32];
      bool live[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int kpos = k0 + lane + 32 * u;
        live[u] = !P.causal || kpos <= qpos;
        x[u] = live[u] ? s_s[r * LDS + lane + 32 * u] * P.scale : kNegInf;
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
    og[(q0 + r) * rs + d] = o_s[r * LDO + d] / (l == 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, register-resident tiles
// ---------------------------------------------------------------------------

template <int D> struct MmaTiles {
  static constexpr int LD = D + 8, BQ = 64, BK = 64;
  static constexpr int TILE = 64 * LD;      // elements of a 64-row tile
  static constexpr int bytes = 5 * TILE * 2;  // Q + double-buffered K, V
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads) sparse_fwd_mma(Problem P) {
  using TL = MmaTiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, KD = D / 16, NS = BK / 8, NO = D / 8;
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
  const long long lrow = static_cast<long long>(h) * P.nq + q0 / P.block;
  const int* cols = P.cols + lrow * P.nj;
  const int n_kt = live_tiles<BQ, BK>(P, cols, P.cnt[lrow], q0);

  if (n_kt == 0) {  // no live column for these rows: o = 0
    for (int i = threadIdx.x; i < BQ * D / 8; i += kMmaThreads) {
      const int r = i / (D / 8), e = (i - r * (D / 8)) * 8;
      *reinterpret_cast<uint4*>(og + (q0 + r) * rs + e) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  load_rows<D, BQ>(q_s, qg, rs, q0, S);
  {
    const int k0 = tile_k0<BK>(cols, P.block, 0);
    load_rows<D, BK>(kv_s, kg, rs, k0, S);
    load_rows<D, BK>(kv_s + TL::TILE, vg, rs, k0, S);
  }
  cp_commit();
  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // l: this thread's columns

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = tile_k0<BK>(cols, P.block, kt);
    const bool prefetch = kt + 1 < n_kt;
    if (prefetch) {  // the next K/V tile lands while this one is used
      const int k1 = tile_k0<BK>(cols, P.block, kt + 1);
      bf16* nxt = kv_s + 2 * ((kt + 1) & 1) * TL::TILE;
      load_rows<D, BK>(nxt, kg, rs, k1, S);
      load_rows<D, BK>(nxt + TL::TILE, vg, rs, k1, S);
      cp_commit();
    }
    cp_wait_prefetch(prefetch);
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) a_frag(qf[kk], q_s, LD, warp * 16, kk * 16);
    }
    const bf16* k_s = kv_s + 2 * (kt & 1) * TL::TILE;
    const bf16* v_s = k_s + TL::TILE;
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        b_rows(r, k_s, LD, np * 16, kk * 16);
        mma16816(sc[2 * np], qf[kk], r[0], r[1]);
        mma16816(sc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }
    if (P.causal && k0 + BK - 1 > q0) {  // a tile that crosses the diagonal
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col > row[e >> 1]) sc[j][e] = kNegInf;
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
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]) * c);
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], c, -m_r[e >> 1]));
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

// the head dims that run: 128 (Llama-2 shapes) and 64 (TinyLlama)
int run(const Problem& P, int B, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid(P.S / MmaTiles<64>::BQ, P.H, B);
    if (D == 64) return start<sparse_fwd_mma<64>>(P, grid, kMmaThreads, MmaTiles<64>::bytes, st);
    if (D == 128) return start<sparse_fwd_mma<128>>(P, grid, kMmaThreads, MmaTiles<128>::bytes, st);
  } else {
    const dim3 grid(P.S / F32Tiles<64>::BQ, P.H, B);
    if (D == 64) return start<sparse_fwd_f32<64>>(P, grid, kThreads, F32Tiles<64>::bytes, st);
    if (D == 128) return start<sparse_fwd_f32<128>>(P, grid, kThreads, F32Tiles<128>::bytes, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: [B, S, H, D] (fp32 or bf16); cols int32 [H, nq, nj], cnt int32
// [H, nq]; block 64 or 128 dividing S
extern "C" int sparse_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const int* cols, const int* cnt, int B, int S, int H,
                                    int D, int block, int nq, int nj, float scale,
                                    int causal, int is_bf16, void* stream) {
  if (block % 64 != 0 || S % block != 0) return static_cast<int>(cudaErrorInvalidValue);
  Problem P{q, k, v, o, cols, cnt, S, H, block, nq, nj, scale, causal};
  return run(P, B, D, is_bf16, stream);
}
