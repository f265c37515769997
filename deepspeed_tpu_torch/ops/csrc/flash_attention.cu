// Flash attention forward and backward, hand-written for Hopper (sm_90a):
// the mma_sync route of the three kernels. The wrappers take contiguous,
// 16-byte-aligned tensors only, so bf16 takes the wgmma route in
// flash_attention_sm90.cu (ops/flash_attention.py, flash_route) and this
// file serves fp32 (the CUDA cores); its bf16 kernels run when a caller
// forces the route, as chip_smoke.py phase 3 does to time both.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel       (O and the logsumexp L)
//   flash_bwd_dkdv_kernel <- _bwd_dkdv_kernel  (dK, dV)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel    (dQ, recomputing P from L)
//
// What they compute, on the public [B, S, H, D] layout (K/V [B, S, Hk, D],
// GQA: query head h reads kv head h / (H / Hk), K/V are never repeated):
//   forward   s = (q . k) * sm_scale in fp32, causal mask (key j visible to
//             query i iff j <= i) with -1e30, online softmax over key tiles;
//             P is rounded to V's dtype before the fp32-accumulated PV
//             product; O = acc / l (l == 0 divides by 1) in q's dtype and
//             L = m + log(l) as fp32 [B, H, S] (the TPU kernel's 128-lane
//             replication of L is a VMEM layout artifact and is dropped);
//   dK, dV    p = exp(s - L); dV += fp32(P in dO's dtype)^T dO;
//             dS = p * (dO V^T - delta) * sm_scale, rounded to q's dtype;
//             dK += dS^T Q. delta = rowsum(fp32(dO) * fp32(O)) comes from the
//             wrapper, taken before dO is rounded to q's dtype.
//   dQ        dS = p * (dO V^T - delta) rounded to k's dtype; dQ += dS K;
//             dQ * sm_scale at the end.
//
// What bounds them on an H100: at the training shapes (S = 2048, D = 64 to
// 256) attention does 4*D flops per (query, key) pair in the forward and
// 14*D in the backward (with the recomputed QK^T and dO V^T) against O(S*D)
// bytes per row: hundreds of flops per byte, above the card's ridge (~295
// bf16 flops/byte), so the bound is the tensor cores' 989 TFLOP/s.
//
// Design, bf16 (the training path): FlashAttention-2's register-resident
// layout on mma.sync m16n8k16 (bf16 in, fp32 accumulate). Four warps per
// block, each owning 16 rows of the block's tile; operand tiles are staged
// from device memory into padded shared memory (row stride D + 8, so the
// 8 rows an ldmatrix reads fall in 8 distinct banks) and read into
// fragments with ldmatrix (.trans where the product needs the transpose).
// Logits, the running (m, l), P, dS and every accumulator (O, dK, dV, dQ)
// stay in registers: the C fragment of QK^T is re-packed in place as the
// bf16 A fragment of PV (and of P^T dO / dS^T Q / dS K in the backward), so
// nothing but the operand tiles goes through shared memory.
//   * the TPU's sequential kv grid axis becomes a loop inside the block:
//     forward and dQ blocks own (batch, query head, 64-row query tile) and
//     walk the key tiles, stopping at the diagonal when causal (the longest
//     rows are launched first); dK/dV blocks own (batch, KV head, 64-row key
//     tile), each warp 16 keys, and walk the GROUP's query heads and the
//     query tiles at or below the diagonal, so the group's dK/dV partials
//     are summed in-kernel in fp32 (the JAX package emits per-query-head
//     [B, H, S, D] partials and sums them outside);
//   * tiles are read straight from the [B, S, H, D] rows (row stride H*D),
//     so no transpose of q/k/v/o is ever made;
//   * ragged S (not a tile multiple) is masked: rows past S load as zero,
//     keys past S are masked, rows past S are never written.
// The next tile is fetched with cp.async into a second buffer while the
// block computes on the current one. TMA and wgmma: flash_attention_sm90.cu.
//
// fp32 (the parity path; the model trains in bf16): the same block
// decomposition on the CUDA cores, with fp32 tiles of S, P and the
// accumulators in shared memory.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; each entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "flash_head_dims.cuh"

namespace {

struct Problem {
  const void* q;      // [B, S, H, D]
  const void* k;      // [B, S, Hk, D]
  const void* v;      // [B, S, Hk, D]
  void* o;            // [B, S, H, D]   forward output
  const void* dout;   // [B, S, H, D]   dO in q's dtype (backward)
  float* lse;         // [B, H, S]      L = m + log(l)
  const float* delta; // [B, H, S]      rowsum(dO * O) (backward)
  void* dq;           // [B, S, H, D]
  void* dk;           // [B, S, Hk, D]
  void* dv;           // [B, S, Hk, D]
  int S, H, Hk;
  float scale;
  int causal;
};

// shared-memory footprint of each kernel, in bytes (the carve-up below and
// the host's cudaFuncSetAttribute use the same numbers)
template <typename T, int D> struct Smem {
  static constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  static constexpr int LDT = D + Tiles<T>::PAD;   // T tile, D columns
  static constexpr int LDS = BK + 4;              // fp32 tile, BK columns
  static constexpr int LDP = BK + Tiles<T>::PAD;  // T tile, BK columns
  static constexpr int LDO = D + 4;               // fp32 tile, D columns
  static constexpr int T_D = BQ * LDT * (int)sizeof(T);  // BQ == BK here
  static constexpr int F_S = BQ * LDS * 4;
  static constexpr int T_P = BQ * LDP * (int)sizeof(T);
  static constexpr int F_O = BQ * LDO * 4;
  static constexpr int fwd = 3 * T_D + F_S + T_P + F_O + 3 * BQ * 4;
  static constexpr int dkdv = 4 * T_D + 2 * F_S + 2 * T_P + 2 * F_O + 2 * BQ * 4;
  static constexpr int dq = 4 * T_D + 2 * F_S + T_P + F_O + 2 * BQ * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Problem P) {
  using SM = Smem<T, D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  constexpr int LDT = SM::LDT, LDS = SM::LDS, LDP = SM::LDP, LDO = SM::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * LDT;
  T* v_s = k_s + BK * LDT;
  float* s_s = reinterpret_cast<float*>(v_s + BK * LDT);
  T* p_s = reinterpret_cast<T*>(s_s + BQ * LDS);
  float* o_s = reinterpret_cast<float*>(p_s + BQ * LDP);
  float* m_s = o_s + BQ * LDO;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int S = P.S, H = P.H, Hk = P.Hk;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;
  const long long qs = static_cast<long long>(H) * D;
  const long long ks = static_cast<long long>(Hk) * D;
  const T* qg = static_cast<const T*>(P.q) + (static_cast<long long>(b) * S * H + h) * D;
  const T* kg = static_cast<const T*>(P.k) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const T* vg = static_cast<const T*>(P.v) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<T, D, BQ>(q_s, LDT, qg, qs, q0, S);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) o_s[(i / D) * LDO + i % D] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int n_kt = (S + BK - 1) / BK;
  if (P.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    load_tile<T, D, BK>(k_s, LDT, kg, ks, k0, S);
    load_tile<T, D, BK>(v_s, LDT, vg, ks, k0, S);
    __syncthreads();
    gemm<T, BQ, BK, D, false, true, false>(q_s, LDT, k_s, LDT, s_s, LDS);
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
        live[u] = kpos < S && (!P.causal || kpos <= qpos);
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
        p_s[r * LDP + lane + 32 * u] = from_float<T>(pr);  // P in V's dtype
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
    gemm<T, BQ, D, BK, false, false, true>(p_s, LDP, v_s, LDT, o_s, LDO);
  }
  __syncthreads();

  T* og = static_cast<T*>(P.o) + (static_cast<long long>(b) * S * H + h) * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (q0 + r < S) {
      const float l = l_s[r];
      og[(q0 + r) * qs + d] = from_float<T>(o_s[r * LDO + d] / (l == 0.f ? 1.f : l));
    }
  }
  float* lse = P.lse + (static_cast<long long>(b) * H + h) * S;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    if (q0 + r < S) {
      const float l = l_s[r];
      lse[q0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

// p = exp(s * scale - L) (0 where masked) and the two dS forms from dP:
// with SCALE_DS (the dK pass) ds = p * (dp - delta) * scale, else
// ds = p * (dp - delta); P (when p_s is given) and dS are stored in T
template <typename T, int BQ, int BK, int LDS, int LDP, bool SCALE_DS>
__device__ __forceinline__ void softmax_grad(const float* s_s, const float* dp_s,
                                             const float* lse_s, const float* dl_s,
                                             T* p_s, T* ds_s, int q0, int k0, int S,
                                             int causal, float scale) {
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK, j = i - r * BK;
    const int qpos = q0 + r, kpos = k0 + j;
    const bool live = qpos < S && kpos < S && (!causal || kpos <= qpos);
    const float p = live ? expf(s_s[r * LDS + j] * scale - lse_s[r]) : 0.f;
    float ds = p * (dp_s[r * LDS + j] - dl_s[r]);
    if (SCALE_DS) ds = ds * scale;
    if (p_s != nullptr) p_s[r * LDP + j] = from_float<T>(p);
    ds_s[r * LDP + j] = from_float<T>(ds);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Problem P) {
  using SM = Smem<T, D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  constexpr int LDT = SM::LDT, LDS = SM::LDS, LDP = SM::LDP, LDO = SM::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BK * LDT;
  T* q_s = v_s + BK * LDT;
  T* do_s = q_s + BQ * LDT;
  float* s_s = reinterpret_cast<float*>(do_s + BQ * LDT);
  float* dp_s = s_s + BQ * LDS;
  T* p_s = reinterpret_cast<T*>(dp_s + BQ * LDS);
  T* ds_s = p_s + BQ * LDP;
  float* dk_s = reinterpret_cast<float*>(ds_s + BQ * LDP);
  float* dv_s = dk_s + BK * LDO;
  float* lse_s = dv_s + BK * LDO;
  float* dl_s = lse_s + BQ;

  const int S = P.S, H = P.H, Hk = P.Hk, G = H / Hk;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const long long qs = static_cast<long long>(H) * D;
  const long long ks = static_cast<long long>(Hk) * D;
  const long long kv_off = (static_cast<long long>(b) * S * Hk + hk) * D;
  load_tile<T, D, BK>(k_s, LDT, static_cast<const T*>(P.k) + kv_off, ks, k0, S);
  load_tile<T, D, BK>(v_s, LDT, static_cast<const T*>(P.v) + kv_off, ks, k0, S);
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D;
    dk_s[r * LDO + i - r * D] = 0.f;
    dv_s[r * LDO + i - r * D] = 0.f;
  }
  const int nq = (S + BQ - 1) / BQ;
  const int iq0 = P.causal ? k0 / BQ : 0;  // first query tile reaching this key tile

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
    const float* lse = P.lse + (static_cast<long long>(b) * H + h) * S;
    const float* delta = P.delta + (static_cast<long long>(b) * H + h) * S;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's readers of q_s, do_s, p_s, ds_s are done
      load_tile<T, D, BQ>(q_s, LDT, static_cast<const T*>(P.q) + q_off, qs, q0, S);
      load_tile<T, D, BQ>(do_s, LDT, static_cast<const T*>(P.dout) + q_off, qs, q0, S);
      load_vec<BQ>(lse_s, lse, q0, S);
      load_vec<BQ>(dl_s, delta, q0, S);
      __syncthreads();
      gemm<T, BQ, BK, D, false, true, false>(q_s, LDT, k_s, LDT, s_s, LDS);     // Q K^T
      gemm<T, BQ, BK, D, false, true, false>(do_s, LDT, v_s, LDT, dp_s, LDS);   // dO V^T
      __syncthreads();
      softmax_grad<T, BQ, BK, LDS, LDP, true>(s_s, dp_s, lse_s, dl_s, p_s, ds_s, q0, k0,
                                              S, P.causal, P.scale);
      __syncthreads();
      gemm<T, BK, D, BQ, true, false, true>(p_s, LDP, do_s, LDT, dv_s, LDO);    // P^T dO
      gemm<T, BK, D, BQ, true, false, true>(ds_s, LDP, q_s, LDT, dk_s, LDO);    // dS^T Q
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(P.dk) + kv_off;
  T* dvg = static_cast<T*>(P.dv) + kv_off;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (k0 + r < S) {
      dkg[(k0 + r) * ks + d] = from_float<T>(dk_s[r * LDO + d]);
      dvg[(k0 + r) * ks + d] = from_float<T>(dv_s[r * LDO + d]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Problem P) {
  using SM = Smem<T, D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  constexpr int LDT = SM::LDT, LDS = SM::LDS, LDP = SM::LDP, LDO = SM::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * LDT;
  T* k_s = do_s + BQ * LDT;
  T* v_s = k_s + BK * LDT;
  float* s_s = reinterpret_cast<float*>(v_s + BK * LDT);
  float* dp_s = s_s + BQ * LDS;
  T* ds_s = reinterpret_cast<T*>(dp_s + BQ * LDS);
  float* dq_s = reinterpret_cast<float*>(ds_s + BQ * LDP);
  float* lse_s = dq_s + BQ * LDO;
  float* dl_s = lse_s + BQ;

  const int S = P.S, H = P.H, Hk = P.Hk;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;
  const long long qs = static_cast<long long>(H) * D;
  const long long ks = static_cast<long long>(Hk) * D;
  const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
  const long long kv_off = (static_cast<long long>(b) * S * Hk + hk) * D;
  load_tile<T, D, BQ>(q_s, LDT, static_cast<const T*>(P.q) + q_off, qs, q0, S);
  load_tile<T, D, BQ>(do_s, LDT, static_cast<const T*>(P.dout) + q_off, qs, q0, S);
  load_vec<BQ>(lse_s, P.lse + (static_cast<long long>(b) * H + h) * S, q0, S);
  load_vec<BQ>(dl_s, P.delta + (static_cast<long long>(b) * H + h) * S, q0, S);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) dq_s[(i / D) * LDO + i % D] = 0.f;
  int n_kt = (S + BK - 1) / BK;
  if (P.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    load_tile<T, D, BK>(k_s, LDT, static_cast<const T*>(P.k) + kv_off, ks, k0, S);
    load_tile<T, D, BK>(v_s, LDT, static_cast<const T*>(P.v) + kv_off, ks, k0, S);
    __syncthreads();
    gemm<T, BQ, BK, D, false, true, false>(q_s, LDT, k_s, LDT, s_s, LDS);     // Q K^T
    gemm<T, BQ, BK, D, false, true, false>(do_s, LDT, v_s, LDT, dp_s, LDS);   // dO V^T
    __syncthreads();
    softmax_grad<T, BQ, BK, LDS, LDP, false>(s_s, dp_s, lse_s, dl_s, nullptr, ds_s, q0,
                                             k0, S, P.causal, P.scale);
    __syncthreads();
    gemm<T, BQ, D, BK, false, false, true>(ds_s, LDP, k_s, LDT, dq_s, LDO);   // dS K
  }
  __syncthreads();

  T* dqg = static_cast<T*>(P.dq) + q_off;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (q0 + r < S) dqg[(q0 + r) * qs + d] = from_float<T>(dq_s[r * LDO + d] * P.scale);
  }
}


// Softmax arithmetic runs in base 2 (exp(x) = 2^(x log2 e)), so each p is
// one FMA and one ex2: logits are scaled by scale * log2(e), the running
// max and L are kept in that domain, and L leaves as m * ln 2 + ln l.
// Masked logits are set to -1e30 before scaling, which 2^x takes to 0:
// every row that is computed has a live key in every tile it visits.

template <int D> struct MmaTiles {
  static constexpr int LD = D + 8, BQ = 64, BK = 64;
  static constexpr int BQ_DKDV = D == 64 ? 64 : 32;  // register budget of dK/dV
  // Past D 128 the fragments of Q (and dO) are read from shared memory for
  // each product instead of held in registers beside a 16 x D accumulator,
  // and a dK/dV block keeps half of D's columns (recomputing S^T and dP^T
  // for each half), so that dK and dV fit the registers.
  static constexpr bool kQRegs = D <= 128;
  static constexpr int DKV = D > 128 ? D / 2 : D;    // dK / dV columns per block
  static constexpr int TILE = 64 * LD;               // elements of a 64-row tile
  static constexpr int fwd = 5 * TILE * 2;           // Q + double-buffered K, V
  static constexpr int dq = 6 * TILE * 2;            // Q, dO + double-buffered K, V
  static constexpr int dkdv = (2 * BK + 4 * BQ_DKDV) * LD * 2 + 4 * BQ_DKDV * 4;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(Problem P) {
  using TL = MmaTiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, KD = D / 16, NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + TL::TILE;  // buffer i: K at kv_s + 2i TILE, V at + (2i + 1) TILE

  const int S = P.S, H = P.H, Hk = P.Hk;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long qs = static_cast<long long>(H) * D, ks = static_cast<long long>(Hk) * D;
  const bf16* qg = static_cast<const bf16*>(P.q) + (static_cast<long long>(b) * S * H + h) * D;
  const bf16* kg = static_cast<const bf16*>(P.k) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const bf16* vg = static_cast<const bf16*>(P.v) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float c = P.scale * kLog2e;

  int n_kt = (S + BK - 1) / BK;
  if (P.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  load_rows<D, BQ>(q_s, qg, qs, q0, S);
  load_rows<D, BK>(kv_s, kg, ks, 0, S);
  load_rows<D, BK>(kv_s + TL::TILE, vg, ks, 0, S);
  cp_commit();
  constexpr int QF = TL::kQRegs ? KD : 1;
  uint32_t qf[QF][4];
  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // l: this thread's columns

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const bool prefetch = kt + 1 < n_kt;
    if (prefetch) {  // the next K/V tile lands while this one is used
      bf16* nxt = kv_s + 2 * ((kt + 1) & 1) * TL::TILE;
      load_rows<D, BK>(nxt, kg, ks, k0 + BK, S);
      load_rows<D, BK>(nxt + TL::TILE, vg, ks, k0 + BK, S);
      cp_commit();
    }
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
    if ((P.causal && k0 + BK - 1 > q0) || k0 + BK > S) {  // a diagonal or ragged tile
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S || (P.causal && col > row[e >> 1])) sc[j][e] = kNegInf;
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

  bf16* og = static_cast<bf16*>(P.o) + (static_cast<long long>(b) * S * H + h) * D;
  float* lse = P.lse + (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = quad_sum(l_r[i]);
    l = l == 0.f ? 1.f : l;
    if (row[i] >= S) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      *reinterpret_cast<uint32_t*>(og + row[i] * qs + d * 8 + 2 * t) =
          pack_bf16(o[d][2 * i] / l, o[d][2 * i + 1] / l);
    }
    if (t == 0) lse[row[i]] = m_r[i] * kLn2 + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma(Problem P) {
  using TL = MmaTiles<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ_DKDV, LD = TL::LD, KD = D / 16, NS = BQ / 8,
                NO = TL::DKV / 8, SPLIT = D / TL::DKV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BK * LD;
  bf16* qd_s = v_s + BK * LD;  // buffer i: Q at qd_s + 2i BQ LD, dO right after it
  float* vec_s = reinterpret_cast<float*>(qd_s + 4 * BQ * LD);  // buffer i: L, delta

  const int S = P.S, H = P.H, Hk = P.Hk, G = H / Hk;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x / SPLIT * BK;
  const int col0 = blockIdx.x % SPLIT * TL::DKV;  // this block's first dK / dV column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long qs = static_cast<long long>(H) * D, ks = static_cast<long long>(Hk) * D;
  const long long kv_off = (static_cast<long long>(b) * S * Hk + hk) * D;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float c = P.scale * kLog2e;
  const int nq = (S + BQ - 1) / BQ;
  const int iq0 = P.causal ? k0 / BQ : 0;  // first query tile reaching this key tile
  const int per_head = nq - iq0, n_it = G * per_head;

  // work item it: query head hk * G + it / per_head, query tile iq0 + it % per_head
  auto issue = [&](int it) {
    const int h = hk * G + it / per_head, q0 = (iq0 + it % per_head) * BQ;
    const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
    const long long v_off = (static_cast<long long>(b) * H + h) * S;
    bf16* q_dst = qd_s + 2 * (it & 1) * BQ * LD;
    float* v_dst = vec_s + 2 * (it & 1) * BQ;
    load_rows<D, BQ>(q_dst, static_cast<const bf16*>(P.q) + q_off, qs, q0, S);
    load_rows<D, BQ>(q_dst + BQ * LD, static_cast<const bf16*>(P.dout) + q_off, qs, q0, S);
    load_vec_async(v_dst, P.lse + v_off, q0, BQ, S);
    load_vec_async(v_dst + BQ, P.delta + v_off, q0, BQ, S);
    cp_commit();
  };

  load_rows<D, BK>(k_s, static_cast<const bf16*>(P.k) + kv_off, ks, k0, S);
  load_rows<D, BK>(v_s, static_cast<const bf16*>(P.v) + kv_off, ks, k0, S);
  issue(0);  // commits the K/V group too
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const bool prefetch = it + 1 < n_it;
    if (prefetch) issue(it + 1);
    cp_wait_prefetch(prefetch);
    __syncthreads();
    const int q0 = (iq0 + it % per_head) * BQ;
    const bf16* q_s = qd_s + 2 * (it & 1) * BQ * LD;
    const bf16* do_s = q_s + BQ * LD;
    const float* lse_s = vec_s + 2 * (it & 1) * BQ;
    const float* dl_s = lse_s + BQ;
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by BQ queries
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      a_frag(ka, k_s, LD, warp * 16, kk * 16);
      a_frag(va, v_s, LD, warp * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        b_rows(r, q_s, LD, np * 16, kk * 16);
        mma16816(st[2 * np], ka, r[0], r[1]);
        mma16816(st[2 * np + 1], ka, r[2], r[3]);
        b_rows(r, do_s, LD, np * 16, kk * 16);
        mma16816(dpt[2 * np], va, r[0], r[1]);
        mma16816(dpt[2 * np + 1], va, r[2], r[3]);
      }
    }
    if ((P.causal && q0 < k0 + BK - 1) || q0 + BQ > S || k0 + BK > S) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + j * 8 + 2 * t + (e & 1), kr = key[e >> 1];
          if (kr >= S || query >= S || (P.causal && kr > query)) st[j][e] = kNegInf;
        }
      }
    }
    // p = exp(s * scale - L); dS = p * (dP - delta) * scale (the dK form)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const float p = ex2(fmaf(st[j][e], c, -lse_s[qc] * kLog2e));
        dpt[j][e] = p * (dpt[j][e] - dl_s[qc]) * P.scale;
        st[j][e] = p;
      }
    }
    // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16 in the A fragments
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st, kk);
      c_to_a(da, dpt, kk);
#pragma unroll
      for (int dp = 0; dp < TL::DKV / 16; ++dp) {
        uint32_t r[4];
        b_cols(r, do_s, LD, kk * 16, col0 + dp * 16);
        mma16816(dv[2 * dp], pa, r[0], r[1]);
        mma16816(dv[2 * dp + 1], pa, r[2], r[3]);
        b_cols(r, q_s, LD, kk * 16, col0 + dp * 16);
        mma16816(dk[2 * dp], da, r[0], r[1]);
        mma16816(dk[2 * dp + 1], da, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  bf16* dkg = static_cast<bf16*>(P.dk) + kv_off;
  bf16* dvg = static_cast<bf16*>(P.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      const long long at = key[i] * ks + col0 + d * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + at) = pack_bf16(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma(Problem P) {
  using TL = MmaTiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, KD = D / 16, NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TL::TILE;
  bf16* kv_s = do_s + TL::TILE;  // buffer i: K at kv_s + 2i TILE, V at + (2i + 1) TILE

  const int S = P.S, H = P.H, Hk = P.Hk;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long qs = static_cast<long long>(H) * D, ks = static_cast<long long>(Hk) * D;
  const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
  const bf16* kg = static_cast<const bf16*>(P.k) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const bf16* vg = static_cast<const bf16*>(P.v) + (static_cast<long long>(b) * S * Hk + hk) * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* lse = P.lse + (static_cast<long long>(b) * H + h) * S;
  const float* delta = P.delta + (static_cast<long long>(b) * H + h) * S;
  const float c = P.scale * kLog2e;
  float L2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L2[i] = row[i] < S ? lse[row[i]] * kLog2e : 0.f;
    dl[i] = row[i] < S ? delta[row[i]] : 0.f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (P.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  load_rows<D, BQ>(q_s, static_cast<const bf16*>(P.q) + q_off, qs, q0, S);
  load_rows<D, BQ>(do_s, static_cast<const bf16*>(P.dout) + q_off, qs, q0, S);
  load_rows<D, BK>(kv_s, kg, ks, 0, S);
  load_rows<D, BK>(kv_s + TL::TILE, vg, ks, 0, S);
  cp_commit();
  constexpr int QF = TL::kQRegs ? KD : 1;
  uint32_t qf[QF][4], df[QF][4];
  float dq[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const bool prefetch = kt + 1 < n_kt;
    if (prefetch) {
      bf16* nxt = kv_s + 2 * ((kt + 1) & 1) * TL::TILE;
      load_rows<D, BK>(nxt, kg, ks, k0 + BK, S);
      load_rows<D, BK>(nxt + TL::TILE, vg, ks, k0 + BK, S);
      cp_commit();
    }
    cp_wait_prefetch(prefetch);
    __syncthreads();
    if (TL::kQRegs && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        a_frag(qf[kk % QF], q_s, LD, warp * 16, kk * 16);
        a_frag(df[kk % QF], do_s, LD, warp * 16, kk * 16);
      }
    }
    const bf16* k_s = kv_s + 2 * (kt & 1) * TL::TILE;
    const bf16* v_s = k_s + TL::TILE;
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qs_f[4], ds_f[4];
      if (!TL::kQRegs) {
        a_frag(qs_f, q_s, LD, warp * 16, kk * 16);
        a_frag(ds_f, do_s, LD, warp * 16, kk * 16);
      }
      const uint32_t(&qk)[4] = TL::kQRegs ? qf[kk % QF] : qs_f;
      const uint32_t(&dof)[4] = TL::kQRegs ? df[kk % QF] : ds_f;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        b_rows(r, k_s, LD, np * 16, kk * 16);
        mma16816(sc[2 * np], qk, r[0], r[1]);
        mma16816(sc[2 * np + 1], qk, r[2], r[3]);
        b_rows(r, v_s, LD, np * 16, kk * 16);
        mma16816(dp[2 * np], dof, r[0], r[1]);
        mma16816(dp[2 * np + 1], dof, r[2], r[3]);
      }
    }
    if ((P.causal && k0 + BK - 1 > q0) || k0 + BK > S) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S || (P.causal && col > row[e >> 1])) sc[j][e] = kNegInf;
        }
      }
    }
    // dS = p * (dP - delta), rounded to k's dtype in the A fragment
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = ex2(fmaf(sc[j][e], c, -L2[i]));
        sc[j][e] = p * (dp[j][e] - dl[i]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, sc, kk);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t r[4];
        b_cols(r, k_s, LD, kk * 16, d2 * 16);
        mma16816(dq[2 * d2], da, r[0], r[1]);
        mma16816(dq[2 * d2 + 1], da, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  bf16* dqg = static_cast<bf16*>(P.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      *reinterpret_cast<uint32_t*>(dqg + row[i] * qs + d * 8 + 2 * t) =
          pack_bf16(dq[d][2 * i] * P.scale, dq[d][2 * i + 1] * P.scale);
    }
  }
}

enum Pass { kFwd = 0, kDkDv = 1, kDq = 2 };

template <void (*KERN)(Problem)>
int start(const Problem& P, dim3 grid, int threads, int bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  KERN<<<grid, threads, bytes, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Problem& P, int B, Pass pass, cudaStream_t st) {
  using TL = MmaTiles<D>;
  const dim3 q_grid((P.S + TL::BQ - 1) / TL::BQ, P.H, B);
  if (pass == kFwd) return start<flash_fwd_mma<D>>(P, q_grid, kMmaThreads, TL::fwd, st);
  if (pass == kDq) return start<flash_bwd_dq_mma<D>>(P, q_grid, kMmaThreads, TL::dq, st);
  const dim3 k_grid((P.S + TL::BK - 1) / TL::BK * (D / TL::DKV), P.Hk, B);
  return start<flash_bwd_dkdv_mma<D>>(P, k_grid, kMmaThreads, TL::dkdv, st);
}

template <int D>
int launch_fp32(const Problem& P, int B, Pass pass, cudaStream_t st) {
  using SM = Smem<float, D>;
  const dim3 q_grid((P.S + SM::BQ - 1) / SM::BQ, P.H, B);
  if (pass == kFwd) return start<flash_fwd_kernel<float, D>>(P, q_grid, kThreads, SM::fwd, st);
  if (pass == kDq) return start<flash_bwd_dq_kernel<float, D>>(P, q_grid, kThreads, SM::dq, st);
  const dim3 k_grid((P.S + SM::BK - 1) / SM::BK, P.Hk, B);
  return start<flash_bwd_dkdv_kernel<float, D>>(P, k_grid, kThreads, SM::dkdv, st);
}

// the head dims of flash_head_dims.cuh
int run(const Problem& P, int B, int D, int is_bf16, Pass pass, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_MMA(DIM) \
  if (D == DIM)        \
    return is_bf16 ? launch_bf16<DIM>(P, B, pass, st) : launch_fp32<DIM>(P, B, pass, st);
  FLASH_HEAD_DIMS(FLASH_MMA)
#undef FLASH_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int S, int H, int Hk, int D,
                                   float scale, int causal, int is_bf16, void* stream) {
  Problem P{q, k, v, o, nullptr, lse, nullptr, nullptr, nullptr, nullptr,
            S, H, Hk, scale, causal};
  return run(P, B, D, is_bf16, kFwd, stream);
}

extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, void* dk, void* dv, int B,
                                        int S, int H, int Hk, int D, float scale,
                                        int causal, int is_bf16, void* stream) {
  Problem P{q, k, v, nullptr, dout, const_cast<float*>(lse), delta, nullptr, dk, dv,
            S, H, Hk, scale, causal};
  return run(P, B, D, is_bf16, kDkDv, stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dq, int B, int S, int H,
                                      int Hk, int D, float scale, int causal, int is_bf16,
                                      void* stream) {
  Problem P{q, k, v, nullptr, dout, const_cast<float*>(lse), delta, dq, nullptr, nullptr,
            S, H, Hk, scale, causal};
  return run(P, B, D, is_bf16, kDq, stream);
}
