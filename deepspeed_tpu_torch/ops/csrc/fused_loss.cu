// Fused LM loss (the LM head matmul folded into the cross entropy), forward
// and backward, hand-written for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/pallas/fused_loss.py:
//   loss_fwd_kernel    <- _fwd_kernel  (per-token logsumexp and target logit)
//   loss_dl_kernel     <- _dlogits     (the gradient tile both backward
//                                       kernels recompute)
//   loss_dh_kernel     <- _dh_kernel   (dh = dl K^T)
//   loss_dk_kernel     <- _dk_kernel   (dK = h^T dl)
// The backward kernels here are the "mma_sync" route: fp32 operands, and
// bf16 operands whose rows TMA cannot describe (a row stride that is not a
// multiple of 16 bytes, e.g. an untied head of vocab 50257). bf16 operands
// that TMA can describe take the "wgmma" route of fused_loss_sm90.cu; the
// wrapper (ops/fused_loss.py, backward_route) chooses.
//
// What they compute, for hidden states h [T, E], the head K [E, V] and
// target ids [T] (an id outside [0, V), e.g. -1, matches no column):
//   forward  s = h K in fp32 from storage-dtype operands; per token the
//            online (max m, sum l of exp(s - m)) over the vocab and the
//            target logit (a column compare, no gather); lse = m + log(l)
//            (l == 0 divides by 1), both fp32 [T];
//   backward dl = g_lse * exp(s - lse) + g_tgt * onehot(target), rounded to
//            K's dtype before each product; dh = dl K^T (fp32 accumulation,
//            h's dtype out), dK = h^T dl (K's dtype out).
// The [T, V] logits never exist.
//
// What bounds them on an H100: each pass is a [T, E] x [E, V] product
// (2 T E V flops; 1.07 TFLOP at T 8192, E 2048, V 32000) against a few
// hundred MB of operands, so the bound is the tensor cores' 989 TFLOP/s.
//
// Design. All four kernels share one block tile: a 64 x 128 output tile of
// a product, accumulated over the reduction dimension in steps of 32 with
// cp.async double buffering; in bf16 four warps (2 x 2, each 32 x 64) run
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments, in
// fp32 (the parity path) the same tiles run on the CUDA cores. The finished
// tile goes through shared memory to the kernel's epilogue.
//   * forward: the TPU grid walks the vocab blocks of a token block in
//     order, carrying (m, l, tgt) in VMEM. Here a block owns 64 tokens and
//     one contiguous share of the vocab tiles (the vocab is split across
//     blocks so that T/64 token tiles still fill the card), carries
//     (m, l, tgt) in shared memory across its tiles, writes its partial
//     triple, and the last block of a token tile to finish (an atomic
//     ticket) merges the shares with the flash-decoding combine.
//   * backward: the TPU keeps dh [Bt, E] and dK [E, Bv] fp32 accumulators
//     in VMEM; on Hopper neither fits a block. So the backward walks the
//     vocab in chunks of Vc columns: loss_dl_kernel computes each dl tile
//     once (full-E reduction) into a bounded [T, Vc] workspace in K's
//     dtype, then loss_dh_kernel adds dl_chunk K_chunk^T into dh (fp32
//     across chunks, h's dtype on the last) and loss_dk_kernel writes
//     dK_chunk = h^T dl_chunk. No buffer of [T, V] size exists.
//   * the tied head (K = embedding^T, stored [V, E]) is read in place with
//     the other operand layout (kvt = 1), and its gradient is written in
//     that layout: no transposed copy.
//   * ragged T, E and V are masked in the loads (zero fill) and the stores;
//     rows whose leading dimension is not a multiple of 16 bytes (a vocab
//     of 50257) are loaded element by element instead of by cp.async.
// mma.sync cannot reach Hopper's tensor-core rate: the forward is next for
// the design of fused_loss_sm90.cu (wgmma on TMA-filled shared memory, a
// persistent warp-specialised block).
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; each entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int LDC = BN + 4;  // fp32 output tile in shared memory
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory carve-up, in elements of T per double-buffer stage
template <typename T> struct Tile {
  static constexpr int G = 16 / sizeof(T);  // elements per 16-byte granule (the row padding)
  static constexpr int A = (BM * (BK + G) > BK * (BM + G)) ? BM * (BK + G) : BK * (BM + G);
  static constexpr int B = (BK * (BN + G) > BN * (BK + G)) ? BK * (BN + G) : BN * (BK + G);
  static constexpr int STAGES_BYTES = 2 * (A + B) * (int)sizeof(T);
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int ROW_BYTES = 8 * BM * 4;  // per-row epilogue vectors
  static constexpr int bytes = STAGES_BYTES + C_BYTES + ROW_BYTES;
};

// a row-major [rows][cols] matrix in device memory with leading dimension ld;
// vec: rows start on 16-byte boundaries, so granules load with cp.async
template <typename T> struct Mat {
  const T* p;
  long long ld;
  int rows, cols;
  bool vec;
};

template <typename T>
__device__ __forceinline__ Mat<T> mat(const void* p, long long ld, int rows, int cols) {
  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % Tile<T>::G == 0;
  return Mat<T>{static_cast<const T*>(p), ld, rows, cols, vec};
}

// rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of m into a shared tile with
// leading dimension ldd; whatever lies outside m loads as zero
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const Mat<T>& m, int r0, int c0) {
  constexpr int G = Tile<T>::G, PER = COLS / G;
  if (m.vec) {
    for (int c = threadIdx.x; c < ROWS * PER; c += kThreads) {
      const int r = c / PER, e = (c - r * PER) * G;
      const int row = r0 + r, col = c0 + e;
      int n = 0;
      if (row < m.rows && col < m.cols) n = min(G, m.cols - col);
      const T* src = n ? m.p + row * m.ld + col : m.p;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + r * ldd + e)),
                   "l"(src), "r"(n * static_cast<int>(sizeof(T))));
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, e = i - r * COLS;
      const int row = r0 + r, col = c0 + e;
      dst[r * ldd + e] = (row < m.rows && col < m.cols) ? m.p[row * m.ld + col]
                                                         : from_float<T>(0.f);
    }
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait(bool prefetching) {
  if (prefetching) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// ---------------------------------------------------------------------------
// mma.sync fragments (the m16n8k16 layouts of flash_attention.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) @ b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 16x16 A block at (m0, k0) of a tile stored [m][k]
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* tile, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// the same block of a tile stored [k][m]: matrix j = lane / 8 holds
// m0 + (j & 1) * 8 .., k0 + (j >> 1) * 8 .., transposed by ldmatrix
__device__ __forceinline__ void a_frag_t(uint32_t (&r)[4], const bf16* tile, int ld, int m0,
                                         int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldsm_x4_t(r, tile + (k0 + (j >> 1) * 8 + (lane & 7)) * ld + m0 + (j & 1) * 8);
}

// B fragments of the n-tiles n0..n0+7 (r[0], r[1]) and n0+8..n0+15 (r[2],
// r[3]) over k0..k0+15, from a tile stored [n][k]
__device__ __forceinline__ void b_rows(uint32_t (&r)[4], const bf16* tile, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same from a tile stored [k][n]
__device__ __forceinline__ void b_cols(uint32_t (&r)[4], const bf16* tile, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// ---------------------------------------------------------------------------
// The shared block tile: C[BM][BN] (fp32, shared) = A[m0.., :K] @ B[:K, n0..]
// A_T: A stored [k][m] (else [m][k]); B_NK: B stored [n][k] (else [k][n]).
// ---------------------------------------------------------------------------

template <typename T, bool A_T, bool B_NK>
__device__ __forceinline__ void load_stage(T* a_s, T* b_s, const Mat<T>& A, const Mat<T>& B,
                                           int m0, int n0, int k0) {
  constexpr int G = Tile<T>::G;
  if (A_T) {
    load_tile<T, BK, BM>(a_s, BM + G, A, k0, m0);
  } else {
    load_tile<T, BM, BK>(a_s, BK + G, A, m0, k0);
  }
  if (B_NK) {
    load_tile<T, BN, BK>(b_s, BK + G, B, n0, k0);
  } else {
    load_tile<T, BK, BN>(b_s, BN + G, B, k0, n0);
  }
}

template <bool A_T, bool B_NK>
__device__ __forceinline__ void compute_mma(const bf16* a_s, const bf16* b_s,
                                            float (&acc)[2][8][4]) {
  constexpr int G = Tile<bf16>::G;
  constexpr int LDA = A_T ? BM + G : BK + G, LDB = B_NK ? BK + G : BN + G;
  const int warp = threadIdx.x >> 5, wm = (warp & 1) * 32, wn = (warp >> 1) * 64;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (A_T) {
        a_frag_t(af[mi], a_s, LDA, wm + mi * 16, kk);
      } else {
        a_frag(af[mi], a_s, LDA, wm + mi * 16, kk);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      if (B_NK) {
        b_rows(r, b_s, LDB, wn + np * 16, kk);
      } else {
        b_cols(r, b_s, LDB, kk, wn + np * 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16816(acc[mi][2 * np], af[mi], r[0], r[1]);
        mma16816(acc[mi][2 * np + 1], af[mi], r[2], r[3]);
      }
    }
  }
}

// fp32 on the CUDA cores: thread (ty, tx) owns rows ty + 8i, columns tx + 16j
template <bool A_T, bool B_NK>
__device__ __forceinline__ void compute_fp32(const float* a_s, const float* b_s,
                                             float (&acc)[8][8]) {
  constexpr int G = Tile<float>::G;
  constexpr int LDA = A_T ? BM + G : BK + G, LDB = B_NK ? BK + G : BN + G;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 8 * i;
      av[i] = A_T ? a_s[k * LDA + m] : a_s[m * LDA + k];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      bv[j] = B_NK ? b_s[n * LDB + k] : b_s[k * LDB + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Runs the whole reduction and leaves the tile in c_s. Starts and ends with
// every thread past a barrier, so the caller may reuse c_s around it.
template <typename T, bool A_T, bool B_NK>
__device__ void block_tile(unsigned char* smem, const Mat<T>& A, const Mat<T>& B, int m0,
                           int n0, int K, float* c_s) {
  using TL = Tile<T>;
  T* stage[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + TL::A + TL::B};
  const int nk = (K + BK - 1) / BK;
  constexpr bool kMma = std::is_same<T, bf16>::value;
  float acc_m[2][8][4];
  float acc_f[8][8];
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_m[mi][nj][e] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_f[i][j] = 0.f;
  }
  __syncthreads();  // the previous tile's readers of the stages and c_s are done
  load_stage<T, A_T, B_NK>(stage[0], stage[0] + TL::A, A, B, m0, n0, 0);
  cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const bool prefetch = kt + 1 < nk;
    if (prefetch) {  // the next step's tiles land while this one is used
      T* nxt = stage[(kt + 1) & 1];
      load_stage<T, A_T, B_NK>(nxt, nxt + TL::A, A, B, m0, n0, (kt + 1) * BK);
      cp_commit();
    }
    cp_wait(prefetch);
    __syncthreads();
    const T* cur = stage[kt & 1];
    if constexpr (kMma) {
      compute_mma<A_T, B_NK>(cur, cur + TL::A, acc_m);
    } else {
      compute_fp32<A_T, B_NK>(cur, cur + TL::A, acc_f);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if constexpr (kMma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 64;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm + mi * 16 + g + (e >> 1) * 8, c = wn + nj * 8 + 2 * t + (e & 1);
          c_s[r * LDC + c] = acc_m[mi][nj][e];
        }
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c_s[(ty + 8 * i) * LDC + tx + 16 * j] = acc_f[i][j];
  }
  __syncthreads();
}

struct LossArgs {
  const void* h;        // [T, E]
  const void* k;        // [E, V], or [V, E] when kvt (the tied head)
  const int* targets;   // [T]
  const float* lse;     // [T]   backward: the forward's logsumexp
  const float* g_lse;   // [T]
  const float* g_tgt;   // [T]
  float* out_lse;       // [T]   forward outputs
  float* out_tgt;       // [T]
  float* part;          // [3, nsplit, T] forward partial (m, l, tgt)
  int* ticket;          // [ceil(T / BM)] forward merge tickets, zeroed
  void* ws;             // [T, vc] dl workspace of one vocab chunk
  float* dh_acc;        // [T, E] fp32 dh across chunks
  void* dh;             // [T, E]
  void* dk;             // like k
  int T, E, V;
  int v0, vc, width;    // chunk: first column, workspace width, live columns
  int nsplit, tiles_per_split;
  int first, last;      // dh: first / last chunk
};

template <typename T>
__device__ __forceinline__ float* c_tile(unsigned char* smem) {
  return reinterpret_cast<float*>(smem + Tile<T>::STAGES_BYTES);
}

template <typename T>
__device__ __forceinline__ float* row_vecs(unsigned char* smem) {
  return reinterpret_cast<float*>(smem + Tile<T>::STAGES_BYTES + Tile<T>::C_BYTES);
}

// the head as the B operand of s = h K over vocab columns [v0, v0 + width):
// [k = e][n = v] stored [E][V], or [n = v][k = e] stored [V][E] when kvt
template <typename T>
__device__ __forceinline__ Mat<T> head_b(const LossArgs& a, int v0, int width, bool kvt) {
  const T* k = static_cast<const T*>(a.k);
  return kvt ? mat<T>(k + static_cast<long long>(v0) * a.E, a.E, width, a.E)
             : mat<T>(k + v0, a.V, a.E, width);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(T / BM), nsplit): token tile x vocab share
template <typename T, bool KVT>
__global__ void __launch_bounds__(kThreads) loss_fwd_kernel(LossArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = c_tile<T>(smem);
  float* m_s = row_vecs<T>(smem);
  float* l_s = m_s + BM;
  float* t_s = l_s + BM;
  int* tg_s = reinterpret_cast<int*>(t_s + BM);
  __shared__ int is_last;
  const int m0 = blockIdx.x * BM, split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    t_s[r] = 0.f;
    tg_s[r] = m0 + r < a.T ? a.targets[m0 + r] : -1;
  }
  const Mat<T> A = mat<T>(a.h, a.E, a.T, a.E);
  const Mat<T> B = head_b<T>(a, 0, a.V, KVT);
  const int n_tiles = (a.V + BN - 1) / BN;
  const int j0 = split * a.tiles_per_split, j1 = min(j0 + a.tiles_per_split, n_tiles);
  for (int j = j0; j < j1; ++j) {
    const int n0 = j * BN;
    block_tile<T, false, KVT>(smem, A, B, m0, n0, a.E, c_s);
    // online softmax and the target logit, one warp per row
    for (int r = warp; r < BM; r += kThreads / 32) {
      float x[BN / 32];
      float mx = kNegInf, hit = 0.f;
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
        const int col = n0 + lane + 32 * u;
        x[u] = col < a.V ? c_s[r * LDC + lane + 32 * u] : kNegInf;
        mx = fmaxf(mx, x[u]);
        if (col < a.V && col == tg_s[r]) hit += x[u];
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
        if (n0 + lane + 32 * u < a.V) sum += __expf(x[u] - m_new);
      }
      sum = warp_sum(sum);
      hit = warp_sum(hit);
      if (lane == 0) {
        l_s[r] = l_s[r] * __expf(m_old - m_new) + sum;
        m_s[r] = m_new;
        t_s[r] += hit;
      }
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(a.nsplit) * a.T;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    if (m0 + r < a.T) {
      const long long at = static_cast<long long>(split) * a.T + m0 + r;
      a.part[at] = m_s[r];
      a.part[plane + at] = l_s[r];
      a.part[2 * plane + at] = t_s[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&a.ticket[blockIdx.x], 1) == a.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the flash-decoding combine of the nsplit partial (m, l, tgt)
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int row = m0 + r;
    if (row >= a.T) continue;
    float m = kNegInf;
    for (int s = 0; s < a.nsplit; ++s) {
      m = fmaxf(m, __ldcg(a.part + s * static_cast<long long>(a.T) + row));
    }
    float l = 0.f, tgt = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const long long at = s * static_cast<long long>(a.T) + row;
      l += __ldcg(a.part + plane + at) * __expf(__ldcg(a.part + at) - m);
      tgt += __ldcg(a.part + 2 * plane + at);
    }
    a.out_lse[row] = m + logf(l == 0.f ? 1.f : l);
    a.out_tgt[row] = tgt;
  }
}

// grid (ceil(T / BM), ceil(width / BN)): dl of one vocab chunk into ws
template <typename T, bool KVT>
__global__ void __launch_bounds__(kThreads) loss_dl_kernel(LossArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = c_tile<T>(smem);
  float* lse_s = row_vecs<T>(smem);
  float* gl_s = lse_s + BM;
  float* gt_s = gl_s + BM;
  int* tg_s = reinterpret_cast<int*>(gt_s + BM);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const bool in = m0 + r < a.T;
    lse_s[r] = in ? a.lse[m0 + r] : 0.f;
    gl_s[r] = in ? a.g_lse[m0 + r] : 0.f;
    gt_s[r] = in ? a.g_tgt[m0 + r] : 0.f;
    tg_s[r] = in ? a.targets[m0 + r] - a.v0 : -1;  // chunk-relative
  }
  block_tile<T, false, KVT>(smem, mat<T>(a.h, a.E, a.T, a.E), head_b<T>(a, a.v0, a.width, KVT),
                            m0, n0, a.E, c_s);
  T* ws = static_cast<T*>(a.ws);
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i - r * BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= a.T || col >= a.vc) continue;
    float d = 0.f;
    if (col < a.width) {
      d = gl_s[r] * __expf(c_s[r * LDC + c] - lse_s[r]);
      if (col == tg_s[r]) d += gt_s[r];
    }
    ws[static_cast<long long>(row) * a.vc + col] = from_float<T>(d);  // dl in K's dtype
  }
}

// grid (ceil(T / BM), ceil(E / BN)): dh += dl_chunk K_chunk^T
template <typename T, bool KVT>
__global__ void __launch_bounds__(kThreads) loss_dh_kernel(LossArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = c_tile<T>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const T* k = static_cast<const T*>(a.k);
  // B[k = v][n = e]: the head stored [V][E] is [k][n]; stored [E][V], [n][k]
  const Mat<T> B = KVT ? mat<T>(k + static_cast<long long>(a.v0) * a.E, a.E, a.width, a.E)
                       : mat<T>(k + a.v0, a.V, a.E, a.width);
  block_tile<T, false, !KVT>(smem, mat<T>(a.ws, a.vc, a.T, a.width), B, m0, n0, a.width, c_s);
  T* dh = static_cast<T*>(a.dh);
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i - r * BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= a.T || col >= a.E) continue;
    const long long at = static_cast<long long>(row) * a.E + col;
    float v = c_s[r * LDC + c];
    if (!a.first) v += a.dh_acc[at];
    if (a.last) {
      dh[at] = from_float<T>(v);
    } else {
      a.dh_acc[at] = v;
    }
  }
}

// grid (ceil(E / BM), ceil(width / BN)): dK_chunk = h^T dl_chunk
template <typename T, bool KVT>
__global__ void __launch_bounds__(kThreads) loss_dk_kernel(LossArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = c_tile<T>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // A[m = e][k = t] is h stored [k][m]; B[k = t][n = v] is the workspace
  block_tile<T, true, false>(smem, mat<T>(a.h, a.E, a.T, a.E),
                             mat<T>(a.ws, a.vc, a.T, a.width), m0, n0, a.T, c_s);
  T* dk = static_cast<T*>(a.dk);
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    // the stored layout's contiguous index runs fastest
    const int r = KVT ? i % BM : i / BN, c = KVT ? i / BM : i % BN;
    const int e = m0 + r, v = n0 + c;
    if (e >= a.E || v >= a.width) continue;
    const long long at = KVT ? static_cast<long long>(a.v0 + v) * a.E + e
                             : static_cast<long long>(e) * a.V + a.v0 + v;
    dk[at] = from_float<T>(c_s[r * LDC + c]);
  }
}

template <void (*KERN)(LossArgs)>
int start(const LossArgs& a, dim3 grid, int bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  KERN<<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

enum Pass { kFwd, kDl, kDh, kDk };

template <typename T, bool KVT>
int launch(const LossArgs& a, Pass pass, cudaStream_t st) {
  const int bytes = Tile<T>::bytes;
  const int tt = (a.T + BM - 1) / BM;
  switch (pass) {
    case kFwd:
      return start<loss_fwd_kernel<T, KVT>>(a, dim3(tt, a.nsplit), bytes, st);
    case kDl:
      return start<loss_dl_kernel<T, KVT>>(a, dim3(tt, (a.width + BN - 1) / BN), bytes, st);
    case kDh:
      return start<loss_dh_kernel<T, KVT>>(a, dim3(tt, (a.E + BN - 1) / BN), bytes, st);
    default:
      return start<loss_dk_kernel<T, KVT>>(
          a, dim3((a.E + BM - 1) / BM, (a.width + BN - 1) / BN), bytes, st);
  }
}

int run(const LossArgs& a, int kvt, int is_bf16, Pass pass, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return kvt ? launch<bf16, true>(a, pass, st) : launch<bf16, false>(a, pass, st);
  return kvt ? launch<float, true>(a, pass, st) : launch<float, false>(a, pass, st);
}

template <typename T, bool KVT>
int fwd_occupancy(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(loss_fwd_kernel<T, KVT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<T>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, loss_fwd_kernel<T, KVT>, kThreads, Tile<T>::bytes));
}

}  // namespace

// How many blocks share a token tile's vocab in the forward: enough that
// ceil(T / 64) token tiles fill one wave of resident blocks, and each share
// holds at least one 128-column tile. Returns the count, or -cudaError_t.
extern "C" int fused_loss_fwd_splits(int T, int V, int kvt, int is_bf16) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int e;
  if (is_bf16) {
    e = kvt ? fwd_occupancy<bf16, true>(&per_sm) : fwd_occupancy<bf16, false>(&per_sm);
  } else {
    e = kvt ? fwd_occupancy<float, true>(&per_sm) : fwd_occupancy<float, false>(&per_sm);
  }
  if (e != 0) return -e;
  const int token_tiles = (T + BM - 1) / BM, vocab_tiles = (V + BN - 1) / BN;
  int n = std::max(1, sms * std::max(per_sm, 1) / std::max(token_tiles, 1));
  n = std::min(n, vocab_tiles);
  const int per = (vocab_tiles + n - 1) / n;
  return (vocab_tiles + per - 1) / per;
}

extern "C" int fused_loss_fwd(const void* h, const void* k, const int* targets, float* lse,
                              float* tgt, float* part, int* ticket, int T, int E, int V,
                              int nsplit, int kvt, int is_bf16, void* stream) {
  LossArgs a{};
  a.h = h;
  a.k = k;
  a.targets = targets;
  a.out_lse = lse;
  a.out_tgt = tgt;
  a.part = part;
  a.ticket = ticket;
  a.T = T;
  a.E = E;
  a.V = V;
  const int vocab_tiles = (V + BN - 1) / BN;
  a.tiles_per_split = (vocab_tiles + nsplit - 1) / nsplit;
  a.nsplit = nsplit;
  return run(a, kvt, is_bf16, kFwd, stream);
}

extern "C" int fused_loss_dl(const void* h, const void* k, const int* targets,
                             const float* lse, const float* g_lse, const float* g_tgt,
                             void* ws, int T, int E, int V, int v0, int vc, int width,
                             int kvt, int is_bf16, void* stream) {
  LossArgs a{};
  a.h = h;
  a.k = k;
  a.targets = targets;
  a.lse = lse;
  a.g_lse = g_lse;
  a.g_tgt = g_tgt;
  a.ws = ws;
  a.T = T;
  a.E = E;
  a.V = V;
  a.v0 = v0;
  a.vc = vc;
  a.width = width;
  return run(a, kvt, is_bf16, kDl, stream);
}

extern "C" int fused_loss_dh(const void* ws, const void* k, float* dh_acc, void* dh, int T,
                             int E, int V, int v0, int vc, int width, int first, int last,
                             int kvt, int is_bf16, void* stream) {
  LossArgs a{};
  a.ws = const_cast<void*>(ws);
  a.k = k;
  a.dh_acc = dh_acc;
  a.dh = dh;
  a.T = T;
  a.E = E;
  a.V = V;
  a.v0 = v0;
  a.vc = vc;
  a.width = width;
  a.first = first;
  a.last = last;
  return run(a, kvt, is_bf16, kDh, stream);
}

extern "C" int fused_loss_dk(const void* h, const void* ws, void* dk, int T, int E, int V,
                             int v0, int vc, int width, int kvt, int is_bf16, void* stream) {
  LossArgs a{};
  a.h = h;
  a.ws = const_cast<void*>(ws);
  a.dk = dk;
  a.T = T;
  a.E = E;
  a.V = V;
  a.v0 = v0;
  a.vc = vc;
  a.width = width;
  return run(a, kvt, is_bf16, kDk, stream);
}
