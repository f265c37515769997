// Tile helpers shared by the attention kernels hand-written for Hopper
// (sm_90a): flash_attention.cu and sparse_attention.cu.
//
// fp32 (CUDA cores): tiles staged in shared memory by the whole block
// (kThreads threads) and multiplied there (gemm), warp reductions.
// bf16 (tensor cores): mma.sync m16n8k16 with bf16 operands and fp32
// accumulators; operand tiles staged by four warps (kMmaThreads) with
// cp.async into padded shared memory (row stride D + 8) and read into
// fragments with ldmatrix; the C -> A re-pack that keeps P in registers;
// base-2 softmax helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// fp32 path: query / key rows per tile and the shared-memory row padding
template <typename T> struct Tiles;
template <> struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 4;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// rows [row0, row0 + ROWS) of a [*, row_stride] tensor (D elements each) into
// a shared tile with leading dimension ld; rows at or past S load as zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride, int row0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, e = (c - r * kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + e);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + e) = val;
  }
}

// rows [row0, row0 + ROWS) of a [B*H, S] fp32 vector into shared memory
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
  }
}

// C[M][N] (fp32, ldc) = (ACC ? C : 0) + A[M][K] @ B[K][N] on the CUDA cores,
// operands in shared memory. A_T: A is stored transposed (A[i][k] at
// a[k * lda + i]); B_T: B is stored transposed (B[k][n] at b[n * ldb + k]).
template <typename T, int M, int N, int K, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void gemm(const T* a, int lda, const T* b, int ldb,
                                     float* c, int ldc) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, n = idx - i * N;
    float s = ACC ? c[i * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float av = A_T ? a[k * lda + i] : a[i * lda + k];
      const float bv = B_T ? b[n * ldb + k] : b[k * ldb + n];
      s = fmaf(av, bv, s);
    }
    c[i * ldc + n] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16, register-resident tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // four warps, 16 rows each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments from a row-major shared tile with leading dimension ld. The
// m16n8k16 layouts (g = lane / 4, t = lane % 4): A holds (g, 2t..2t+1),
// (g+8, ..), (g, 2t+8..), (g+8, 2t+8..); B holds (k = 2t..2t+1, n = g) and
// (k = 2t+8.., n = g); C holds (g, 2t..2t+1) and (g+8, 2t..2t+1).
// a_frag: the 16x16 A block at (row0, col0).
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* tile, int ld, int row0,
                                       int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// b_rows: B = tile^T, the tile stored [n][k] (rows are n): the B fragments of
// the two n-tiles n0..n0+7 (r[0], r[1]) and n0+8..n0+15 (r[2], r[3]) over k0..k0+15
__device__ __forceinline__ void b_rows(uint32_t (&r)[4], const bf16* tile, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// b_cols: B = tile, stored [k][n] (rows are k): the same two n-tiles
__device__ __forceinline__ void b_cols(uint32_t (&r)[4], const bf16* tile, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// the bf16 A fragment of k-block kk from fp32 C fragments over n-tiles
// 2kk and 2kk+1 (the C -> A re-pack that keeps P and dS in registers)
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows [row0, row0 + ROWS) of a [*, stride] bf16 tensor (D elements each)
// into a padded shared tile, as 16-byte cp.async copies that land while the
// block computes on the other buffer; rows at or past S are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int row0, int S) {
  constexpr int kPer = D / 8, LD = D + 8;
  for (int c = threadIdx.x; c < ROWS * kPer; c += kMmaThreads) {
    const int r = c / kPer, e = (c - r * kPer) * 8;
    const bool in = row0 + r < S;
    const bf16* from = src + (in ? (row0 + r) * stride + e : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LD + e)),
                 "l"(from), "r"(in ? 16 : 0));
  }
}

// n fp32 values src[row0 ..) into dst (zero at or past S), as cp.async copies
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int row0,
                                               int n, int S) {
  for (int r = threadIdx.x; r < n; r += kMmaThreads) {
    const bool in = row0 + r < S;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst + r)),
                 "l"(src + (in ? row0 + r : 0)), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one group (the prefetch just issued) is in flight
__device__ __forceinline__ void cp_wait_prefetch(bool prefetching) {
  if (prefetching) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

}  // namespace
