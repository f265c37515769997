// The fused LM loss's kernels on Hopper's tensor-core path (sm_90a): wgmma
// from shared memory that TMA fills, in a persistent, warp-specialised
// block. The other route of the forward and the backward (fp32, and rows
// TMA cannot describe) stays in fused_loss.cu.
//
// Replaces, from deepspeed_tpu/ops/pallas/fused_loss.py:
//   loss_fwd  <- _fwd_kernel (per-token logsumexp and target logit)
//   loss_dl   <- _dlogits   (the gradient tile both backward kernels
//                            recompute, computed here once per vocab chunk)
//   loss_dh   <- _dh_kernel (dh = dl K^T)
//   loss_dk   <- _dk_kernel (dK = h^T dl)
// for hidden states h [T, E], the head K [E, V] (or the tied head stored
// [V, E]) and target ids [T]. The forward, over the whole vocab at once:
//   loss_fwd: per (row, 256-column tile) the tile's max m, sum l of
//        exp(s - m) and target logit (a column compare: an id outside
//        [0, V) matches nothing), fp32 into part [3][tiles][T];
//   loss_fwd_combine, a second launch: per row the partials merged in tile
//        order, m = max m_i, l = sum l_i exp(m_i - m), tgt = sum tgt_i,
//        lse = m + log(l) (l == 0 divides by 1), so the result does not
//        depend on which block finished when. (A merge in the GEMM's last
//        block of each row block needs a fence and an atomic ticket per
//        tile, which stalls both consumer warpgroups in every epilogue.)
// The backward, per vocab chunk [v0, v0 + width):
//   dl = g_lse * exp(s - lse) + g_tgt * onehot(target - v0), s = h K_chunk in
//        fp32 from bf16 operands, rounded to bf16 into the workspace ws [T, vc]
//        (columns in [width, vc) of a tile store 0);
//   dh = sum over chunks of ws K_chunk^T, fp32 in dh_acc, bf16 on the last;
//   dK_chunk = h^T ws, bf16, in the head's stored layout (for the tied head
//        the kernel computes dK_chunk^T = ws^T h, which is that layout).
//
// What bounds them on an H100: each launch is one product of 2 M N K flops
// (per chunk of 4096 columns at T 8192, E 2048: 137 GFLOP) over a few tens of
// MB of operands, far above the card's ~295 flop per byte, so the tensor
// cores' 989 TFLOP/s bound it. Only wgmma reaches that rate.
//
// Design: one GEMM mainloop, C[M][N] = A[M][K] B[K][N], shared by the five
// (pass, operand layout) instantiations.
//   * Block: 384 threads. Warpgroups 0-1 consume, warpgroup 2 produces;
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232).
//   * Tile 128 x 256, depth 64. One producer thread keeps TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the tensor's
//     edge) in flight into a ring of 4 stages of 48 KB, each guarded by a
//     full and an empty mbarrier. Each consumer warpgroup issues
//     wgmma.mma_async m64n256k16 (bf16 in, fp32 accumulate) on its 64 rows,
//     the sums in registers, one group in flight; a stage is released as
//     soon as the group that read it has completed.
//   * Operand majors: bf16 wgmma reads both K-major and MN-major tiles from
//     shared memory. dl: A = h (K-major), B = the head, MN-major untied
//     ([E][V]) or K-major tied ([V][E]). dh: A = ws (K-major), B = K^T,
//     K-major untied or MN-major tied. dK: A and B both MN-major (h and ws,
//     or ws and h for the tied head).
//   * Persistent schedule: one block per SM walks the output tiles in a
//     grouped raster (8 row tiles per group), so the head chunk and the rows
//     of h in use stay in the 50 MB L2. The producer runs ahead across tile
//     boundaries, so the next tile's loads overlap this tile's epilogue.
//   * Epilogues read the accumulators in registers and store straight to
//     device memory (no fp32 tile in shared memory): the forward reduces
//     each row over the thread's 64 columns and the 4 lanes that share the
//     row (shuffles) and stores one partial triple per row and tile; dl
//     applies exp, the cotangents and the one-hot compare; dh adds into or
//     writes dh_acc and writes dh on the last chunk; dK stores bf16. Stores
//     are masked at the ragged T, E and V edges; the mainloop takes those
//     edges from TMA's zero fill, so the forward leaves the zero-filled
//     columns past V (logit 0, not -inf) out of its max and sums.
// TMA needs 16-byte-aligned bases and row strides: the wrapper
// (ops/fused_loss.py, backward_route) sends bf16 operands that satisfy that
// here and everything else to fused_loss.cu.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t. Each entry returns 0, a cudaError_t from the launch,
// or 10000 + the CUresult of a tensor map that could not be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 256, BK = 64, kStages = 4, kGroupM = 8;
constexpr int kThreads = 384;                 // 2 consumer warpgroups + 1 producer
constexpr int kConsumerWarps = 8;
constexpr int kABytes = BM * BK * 2;          // 16 KB
constexpr int kBBytes = BN * BK * 2;          // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAtomBytes = 64 * BK * 2;       // one 64-wide MN-major box: 8 KB
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

constexpr float kNegInf = -1e30f;

enum Epi { kDl = 0, kDh = 1, kDk = 2, kFwd = 3 };

struct Params {
  int M, N, K;                // C[M][N] = A[M][K] B[K][N]
  int num_m, num_n, num_k, tiles;
  void* out;                  // dl: ws; dh: dh; dK: the chunk's first element
  long long ld;               // out's row stride in elements
  int n_store;                // dl: ws width vc (columns in [N, n_store) store 0)
  const int* targets;         // dl
  const float* lse;
  const float* g_lse;
  const float* g_tgt;
  int v0;
  float* dh_acc;              // dh
  int first, last;
  float* part;                // forward: the partial (m, l, tgt) [3][num_n][T]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// box {c0 (inner), c1} of the tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles: rows of
// 128 bytes (64 bf16 of K), 8-row groups 1024 bytes apart (SBO); LBO unused.
// MN-major tiles: boxes of 64 MN x 64 K, each K row 128 bytes, 8-row groups
// 1024 bytes apart (SBO), boxes kAtomBytes apart along MN (LBO).
__device__ __forceinline__ uint64_t desc(uint32_t addr, bool mn_major) {
  const uint64_t lbo = mn_major ? kAtomBytes : 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the descriptor's start address of k-slice kk (16 deep) of a tile at addr
__device__ __forceinline__ uint32_t k_slice(uint32_t addr, int kk, bool mn_major) {
  return addr + (mn_major ? kk * 16 * 128 : kk * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16) B (16 x 256); TA / TB: A / B MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef ACC8

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// tile t of the grouped raster: kGroupM row tiles share each column tile
__device__ __forceinline__ void tile_coords(const Params& p, int t, int& m0, int& n0) {
  const int per_group = kGroupM * p.num_n;
  const int first_m = (t / per_group) * kGroupM;
  const int rows = min(p.num_m - first_m, kGroupM);
  const int in_group = t % per_group;
  m0 = (first_m + in_group % rows) * BM;
  n0 = (in_group / rows) * BN;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (per warpgroup): warp w of the group owns
// rows 16 w .. 16 w + 15; d[4 j + e] sits at row lane / 4 + 8 (e >> 1), column
// 8 j + 2 (lane % 4) + (e & 1).
template <int EPI>
__device__ __forceinline__ void epilogue(const Params& p, float (&d)[128], int m0, int n0,
                                         int wg) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  if constexpr (EPI == kFwd) {
    const long long M = p.M, plane = static_cast<long long>(p.num_n) * M;
    float mx[2], sum[2], hit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int tg = row < p.M ? p.targets[row] : -1;
      mx[h] = kNegInf;
      hit[h] = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + 8 * j + e;
          if (c < p.N) {
            const float v = d[4 * j + 2 * h + e];
            mx[h] = fmaxf(mx[h], v);
            if (c == tg) hit[h] += v;
          }
        }
      }
      // the 4 lanes of a row hold its 256 columns
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      sum[h] = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col0 + 8 * j + e < p.N) sum[h] += __expf(d[4 * j + 2 * h + e] - mx[h]);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
        hit[h] += __shfl_xor_sync(0xffffffffu, hit[h], o);
      }
    }
    const long long nt = n0 / BN;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        p.part[nt * M + row] = mx[h];
        p.part[plane + nt * M + row] = sum[h];
        p.part[2 * plane + nt * M + row] = hit[h];
      }
    }
  } else if constexpr (EPI == kDl) {
    float lse[2], gl[2], gt[2];
    int tg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const bool in = row < p.M;
      lse[h] = in ? p.lse[row] : 0.f;
      gl[h] = in ? p.g_lse[row] : 0.f;
      gt[h] = in ? p.g_tgt[row] : 0.f;
      tg[h] = in ? p.targets[row] - p.v0 : -1;  // chunk-relative
    }
    bf16* ws = static_cast<bf16*>(p.out);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.n_store) continue;  // n_store is even: col + 1 is inside too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          float v = 0.f;
          if (c < p.N) {
            v = gl[h] * __expf(d[4 * j + 2 * h + e] - lse[h]);
            if (c == tg[h]) v += gt[h];
          }
          x[e] = v;
        }
        *reinterpret_cast<uint32_t*>(ws + static_cast<long long>(row) * p.ld + col) =
            pack_bf16(x[0], x[1]);
      }
    }
  } else if constexpr (EPI == kDh) {
    bf16* dh = static_cast<bf16*>(p.out);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.N) continue;  // N = E is a multiple of 8 on this route
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        const long long at = static_cast<long long>(row) * p.ld + col;
        float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        if (!p.first) {
          const float2 old = *reinterpret_cast<const float2*>(p.dh_acc + at);
          v.x += old.x;
          v.y += old.y;
        }
        if (p.last) {
          *reinterpret_cast<uint32_t*>(dh + at) = pack_bf16(v.x, v.y);
        } else {
          *reinterpret_cast<float2*>(p.dh_acc + at) = v;
        }
      }
    }
  } else {
    bf16* dk = static_cast<bf16*>(p.out);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.N) continue;  // N (width untied, E tied) is a multiple of 8 here
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        *reinterpret_cast<uint32_t*>(dk + static_cast<long long>(row) * p.ld + col) =
            pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int EPI, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kThreads, 1)
    loss_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on that boundary
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto stage_a = [&](int s) { return base + static_cast<uint32_t>(s) * kStageBytes; };
  auto stage_b = [&](int s) { return stage_a(s) + kABytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load of every tile of this block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int m0, n0;
        tile_coords(p, t, m0, n0);
        for (int kb = 0; kb < p.num_k; ++kb) {
          const int k0 = kb * BK;
          mbar_wait(empty(s), phase ^ 1u);
          mbar_expect_tx(full(s), kStageBytes);
          if (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 64; ++j)
              tma_load(stage_a(s) + j * kAtomBytes, &map_a, m0 + 64 * j, k0, full(s));
          } else {
            tma_load(stage_a(s), &map_a, k0, m0, full(s));
          }
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(stage_b(s) + j * kAtomBytes, &map_b, n0 + 64 * j, k0, full(s));
          } else {
            tma_load(stage_b(s), &map_b, k0, n0, full(s));
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    const bool signals = (threadIdx.x & 31) == 0;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int m0, n0;
      tile_coords(p, t, m0, n0);
      int prev = -1;
      for (int kb = 0; kb < p.num_k; ++kb) {
        mbar_wait(full(s), phase);
        // both layouts put this warpgroup's 64 rows of A 8 KB into the stage
        const uint32_t a = stage_a(s) + wg * kAtomBytes, b = stage_b(s);
        wgmma_fence();
        fence_acc(d);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_256<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, desc(k_slice(a, kk, A_MN), A_MN),
                                                desc(k_slice(b, kk, B_MN), B_MN),
                                                (kb | kk) != 0);
        }
        wgmma_commit();
        fence_acc(d);
        if (prev >= 0) {
          wgmma_wait<1>();  // the group that read stage prev is done
          if (signals) mbar_arrive(empty(prev));
        }
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (signals) mbar_arrive(empty(prev));
      epilogue<EPI>(p, d, m0, n0, wg);
    }
  }
}

// the forward's combine: thread per row, the row's partials in tile order
// (reads coalesced across the rows of a block)
__global__ void __launch_bounds__(64) loss_fwd_combine(const float* part, int n_tiles, int T,
                                                      float* lse, float* tgt) {
  const int row = blockIdx.x * 64 + threadIdx.x;
  if (row >= T) return;
  const long long M = T, plane = static_cast<long long>(n_tiles) * M;
  float m = kNegInf;
#pragma unroll 4
  for (int i = 0; i < n_tiles; ++i) m = fmaxf(m, part[i * M + row]);
  float l = 0.f, t = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_tiles; ++i) {
    l += part[plane + i * M + row] * __expf(part[i * M + row] - m);
    t += part[2 * plane + i * M + row];
  }
  lse[row] = m + logf(l == 0.f ? 1.f : l);
  tgt[row] = t;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder(int* err) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || sym == nullptr) {
      *err = e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaErrorNotSupported);
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// a bf16 matrix of `outer` rows of `inner` elements, rows `row_elems` apart,
// read in boxes of 64 inner x box_outer (64 inner bf16 = the 128-byte swizzle)
int make_map(CUtensorMap* map, const void* ptr, long long inner, long long outer,
             long long row_elems, int box_outer) {
  int err = 0;
  EncodeTiled encode = encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_elems) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// the operand's box: K-major A 64 x BM, K-major B 64 x BN, MN-major 64 x 64
int map_operand(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                long long row_elems, bool mn_major, bool is_a) {
  return make_map(map, ptr, inner, outer, row_elems, mn_major ? 64 : (is_a ? BM : BN));
}

template <int EPI, bool A_MN, bool B_MN>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, Params p, cudaStream_t st) {
  auto kern = loss_gemm_kernel<EPI, A_MN, B_MN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.num_m = (p.M + BM - 1) / BM;
  p.num_n = (p.N + BN - 1) / BN;
  p.num_k = (p.K + BK - 1) / BK;
  p.tiles = p.num_m * p.num_n;
  kern<<<p.tiles < sms ? p.tiles : sms, kThreads, kSmemBytes, st>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the forward's partials over the whole vocab: M = T, N = V, K = E; part
// holds [3][n_tiles][T] floats (n_tiles = ceil(V / 256))
extern "C" int fused_loss_fwd_sm90(const void* h, const void* k, const int* targets, float* part,
                                   int T, int E, int V, int n_tiles, int kvt, void* stream) {
  if (n_tiles != (V + BN - 1) / BN) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  int err = map_operand(&ma, h, E, T, E, false, true);
  if (err == 0) {
    err = kvt ? map_operand(&mb, k, E, V, E, false, false)
              : map_operand(&mb, k, V, E, V, true, false);
  }
  if (err != 0) return err;
  Params p{};
  p.M = T;
  p.N = V;
  p.K = E;
  p.targets = targets;
  p.part = part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kvt ? launch<kFwd, false, false>(ma, mb, p, st) : launch<kFwd, false, true>(ma, mb, p, st);
}

// lse, tgt [T] from the forward's partials
extern "C" int fused_loss_fwd_combine_sm90(const float* part, float* lse, float* tgt, int T,
                                           int n_tiles, void* stream) {
  loss_fwd_combine<<<(T + 63) / 64, 64, 0, static_cast<cudaStream_t>(stream)>>>(part, n_tiles, T,
                                                                                 lse, tgt);
  return static_cast<int>(cudaGetLastError());
}

// dl of the chunk [v0, v0 + width) into ws [T, vc]: M = T, N = width, K = E
extern "C" int fused_loss_dl_sm90(const void* h, const void* k, const int* targets,
                                  const float* lse, const float* g_lse, const float* g_tgt,
                                  void* ws, int T, int E, int V, int v0, int vc, int width,
                                  int kvt, void* stream) {
  CUtensorMap ma, mb;
  int err = map_operand(&ma, h, E, T, E, false, true);
  const bf16* kb = static_cast<const bf16*>(k);
  if (err == 0) {
    err = kvt ? map_operand(&mb, kb + static_cast<long long>(v0) * E, E, width, E, false, false)
              : map_operand(&mb, kb + v0, width, E, V, true, false);
  }
  if (err != 0) return err;
  Params p{};
  p.M = T;
  p.N = width;
  p.K = E;
  p.out = ws;
  p.ld = vc;
  p.n_store = vc;
  p.targets = targets;
  p.lse = lse;
  p.g_lse = g_lse;
  p.g_tgt = g_tgt;
  p.v0 = v0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kvt ? launch<kDl, false, false>(ma, mb, p, st) : launch<kDl, false, true>(ma, mb, p, st);
}

// dh (+)= ws K_chunk^T: M = T, N = E, K = width
extern "C" int fused_loss_dh_sm90(const void* ws, const void* k, float* dh_acc, void* dh, int T,
                                  int E, int V, int v0, int vc, int width, int first, int last,
                                  int kvt, void* stream) {
  CUtensorMap ma, mb;
  int err = map_operand(&ma, ws, width, T, vc, false, true);
  const bf16* kb = static_cast<const bf16*>(k);
  if (err == 0) {
    // B[k = v][n = e]: stored [E][V] untied (K-major), [V][E] tied (MN-major)
    err = kvt ? map_operand(&mb, kb + static_cast<long long>(v0) * E, E, width, E, true, false)
              : map_operand(&mb, kb + v0, width, E, V, false, false);
  }
  if (err != 0) return err;
  Params p{};
  p.M = T;
  p.N = E;
  p.K = width;
  p.out = dh;
  p.ld = E;
  p.dh_acc = dh_acc;
  p.first = first;
  p.last = last;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kvt ? launch<kDh, false, true>(ma, mb, p, st) : launch<kDh, false, false>(ma, mb, p, st);
}

// dK of the chunk, K = T: untied dK[E][V] = h^T ws (M = E, N = width); tied
// dK^T[V][E] = ws^T h (M = width, N = E), the stored layout of either
extern "C" int fused_loss_dk_sm90(const void* h, const void* ws, void* dk, int T, int E, int V,
                                  int v0, int vc, int width, int kvt, void* stream) {
  CUtensorMap mh, mw;
  int err = map_operand(&mh, h, E, T, E, true, !kvt);
  if (err == 0) err = map_operand(&mw, ws, width, T, vc, true, kvt);
  if (err != 0) return err;
  Params p{};
  p.K = T;
  bf16* out = static_cast<bf16*>(dk);
  if (kvt) {
    p.M = width;
    p.N = E;
    p.out = out + static_cast<long long>(v0) * E;
    p.ld = E;
  } else {
    p.M = E;
    p.N = width;
    p.out = out + v0;
    p.ld = V;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kvt ? launch<kDk, true, true>(mw, mh, p, st) : launch<kDk, true, true>(mh, mw, p, st);
}
