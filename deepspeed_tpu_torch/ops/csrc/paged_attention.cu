// Paged attention over the blocked KV pool, hand-written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of deepspeed_tpu/ops/pallas/paged_attention.py:
//   paged_attention_kernel     <- _kernel        (SplitFuse packed chunks, one
//                                                 layer's [N, Hk, bs, D] pool)
//   paged_flash_decode_kernel  <- _decode_kernel (one query per sequence over
//                                                 the resident [L, N, Hk, bs, D]
//                                                 pool, bf16/fp32 storage)
//
// What they compute (both): for query row (token i, head hq) of sequence s,
// at absolute position pos = start[s] + i, attention over the slots j of the
// sequence's pages (resolved through its block table row) with j <= pos and
// j < kv_len[s]; GQA routes query head hq to kv head hq / G. Masked slots
// contribute an exact 0; a row with no live slot (kv_len 0, or a padded query
// i >= chunk_len[s]) yields o = 0, m = -1e30, l = 0. Logits are
// sum_d q*k in fp32 times the explicit sm_scale; P is rounded to V's dtype
// before the PV product, which accumulates in fp32. The optional (m, l) are
// the raw online-softmax statistics the decode loop merges with its
// in-window buffer.
//
// What bounds them on an H100: decode reads every live K/V page once and does
// 4*D flops per (query row, slot), about one flop per byte in bf16 — far
// below the card's ~295 flops per byte, so it is memory-bound; its bound is
// the live-page bytes over 3.35 TB/s. The packed kernel over a 128-token
// prompt chunk does up to 128 flops per page byte: against the card's peaks
// that is still below the ridge (memory-bound), but this design does its
// arithmetic in fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor
// cores' 989), so prefill chunks run operation-bound in practice; moving QK
// and PV onto wgmma is the later step.
//
// Design (simple first, per the port's plan; wgmma, TMA and split-KV across
// blocks are later work):
//   * one thread block (4 warps) per (sequence, kv head, tile of query rows);
//     the block reads its own block-table row, so pages are resolved in-kernel;
//   * the block's warps take the sequence's live pages round-robin and stop at
//     the last slot any valid row of the tile can see (min(kv_len, last
//     position + 1)), so work follows the live context and chunk_len, not the
//     block table's width or the padded chunk size Q — the TPU kernel's clamp
//     of dead pages onto the last live one (a DMA-elision trick) has no use
//     here;
//   * per 32-slot group a lane owns one slot: it streams that slot's K row
//     straight from device memory in 16-byte loads (each page byte is read by
//     exactly one lane), dots it against the tile's queries held in shared
//     memory, and the warp folds the group into per-row fp32 (m, l, acc)
//     state; for the PV product each lane owns D/32 output columns and reads
//     V rows coalesced;
//   * decode issues its loads ahead of their use (the whole K row, V rows
//     eight at a time), since each warp walks its pages one after another and
//     would otherwise wait out one memory latency per row (2.2x faster on the
//     H100 than one V row at a time); its blocks hold only the GQA group's
//     rows of state (1, 2, 4 or 8), so more of them fit an SM;
//   * at the end the warps' partial states are merged in shared memory with
//     the flash combine, and the block writes o (and m, l) in the public
//     [S, Q, Hq, D] / [S, Hq, D] layouts directly — the TPU kernel's
//     head-major row shuffle and lane-replicated [rows, 128] statistics are
//     VMEM layout conveniences that do not carry over;
//   * the decode kernel gets the resident pool's base pointer plus the layer's
//     element offset and the page stride: no layer slice is ever copied.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t, each entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// query rows per block: 16 for the packed kernel (amortizes each page read
// over more rows); for decode the GQA group rounded up to 1, 2, 4 or 8, so
// an MHA model's blocks hold one row's state and more of them fit an SM
__host__ __device__ constexpr int packed_rows(int D) { return D <= 128 ? 16 : 8; }
// V rows loaded ahead of their products in the PV loop
constexpr int kVRows = 8;

template <typename T> struct Bits;
template <> struct Bits<float> { using type = unsigned int; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float bits_to_float(unsigned int b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ float bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (round to nearest even), back in fp32
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// N consecutive elements of T as floats, in vector loads of at most 16 bytes
// (the caller guarantees the alignment)
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* out) {
  constexpr int kPer = (N * sizeof(T) > 16) ? static_cast<int>(16 / sizeof(T)) : N;
  using W = typename Bits<T>::type;
  using R = typename Raw<kPer * sizeof(T)>::type;
#pragma unroll
  for (int c = 0; c < N; c += kPer) {
    union {
      R raw;
      W w[kPer];
    } u;
    u.raw = *reinterpret_cast<const R*>(p + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c + i] = bits_to_float(u.w[i]);
  }
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

struct Problem {
  const void* q;          // [S, Q, Hq, D]
  void* o;                // [S, Q, Hq, D]
  float* m_out;           // [S, Q, Hq] or null
  float* l_out;           // [S, Q, Hq] or null
  const void* k;          // page 0 of the layer: pages of [Hk, bs, D]
  const void* v;
  const int* block_table; // [S, B]
  const int* start;       // [S] position of query token 0
  const int* chunk;       // [S] valid query tokens, or null: all Q valid
  const int* kv_len;      // [S]
  int Q, Hq, Hk, bs, B;
  long long page_stride;  // elements from one physical page to the next
  float sm_scale;
};

template <typename T, int D, int ROWS>
__device__ __forceinline__ void attend_tile(const Problem& P) {
  constexpr int DL = D / 32;                            // output columns per lane
  constexpr int VEC = static_cast<int>(16 / sizeof(T)); // elements per K load
  // loads a lane keeps in flight: decode (few rows of state) issues its whole
  // K row and kVRows V rows ahead of use; the packed kernel's 16 rows of state
  // leave no registers for that (on the H100 it ran ~20% slower with them:
  // 254 registers against 168), so it keeps two K chunks and one V row
  constexpr int KSTEP = ROWS >= 16 ? 2 : D / VEC;
  constexpr int VROWS = ROWS >= 16 ? 1 : kVRows;
  __shared__ float q_s[ROWS][D];
  __shared__ float m_s[kWarps][ROWS];
  __shared__ float l_s[kWarps][ROWS];
  __shared__ float acc_s[kWarps][ROWS][D];

  const int s = blockIdx.x, h = blockIdx.y;
  const int G = P.Hq / P.Hk;
  const int total_rows = P.Q * G;
  const int r0 = blockIdx.z * ROWS;
  const int chunk = P.chunk != nullptr ? P.chunk[s] : P.Q;
  const int start = P.start[s];
  const int kv_len = P.kv_len[s];
  // rows of this tile with a valid query (row r is token (r0+r)/G, query
  // head h*G + (r0+r)%G); the rest only get written as empty rows
  const int nrows = max(0, min(ROWS, min(total_rows, chunk * G) - r0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(P.q);

  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float x = 0.f;
    if (r < nrows) {
      const int row = r0 + r;
      const long long qrow =
          (static_cast<long long>(s) * P.Q + row / G) * P.Hq + h * G + row % G;
      x = to_float(q[qrow * D + d]);
    }
    q_s[r][d] = x;
  }
  // slots at or past live_end are masked for every valid row of the tile
  const int live_end =
      nrows > 0 ? min(kv_len, start + (r0 + nrows - 1) / G + 1) : 0;
  const int n_pages = (live_end + P.bs - 1) / P.bs;
  __syncthreads();

  float acc[ROWS][DL];
  float m[ROWS], l[ROWS];
  int pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    pos[r] = r < nrows ? start + (r0 + r) / G : -1;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }
  const long long head_off = static_cast<long long>(h) * P.bs * D;
  const T* kbase = static_cast<const T*>(P.k) + head_off;
  const T* vbase = static_cast<const T*>(P.v) + head_off;

  for (int page = warp; page < n_pages; page += kWarps) {
    const long long phys = P.block_table[static_cast<long long>(s) * P.B + page];
    const T* kp = kbase + phys * P.page_stride;
    const T* vp = vbase + phys * P.page_stride;
    const int slot0 = page * P.bs;
    for (int j0 = 0; j0 < P.bs && slot0 + j0 < live_end; j0 += 32) {
      const int j = j0 + lane;
      const int slot = slot0 + j;
      const bool in_range = j < P.bs && slot < live_end;
      float sc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
      if (in_range) {
        const T* krow = kp + static_cast<long long>(j) * D;
#pragma unroll 1
        for (int d1 = 0; d1 < D; d1 += KSTEP * VEC) {
#pragma unroll
          for (int c = 0; c < KSTEP; ++c) {
            const int d0 = d1 + c * VEC;
            float kf[VEC];
            load_floats<T, VEC>(krow + d0, kf);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              if (r < nrows) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) sc[r] = fmaf(q_s[r][d0 + e], kf[e], sc[r]);
              }
            }
          }
        }
      }
      float p[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        p[r] = 0.f;
        if (r < nrows) {  // warp-uniform
          const bool live = in_range && slot <= pos[r];
          const float sv = live ? sc[r] * P.sm_scale : kNegInf;
          const float m_new = fmaxf(m[r], warp_max(sv));
          const float pr = live ? expf(sv - m_new) : 0.f;
          const float alpha = expf(m[r] - m_new);
          l[r] = alpha * l[r] + warp_sum(pr);
          m[r] = m_new;
          p[r] = round_to<T>(pr);  // P in V's dtype before the PV product
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[r][e] *= alpha;
        }
      }
      // V rows of this group, VROWS loads in flight before their products
      const int n_j = min(32, min(P.bs - j0, live_end - slot0 - j0));
      for (int j1 = 0; j1 < n_j; j1 += VROWS) {
        float vf[VROWS][DL];
#pragma unroll
        for (int u = 0; u < VROWS; ++u) {
          if (j1 + u < n_j) {
            load_floats<T, DL>(
                vp + static_cast<long long>(j0 + j1 + u) * D + lane * DL, vf[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < VROWS; ++u) {
          if (j1 + u < n_j) {  // warp-uniform
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              if (r < nrows) {
                const float pj = __shfl_sync(0xffffffffu, p[r], j1 + u);
#pragma unroll
                for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(pj, vf[u][e], acc[r][e]);
              }
            }
          }
        }
      }
    }
  }

  // merge the warps' partial (m, l, acc) with the flash combine
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int e = 0; e < DL; ++e) acc_s[warp][r][lane * DL + e] = acc[r][e];
  }
  __syncthreads();

  T* o = static_cast<T*>(P.o);
  const int rows_here = min(ROWS, total_rows - r0);
  for (int idx = threadIdx.x; idx < rows_here * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w][r] - mx);
      lsum = fmaf(l_s[w][r], e, lsum);
      a = fmaf(acc_s[w][r][d], e, a);
    }
    const int row = r0 + r;
    const long long orow =
        (static_cast<long long>(s) * P.Q + row / G) * P.Hq + h * G + row % G;
    o[orow * D + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
    if (d == 0 && P.m_out != nullptr) {
      P.m_out[orow] = mx;
      P.l_out[orow] = lsum;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Problem P) {
  attend_tile<T, D, packed_rows(D)>(P);
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_flash_decode_kernel(Problem P) {
  attend_tile<T, D, ROWS>(P);
}

inline dim3 grid_for(const Problem& P, int S, int rows) {
  return dim3(S, P.Hk, (P.Q * (P.Hq / P.Hk) + rows - 1) / rows);
}

template <typename T, int D>
void launch(const Problem& P, int S, bool decode, cudaStream_t st) {
  if (!decode) {
    paged_attention_kernel<T, D><<<grid_for(P, S, packed_rows(D)), kThreads, 0, st>>>(P);
    return;
  }
  const int G = P.Hq / P.Hk;
  if (G <= 1) {
    paged_flash_decode_kernel<T, D, 1><<<grid_for(P, S, 1), kThreads, 0, st>>>(P);
  } else if (G <= 2) {
    paged_flash_decode_kernel<T, D, 2><<<grid_for(P, S, 2), kThreads, 0, st>>>(P);
  } else if (G <= 4) {
    paged_flash_decode_kernel<T, D, 4><<<grid_for(P, S, 4), kThreads, 0, st>>>(P);
  } else {
    paged_flash_decode_kernel<T, D, 8><<<grid_for(P, S, 8), kThreads, 0, st>>>(P);
  }
}

template <typename T>
int dispatch(const Problem& P, int S, int D, bool decode, cudaStream_t st) {
  switch (D) {
    case 32: launch<T, 32>(P, S, decode, st); break;
    case 64: launch<T, 64>(P, S, decode, st); break;
    case 128: launch<T, 128>(P, S, decode, st); break;
    case 256: launch<T, 256>(P, S, decode, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(Problem P, int S, int D, bool decode, long long layer_offset,
        int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    P.k = static_cast<const __nv_bfloat16*>(P.k) + layer_offset;
    P.v = static_cast<const __nv_bfloat16*>(P.v) + layer_offset;
    return dispatch<__nv_bfloat16>(P, S, D, decode, st);
  }
  P.k = static_cast<const float*>(P.k) + layer_offset;
  P.v = static_cast<const float*>(P.v) + layer_offset;
  return dispatch<float>(P, S, D, decode, st);
}

}  // namespace

extern "C" int paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, void* o, float* m,
    float* l, const int* block_table, const int* start_pos,
    const int* chunk_len, const int* kv_len, int S, int Q, int Hq, int Hk,
    int D, int bs, int B, long long page_stride, float sm_scale, int is_bf16,
    void* stream) {
  Problem P{q, o, m, l, k_pool, v_pool, block_table, start_pos, chunk_len,
            kv_len, Q, Hq, Hk, bs, B, page_stride, sm_scale};
  return run(P, S, D, false, 0, is_bf16, stream);
}

extern "C" int paged_flash_decode_fwd(
    const void* q, const void* k_pool, const void* v_pool, void* o, float* m,
    float* l, const int* block_table, const int* pos, const int* kv_len,
    int S, int Hq, int Hk, int D, int bs, int B, long long layer_offset,
    long long page_stride, float sm_scale, int is_bf16, void* stream) {
  Problem P{q, o, m, l, k_pool, v_pool, block_table, pos, nullptr,
            kv_len, 1, Hq, Hk, bs, B, page_stride, sm_scale};
  return run(P, S, D, true, layer_offset, is_bf16, stream);
}
