// The CUDA-core paged-attention tile and its launchers (the cuda_core route:
// fp32, and shapes the sm90 design does not take), shared by
// paged_attention.cu (the packed kernel and the decode kernel over bf16/fp32
// pools) and paged_attention_int8.cu (the decode kernel's int8 mode): two
// sources, so nvcc builds the two sets of instantiations in parallel. Design
// notes are at the top of paged_attention.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_rows.cuh"
#include "paged_head_dims.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// query rows per block: 16 for the packed kernel (amortizes each page read
// over more rows), 8 past D 128 (the block's q_s and acc_s stay within the
// 48 KB of static shared memory); for decode the GQA group rounded up to 1,
// 2, 4 or 8, so an MHA model's blocks hold one row's state and more of them
// fit an SM
__host__ __device__ constexpr int packed_rows(int D) { return D <= 128 ? 16 : 8; }
// V rows loaded ahead of their products in the PV loop
constexpr int kVRows = 8;

// the largest divisor of n that is at most cap
__host__ __device__ constexpr int divisor_upto(int n, int cap) {
  int best = 1;
  for (int k = 1; k <= cap && k <= n; ++k)
    if (n % k == 0) best = k;
  return best;
}

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

// N values (N even) times s, each product rounded to T's precision: the
// dequant_rows_tile arithmetic. bf16 rounds two products per packed convert.
template <typename T, int N>
__device__ __forceinline__ void dequant(float* x, float s) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float a = x[e] * s, b = x[e + 1] * s;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
      const unsigned int u = *reinterpret_cast<unsigned int*>(&h);
      x[e] = __uint_as_float(u << 16);
      x[e + 1] = __uint_as_float(u & 0xffff0000u);
    } else {
      x[e] = a;
      x[e + 1] = b;
    }
  }
}

// N consecutive int8 values as floats, in one load of 2, 4, 8 or 16 bytes
template <int N>
__device__ __forceinline__ void load_s8(const int8_t* p, float* out) {
  static_assert(N == 2 || N == 4 || N == 8 || N == 16, "int8 rows load 2, 4, 8 or 16 bytes");
  if constexpr (N == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    s8x4_to_floats(r.x, out);
    s8x4_to_floats(r.y, out + 4);
  } else if constexpr (N == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    s8x4_to_floats(r.x, out);
    s8x4_to_floats(r.y, out + 4);
    s8x4_to_floats(r.z, out + 8);
    s8x4_to_floats(r.w, out + 12);
  } else if constexpr (N == 4) {
    s8x4_to_floats(*reinterpret_cast<const unsigned int*>(p), out);
  } else {
    float t[4];
    s8x4_to_floats(*reinterpret_cast<const unsigned short*>(p), t);
    out[0] = t[0];
    out[1] = t[1];
  }
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

// int8 pools: the layer's per-row scales, pages of [Hk, bs] fp32. A kernel
// parameter of its own, so the kernels over compute-dtype pools keep
// Problem's layout: grown by these fields, Problem compiled the packed
// kernel to more registers, fewer blocks per SM and a slower kernel.
struct Scales {
  const float* k;
  const float* v;
  long long page_stride;  // scales from one physical page to the next
};

// T: the compute dtype (q, o, P); KV: the pools' storage dtype (T, or int8_t
// with the per-row scales of Problem)
template <typename T, typename KV, int D, int ROWS>
__device__ __forceinline__ void attend_tile(const Problem& P, const Scales& Z) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // a lane's output columns: NC chunks of CW consecutive columns, chunk c at
  // 32 CW c + CW lane. D a multiple of 64 takes one chunk of D / 32; D 80
  // and 96 take pairs in two chunks, the second one's lanes past D idle
  constexpr int CW = D % 64 == 0 ? D / 32 : 2;
  constexpr int NC = (D + 32 * CW - 1) / (32 * CW);
  constexpr int DL = NC * CW;                            // output columns per lane
  constexpr bool kRagged = NC * 32 * CW != D;
  constexpr int VEC = static_cast<int>(16 / sizeof(KV)); // elements per K load
  // loads a lane keeps in flight: decode (few rows of state) issues up to 128
  // values of its K row (all of it up to D 128) and kVRows V rows ahead of
  // use; the packed kernel's 16 rows of state leave no registers for that (on
  // the H100 it ran ~20% slower with them: 254 registers against 168), so it
  // keeps two K chunks and one V row
  constexpr int KSTEP = ROWS >= 16 ? 2 : divisor_upto(D / VEC, 128 / VEC);
  constexpr int VROWS = ROWS >= 16 ? 1 : kVRows;
  __shared__ float q_s[ROWS][D];
  __shared__ float m_s[kWarps][ROWS];
  __shared__ float l_s[kWarps][ROWS];
  __shared__ float acc_s[kWarps][ROWS][D];
  static_assert(sizeof(q_s) + sizeof(m_s) + sizeof(l_s) + sizeof(acc_s) <= 48 * 1024,
                "static shared memory of one block");

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
  const KV* kbase = static_cast<const KV*>(P.k) + head_off;
  const KV* vbase = static_cast<const KV*>(P.v) + head_off;

  for (int page = warp; page < n_pages; page += kWarps) {
    const long long phys = P.block_table[static_cast<long long>(s) * P.B + page];
    const KV* kp = kbase + phys * P.page_stride;
    const KV* vp = vbase + phys * P.page_stride;
    const int slot0 = page * P.bs;
    for (int j0 = 0; j0 < P.bs && slot0 + j0 < live_end; j0 += 32) {
      const int j = j0 + lane;
      const int slot = slot0 + j;
      const bool in_range = j < P.bs && slot < live_end;
      float sc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
      float k_sc = 1.f, v_sc = 1.f;  // this lane's slot's row scales (int8)
      if constexpr (kQuant) {
        if (in_range) {
          const long long row = phys * Z.page_stride +
                                static_cast<long long>(h) * P.bs + j;
          k_sc = Z.k[row];
          v_sc = Z.v[row];
        }
      }
      if (in_range) {
        const KV* krow = kp + static_cast<long long>(j) * D;
#pragma unroll 1
        for (int d1 = 0; d1 < D; d1 += KSTEP * VEC) {
#pragma unroll
          for (int c = 0; c < KSTEP; ++c) {
            const int d0 = d1 + c * VEC;
            float kf[VEC];
            if constexpr (kQuant) {
              load_s8<VEC>(krow + d0, kf);
              dequant<T, VEC>(kf, k_sc);
            } else {
              load_floats<KV, VEC>(krow + d0, kf);
            }
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
          if (j1 + u < n_j) {  // warp-uniform
            const KV* vrow = vp + static_cast<long long>(j0 + j1 + u) * D + lane * CW;
            float vs = 1.f;
            if constexpr (kQuant) vs = __shfl_sync(0xffffffffu, v_sc, j1 + u);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              float* const dst = vf[u] + c * CW;
              if (kRagged && 32 * CW * c + CW * lane >= D) {
#pragma unroll
                for (int e = 0; e < CW; ++e) dst[e] = 0.f;
              } else if constexpr (kQuant) {
                load_s8<CW>(vrow + 32 * CW * c, dst);
                dequant<T, CW>(dst, vs);
              } else {
                load_floats<KV, CW>(vrow + 32 * CW * c, dst);
              }
            }
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
    for (int c = 0; c < NC; ++c) {
      if (kRagged && 32 * CW * c + CW * lane >= D) continue;
#pragma unroll
      for (int e = 0; e < CW; ++e) acc_s[warp][r][32 * CW * c + CW * lane + e] = acc[r][c * CW + e];
    }
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
  attend_tile<T, T, D, packed_rows(D)>(P, Scales{});
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_flash_decode_kernel(Problem P) {
  attend_tile<T, T, D, ROWS>(P, Scales{});
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_flash_decode_int8_kernel(Problem P,
                                                                           Scales Z) {
  attend_tile<T, int8_t, D, ROWS>(P, Z);
}

inline dim3 grid_for(const Problem& P, int S, int rows) {
  return dim3(S, P.Hk, (P.Q * (P.Hq / P.Hk) + rows - 1) / rows);
}

// the decode kernel for a GQA group of G rows, rounded up to 1, 2, 4 or 8;
// INT8: its int8 mode
template <bool INT8, typename T, int D, int ROWS>
void launch_decode(const Problem& P, const Scales& Z, int S, cudaStream_t st) {
  if constexpr (INT8) {
    paged_flash_decode_int8_kernel<T, D, ROWS><<<grid_for(P, S, ROWS), kThreads, 0, st>>>(P, Z);
  } else {
    paged_flash_decode_kernel<T, D, ROWS><<<grid_for(P, S, ROWS), kThreads, 0, st>>>(P);
  }
}

template <bool INT8, typename T, int D>
void launch(const Problem& P, const Scales& Z, int S, bool decode, cudaStream_t st) {
  if constexpr (!INT8) {  // the packed kernel takes compute-dtype pools only
    if (!decode) {
      paged_attention_kernel<T, D><<<grid_for(P, S, packed_rows(D)), kThreads, 0, st>>>(P);
      return;
    }
  }
  const int G = P.Hq / P.Hk;
  if (G <= 1) {
    launch_decode<INT8, T, D, 1>(P, Z, S, st);
  } else if (G <= 2) {
    launch_decode<INT8, T, D, 2>(P, Z, S, st);
  } else if (G <= 4) {
    launch_decode<INT8, T, D, 4>(P, Z, S, st);
  } else {
    launch_decode<INT8, T, D, 8>(P, Z, S, st);
  }
}

template <bool INT8, typename T>
int dispatch(const Problem& P, const Scales& Z, int S, int D, bool decode, cudaStream_t st) {
  // only the head dims of PAGED_HEAD_DIMS are instantiated (each costs
  // build time); any other D is refused, never served by another D's kernel
  return with_paged_head_dim(D, [&](auto dim) {
    launch<INT8, T, decltype(dim)::value>(P, Z, S, decode, st);
    return static_cast<int>(cudaGetLastError());
  });
}

// pools in the compute dtype, or (INT8, decode only) int8 with the scales Z;
// the layer offsets are in elements of each tensor
template <bool INT8>
int run(Problem P, Scales Z, int S, int D, bool decode, long long layer_offset,
        long long scale_layer_offset, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int item = INT8 ? 1 : is_bf16 ? 2 : 4;  // bytes per pool element
  P.k = static_cast<const char*>(P.k) + layer_offset * item;
  P.v = static_cast<const char*>(P.v) + layer_offset * item;
  if constexpr (INT8) {
    Z.k += scale_layer_offset;
    Z.v += scale_layer_offset;
  }
  return is_bf16 ? dispatch<INT8, __nv_bfloat16>(P, Z, S, D, decode, st)
                 : dispatch<INT8, float>(P, Z, S, D, decode, st);
}

}  // namespace
