// Block int8 quantization: quantize (round to nearest), quantize with
// stochastic rounding, and dequantize, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/quant.py:
//   _quant_kernel     -> quant_kernel<TPB, false>
//   _quant_sr_kernel  -> quant_kernel<TPB, true>
//   _dequant_kernel   -> dequant_kernel
// What they compute, per quant block of `block` fp32 values (the flat input
// padded with zeros to a whole number of blocks):
//   absmax = max |x|;  scale = absmax == 0 ? 1 : absmax * fp32(1 / 127)
//   q = clamp(rint(x / scale), -127, 127)            (nearest, half to even)
//   q = clamp(floor(x / scale + u), -127, 127)       (stochastic, u in [0, 1))
//   x' = q * scale                                   (dequantize)
// For finite input the scale is the TPU kernel's where(absmax > 0, ...), and
// absmax / 127 is taken as XLA compiles it, a multiplication by the fp32
// reciprocal (it differs from IEEE division in the last bit). x / scale is
// IEEE division (__fdiv_rn), since multiplying by 127 / absmax differs in
// the last bit and flips ties, and nothing is built with fast math, so this
// kernel, the plain PyTorch version and the JAX kernel agree bitwise.
//
// Non-finite input: absmax propagates a NaN (fmaxf would drop it) and an
// Inf stays Inf, so the block's scale is NaN or Inf; x / scale is then NaN
// or 0 for every element, NaN quantizes to 0, and the whole block decodes
// to 0 * NaN or 0 * Inf = NaN. A non-finite gradient therefore reaches the
// reduced result as NaN, as it would through the exact all-reduce.
//
// Stochastic rounding draws u in the kernel from a counter-based
// Philox4x32-10 keyed by the caller's 64-bit seed, with the element's index
// in the padded input as the counter (one Philox call gives the u of four
// consecutive elements), u = (32-bit word >> 8) * 2^-24 in [0, 1), so the
// zero padding stays exactly 0 (floor(0 + u) = 0). The TPU version reads a
// separate [nb, block] fp32 array of uniforms from memory: 4 bytes per
// element that this kernel never moves.
//
// What bounds them on an H100: each moves 9 bytes per element (quantize:
// read 4, write 1, plus 4 per block of scale; dequantize the reverse) and
// does a few flops per element: far below the ridge, so the bound is bytes
// over 3.35 TB/s. Design: 8 elements per thread as two 16-byte loads and
// one 8-byte store (dequantize: 4 elements per thread as one 4-byte load
// and one 16-byte store, so each warp's store covers 512 contiguous
// bytes); TPB = block / 8 threads per quant block, so a 256-thread CTA holds one
// block of 2048, four of 512 or sixteen of 128; the absmax is a warp
// shuffle reduction, across warps through shared memory. A grid-stride loop
// keeps about 8 CTAs per SM resident for any number of blocks. The ragged
// tail of the input (elements at or past n) loads as 0.
//
// C interface (loaded with ctypes): device pointers, sizes, the caller's
// cudaStream_t; each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kRcp127 = 1.f / 127.f;  // fp32(1 / 127), folded in single precision

__device__ __forceinline__ float max_nan(float a, float b) {
  // max that propagates NaN (a NaN in either operand wins)
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ uint32_t mulhilo(uint32_t a, uint32_t b, uint32_t* hi) {
  *hi = __umulhi(a, b);
  return a * b;
}

// Philox4x32-10 (Salmon et al., SC'11), the generator of curand's Philox.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(0xD2511F53u, c.x, &hi0);
    const uint32_t lo1 = mulhilo(0xCD9E8D57u, c.z, &hi1);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float u01(uint32_t r) {
  return static_cast<float>(r >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ int quant_one(float x, float scale, float u, bool sr) {
  const float y = __fdiv_rn(x, scale);
  const float t = sr ? __fadd_rn(y, u) : y;
  if (t != t) return 0;
  int q = sr ? __float2int_rd(t) : __float2int_rn(t);
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// absmax over the TPB threads of one quant block (TPB a power of two)
template <int TPB>
__device__ __forceinline__ float group_absmax(float v, float* red) {
  constexpr int W = TPB < 32 ? TPB : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (TPB <= 32) {
    return v;
  } else {
    constexpr int NW = TPB / 32;  // warps per quant block
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = (warp / NW) * NW;
    float m = red[first];
#pragma unroll
    for (int i = 1; i < NW; ++i) m = max_nan(m, red[first + i]);
    __syncthreads();  // red is rewritten in the next iteration
    return m;
  }
}

// x: n fp32 values (read as zeros from n on); q: nb * block int8; s: nb fp32
template <int TPB, bool SR>
__global__ void __launch_bounds__(kThreads)
    quant_kernel(const float* __restrict__ x, long long n, long long nb,
                 int8_t* __restrict__ q, float* __restrict__ s, int x_aligned,
                 uint32_t k0, uint32_t k1) {
  constexpr int QPC = kThreads / TPB;  // quant blocks per CTA iteration
  constexpr int BLOCK = TPB * 8;
  __shared__ float red[kThreads / 32];
  const int g = threadIdx.x / TPB;
  const int lane = threadIdx.x % TPB;
  for (long long b0 = static_cast<long long>(blockIdx.x) * QPC; b0 < nb;
       b0 += static_cast<long long>(gridDim.x) * QPC) {
    const long long b = b0 + g;
    const long long base = b * BLOCK + lane * 8;
    float v[8];
    if (b < nb && x_aligned && base + 8 <= n) {
      const float4 a = *reinterpret_cast<const float4*>(x + base);
      const float4 c = *reinterpret_cast<const float4*>(x + base + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (b < nb && base + k < n) ? x[base + k] : 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = max_nan(amax, fabsf(v[k]));
    amax = group_absmax<TPB>(amax, red);
    if (b >= nb) continue;  // after the reduction: every thread joins its barriers
    const float scale = amax == 0.f ? 1.f : __fmul_rn(amax, kRcp127);
    float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (SR) {
      const unsigned long long j = static_cast<unsigned long long>(base) >> 2;
      const uint4 r0 = philox4x32_10(
          make_uint4(static_cast<uint32_t>(j), static_cast<uint32_t>(j >> 32), 0u, 0u), k0, k1);
      const uint4 r1 = philox4x32_10(
          make_uint4(static_cast<uint32_t>(j + 1), static_cast<uint32_t>((j + 1) >> 32), 0u, 0u),
          k0, k1);
      u[0] = u01(r0.x); u[1] = u01(r0.y); u[2] = u01(r0.z); u[3] = u01(r0.w);
      u[4] = u01(r1.x); u[5] = u01(r1.y); u[6] = u01(r1.z); u[7] = u01(r1.w);
    }
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(quant_one(v[k], scale, u[k], SR)));
      w[k / 4] |= byte << (8 * (k % 4));
    }
    *reinterpret_cast<uint2*>(q + base) = make_uint2(w[0], w[1]);
    if (lane == 0) s[b] = scale;
  }
}

// q: rows of 2^log2_block int8; s: one fp32 per row; out: the first n
// dequantized values. One float4 of output per thread and iteration: a
// warp loads 128 contiguous bytes of q and stores 512 contiguous bytes.
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, long long n, int log2_block, int aligned) {
  const long long quads = (n + 3) / 4;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < quads;
       c += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = c * 4;
    const float scale = s[i >> log2_block];
    int8_t b[4];
    if (aligned) {
      const uint32_t p = *reinterpret_cast<const uint32_t*>(q + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = static_cast<int8_t>((p >> (8 * k)) & 0xff);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = q[i + k];
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = __fmul_rn(static_cast<float>(b[k]), scale);
    if (aligned && i + 4 <= n) {
      *reinterpret_cast<float4*>(out + i) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int k = 0; k < 4 && i + k < n; ++k) out[i + k] = o[k];
    }
  }
}

int grid_for(long long work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = 8LL * sms;  // 8 CTAs of 256 threads fill an SM
  return static_cast<int>(work < most ? (work > 0 ? work : 1) : most);
}

template <bool SR>
int launch_quant(const float* x, long long n, long long nb, int block, int8_t* q, float* s,
                 int x_aligned, unsigned long long seed, cudaStream_t st) {
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  const int tpb = block / 8;
  const int grid = grid_for((nb * tpb + kThreads - 1) / kThreads);
  switch (tpb) {
    case 16: quant_kernel<16, SR><<<grid, kThreads, 0, st>>>(x, n, nb, q, s, x_aligned, k0, k1); break;
    case 32: quant_kernel<32, SR><<<grid, kThreads, 0, st>>>(x, n, nb, q, s, x_aligned, k0, k1); break;
    case 64: quant_kernel<64, SR><<<grid, kThreads, 0, st>>>(x, n, nb, q, s, x_aligned, k0, k1); break;
    case 128: quant_kernel<128, SR><<<grid, kThreads, 0, st>>>(x, n, nb, q, s, x_aligned, k0, k1); break;
    case 256: quant_kernel<256, SR><<<grid, kThreads, 0, st>>>(x, n, nb, q, s, x_aligned, k0, k1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// block must be 128, 256, 512, 1024 or 2048 (checked by the wrapper too)
extern "C" int quant_int8(const float* x, long long n, long long nb, int block, int8_t* q,
                          float* s, int x_aligned, void* stream) {
  return launch_quant<false>(x, n, nb, block, q, s, x_aligned, 0ULL,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int quant_int8_sr(const float* x, long long n, long long nb, int block, int8_t* q,
                             float* s, int x_aligned, unsigned long long seed, void* stream) {
  return launch_quant<true>(x, n, nb, block, q, s, x_aligned, seed,
                            static_cast<cudaStream_t>(stream));
}

// block = 2^log2_block (the wrapper takes the quantizer's blocks only)
extern "C" int dequant_int8(const int8_t* q, const float* s, float* out, long long n,
                            int log2_block, int aligned, void* stream) {
  const int grid = grid_for(((n + 3) / 4 + kThreads - 1) / kThreads);
  if (n > 0) {
    dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, s, out, n, log2_block, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
