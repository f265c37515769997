// Host Adam / AdamW for the ZeRO-Offload optimizer step: the port's own copy
// of the JAX package's csrc/adam/cpu_adam.cpp, with the same C ABI, the same
// fused loop and the same round-to-nearest-even bf16 emission, so the two
// libraries give bitwise the same masters, moments and bf16 output.
//
// It replaces no TPU kernel: the JAX package runs this step on the host too
// (reference DeepSpeedCPUAdam, csrc/adam/cpu_adam_impl.cpp). The fp32 masters
// and both moments live in host memory; the card sends the clipped gradients
// down and receives compute-dtype parameters back. The loop reads p, m, v and
// g and writes p, m, v (and the bf16 copy) once per element: it is bound by
// the host's memory bandwidth. A std::thread pool splits large leaves across
// the cores; each thread runs the loop on scalars (g++ keeps it scalar for
// the branches in its body), which is the simple first version.
//
// The JAX source leaves the multiply-adds to the compiler, which contracts
// four of them into fused multiply-adds (g++ -O3 -march=native on an x86 CPU
// with FMA). This copy writes those four as std::fma and is built with
// -ffp-contract=off, so its arithmetic is what the source says on any
// compiler, and the plain version (cpu_adam_reference) can repeat it
// exactly.
//
// One addition the JAX source lacks: dstpu_cpu_adam_bf16g takes the gradient
// in bf16 (offload_optimizer.grad_dtype "bfloat16") and widens it in the
// loop, so the host never holds an fp32 copy of the gradients. Widening
// bf16 to fp32 is exact, so it gives bitwise what dstpu_cpu_adam gives on
// the widened gradient.
//
// Exported C ABI (ctypes):
//   dstpu_cpu_adam(p, m, v, g, n, lr, b1, b2, eps, wd, step, adamw_mode,
//                  bias_correction, out_bf16_or_null, nthreads)
//   dstpu_cpu_adam_bf16g(...the same, with g a bf16 array...)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint16_t f32_to_bf16_rne(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u) return uint16_t((x >> 16) | 0x0040);  // NaN
  uint32_t lsb = (x >> 16) & 1u;
  return uint16_t((x + 0x7fffu + lsb) >> 16);
}

inline float widen(float g) { return g; }

inline float widen(uint16_t g) {
  uint32_t x = uint32_t(g) << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

template <typename G>
void adam_chunk(float* p, float* m, float* v, const G* g, int64_t lo,
                int64_t hi, float lr, float b1, float b2, float eps, float wd,
                int adamw, float bc1, float bc2, uint16_t* out_bf16) {
  const float omb1 = 1.0f - b1, omb2 = 1.0f - b2;
  for (int64_t i = lo; i < hi; ++i) {
    float gi = widen(g[i]);
    float pi = p[i];
    if (!adamw) gi = std::fma(wd, pi, gi);            // gi += wd * pi
    float mi = std::fma(b1, m[i], omb1 * gi);         // b1 m + (1 - b1) g
    float vi = std::fma(b2, v[i], omb2 * gi * gi);    // b2 v + (1 - b2) g g
    m[i] = mi;
    v[i] = vi;
    float upd = -lr * (mi / bc1) / (std::sqrt(vi / bc2) + eps);
    if (adamw) upd = std::fma(-(lr * wd), pi, upd);   // upd -= lr wd pi
    pi += upd;
    p[i] = pi;
    if (out_bf16) out_bf16[i] = f32_to_bf16_rne(pi);
  }
}

template <typename G>
void adam(float* p, float* m, float* v, const G* g, int64_t n, float lr,
          float b1, float b2, float eps, float wd, int step, int adamw_mode,
          int bias_correction, uint16_t* out_bf16, int nthreads) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(b1, float(step));
    bc2 = 1.0f - std::pow(b2, float(step));
  }
  if (nthreads <= 0) {
    nthreads = int(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 4;
  }
  const int64_t min_chunk = 1 << 16;  // threads only pay off on big leaves
  int chunks = int(std::min<int64_t>(nthreads, (n + min_chunk - 1) / min_chunk));
  if (chunks <= 1) {
    adam_chunk<G>(p, m, v, g, 0, n, lr, b1, b2, eps, wd, adamw_mode, bc1, bc2,
                  out_bf16);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(chunks);
  int64_t per = (n + chunks - 1) / chunks;
  for (int c = 0; c < chunks; ++c) {
    int64_t lo = c * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back(adam_chunk<G>, p, m, v, g, lo, hi, lr, b1, b2, eps, wd,
                      adamw_mode, bc1, bc2, out_bf16);
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

void dstpu_cpu_adam(float* p, float* m, float* v, const float* g, int64_t n,
                    float lr, float b1, float b2, float eps, float wd,
                    int step, int adamw_mode, int bias_correction,
                    uint16_t* out_bf16, int nthreads) {
  adam<float>(p, m, v, g, n, lr, b1, b2, eps, wd, step, adamw_mode,
              bias_correction, out_bf16, nthreads);
}

void dstpu_cpu_adam_bf16g(float* p, float* m, float* v, const uint16_t* g,
                          int64_t n, float lr, float b1, float b2, float eps,
                          float wd, int step, int adamw_mode,
                          int bias_correction, uint16_t* out_bf16,
                          int nthreads) {
  adam<uint16_t>(p, m, v, g, n, lr, b1, b2, eps, wd, step, adamw_mode,
                 bias_correction, out_bf16, nthreads);
}

}  // extern "C"
