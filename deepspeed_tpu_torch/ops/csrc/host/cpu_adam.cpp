// Host Adam / AdamW for the ZeRO-Offload optimizer step: the port's own
// version of the JAX package's csrc/adam/cpu_adam.cpp, with its C ABI, its
// arithmetic and its round-to-nearest-even bf16 emission, so the two
// libraries give bitwise the same masters, moments and bf16 output.
//
// It replaces no TPU kernel: the JAX package runs this step on the host too
// (reference DeepSpeedCPUAdam, csrc/adam/cpu_adam_impl.cpp). The fp32 masters
// and both moments live in host memory; the card sends the clipped gradients
// down and receives compute-dtype parameters back. The loop reads p, m, v and
// g and writes p, m, v (and the bf16 copy) once per element: it is bound by
// the host's memory bandwidth.
//
// Three routes run the same loop, chosen once per loaded library from what
// the CPU offers (__builtin_cpu_supports), or forced per call:
//   avx512  16 lanes of intrinsics (avx512f + avx512bw), the tail under a
//           mask, so any length and start offset is exact; the bf16 output
//           leaves by non-temporal stores (the ring's H2D copy reads it, not
//           this core), and p, m, v and g are prefetched 512 elements (2 KiB
//           of fp32) ahead, across the 4 KiB pages where the hardware's
//           stream prefetcher stops. dstpu_cpu_adam_set_stream and
//           dstpu_cpu_adam_set_prefetch turn either off, so each can be timed
//           against the loop without it;
//   avx2    8 lanes (avx2 + fma), the tail on the scalar loop;
//   scalar  one element at a time (kept scalar: the route of a CPU without
//           AVX2, and the reference the vector routes are held to).
// Each lane does what the scalar loop does, in its order: the four fused
// multiply-adds are fmadd (one rounding each, as std::fma), the divides and
// the square root are the correctly rounded div / sqrt (no rsqrt or rcp
// approximation), a bf16 gradient is widened by a zero-extend and a shift,
// and the bf16 output is the integer round-to-nearest-even below, NaN case
// included (not vcvtneps2bf16, which takes a denormal input as zero).
// g++ would not vectorise the scalar loop itself: under the default
// -fmath-errno, std::sqrt carries a branch that sets errno. The library is
// built with -fno-math-errno, so no route has that branch.
//
// The JAX source leaves the multiply-adds to the compiler, which contracts
// four of them into fused multiply-adds (g++ -O3 -march=native on an x86 CPU
// with FMA). This version writes those four as std::fma / fmadd and is built
// with -ffp-contract=off, so its arithmetic is what the source says on any
// compiler, and the plain version (cpu_adam_reference) can repeat it
// exactly.
//
// Threads: a pool started at the first call that wants more than one
// thread, sized by the CPUs the process may run on (sched_getaffinity),
// parked on a condition variable between calls; the calling thread takes
// the first share. A call splits the total elements of its slices evenly
// over the threads (a leaf may be split, and small leaves share a thread),
// at most `nthreads` of them when that is positive, and never more than the
// pool holds.
//
// One addition the JAX source lacks: the *_bf16g entries take the gradient
// in bf16 (offload_optimizer.grad_dtype "bfloat16") and widen it in the
// loop, so the host never holds an fp32 copy of the gradients. Widening
// bf16 to fp32 is exact, so they give bitwise what the fp32 entries give on
// the widened gradient.
//
// Exported C ABI (ctypes):
//   dstpu_cpu_adam(p, m, v, g, n, lr, b1, b2, eps, wd, step, adamw_mode,
//                  bias_correction, out_bf16_or_null, nthreads)
//   dstpu_cpu_adam_bf16g(...the same, with g a bf16 array...)
//   dstpu_cpu_adam_slices(nslices, p[], m[], v[], g[], out[]_or_null, n[],
//                         lr, b1, b2, eps, wd, step, adamw_mode,
//                         bias_correction, route, nthreads) -> 0, or -1 for a
//                         route the CPU lacks
//   dstpu_cpu_adam_slices_bf16g(...the same, with g[] bf16 arrays...)
//   dstpu_cpu_adam_routes() -> bit r set for each route r the CPU runs
//                              (0 scalar, 1 avx2, 2 avx512)
//   dstpu_cpu_adam_best_route() -> the route the per-leaf entries take
//   dstpu_cpu_adam_threads() -> the pool's size
//   dstpu_cpu_adam_set_stream(on) -> the avx512 route's bf16 stores
//                                    non-temporal (1, the default) or plain
//                                    (0); returns the previous setting
//   dstpu_cpu_adam_set_prefetch(elements) -> how far ahead the avx512 route
//                                    prefetches (512, the default; 0: not at
//                                    all); returns the previous distance
//   dstpu_host_stream(kind, a, b, c, d, out, n, nthreads) -> seconds of one
//       pass of a memory stream with no Adam arithmetic over the pool (see
//       "stream" below), or -1 where the CPU lacks avx512 or the arrays are
//       not 64-byte aligned and a multiple of 64 elements long

#include <immintrin.h>
#include <sched.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Route { kScalar = 0, kAvx2 = 1, kAvx512 = 2 };

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2;
  int adamw;
};

Hyper make_hyper(float lr, float b1, float b2, float eps, float wd, int step,
                 int adamw_mode, int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(b1, float(step));
    bc2 = 1.0f - std::pow(b2, float(step));
  }
  return Hyper{lr, b1, b2, eps, wd, bc1, bc2, adamw_mode};
}

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

// ---------------------------------------------------------------- scalar --

template <typename G>
__attribute__((optimize("no-tree-vectorize"))) void adam_scalar(
    const Hyper& h, float* p, float* m, float* v, const G* g, uint16_t* out,
    int64_t n) {
  const float lr = h.lr, b1 = h.b1, b2 = h.b2, eps = h.eps, wd = h.wd;
  const float omb1 = 1.0f - b1, omb2 = 1.0f - b2;
  for (int64_t i = 0; i < n; ++i) {
    float gi = widen(g[i]);
    float pi = p[i];
    if (!h.adamw) gi = std::fma(wd, pi, gi);          // gi += wd * pi
    float mi = std::fma(b1, m[i], omb1 * gi);         // b1 m + (1 - b1) g
    float vi = std::fma(b2, v[i], omb2 * gi * gi);    // b2 v + (1 - b2) g g
    m[i] = mi;
    v[i] = vi;
    float upd = -lr * (mi / h.bc1) / (std::sqrt(vi / h.bc2) + eps);
    if (h.adamw) upd = std::fma(-(lr * wd), pi, upd);  // upd -= lr wd pi
    pi += upd;
    p[i] = pi;
    if (out) out[i] = f32_to_bf16_rne(pi);
  }
}

// ---------------------------------------------------------------- avx512 --

#define DSTPU_AVX512 __attribute__((target("avx512f,avx512bw")))

std::atomic<bool> g_stream_bf16{true};  // dstpu_cpu_adam_set_stream
std::atomic<int> g_prefetch{512};       // dstpu_cpu_adam_set_prefetch

DSTPU_AVX512 inline __m512 load_g16(const float* g, __mmask16 k) {
  return _mm512_maskz_loadu_ps(k, g);
}

DSTPU_AVX512 inline __m512 load_g16(const uint16_t* g, __mmask16 k) {
  const __m256i half = _mm512_castsi512_si256(_mm512_maskz_loadu_epi16(__mmask32(k), g));
  return _mm512_castsi512_ps(_mm512_slli_epi32(_mm512_cvtepu16_epi32(half), 16));
}

// f32_to_bf16_rne in 16 lanes, each in the low half of a 32-bit lane
DSTPU_AVX512 inline __m512i bf16_rne16(__m512 f) {
  const __m512i x = _mm512_castps_si512(f);
  const __m512i hi = _mm512_srli_epi32(x, 16);
  const __m512i lsb = _mm512_and_si512(hi, _mm512_set1_epi32(1));
  const __m512i r = _mm512_srli_epi32(
      _mm512_add_epi32(_mm512_add_epi32(x, _mm512_set1_epi32(0x7fff)), lsb), 16);
  const __mmask16 nan = _mm512_cmpgt_epi32_mask(
      _mm512_and_si512(x, _mm512_set1_epi32(0x7fffffff)), _mm512_set1_epi32(0x7f800000));
  return _mm512_mask_or_epi32(r, nan, hi, _mm512_set1_epi32(0x0040));
}

template <typename G>
DSTPU_AVX512 void adam_avx512(const Hyper& h, float* p, float* m, float* v,
                              const G* g, uint16_t* out, int64_t n) {
  const __m512 b1 = _mm512_set1_ps(h.b1), b2 = _mm512_set1_ps(h.b2);
  const __m512 omb1 = _mm512_set1_ps(1.0f - h.b1), omb2 = _mm512_set1_ps(1.0f - h.b2);
  const __m512 bc1 = _mm512_set1_ps(h.bc1), bc2 = _mm512_set1_ps(h.bc2);
  const __m512 eps = _mm512_set1_ps(h.eps), wd = _mm512_set1_ps(h.wd);
  const __m512 neg_lr = _mm512_set1_ps(-h.lr), neg_lr_wd = _mm512_set1_ps(-(h.lr * h.wd));
  // whole 16-lane vectors of the bf16 output go out by non-temporal stores
  // (no read for ownership; the H2D copy reads them, not this core) once
  // out + i is 32-byte aligned: the first `head` elements go under a mask
  const uintptr_t addr = reinterpret_cast<uintptr_t>(out);
  const bool stream = out != nullptr && addr % 2 == 0 &&
                      g_stream_bf16.load(std::memory_order_relaxed);
  const int64_t head = stream ? std::min<int64_t>(n, (32 - addr % 32) % 32 / 2) : 0;
  const int64_t ahead = g_prefetch.load(std::memory_order_relaxed);
  for (int64_t i = 0, w; i < n; i += w) {
    w = i < head ? head - i : std::min<int64_t>(16, n - i);
    const __mmask16 k = w == 16 ? __mmask16(0xffff) : __mmask16((1u << w) - 1);
    if (ahead > 0) {  // a prefetch past the end of an array is dropped, never faults
      _mm_prefetch(reinterpret_cast<const char*>(p + i + ahead), _MM_HINT_T0);
      _mm_prefetch(reinterpret_cast<const char*>(m + i + ahead), _MM_HINT_T0);
      _mm_prefetch(reinterpret_cast<const char*>(v + i + ahead), _MM_HINT_T0);
      _mm_prefetch(reinterpret_cast<const char*>(g + i + ahead), _MM_HINT_T0);
    }
    __m512 gi = load_g16(g + i, k);
    __m512 pi = _mm512_maskz_loadu_ps(k, p + i);
    if (!h.adamw) gi = _mm512_fmadd_ps(wd, pi, gi);
    const __m512 mi = _mm512_fmadd_ps(b1, _mm512_maskz_loadu_ps(k, m + i),
                                      _mm512_mul_ps(omb1, gi));
    const __m512 vi = _mm512_fmadd_ps(b2, _mm512_maskz_loadu_ps(k, v + i),
                                      _mm512_mul_ps(_mm512_mul_ps(omb2, gi), gi));
    _mm512_mask_storeu_ps(m + i, k, mi);
    _mm512_mask_storeu_ps(v + i, k, vi);
    __m512 upd = _mm512_div_ps(
        _mm512_mul_ps(neg_lr, _mm512_div_ps(mi, bc1)),
        _mm512_add_ps(_mm512_sqrt_ps(_mm512_div_ps(vi, bc2)), eps));
    if (h.adamw) upd = _mm512_fmadd_ps(neg_lr_wd, pi, upd);
    pi = _mm512_add_ps(pi, upd);
    _mm512_mask_storeu_ps(p + i, k, pi);
    if (stream && w == 16 && i >= head)
      _mm256_stream_si256(reinterpret_cast<__m256i*>(out + i),
                          _mm512_cvtepi32_epi16(bf16_rne16(pi)));
    else if (out)
      _mm512_mask_cvtepi32_storeu_epi16(out + i, k, bf16_rne16(pi));
  }
  if (stream) _mm_sfence();  // the streamed stores before the caller's next read
}

// ------------------------------------------------------------------ avx2 --

#define DSTPU_AVX2 __attribute__((target("avx2,fma")))

DSTPU_AVX2 inline __m256 load_g8(const float* g) { return _mm256_loadu_ps(g); }

DSTPU_AVX2 inline __m256 load_g8(const uint16_t* g) {
  const __m128i half = _mm_loadu_si128(reinterpret_cast<const __m128i*>(g));
  return _mm256_castsi256_ps(_mm256_slli_epi32(_mm256_cvtepu16_epi32(half), 16));
}

// f32_to_bf16_rne in 8 lanes, packed to 8 uint16
DSTPU_AVX2 inline __m128i bf16_rne8(__m256 f) {
  const __m256i x = _mm256_castps_si256(f);
  const __m256i hi = _mm256_srli_epi32(x, 16);
  const __m256i lsb = _mm256_and_si256(hi, _mm256_set1_epi32(1));
  const __m256i r = _mm256_srli_epi32(
      _mm256_add_epi32(_mm256_add_epi32(x, _mm256_set1_epi32(0x7fff)), lsb), 16);
  const __m256i nan = _mm256_cmpgt_epi32(
      _mm256_and_si256(x, _mm256_set1_epi32(0x7fffffff)), _mm256_set1_epi32(0x7f800000));
  const __m256i out = _mm256_blendv_epi8(
      r, _mm256_or_si256(hi, _mm256_set1_epi32(0x0040)), nan);
  // every lane is below 2^16, so the unsigned saturating pack is exact
  return _mm_packus_epi32(_mm256_castsi256_si128(out), _mm256_extracti128_si256(out, 1));
}

template <typename G>
DSTPU_AVX2 void adam_avx2(const Hyper& h, float* p, float* m, float* v,
                          const G* g, uint16_t* out, int64_t n) {
  const __m256 b1 = _mm256_set1_ps(h.b1), b2 = _mm256_set1_ps(h.b2);
  const __m256 omb1 = _mm256_set1_ps(1.0f - h.b1), omb2 = _mm256_set1_ps(1.0f - h.b2);
  const __m256 bc1 = _mm256_set1_ps(h.bc1), bc2 = _mm256_set1_ps(h.bc2);
  const __m256 eps = _mm256_set1_ps(h.eps), wd = _mm256_set1_ps(h.wd);
  const __m256 neg_lr = _mm256_set1_ps(-h.lr), neg_lr_wd = _mm256_set1_ps(-(h.lr * h.wd));
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 gi = load_g8(g + i);
    __m256 pi = _mm256_loadu_ps(p + i);
    if (!h.adamw) gi = _mm256_fmadd_ps(wd, pi, gi);
    const __m256 mi = _mm256_fmadd_ps(b1, _mm256_loadu_ps(m + i), _mm256_mul_ps(omb1, gi));
    const __m256 vi = _mm256_fmadd_ps(b2, _mm256_loadu_ps(v + i),
                                      _mm256_mul_ps(_mm256_mul_ps(omb2, gi), gi));
    _mm256_storeu_ps(m + i, mi);
    _mm256_storeu_ps(v + i, vi);
    __m256 upd = _mm256_div_ps(
        _mm256_mul_ps(neg_lr, _mm256_div_ps(mi, bc1)),
        _mm256_add_ps(_mm256_sqrt_ps(_mm256_div_ps(vi, bc2)), eps));
    if (h.adamw) upd = _mm256_fmadd_ps(neg_lr_wd, pi, upd);
    pi = _mm256_add_ps(pi, upd);
    _mm256_storeu_ps(p + i, pi);
    if (out) _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i), bf16_rne8(pi));
  }
  adam_scalar(h, p + i, m + i, v + i, g + i, out ? out + i : nullptr, n - i);
}

// ----------------------------------------------------------------- routes --

int supported_routes() {
  static const int routes = [] {
    __builtin_cpu_init();
    int r = 1 << kScalar;
    if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma")) r |= 1 << kAvx2;
    if (__builtin_cpu_supports("avx512f") && __builtin_cpu_supports("avx512bw"))
      r |= 1 << kAvx512;
    return r;
  }();
  return routes;
}

int best_route() {
  const int r = supported_routes();
  return (r & (1 << kAvx512)) ? kAvx512 : (r & (1 << kAvx2)) ? kAvx2 : kScalar;
}

template <typename G>
void adam_range(int route, const Hyper& h, float* p, float* m, float* v,
                const G* g, uint16_t* out, int64_t n) {
  if (route == kAvx512)
    adam_avx512(h, p, m, v, g, out, n);
  else if (route == kAvx2)
    adam_avx2(h, p, m, v, g, out, n);
  else
    adam_scalar(h, p, m, v, g, out, n);
}

// ------------------------------------------------------------------- pool --

int process_cpus() {
  cpu_set_t set;
  CPU_ZERO(&set);
  if (sched_getaffinity(0, sizeof(set), &set) == 0 && CPU_COUNT(&set) > 0)
    return CPU_COUNT(&set);
  const unsigned hc = std::thread::hardware_concurrency();
  return hc > 0 ? int(hc) : 1;
}

// Workers 1..size-1 park on a condition variable; Run hands each of the
// first nt threads job(t), the caller doing t = 0, and returns when all are
// done. One call runs at a time.
class Pool {
 public:
  explicit Pool(int size) : size_(size) {
    for (int id = 1; id < size; ++id) std::thread([this, id] { Work(id); }).detach();
  }

  int size() const { return size_; }

  void Run(int nt, const std::function<void(int)>& job) {
    std::lock_guard<std::mutex> one_call(call_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      job_ = &job;
      active_ = nt;
      left_ = nt - 1;
      ++generation_;
    }
    wake_.notify_all();
    job(0);
    std::unique_lock<std::mutex> lk(m_);
    done_.wait(lk, [&] { return left_ == 0; });
  }

 private:
  void Work(int id) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* job;
      {
        std::unique_lock<std::mutex> lk(m_);
        wake_.wait(lk, [&] { return generation_ != seen; });
        seen = generation_;
        if (id >= active_) continue;
        job = job_;
      }
      (*job)(id);
      std::lock_guard<std::mutex> lk(m_);
      if (--left_ == 0) done_.notify_one();
    }
  }

  const int size_;
  std::mutex call_m_, m_;
  std::condition_variable wake_, done_;
  const std::function<void(int)>* job_ = nullptr;
  uint64_t generation_ = 0;
  int active_ = 0, left_ = 0;
};

// The pool of this process, started at first use and never torn down (its
// threads are parked at exit). A forked child starts its own.
Pool& pool() {
  static std::mutex m;
  static Pool* p = nullptr;
  static pid_t owner = 0;
  std::lock_guard<std::mutex> lk(m);
  if (p == nullptr || owner != getpid()) {
    p = new Pool(process_cpus());
    owner = getpid();
  }
  return *p;
}

// a thread's share is worth waking it for from this many elements on
constexpr int64_t kMinPerThread = 1 << 16;

template <typename G>
void run_slices(int route, const Hyper& h, int ns, float* const* p, float* const* m,
                float* const* v, const G* const* g, uint16_t* const* out,
                const int64_t* n, int nthreads) {
  std::vector<int64_t> start(ns + 1, 0);
  for (int s = 0; s < ns; ++s) start[s + 1] = start[s] + std::max<int64_t>(n[s], 0);
  const int64_t total = start[ns];
  if (total == 0) return;
  int64_t nt = (total + kMinPerThread - 1) / kMinPerThread;
  if (nthreads > 0) nt = std::min<int64_t>(nt, nthreads);
  // the pool runs at most its size of shares: cut no more than it has
  Pool* workers = nt > 1 ? &pool() : nullptr;
  if (workers) nt = std::min<int64_t>(nt, workers->size());
  auto job = [&](int t) {
    // whole cache lines of fp32 and bf16 at the split points (64 elements)
    const auto split = [&](int64_t k) { return k == nt ? total : total * k / nt / 64 * 64; };
    const int64_t lo = split(t), hi = split(t + 1);
    int s = int(std::upper_bound(start.begin(), start.end(), lo) - start.begin()) - 1;
    for (; s < ns && start[s] < hi; ++s) {
      const int64_t a = std::max(lo, start[s]) - start[s];
      const int64_t b = std::min(hi, start[s + 1]) - start[s];
      if (a < b)
        adam_range(route, h, p[s] + a, m[s] + a, v[s] + a, g[s] + a,
                   out && out[s] ? out[s] + a : nullptr, b - a);
    }
  };
  if (nt <= 1)
    job(0);
  else
    workers->Run(int(nt), job);
}

// ---------------------------------------------------------------- stream --
// The host's memory ceiling, the rate the host Adam's bound is taken from:
// the same pool moving bytes with no arithmetic beyond an add, each thread a
// contiguous share (whole cache lines), its inputs prefetched as the avx512
// route prefetches them, streamed stores 64-byte aligned.
//   kind 0  read:  sum a                                     4 B an element
//   kind 1  rmw:   a += b                                    12 B
//   kind 2  adam:  a, b, c += d; out = the top half of a's
//                  bits, streamed (the host Adam's traffic) 30 B
//   kind 3  copy:  b = a, streamed                           8 B

DSTPU_AVX512 void stream_share(int kind, float* a, float* b, float* c, const float* d,
                               uint16_t* out, int64_t lo, int64_t hi, float* sink) {
  __m512 s0 = _mm512_setzero_ps(), s1 = s0, s2 = s0, s3 = s0;
  const int64_t ahead = g_prefetch.load(std::memory_order_relaxed);
  // the arrays this kind reads (a streamed destination is not prefetched)
  const float* reads[4] = {a, kind == 1 || kind == 2 ? b : nullptr, kind == 2 ? c : nullptr,
                           kind == 2 ? d : nullptr};
  for (int64_t i = lo; i < hi; i += 64) {
    if (ahead > 0)  // each of the 64 elements' four cache lines
      for (const float* x : reads)
        for (int64_t line = 0; x && line < 64; line += 16)
          _mm_prefetch(reinterpret_cast<const char*>(x + i + ahead + line), _MM_HINT_T0);
    if (kind == 0) {
      s0 = _mm512_add_ps(s0, _mm512_load_ps(a + i));
      s1 = _mm512_add_ps(s1, _mm512_load_ps(a + i + 16));
      s2 = _mm512_add_ps(s2, _mm512_load_ps(a + i + 32));
      s3 = _mm512_add_ps(s3, _mm512_load_ps(a + i + 48));
      continue;
    }
    for (int64_t j = i; j < i + 64; j += 16) {
      const __m512 x = _mm512_load_ps(a + j);
      if (kind == 1) {
        _mm512_store_ps(a + j, _mm512_add_ps(x, _mm512_load_ps(b + j)));
      } else if (kind == 2) {
        const __m512 g = _mm512_load_ps(d + j);
        const __m512 p = _mm512_add_ps(x, g);
        _mm512_store_ps(a + j, p);
        _mm512_store_ps(b + j, _mm512_add_ps(_mm512_load_ps(b + j), g));
        _mm512_store_ps(c + j, _mm512_add_ps(_mm512_load_ps(c + j), g));
        _mm256_stream_si256(reinterpret_cast<__m256i*>(out + j),
                            _mm512_cvtepi32_epi16(_mm512_srli_epi32(_mm512_castps_si512(p), 16)));
      } else {
        _mm512_stream_ps(b + j, x);
      }
    }
  }
  _mm_sfence();
  float lanes[16];
  _mm512_storeu_ps(lanes, _mm512_add_ps(_mm512_add_ps(s0, s1), _mm512_add_ps(s2, s3)));
  *sink = lanes[0];
}

double host_stream(int kind, float* a, float* b, float* c, const float* d, uint16_t* out,
                   int64_t n, int nthreads) {
  const auto aligned = [](const void* x) {
    return x == nullptr || reinterpret_cast<uintptr_t>(x) % 64 == 0;
  };
  const bool needs[4][5] = {{1, 0, 0, 0, 0}, {1, 1, 0, 0, 0}, {1, 1, 1, 1, 1}, {1, 1, 0, 0, 0}};
  const void* arrays[5] = {a, b, c, d, out};
  if (kind < 0 || kind > 3 || n <= 0 || n % 64 != 0 || !(supported_routes() & (1 << kAvx512)))
    return -1;
  for (int k = 0; k < 5; ++k)
    if (needs[kind][k] && (arrays[k] == nullptr || !aligned(arrays[k]))) return -1;
  Pool& workers = pool();
  const int nt = nthreads > 0 ? std::min(nthreads, workers.size()) : workers.size();
  std::vector<float> sinks(nt);
  const auto job = [&](int t) {
    stream_share(kind, a, b, c, d, out, n * t / nt / 64 * 64, n * (t + 1) / nt / 64 * 64,
                 &sinks[t]);
  };
  const auto t0 = std::chrono::steady_clock::now();
  if (nt <= 1)
    job(0);
  else
    workers.Run(nt, job);
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

template <typename G>
int slices_entry(int ns, float* const* p, float* const* m, float* const* v,
                 const G* const* g, uint16_t* const* out, const int64_t* n, float lr,
                 float b1, float b2, float eps, float wd, int step, int adamw_mode,
                 int bias_correction, int route, int nthreads) {
  if (route < kScalar || route > kAvx512 || !(supported_routes() & (1 << route))) return -1;
  run_slices<G>(route, make_hyper(lr, b1, b2, eps, wd, step, adamw_mode, bias_correction),
                ns, p, m, v, g, out, n, nthreads);
  return 0;
}

}  // namespace

extern "C" {

void dstpu_cpu_adam(float* p, float* m, float* v, const float* g, int64_t n,
                    float lr, float b1, float b2, float eps, float wd,
                    int step, int adamw_mode, int bias_correction,
                    uint16_t* out_bf16, int nthreads) {
  slices_entry<float>(1, &p, &m, &v, &g, &out_bf16, &n, lr, b1, b2, eps, wd, step,
                      adamw_mode, bias_correction, best_route(), nthreads);
}

void dstpu_cpu_adam_bf16g(float* p, float* m, float* v, const uint16_t* g,
                          int64_t n, float lr, float b1, float b2, float eps,
                          float wd, int step, int adamw_mode,
                          int bias_correction, uint16_t* out_bf16,
                          int nthreads) {
  slices_entry<uint16_t>(1, &p, &m, &v, &g, &out_bf16, &n, lr, b1, b2, eps, wd, step,
                         adamw_mode, bias_correction, best_route(), nthreads);
}

int dstpu_cpu_adam_slices(int nslices, float* const* p, float* const* m, float* const* v,
                          const float* const* g, uint16_t* const* out, const int64_t* n,
                          float lr, float b1, float b2, float eps, float wd, int step,
                          int adamw_mode, int bias_correction, int route, int nthreads) {
  return slices_entry<float>(nslices, p, m, v, g, out, n, lr, b1, b2, eps, wd, step,
                             adamw_mode, bias_correction, route, nthreads);
}

int dstpu_cpu_adam_slices_bf16g(int nslices, float* const* p, float* const* m,
                                float* const* v, const uint16_t* const* g,
                                uint16_t* const* out, const int64_t* n, float lr, float b1,
                                float b2, float eps, float wd, int step, int adamw_mode,
                                int bias_correction, int route, int nthreads) {
  return slices_entry<uint16_t>(nslices, p, m, v, g, out, n, lr, b1, b2, eps, wd, step,
                                adamw_mode, bias_correction, route, nthreads);
}

int dstpu_cpu_adam_routes() { return supported_routes(); }

int dstpu_cpu_adam_best_route() { return best_route(); }

int dstpu_cpu_adam_threads() { return process_cpus(); }

int dstpu_cpu_adam_set_stream(int on) { return g_stream_bf16.exchange(on != 0); }

int dstpu_cpu_adam_set_prefetch(int elements) {
  return g_prefetch.exchange(std::max(elements, 0));
}

double dstpu_host_stream(int kind, float* a, float* b, float* c, const float* d,
                         uint16_t* out, int64_t n, int nthreads) {
  return host_stream(kind, a, b, c, d, out, n, nthreads);
}

}  // extern "C"
