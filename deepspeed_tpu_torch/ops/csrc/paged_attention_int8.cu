// The int8 mode of the paged flash-decode kernel on the CUDA cores: the
// cuda_core route of the quantized=True mode of _decode_kernel in
// deepspeed_tpu/ops/pallas/paged_attention.py (fp32 queries, and shapes the
// sm90 design in paged_attention_sm90_int8.cu does not take). Its design and
// arithmetic are described at the top of paged_attention.cu; the tile it
// instantiates (attend_tile<T, int8_t, D, ROWS>) is in paged_attention.cuh.
// A source of its own so that its 40 instantiations (8 per head dim) build
// in parallel with the others.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; the entry returns cudaGetLastError() after launch.

#include "paged_attention.cuh"

// the int8 mode: k_pool / v_pool int8 [L, N, Hk, bs, D], k_scale / v_scale
// fp32 [L, N, Hk, bs]; offsets and strides in elements of each
extern "C" int paged_flash_decode_int8_fwd(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, void* o, float* m, float* l, const int* block_table,
    const int* pos, const int* kv_len, int S, int Hq, int Hk, int D, int bs,
    int B, long long layer_offset, long long page_stride,
    long long scale_layer_offset, long long scale_page_stride, float sm_scale,
    int is_bf16, void* stream) {
  Problem P{q, o, m, l, k_pool, v_pool, block_table, pos, nullptr,
            kv_len, 1, Hq, Hk, bs, B, page_stride, sm_scale};
  return run<true>(P, Scales{k_scale, v_scale, scale_page_stride}, S, D, true,
                   layer_offset, scale_layer_offset, is_bf16, stream);
}
