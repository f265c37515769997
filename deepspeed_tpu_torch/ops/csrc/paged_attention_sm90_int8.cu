// The int8 mode of the paged decode kernel on Hopper's tensor-core path
// (sm_90a): replaces the quantized=True mode of _decode_kernel in
// deepspeed_tpu/ops/pallas/paged_attention.py. Its design is described at the
// top of paged_attention_sm90.cu (the kernel template is in
// paged_attention_sm90.cuh); a source of its own so that it builds in
// parallel with the bf16 instantiations. Each page's int8 K and V rows and
// their fp32 scales land by bulk copy, and the consumer dequantizes them in
// shared memory (bf16(float(v8) * scale), the ops/quant.py dequant_rows_tile
// arithmetic) before wgmma reads them. Its bound is the live-page bytes,
// (D + 4) / (2 D) of the bf16 mode's.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t; the entry returns 0 or a cudaError_t.

#include "paged_attention_sm90.cuh"

// bf16 q [S, Hq, D]; int8 pools [L, N, Hk, bs, D] as `rows` rows of D and
// fp32 scales [L, N, Hk, bs], the layer's first row row0; ws as for
// paged_attention_sm90_fwd
extern "C" int paged_flash_decode_int8_sm90_fwd(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, void* o, float* m, float* l, const int* block_table, const int* pos,
    const int* kv_len, float* ws, int S, int Hq, int Hk, int D, int bs, int B, long long rows,
    long long row0, int split_tiles, int n_splits, int item_rows, int tile_slots, int blocks,
    float sm_scale, void* stream) {
  if (!paged_shape_ok(S, 1, Hq, Hk, D, bs, B, rows, split_tiles, n_splits, item_rows,
                      tile_slots, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p = paged_params(q, o, m, l, block_table, pos, nullptr, kv_len, ws, S, 1, Hq, Hk,
                               bs, B, row0, split_tiles, n_splits, sm_scale);
  p.k8 = static_cast<const int8_t*>(k_pool);
  p.v8 = static_cast<const int8_t*>(v_pool);
  p.ks = k_scale;
  p.vs = v_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_paged_head_dim(D, [&](auto dim) {
    return launch_paged<decltype(dim)::value, true>(p, k_pool, v_pool, rows, st);
  });
}

// blocks per SM of the int8 mode's instantiation a launch takes (blocks_per_sm)
extern "C" int paged_sm90_blocks_per_sm(int D, int G, int decode) {
  return blocks_per_sm<true>(D, G, decode != 0);
}
