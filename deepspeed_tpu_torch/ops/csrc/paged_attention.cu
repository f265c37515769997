// Paged attention over the blocked KV pool on the CUDA cores: the fp32
// route of both paged kernels, and the route of shapes the sm90 design does
// not take (page sizes other than 16, 32 or 64 slots, GQA groups over 64
// heads, tensors TMA cannot describe). Both routes build the head dims of
// paged_head_dims.cuh: 64, 80, 96, 128 and 256; a lane owns D / 32 output
// columns where D is a multiple of 64, pairs of columns in two chunks at
// D 80 and 96. bf16 on Hopper takes the sm90
// design in paged_attention_sm90.cu; ops/paged_attention.py::paged_route
// chooses.
//
// Replaces the two TPU kernels of deepspeed_tpu/ops/pallas/paged_attention.py:
//   paged_attention_kernel     <- _kernel        (SplitFuse packed chunks, one
//                                                 layer's [N, Hk, bs, D] pool)
//   paged_flash_decode_kernel  <- _decode_kernel (one query per sequence over
//                                                 the resident [L, N, Hk, bs, D]
//                                                 pool: bf16/fp32 storage, and
//                                                 the quantized=True mode on
//                                                 int8 storage with fp32
//                                                 per-row scales [L, N, Hk, bs])
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
// int8 mode (decode only): each K and V row is dequantized as it is read,
// k = round_to_T(float(k8) * k_scale[row]) — the ops/quant.py
// dequant_rows_tile arithmetic, one fp32 product rounded once to the
// compute dtype T (bf16: a bf16 rounding; fp32: none) — before its products,
// exactly as the TPU kernel dequantizes the page tile in VMEM. Its bound is
// the live-page bytes, (D + 4) / (2 D) of the bf16 mode's at the same shape
// (D int8 bytes and one fp32 scale per row against 2 D bytes). A K row of
// D 128 is 128 B, eight 16-byte loads per lane; the 32 lanes of a slot group
// read 32 consecutive scales (one 128-byte load); for PV each lane owns D/32
// int8 columns (a 4-byte load at D 128) and the V row's scale reaches the
// warp by a shuffle from the lane that loaded it beside its K scale. int8
// becomes fp32 by a byte permute and a subtraction (no conversion
// instruction), and bf16 rounds two products per packed convert, bit for
// bit what a convert per element gives. Each warp walks its pages one after
// another, and the dequant lengthens that serial chain, so the mode is not
// faster than the bf16 mode on half its bytes (PERF.md).
//
// What bounds them on an H100: decode reads every live K/V page once and does
// 4*D flops per (query row, slot), about one flop per byte in bf16 — far
// below the card's ~295 flops per byte, so it is memory-bound; its bound is
// the live-page bytes over 3.35 TB/s. The packed kernel over a 128-token
// prompt chunk does up to 128 flops per page byte: against the card's peaks
// that is still below the ridge (memory-bound), but this design does its
// arithmetic in fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor
// cores' 989), so prefill chunks run operation-bound in practice (the sm90
// design runs QK and PV on wgmma).
//
// Design (one CUDA-core tile; the sm90 design adds TMA staging, wgmma and
// split-KV across blocks):
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
// The tile and the launchers live in paged_attention.cuh; the int8 mode's
// instantiations build from paged_attention_int8.cu in parallel with these.
//
// C interface (loaded with ctypes): pointers as void*, the stream as the
// caller's cudaStream_t, each entry returns cudaGetLastError() after launch.

#include "paged_attention.cuh"

extern "C" int paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, void* o, float* m,
    float* l, const int* block_table, const int* start_pos,
    const int* chunk_len, const int* kv_len, int S, int Q, int Hq, int Hk,
    int D, int bs, int B, long long page_stride, float sm_scale, int is_bf16,
    void* stream) {
  Problem P{q, o, m, l, k_pool, v_pool, block_table, start_pos, chunk_len,
            kv_len, Q, Hq, Hk, bs, B, page_stride, sm_scale};
  return run<false>(P, Scales{}, S, D, false, 0, 0, is_bf16, stream);
}

extern "C" int paged_flash_decode_fwd(
    const void* q, const void* k_pool, const void* v_pool, void* o, float* m,
    float* l, const int* block_table, const int* pos, const int* kv_len,
    int S, int Hq, int Hk, int D, int bs, int B, long long layer_offset,
    long long page_stride, float sm_scale, int is_bf16, void* stream) {
  Problem P{q, o, m, l, k_pool, v_pool, block_table, pos, nullptr,
            kv_len, 1, Hq, Hk, bs, B, page_stride, sm_scale};
  return run<false>(P, Scales{}, S, D, true, layer_offset, 0, is_bf16, stream);
}
