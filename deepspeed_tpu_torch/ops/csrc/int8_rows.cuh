// int8 values as floats, shared by the paged-attention kernels that
// dequantize int8 KV pools (paged_attention.cuh, paged_attention_sm90.cuh).

#pragma once

namespace {

// the 4 signed bytes of w as floats, exactly and without a conversion
// instruction: each byte, biased to unsigned, becomes the low mantissa byte
// of 2^23 (one byte permute), and 2^23 + 128 is subtracted
__device__ __forceinline__ void s8x4_to_floats(unsigned int w, float* out) {
  const unsigned int x = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - 8388736.f;
}

}  // namespace
