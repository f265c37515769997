// The head dims the paged-attention kernels build, on both routes: the
// CUDA-core tile (paged_attention.cu, paged_attention_int8.cu) and the sm90
// design (paged_attention_sm90.cu, paged_attention_sm90_int8.cu). Each
// entry instantiates exactly these, through with_paged_head_dim, and
// refuses any other D with cudaErrorInvalidValue. ops/paged_attention.py's
// _HEAD_DIMS lists the same ones: 64 (TinyLlama), 80 (phi-2, Pythia-2.8B),
// 96 (phi-3-mini), 128 (Llama-2) and 256 (Pythia-1B, GPT-J).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#define PAGED_HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(256)

// f(std::integral_constant<int, D>{}) for a D of PAGED_HEAD_DIMS; any other
// D is refused with cudaErrorInvalidValue, never served by another D's kernel
template <class F>
int with_paged_head_dim(int D, F&& f) {
#define PAGED_CASE(DIM) \
  case DIM:             \
    return f(std::integral_constant<int, DIM>{});
  switch (D) {
    PAGED_HEAD_DIMS(PAGED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CASE
}

// whether the kernels are built for head dim D
inline bool paged_head_dim_built(int D) {
  return with_paged_head_dim(D, [](auto) { return 0; }) == 0;
}
