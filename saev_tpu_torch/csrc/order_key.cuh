// The order-preserving uint32 key of a float32, shared by the k-th value
// kernels (K1 and P1 through topk_row.cuh, K5 and K6 in kth.cu).
//
// Non-negative floats get the sign bit set; negative floats are bit-inverted.
// The map is monotone in the float's value (with -0.0 just below +0.0), so
// the k-th largest key maps back to the k-th largest float.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t float_key(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key >> 31) ? (key & 0x7FFFFFFFu) : ~key);
}

}  // namespace
