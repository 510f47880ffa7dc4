// The order-preserving uint32 key of a float32, shared by the k-th value
// kernels (K1 and P1 through topk_row.cuh, K5 in kth_masked.cu, K6 in kth.cu),
// and the bisection over keys that K1 and K5 run.
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

// The largest t in [lo, hi] with count(t) >= k, for a count(t) of keys >= t
// (non-increasing in t) whose answer lies in [lo, hi]: every t there shares
// lo's and hi's bits above their highest differing bit, so the bisection
// runs over the bits below it only, down to bit `lowest`; the bits below
// that come back cleared, a lower bound of the answer. count(t, step) is
// called once a step, by every thread that calls this, with the same t.
template <class Count>
__device__ __forceinline__ uint32_t bisect(uint32_t lo, uint32_t hi, int k, int lowest, Count count) {
  if (lo == hi) return lo;
  const int top = 31 - __clz(lo ^ hi);
  uint32_t cur = lo & ~((2u << top) - 1u);
#pragma unroll 1
  for (int b = top; b >= lowest; --b) {
    const uint32_t cand = cur | (1u << b);
    if (count(cand, b) >= k) cur = cand;
  }
  return cur;
}

}  // namespace
