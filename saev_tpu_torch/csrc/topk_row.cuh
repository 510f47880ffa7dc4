// K1's per-row routine: the TopK statistics of one f32 row of S values, run
// by a whole CTA. Shared by K1 (topk_stats.cu, one CTA per row) and P1
// (encode_stats.cu, one CTA walking its own rows in turn).
//
// The exact k-th largest value kth by 32-step bisection over the
// order-preserving uint32 key of each float, then f = bf16(where(h >= kth,
// h, 0)), liveness (any bf16 f != 0 over the batch), L0 = count(h >= kth and
// h != 0) and L1 = sum |f32 f|. The row lives in registers (VPT keys a
// thread; thread t holds t, t + T, t + 2T, ...), so the 32 passes read
// registers and each costs one block reduction of integer counts. Liveness
// crosses rows: an int32 (S,) buffer zeroed by the caller and set with
// atomicOr, which does not depend on order. L1 is reduced in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

struct TopkRowSmem {
  int counts[2][32];
  float l1_warp[32];
  int l0_warp[32];
};

// Writes kth_out[row], f[row, :], live, l0_out[row] and l1_out[row] for the
// row `hr` of S values. Every thread of the CTA must call it.
template <int VPT>
__device__ __forceinline__ void topk_stats_row(const float* __restrict__ hr, int S, int k,
                                               long row, TopkRowSmem& sm,
                                               float* __restrict__ kth_out,
                                               __nv_bfloat16* __restrict__ f,
                                               int* __restrict__ live,
                                               float* __restrict__ l0_out,
                                               float* __restrict__ l1_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;

  // Key 0 (the key of the most negative NaN pattern) pads the ragged edge:
  // every candidate below has a bit set, so padding never counts.
  uint32_t key[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int i = tid + j * nt;
    key[j] = i < S ? float_key(hr[i]) : 0u;
  }

  // Largest t with count(key >= t) >= k: the k-th largest key.
  uint32_t cur = 0;
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const uint32_t cand = cur | (1u << b);
    int c = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) c += key[j] >= cand;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) sm.counts[b & 1][warp] = c;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += sm.counts[b & 1][w];
    if (total >= k) cur = cand;
  }
  const float kth = key_float(cur);

  __nv_bfloat16* fr = f + row * S;
  float l1 = 0.f;
  int l0 = 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int i = tid + j * nt;
    if (i < S) {
      const float x = key_float(key[j]);
      const bool keep = x >= kth;  // float compare: -0.0 >= +0.0 holds
      const float fv = keep ? x : 0.f;
      const __nv_bfloat16 fb = __float2bfloat16_rn(fv);
      fr[i] = fb;
      if (__bfloat16_as_ushort(fb) & 0x7FFFu) atomicOr(live + i, 1);
      l0 += keep && x != 0.f;
      l1 += fabsf(fv);
    }
  }
  l0 = __reduce_add_sync(0xffffffffu, l0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  if (lane == 0) {
    sm.l0_warp[warp] = l0;
    sm.l1_warp[warp] = l1;
  }
  __syncthreads();
  if (tid == 0) {
    int l0_total = 0;
    float l1_total = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      l0_total += sm.l0_warp[w];
      l1_total += sm.l1_warp[w];
    }
    kth_out[row] = kth;
    l0_out[row] = static_cast<float>(l0_total);
    l1_out[row] = l1_total;
  }
}

}  // namespace
