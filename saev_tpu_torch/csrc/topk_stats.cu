// K1: the fused TopK statistics of one (B, S) f32 pre-activation batch.
//
// Replaces saev_tpu/ops/pallas_topk.py `_kernel_stats` (via
// `topk_stats_pallas`). For each row: the exact k-th largest value kth by
// 32-step bisection over the order-preserving uint32 key of each float, then
// f = bf16(where(h >= kth, h, 0)), liveness (any bf16 f != 0 over the batch),
// L0 = count(h >= kth and h != 0) and L1 = sum |f32 f|.
//
// What bounds it on the card: device memory. Each row of h is read once
// (4 bytes an element) and f written once (2 bytes), 1.5 GiB at the
// production shape (16384 x 16384), about 0.5 ms at 3.35 TB/s. The 32
// bisection passes are compare-and-count work that must stay on chip.
//
// What the design does about it: one CTA per row keeps the whole row in
// registers (VPT keys a thread, up to 64 at 256 threads for S = 16384), so
// the 32 passes read registers, not memory, and each pass costs one block
// reduction of integer counts. Loads are coalesced (thread t holds elements
// t, t + T, t + 2T, ...). Liveness crosses rows, so it is an int32 (S,)
// buffer zeroed by the caller and set with atomicOr, which does not depend on
// order. L1 is reduced in a fixed order and is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_stats_kernel(const float* __restrict__ h, int S, int k,
                      float* __restrict__ kth_out, __nv_bfloat16* __restrict__ f,
                      int* __restrict__ live, float* __restrict__ l0_out,
                      float* __restrict__ l1_out) {
  __shared__ int counts[2][32];
  __shared__ float l1_warp[32];
  __shared__ int l0_warp[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const long row = blockIdx.x;
  const float* hr = h + row * S;

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
    if (lane == 0) counts[b & 1][warp] = c;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += counts[b & 1][w];
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
    l0_warp[warp] = l0;
    l1_warp[warp] = l1;
  }
  __syncthreads();
  if (tid == 0) {
    int l0_total = 0;
    float l1_total = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      l0_total += l0_warp[w];
      l1_total += l1_warp[w];
    }
    kth_out[row] = kth;
    l0_out[row] = static_cast<float>(l0_total);
    l1_out[row] = l1_total;
  }
}

template <int VPT, int MAXT>
void launch(const float* h, int B, int S, int k, float* kth, __nv_bfloat16* f,
            int* live, float* l0, float* l1, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  topk_stats_kernel<VPT, MAXT>
      <<<B, threads, 0, stream>>>(h, S, k, kth, f, live, l0, l1);
}

}  // namespace

extern "C" int saev_topk_stats(const float* h, int B, int S, int k, float* kth,
                               __nv_bfloat16* f, int* live, float* l0, float* l1,
                               cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (S <= 256 * 4) launch<4, 256>(h, B, S, k, kth, f, live, l0, l1, stream);
  else if (S <= 256 * 8) launch<8, 256>(h, B, S, k, kth, f, live, l0, l1, stream);
  else if (S <= 256 * 16) launch<16, 256>(h, B, S, k, kth, f, live, l0, l1, stream);
  else if (S <= 256 * 32) launch<32, 256>(h, B, S, k, kth, f, live, l0, l1, stream);
  else if (S <= 256 * 64) launch<64, 256>(h, B, S, k, kth, f, live, l0, l1, stream);
  else if (S <= 512 * 64) launch<64, 512>(h, B, S, k, kth, f, live, l0, l1, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}
