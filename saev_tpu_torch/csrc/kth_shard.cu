// The candidates of a latent-sharded row's exact k-th largest value: the
// step between K6 (or K5) on each shard and K6 on the gathered candidates
// (ops/topk.py `_sharded_kth`).
//
// A row of S columns is split over F ranks, each holding S / F of them.
// Each rank takes its shard's k-th largest key (K6, or K5 among the
// unmasked columns); t0, the largest of those over the ranks, is at most the
// whole row's k-th largest key, since its shard holds k keys at or above
// it. A shard holds fewer than k keys above its own k-th largest, so fewer
// than k above t0. This kernel writes, for each row, the shard's (unmasked)
// values whose key is above t0's into k slots and fills the rest with t0.
// Gathered over the ranks, the F k candidates of a row hold every key above
// t0 and at least k - (those) copies of t0, so their k-th largest key is the
// whole row's, bit for bit: above t0 where k or more keys are, t0 itself
// otherwise. Keys are order_key.cuh's (-0.0 below +0.0), as K1, K5 and K6
// rank them.
//
// What bounds it on the card: device memory. Each element of the shard is
// read once (4 bytes), the k slots a row written once.
//
// What the design does about it: one CTA of 256 threads a row reads the row
// in coalesced passes of 256 columns; a warp's keys above t0 are compacted
// by a ballot and one shared atomic a warp (the slots' order does not
// matter to the k-th largest).

#include <cuda_runtime.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

constexpr int kShardThreads = 256;

__global__ void __launch_bounds__(kShardThreads)
    kth_candidates_kernel(const float* __restrict__ h, const uint8_t* __restrict__ mask, int S, int k,
                          const float* __restrict__ t0, float* __restrict__ out) {
  __shared__ int n_above;
  const long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const float t = t0[row];
  const uint32_t tk = float_key(t);
  const float* hr = h + row * S;
  float* o = out + row * k;
  for (int j = tid; j < k; j += kShardThreads) o[j] = t;
  if (tid == 0) n_above = 0;
  __syncthreads();
  for (int c0 = 0; c0 < S; c0 += kShardThreads) {
    const int c = c0 + tid;
    float v = 0.f;
    bool above = false;
    if (c < S && (mask == nullptr || mask[c] != 0)) {
      v = hr[c];
      above = float_key(v) > tk;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, above);
    if (ballot == 0u) continue;  // warp-uniform
    int base = 0;
    if (lane == 0) base = atomicAdd(&n_above, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int pos = base + __popc(ballot & ((1u << lane) - 1u));
    if (above && pos < k) o[pos] = v;
  }
}

}  // namespace

// out (B, k): each row's values (at columns where mask, when not null, is
// set) with a key above t0[row]'s, then copies of t0[row]. Fewer than k keys
// of a row may lie above t0[row] (the caller's t0 is at least the row's
// k-th largest key).
extern "C" int saev_kth_candidates(const float* h, const uint8_t* mask, int B, int S, int k, const float* t0,
                                   float* out, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0) return cudaErrorInvalidValue;
  kth_candidates_kernel<<<B, kShardThreads, 0, stream>>>(h, mask, S, k, t0, out);
  return cudaGetLastError();
}
