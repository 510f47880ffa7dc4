// K6: the exact per-row k-th largest value of a (B, S) f32 batch.
//
// Replaces saev_tpu/ops/pallas_topk.py `_kernel` (via
// `exact_kth_value_pallas`): the k-th largest order key of the row, found bit
// by bit over 32 compare-and-count passes, mapped back to a float. The ragged
// end of a row beyond S takes key 0, which no candidate reaches, so it never
// counts. (K5, the column-masked form, is kth_masked.cu.)
//
// What bounds it on the card: device memory. Each element of h is read once
// (4 bytes), 1 GiB at 16384 x 16384, about 0.32 ms at 3.35 TB/s; the output
// is 4 bytes a row. The 32 passes must stay on chip.
//
// What the design does about it: one CTA per row holds the row's keys in
// registers (VPT a thread, coalesced: thread t holds t, t + T, ...), so each
// pass reads registers and costs one block reduction of integer counts.
//
// P3 (`count_loop_kernel`) replaces scripts/microbench_kth.py `loop_kernel`
// (via `count_loop`): the same row layout and per-pass reduction with the
// bisection's data dependence taken out, sum_{i < n} count(key >= i) over
// int32 keys. It measures what n compare-and-count passes cost on their own,
// the floor under K6's 32 passes and K1's whole-row fallback.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    kth_kernel(const float* __restrict__ h, int S, int k, float* __restrict__ out) {
  __shared__ int counts[2][32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const long row = blockIdx.x;
  const float* hr = h + row * S;

  uint32_t key[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + j * nt;
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
  if (tid == 0) out[row] = key_float(cur);
}

template <int VPT, int MAXT>
void launch(const float* h, int B, int S, int k, float* out, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  kth_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(h, S, k, out);
}

// P3: out[row] = sum_{i < n_passes} count(key[row, :] >= i). The ragged end
// of a row takes INT_MIN, which no pass counts.
template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    count_loop_kernel(const int* __restrict__ key, int S, int n_passes, int* __restrict__ out) {
  __shared__ int counts[2][32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const long row = blockIdx.x;
  const int* kr = key + row * S;

  int kv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + j * nt;
    kv[j] = i < S ? kr[i] : INT_MIN;
  }
  int acc = 0;
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) c += kv[j] >= p;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) counts[p & 1][warp] = c;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += counts[p & 1][w];
    acc += total;
  }
  if (tid == 0) out[row] = acc;
}

template <int VPT, int MAXT>
void launch_count(const int* key, int B, int S, int n_passes, int* out, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  count_loop_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(key, S, n_passes, out);
}

}  // namespace

extern "C" int saev_count_loop(const int* key, int B, int S, int n_passes, int* out,
                               cudaStream_t stream) {
  if (B <= 0 || S <= 0 || n_passes < 0) return cudaErrorInvalidValue;
  if (S <= 256 * 4) launch_count<4, 256>(key, B, S, n_passes, out, stream);
  else if (S <= 256 * 8) launch_count<8, 256>(key, B, S, n_passes, out, stream);
  else if (S <= 256 * 16) launch_count<16, 256>(key, B, S, n_passes, out, stream);
  else if (S <= 256 * 32) launch_count<32, 256>(key, B, S, n_passes, out, stream);
  else if (S <= 256 * 64) launch_count<64, 256>(key, B, S, n_passes, out, stream);
  else if (S <= 512 * 64) launch_count<64, 512>(key, B, S, n_passes, out, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int saev_kth(const float* h, int B, int S, int k, float* out,
                        cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (S <= 256 * 4) launch<4, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 8) launch<8, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 16) launch<16, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 32) launch<32, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 64) launch<64, 256>(h, B, S, k, out, stream);
  else if (S <= 512 * 64) launch<64, 512>(h, B, S, k, out, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}
