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
// order. L1 is reduced in a fixed order and is deterministic. The per-row
// routine is in topk_row.cuh, shared with P1 (encode_stats.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_row.cuh"

namespace {

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_stats_kernel(const float* __restrict__ h, int S, int k,
                      float* __restrict__ kth_out, __nv_bfloat16* __restrict__ f,
                      int* __restrict__ live, float* __restrict__ l0_out,
                      float* __restrict__ l1_out) {
  __shared__ TopkRowSmem sm;
  const long row = blockIdx.x;
  topk_stats_row<VPT>(h + row * S, S, k, row, sm, kth_out, f, live, l0_out, l1_out);
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
