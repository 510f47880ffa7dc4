// K1: the fused TopK statistics of one (B, S) f32 pre-activation batch.
//
// Replaces saev_tpu/ops/pallas_topk.py `_kernel_stats` (via
// `topk_stats_pallas`). For each row: the exact k-th largest value kth, then
// f = bf16(where(h >= kth, h, 0)), liveness (any bf16 f != 0 over the
// batch), L0 = count(h >= kth and h != 0) and L1 = sum |f32 f|.
//
// What bounds it on the card: device memory. Each row of h is read once
// (4 bytes an element) and f written once (2 bytes), 1.5 GiB at the
// production shape (16384 x 16384), about 0.5 ms at 3.35 TB/s.
//
// What the design does about it: a CTA keeps a whole row in registers (VPT
// keys a thread, 64 at 256 threads for S = 16384) and selects its k-th
// largest key by a candidate filter (topk_row.cuh): a lower bound from the
// per-thread maxima, the few keys above it compacted into shared memory and
// ranked, so a row pays four block barriers and not one a bisection step; a
// row whose candidates overflow the buffer takes the whole-row bisection in
// the same kernel. With the select that short, a row's load is what a CTA
// waits on, so where S % 4 == 0 the CTAs are persistent and stream: each
// walks rows blockIdx.x, + gridDim.x, .., and as soon as a row is in its
// registers one thread starts the bulk copy (cp.async.bulk on an mbarrier)
// of its next row into shared memory, which lands while this row is
// selected (row_stream.cuh, shared with K6). Other rows (S % 4 != 0) take
// one CTA a row and scalar loads.
// Liveness crosses rows, so it is an int32 (S,) buffer zeroed by the caller
// and set with atomicOr, which does not depend on order. L1 is reduced in a
// fixed order and is deterministic. The per-row routine is shared with P1
// (encode_stats.cu), and its select with K6 (kth.cu).
//
// The threshold entry (`saev_topk_stats_given`) is K1 with the select
// skipped: a latent-sharded row's kth is found over its shards (the exact
// k-th largest of the whole row, ops/topk.py `_sharded_kth`), and each
// shard writes its f, live, L0 and L1 from it with the same epilogue, the
// same stream and the same layouts (`topk_given_stream_kernel`,
// `topk_given_kernel`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"
#include "topk_row.cuh"

namespace {

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_stats_stream_kernel(const float* __restrict__ h, int B, int S, int k,
                             float* __restrict__ kth_out, __nv_bfloat16* __restrict__ f,
                             int* __restrict__ live, float* __restrict__ l0_out,
                             float* __restrict__ l1_out, int* __restrict__ fallback) {
  extern __shared__ __align__(16) float row_buf[];  // S floats
  __shared__ TopkRowSmem<MAXT> sm;
  stream_rows(h, B, S, row_buf, [&](const float* hr, long row, auto released) {
    topk_stats_row<VPT, MAXT, true>(hr, S, k, row, sm, kth_out, f, live, l0_out, l1_out, fallback, released);
  });
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_stats_kernel(const float* __restrict__ h, int S, int k,
                      float* __restrict__ kth_out, __nv_bfloat16* __restrict__ f,
                      int* __restrict__ live, float* __restrict__ l0_out,
                      float* __restrict__ l1_out, int* __restrict__ fallback) {
  __shared__ TopkRowSmem<MAXT> sm;
  const long row = blockIdx.x;
  topk_stats_row<VPT, MAXT, false>(h + row * S, S, k, row, sm, kth_out, f, live, l0_out, l1_out, fallback,
                                   [] {});
}

// The threshold entry's kernels: K1's with kth given, read from kth_in.
template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_given_stream_kernel(const float* __restrict__ h, int B, int S, float* __restrict__ kth_in,
                             __nv_bfloat16* __restrict__ f, int* __restrict__ live, float* __restrict__ l0_out,
                             float* __restrict__ l1_out) {
  extern __shared__ __align__(16) float row_buf[];  // S floats
  __shared__ TopkRowSmem<MAXT> sm;
  stream_rows(h, B, S, row_buf, [&](const float* hr, long row, auto released) {
    topk_stats_row<VPT, MAXT, true, true>(hr, S, 1, row, sm, kth_in, f, live, l0_out, l1_out, nullptr, released);
  });
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    topk_given_kernel(const float* __restrict__ h, int S, float* __restrict__ kth_in,
                      __nv_bfloat16* __restrict__ f, int* __restrict__ live, float* __restrict__ l0_out,
                      float* __restrict__ l1_out) {
  __shared__ TopkRowSmem<MAXT> sm;
  const long row = blockIdx.x;
  topk_stats_row<VPT, MAXT, false, true>(h + row * S, S, 1, row, sm, kth_in, f, live, l0_out, l1_out, nullptr,
                                         [] {});
}

template <int VPT, int MAXT, bool GIVEN = false>
int launch(const float* h, int B, int S, int k, float* kth, __nv_bfloat16* f, int* live,
           float* l0, float* l1, int* fallback, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  const bool streamed = S % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(f) % 8 == 0;
  if constexpr (GIVEN) {
    if (!streamed) {
      topk_given_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(h, S, kth, f, live, l0, l1);
      return cudaGetLastError();
    }
    return launch_stream(topk_given_stream_kernel<VPT, MAXT>, B, S, threads, stream, h, B, S, kth, f, live, l0,
                         l1);
  } else {
    if (!streamed) {
      topk_stats_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(h, S, k, kth, f, live, l0, l1, fallback);
      return cudaGetLastError();
    }
    return launch_stream(topk_stats_stream_kernel<VPT, MAXT>, B, S, threads, stream, h, B, S, k, kth, f, live,
                         l0, l1, fallback);
  }
}

}  // namespace

// live must be zeroed by the caller; fallback, when not null, gains 1 for
// each row that took the whole-row bisection.
extern "C" int saev_topk_stats(const float* h, int B, int S, int k, float* kth,
                               __nv_bfloat16* f, int* live, float* l0, float* l1,
                               int* fallback, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (S <= 256 * 4) return launch<4, 256>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (S <= 256 * 8) return launch<8, 256>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (S <= 256 * 16) return launch<16, 256>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (S <= 256 * 32) return launch<32, 256>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (S <= 256 * 64) return launch<64, 256>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (S <= 512 * 64) return launch<64, 512>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  return cudaErrorInvalidValue;
}

// The threshold entry, on K1's layouts: kth (B floats) is read, not
// written; live must be zeroed by the caller.
extern "C" int saev_topk_stats_given(const float* h, int B, int S, float* kth, __nv_bfloat16* f, int* live,
                                     float* l0, float* l1, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (S <= 256 * 4) return launch<4, 256, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (S <= 256 * 8) return launch<8, 256, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (S <= 256 * 16) return launch<16, 256, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (S <= 256 * 32) return launch<32, 256, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (S <= 256 * 64) return launch<64, 256, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (S <= 512 * 64) return launch<64, 512, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  return cudaErrorInvalidValue;
}
