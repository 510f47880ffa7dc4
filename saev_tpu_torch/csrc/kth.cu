// K6: the exact per-row k-th largest value of a (B, S) f32 batch.
//
// Replaces saev_tpu/ops/pallas_topk.py `_kernel` (via
// `exact_kth_value_pallas`): the k-th largest order key of the row (the
// 32-pass bisection's answer, bit for bit), mapped back to a float. (K5, the
// column-masked form, is kth_masked.cu.)
//
// What bounds it on the card: device memory. Each element of h is read once
// (4 bytes), 1 GiB at 16384 x 16384, about 0.32 ms at 3.35 TB/s; the output
// is 4 bytes a row.
//
// What the design does about it: K1's select (topk_row.cuh `row_keys` and
// `select_kth_key`) without K1's epilogue. A CTA holds a row in registers,
// finds a lower bound of its k-th largest key from the per-thread maxima,
// compacts the few keys above it into shared memory and ranks them, so a
// row pays a few block barriers and not one a bisection step; a row whose
// candidates overflow the buffer, or with k above the threads that hold a
// column, bisects the whole row in registers in the same kernel. With the
// select that short, where S % 4 == 0 the CTAs are persistent and stream
// their rows (row_stream.cuh, as K1 does); other rows take one CTA a row and
// scalar loads.
//
// P3, the raw compare-and-count loop, lives beside P4 in kth_ops.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"
#include "topk_row.cuh"

namespace {

// One row: the select, then thread 0 writes the k-th largest value.
template <int VPT, int MAXT, bool VEC, class Released>
__device__ __forceinline__ void kth_row(const float* __restrict__ hr, int S, int k, long row,
                                        SelectSmem<MAXT>& sm, float* __restrict__ out,
                                        int* __restrict__ fallback, Released released) {
  uint32_t key[VPT];
  const uint32_t mx = row_keys<VPT, VEC>(hr, S, key);
  const uint32_t kth = select_kth_key<VPT, MAXT>(key, mx, S, k, sm, fallback, released);
  if (threadIdx.x == 0) out[row] = key_float(kth);
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    kth_stream_kernel(const float* __restrict__ h, int B, int S, int k, float* __restrict__ out,
                      int* __restrict__ fallback) {
  extern __shared__ __align__(16) float row_buf[];  // S floats
  __shared__ SelectSmem<MAXT> sm;
  stream_rows(h, B, S, row_buf, [&](const float* hr, long row, auto released) {
    kth_row<VPT, MAXT, true>(hr, S, k, row, sm, out, fallback, released);
    __syncthreads();  // the next row's select reuses sm
  });
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    kth_kernel(const float* __restrict__ h, int S, int k, float* __restrict__ out, int* __restrict__ fallback) {
  __shared__ SelectSmem<MAXT> sm;
  const long row = blockIdx.x;
  kth_row<VPT, MAXT, false>(h + row * S, S, k, row, sm, out, fallback, [] {});
}

template <int VPT, int MAXT>
int launch(const float* h, int B, int S, int k, float* out, int* fallback, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  if (S % 4 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0) {
    kth_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(h, S, k, out, fallback);
    return cudaGetLastError();
  }
  return launch_stream(kth_stream_kernel<VPT, MAXT>, B, S, threads, stream, h, B, S, k, out, fallback);
}

}  // namespace

// fallback, when not null, gains 1 for each row that took the whole-row
// bisection.
extern "C" int saev_kth(const float* h, int B, int S, int k, float* out, int* fallback,
                        cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (S <= 256 * 4) return launch<4, 256>(h, B, S, k, out, fallback, stream);
  if (S <= 256 * 8) return launch<8, 256>(h, B, S, k, out, fallback, stream);
  if (S <= 256 * 16) return launch<16, 256>(h, B, S, k, out, fallback, stream);
  if (S <= 256 * 32) return launch<32, 256>(h, B, S, k, out, fallback, stream);
  if (S <= 256 * 64) return launch<64, 256>(h, B, S, k, out, fallback, stream);
  if (S <= 512 * 64) return launch<64, 512>(h, B, S, k, out, fallback, stream);
  return cudaErrorInvalidValue;
}
