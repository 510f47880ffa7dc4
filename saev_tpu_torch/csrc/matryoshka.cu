// The fixed-order sum of per-CTA loss partials that K2 (prefix_fwd.cu) and
// P2 (prefix_gouter.cu) share: one CTA, a strided sum a thread, then a
// block reduction in a fixed order, so the loss is the same bits every run.
// (P2 itself moved to prefix_gouter.cu; this file held it on mma.sync until
// then, as it held K2-K4 before prefix_fwd.cu, dgrad.cu and wgrad.cu.)

#include "tile_mma.cuh"

using namespace saev;

namespace {

// Fixed-order sum of the per-CTA loss partials: bitwise the same every run.
__global__ void __launch_bounds__(THREADS)
    sum_partials_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) v += partials[i];
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace

cudaError_t saev_sum_partials(const float* partials, int n, float* out, cudaStream_t stream) {
  sum_partials_kernel<<<1, THREADS, 0, stream>>>(partials, n, out);
  return cudaGetLastError();
}
