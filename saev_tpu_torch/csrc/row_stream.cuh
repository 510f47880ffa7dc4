// The persistent row stream of K1 (topk_stats.cu) and K6 (kth.cu): each CTA
// walks the rows blockIdx.x, + gridDim.x, .. of a (B, S) f32 batch, and as
// soon as the CTA holds a row in its registers, thread 0 starts the bulk
// copy (cp.async.bulk on an mbarrier) of its next row into shared memory,
// which lands while this row is worked on. Both kernels' rows end in a short
// select, so a row's load is what a CTA would wait on without it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr uint32_t kCopyBytes = 16 * 1024;  // one bulk copy's bytes

// Thread 0: the row at src into shared memory at dst, on bar's next phase.
__device__ __forceinline__ void fetch_row(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {
  hopper::mbar_expect_tx(bar, bytes);
  for (uint32_t off = 0; off < bytes; off += kCopyBytes)
    hopper::bulk_load(dst + off, reinterpret_cast<const char*>(src) + off, min(kCopyBytes, bytes - off), bar);
}

// Calls row_fn(hr, row, released) for each of this CTA's rows, hr the row
// staged in row_buf (S floats of dynamic shared memory; S % 4 == 0 and h
// 16-byte aligned). Every thread of the CTA calls it. row_fn has every
// thread call released() once the row is in its registers and no thread
// reads hr again: thread 0 then starts the copy of the next row.
template <class RowFn>
__device__ __forceinline__ void stream_rows(const float* __restrict__ h, int B, int S, float* row_buf,
                                            RowFn row_fn) {
  __shared__ __align__(8) uint64_t full;
  const uint32_t bar = hopper::smem_u32(&full), buf = hopper::smem_u32(row_buf);
  const uint32_t bytes = 4u * static_cast<uint32_t>(S);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch_row(buf, h + static_cast<long>(blockIdx.x) * S, bytes, bar);
  }
  __syncthreads();
  uint32_t parity = 0;
  for (long row = blockIdx.x; row < B; row += gridDim.x, parity ^= 1) {
    hopper::mbar_wait(bar, parity);
    const long next = row + gridDim.x;
    row_fn(row_buf, row, [&] {
      if (threadIdx.x == 0 && next < B) {
        // The buffer's reads are done: order them before the copy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_row(buf, h + next * S, bytes, bar);
      }
    });
  }
}

// Launches a streaming kernel (one argument list, `args`) with as many CTAs
// of `threads` as fit on the card at once with 4 S bytes of dynamic shared
// memory each, at most B.
template <class Kernel, class... Args>
cudaError_t launch_stream(Kernel kernel, int B, int S, int threads, cudaStream_t stream, Args... args) {
  const int smem = 4 * S;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = B < sms * per_sm ? B : sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
