// P1: the encoder product fused with K1's TopK statistics.
//
// Replaces scripts/proto_encode_stats.py `_kernel` (via
// `encode_stats_pallas`): h = bf16(x) @ W_enc + b_enc with bf16 operands and
// f32 accumulation, then K1's statistics of that same h (kth, f, live, L0,
// L1; topk_row.cuh). x is rounded to bf16 to nearest even inside the kernel,
// as the TPU kernel does. h is an output too.
//
// What bounds it on the card: the product's tensor-core work, 2 * B * D * S
// = 0.55 TFLOP at B = S = 16384, D = 1024 (about 0.6 ms at the card's dense
// bf16 rate, several ms at this kernel's mma.sync rate), then K1's row work:
// its candidate-filter select over registers a row, and h read back (1 GiB)
// and f written (0.5 GiB).
//
// The hard part: a row's bisection needs all S of its h values (64 KB in
// f32). The TPU kernel kept a 256-row tile of h in VMEM; here a 128-row tile
// is 8 MB and cannot stay on chip. So each CTA owns 128 rows and works in
// three phases, with no CTA waiting on another:
//  1. it rounds its 128 rows of x to bf16 into a scratch (B, D) buffer
//     (256 KB a CTA), so the product streams bf16 A tiles with cp.async;
//  2. it computes its rows of h one 128-column tile after another (the
//     tile_mma.cuh GEMM), adds b_enc and writes h to device memory;
//  3. it runs K1's row routine on each of its rows in turn, reading h back.
// Bytes: every CTA reads all of W (D * S * 2 = 32 MB), 4 GB over the 128
// CTAs; the CTAs walk the column tiles in step, so each W tile (256 KB) is
// fetched from device memory about once and served to the others from L2.
// The read-back of h does not stay in L2: the 128 CTAs write their 8 MB of
// h each (1 GiB in all) before any reads it back, against a 50 MB L2, so at
// most about 5% of the read-back hits L2 and the rest costs a second 1 GiB
// read of device memory, as the two-pass form pays. What fusion saves here
// is one launch and the f32 h of an f32 encoder, not h's round trip.
// One CTA per 128 rows gives 128 CTAs of 256 threads for B = 16384: one wave
// on 132 SMs, one CTA an SM, so phase 3 runs one row at a time an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_mma.cuh"
#include "topk_row.cuh"

using namespace saev;

namespace {

template <int VPT>
__global__ void __launch_bounds__(THREADS, 1)
    encode_stats_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ b_enc, int D, int S, int k,
                        __nv_bfloat16* __restrict__ xb, float* __restrict__ h,
                        float* __restrict__ kth, __nv_bfloat16* __restrict__ f,
                        int* __restrict__ live, float* __restrict__ l0,
                        float* __restrict__ l1) {
  __shared__ __align__(16) __nv_bfloat16 smem[4 * STAGE_ELEMS];
  __shared__ TopkRowSmem<THREADS> sm;
  const long b0 = (long)blockIdx.x * BM;

  // 1. This CTA's rows of x, rounded to bf16 to nearest even.
  const long n_x = (long)BM * D;
  for (long i = 2 * threadIdx.x; i < n_x; i += 2 * THREADS) {
    const float2 v = *reinterpret_cast<const float2*>(x + b0 * D + i);
    __nv_bfloat162 o;
    o.x = __float2bfloat16_rn(v.x);
    o.y = __float2bfloat16_rn(v.y);
    *reinterpret_cast<__nv_bfloat162*>(xb + b0 * D + i) = o;
  }
  __threadfence();  // the stores reach L2 before cp.async.cg reads them there
  __syncthreads();

  // 2. h[b0 .. b0 + 128, :] = bf16(x) @ W + b_enc, one column tile at a time.
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  for (long n0 = 0; n0 < S; n0 += BN) {
    Acc acc;
    zero(acc);
    gemm_range(acc, smem, xb, D, b0, w, S, n0, 0, D);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long row = b0 + wm + 16 * i + (l >> 2) + 8 * hh;
          const long col = n0 + wn + 8 * t + 2 * (l & 3);
          const float2 bv = *reinterpret_cast<const float2*>(b_enc + col);
          *reinterpret_cast<float2*>(h + row * S + col) =
              make_float2(acc.v[i][t][2 * hh] + bv.x, acc.v[i][t][2 * hh + 1] + bv.y);
        }
  }
  __threadfence();
  __syncthreads();

  // 3. K1's statistics on each of this CTA's rows of h (S is a multiple of
  // BN and h and f are the wrapper's own tensors, so rows take 16-byte loads).
  for (int i = 0; i < BM; ++i) {
    const long row = b0 + i;
    topk_stats_row<VPT, THREADS, true>(h + row * S, S, k, row, sm, kth, f, live, l0, l1, nullptr,
                                       [] {});
    __syncthreads();
  }
}

template <int VPT>
void launch(const float* x, const __nv_bfloat16* w, const float* b_enc, int B, int D, int S,
            int k, __nv_bfloat16* xb, float* h, float* kth, __nv_bfloat16* f, int* live,
            float* l0, float* l1, cudaStream_t stream) {
  encode_stats_kernel<VPT><<<B / BM, THREADS, 0, stream>>>(x, w, b_enc, D, S, k, xb, h, kth,
                                                          f, live, l0, l1);
}

}  // namespace

// live must be zeroed by the caller; xb is a (B, D) bf16 scratch buffer.
extern "C" int saev_encode_stats(const float* x, const __nv_bfloat16* w, const float* b_enc,
                                 int B, int D, int S, int k, __nv_bfloat16* xb, float* h,
                                 float* kth, __nv_bfloat16* f, int* live, float* l0,
                                 float* l1, cudaStream_t stream) {
  if (B <= 0 || B % BM != 0 || D <= 0 || D % BK != 0 || S <= 0 || S % BN != 0 || k <= 0 ||
      k > S)
    return cudaErrorInvalidValue;
  if (S <= THREADS * 4) launch<4>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, stream);
  else if (S <= THREADS * 8) launch<8>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, stream);
  else if (S <= THREADS * 16) launch<16>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, stream);
  else if (S <= THREADS * 32) launch<32>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, stream);
  else if (S <= THREADS * 64) launch<64>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}
