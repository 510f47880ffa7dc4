// K5: the exact per-row k-th largest value of a (B, S) f32 batch over the
// columns a (S,) mask keeps, the k-th largest of where(mask, h, -inf).
//
// Replaces saev_tpu/ops/pallas_topk.py `_kernel_masked` (via
// `exact_kth_value_masked_pallas`). In the train step it takes the AuxK
// threshold among the dead latents: on the subspace rungs 819 or 3276
// unmasked columns of 1024 or 4096, in the dense step 819 of 16384.
//
// What bounds it on the card: device memory, and only the unmasked columns
// need reading: 16384 x 819 f32 is 54 MB, 0.016 ms at 3.35 TB/s. The 32
// bisection steps over those keys must stay on chip.
//
// What the design does about it: the mask is one vector shared by every row,
// so each CTA compacts it once into the ascending indices of the n unmasked
// columns (uint16 in shared memory; a thread scans a contiguous run of
// columns, one block scan gives its offset), and a row then holds n keys,
// not S. If n < k every row's answer is -inf. Otherwise a masked key,
// key(-inf), lies below every unmasked key that is not NaN, so the answer is
// the k-th largest of the n unmasked keys: a group of G warps (G a power of
// two, the fewest that hold n at KPL keys a lane) gathers them into
// registers and bisects them, one warp reduction a step and, for G > 1, a
// named barrier of the group alone over G partial counts in shared memory.
// The CTAs are persistent, so each compacts the mask once for all the rows
// it walks, and a lane issues all its gathers before it uses one (a slot
// past n reads column idx[n - 1] again and takes key 0).
// The bisection starts below the common prefix of the row's least and
// largest unmasked key (`bisect`, order_key.cuh): the bits above are the
// answer's, so the result is the 32-step bisection's, bit for bit, in fewer
// steps where the keys lie close together (dead latents pinned near one
// value share their sign, exponent and top mantissa bits). At the tight rung
// (n = 819) a row is one warp, 8 rows a CTA, and a step has no block
// barrier. The dead latents of the subspace form come first in its columns
// (stalest_columns), so the gathers are contiguous. The ragged end of the
// compacted row takes key 0, which no step's candidate reaches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

constexpr int kMaxWarps = 16;

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A CTA of W warps walks the rows in groups of G warps; W * 32 * KPL >= S.
// At KPL 32 the registers are held to 64, so two CTAs of 16 warps (or four
// of 8) fit an SM; ptxas then spills a few keys. Against 94 registers and no
// spill, that wins at the wide rung and loses a little at the others
// (scripts/select_probe.py times the caps).
template <int KPL>
__global__ void __launch_bounds__(kMaxWarps * 32, KPL == 32 ? 2 : 1)
    kth_masked_kernel(const float* __restrict__ h, const uint8_t* __restrict__ mask, int B,
                      int S, int k, float* __restrict__ out) {
  extern __shared__ uint16_t idx[];  // S entries
  __shared__ int warp_n[kMaxWarps];
  __shared__ int part[kMaxWarps / 2][2][kMaxWarps];  // group, step parity, warp of the group
  // Group, round parity, least or largest key, warp of the group. A round
  // whose keys are all equal runs no step, so no barrier follows its reads:
  // the next round writes the other half.
  __shared__ uint32_t ends[kMaxWarps / 2][2][2][kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = nt >> 5;

  // 1. The unmasked columns, ascending: thread t scans columns
  // [t * per, (t + 1) * per), per <= 64.
  const int per = (S + nt - 1) / nt;
  const int c0 = tid * per;
  uint64_t bits = 0;
  for (int j = 0; j < per; ++j) {
    const int c = c0 + j;
    if (c < S && mask[c]) bits |= 1ull << j;
  }
  const int cnt = __popcll(bits);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_n[warp] = incl;
  __syncthreads();
  int n = 0, pos = incl - cnt;
  for (int w = 0; w < W; ++w) {
    const int v = warp_n[w];
    pos += w < warp ? v : 0;
    n += v;
  }
  while (bits) {
    const int j = __ffsll(static_cast<long long>(bits)) - 1;
    idx[pos++] = static_cast<uint16_t>(c0 + j);
    bits &= bits - 1;
  }
  __syncthreads();

  // 2. Fewer than k unmasked columns: the k-th largest is -inf.
  if (n < k) {
    for (long row = static_cast<long>(blockIdx.x) * nt + tid; row < B; row += static_cast<long>(gridDim.x) * nt)
      out[row] = -INFINITY;
    return;
  }

  // 3. G warps a row; group q of this CTA takes rows blockIdx.x * groups + q,
  // then every gridDim.x * groups rows on.
  int G = 1;
  while (G * 32 * KPL < n) G <<= 1;
  const int groups = W / G, q = warp / G, g = warp % G;
  const long stride = static_cast<long>(gridDim.x) * groups;
  int rp = 0;  // round parity
#pragma unroll 1
  for (long row = static_cast<long>(blockIdx.x) * groups + q; row < B; row += stride, rp ^= 1) {
    const float* hr = h + row * S;
    uint32_t key[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) key[i] = __float_as_uint(hr[idx[min((i * G + g) * 32 + lane, n - 1)]]);
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const bool in = (i * G + g) * 32 + lane < n;
      key[i] = in ? float_key(__uint_as_float(key[i])) : 0u;
      lo = min(lo, in ? key[i] : 0xFFFFFFFFu);
      hi = max(hi, key[i]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (G > 1) {
      if (lane == 0) {
        ends[q][rp][0][g] = lo;
        ends[q][rp][1][g] = hi;
      }
      group_barrier(1 + q, 32 * G);
      for (int w = 0; w < G; ++w) {
        lo = min(lo, ends[q][rp][0][w]);
        hi = max(hi, ends[q][rp][1][w]);
      }
    }
    // The k-th largest key, in [lo, hi].
    const uint32_t kth = bisect(lo, hi, k, 0, [&](uint32_t t, int b) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < KPL; ++i) c += key[i] >= t;
      c = __reduce_add_sync(0xffffffffu, c);
      if (G > 1) {
        if (lane == 0) part[q][b & 1][g] = c;
        group_barrier(1 + q, 32 * G);
        c = 0;
        for (int w = 0; w < G; ++w) c += part[q][b & 1][w];
      }
      return c;
    });
    if (g == 0 && lane == 0) out[row] = key_float(kth);
  }
}

// As many CTAs as fit the card at once, at most one for each W rows.
template <int KPL>
int launch(const float* h, const uint8_t* mask, int B, int S, int k, float* out, int warps,
           cudaStream_t stream) {
  auto kernel = kth_masked_kernel<KPL>;
  const int smem = S * static_cast<int>(sizeof(uint16_t));
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = (B + warps - 1) / warps;
  const int grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  kernel<<<grid, warps * 32, smem, stream>>>(h, mask, B, S, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int saev_kth_masked(const float* h, const uint8_t* mask, int B, int S, int k,
                               float* out, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (S <= 8 * 32 * 32) return launch<32>(h, mask, B, S, k, out, 8, stream);
  if (S <= 16 * 32 * 32) return launch<32>(h, mask, B, S, k, out, 16, stream);
  if (S <= 16 * 32 * 64) return launch<64>(h, mask, B, S, k, out, 16, stream);
  return cudaErrorInvalidValue;
}
