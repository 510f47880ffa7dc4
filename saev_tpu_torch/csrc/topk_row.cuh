// K1's per-row routine: the TopK statistics of one f32 row of S values, run
// by a whole CTA. Shared by K1 (topk_stats.cu, streamed rows or one CTA a
// row) and P1 (encode_stats.cu, one CTA walking its own rows in turn); K6
// (kth.cu) runs its first part, the select, alone.
//
// The exact k-th largest value kth, then f = bf16(where(h >= kth, h, 0)),
// liveness (any bf16 f != 0 over the batch), L0 = count(h >= kth and h != 0)
// and L1 = sum |f32 f|. kth is the k-th largest order key (order_key.cuh)
// mapped back to a float, found by a candidate filter (`select_kth_key`):
//  1. Lower bound. Each of the T threads keeps the maximum of its keys; the
//     T' threads that hold a column give T' keys of T' distinct columns, so
//     if k <= T' the k-th largest of the T maxima is at most the row's k-th
//     largest key, and so is t0, that value with its bits below kBoundBit
//     cleared. Every warp finds t0 from the maxima on its own (warp
//     shuffles only, no block barrier).
//  2. Filter. The keys >= t0 go to a shared candidate buffer (a warp scan
//     and one shared atomic a warp; the buffer's order does not matter).
//  3. Select. Every key >= kth is >= t0, so kth is the k-th largest
//     candidate: the candidate with fewer than k candidates above it and at
//     least k at or above it, each thread ranking one candidate against
//     all; past T candidates, one warp bisects them.
//  4. Fallback. Where k > T', or more than kCandCap keys reach t0 (a row of
//     zeros, a row tied at its top), the CTA bisects the whole row in its
//     registers, a block reduction a step.
// Each bisection starts below the common prefix of a lower and an upper
// bound of its answer (`bisect`, order_key.cuh), so it skips the steps
// whose bit is fixed; the answer is the bisection's over all 32 bits, bit
// for bit. The epilogue touches only the keys at or above kth (an integer
// compare of keys first), so most of a row costs a compare and a zero store.
//
// The row lives in registers (`row_keys`): thread t holds runs of 4 columns,
// 4t..4t+3, then 4(t+T).., VPT keys in all, so a row with S % 4 == 0 is read
// in 16-byte loads and f written in 8-byte stores (VEC); otherwise each
// column alone. The ragged end beyond S takes key 0, which no step's
// candidate reaches. Liveness crosses rows: an int32 (S,) buffer zeroed by
// the caller and set with atomicOr, which does not depend on order. L1 is
// reduced in a fixed order (each thread's keys in turn, a warp's xor tree,
// the warps in turn).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "order_key.cuh"

namespace {

// Keys the candidate buffer holds (4 KB). A Gaussian row of 16384 at k = 32
// puts a few dozen keys at or above t0.
constexpr int kCandCap = 1024;
// The lower bound keeps its bits from 31 down to this one: the sign, the
// exponent and 6 mantissa bits of a float, within 1/64 of the k-th largest
// maximum, in a few bisection steps.
constexpr int kBoundBit = 17;

// The select's shared memory.
template <int MAXT>
struct SelectSmem {
  uint32_t maxima[MAXT];
  uint32_t cand[kCandCap];
  int n_cand;
  uint32_t kth_key;
  int counts[2][32];
};

template <int MAXT>
struct TopkRowSmem {
  SelectSmem<MAXT> sel;
  float l1_warp[32];
  int l0_warp[32];
};

// The row `hr` of S values (in device or shared memory) into this thread's
// VPT keys, in runs of 4 columns; returns their maximum. For VEC, S % 4 == 0
// and hr is 16-byte aligned.
template <int VPT, bool VEC>
__device__ __forceinline__ uint32_t row_keys(const float* __restrict__ hr, int S, uint32_t (&key)[VPT]) {
  static_assert(VPT % 4 == 0, "a thread holds whole runs of 4 columns");
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t mx = 0;
#pragma unroll
  for (int r = 0; r < VPT / 4; ++r) {
    const int c = 4 * (tid + r * nt);
    if (VEC) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < S) v = *reinterpret_cast<const float4*>(hr + c);
      const bool in = c < S;
      key[4 * r] = in ? float_key(v.x) : 0u;
      key[4 * r + 1] = in ? float_key(v.y) : 0u;
      key[4 * r + 2] = in ? float_key(v.z) : 0u;
      key[4 * r + 3] = in ? float_key(v.w) : 0u;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) key[4 * r + q] = c + q < S ? float_key(hr[c + q]) : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) mx = max(mx, key[4 * r + q]);
  }
  return mx;
}

// Phases 1-4: the k-th largest key of the row whose keys the CTA holds
// (`row_keys`; mx, this thread's maximum). Every thread of the CTA calls it,
// with blockDim.x <= MAXT, blockDim.x * VPT >= S and 1 <= k <= S, and gets
// the key. It calls released() once every thread's keys are in registers,
// and adds 1 to *fallback (when not null) if the row took the whole-row
// bisection. The CTA passes a block barrier between its return and the next
// call on the same sm.
template <int VPT, int MAXT, class Released>
__device__ __forceinline__ uint32_t select_kth_key(const uint32_t (&key)[VPT], uint32_t mx, int S, int k,
                                                   SelectSmem<MAXT>& sm, int* __restrict__ fallback,
                                                   Released released) {
  constexpr int MW = MAXT / 32;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  sm.maxima[tid] = mx;
  if (tid == 0) sm.n_cand = 0;
  __syncthreads();
  released();

  // 1. t0, the k-th largest of the maxima, in every warp; hi, the row's
  // largest key. Lanes past the CTA's threads hold key 0, the least.
  uint32_t m[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) m[i] = lane + 32 * i < nt ? sm.maxima[lane + 32 * i] : 0u;
  uint32_t lo = m[0], hi = m[0];
#pragma unroll
  for (int i = 1; i < MW; ++i) {
    lo = min(lo, m[i]);
    hi = max(hi, m[i]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int t_live = min(nt, (S + 3) / 4);  // threads that hold a column
  const bool bounded = k <= t_live;
  uint32_t t0 = 0;
  if (bounded) {
    t0 = bisect(lo, hi, k, kBoundBit, [&](uint32_t t, int) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < MW; ++i) c += m[i] >= t;
      return static_cast<int>(__reduce_add_sync(0xffffffffu, c));
    });
  }

  // 2. The keys >= t0 into the candidate buffer. t0 > 0 keeps the ragged
  // end's key 0 out.
  const bool filter = bounded && t0 > 0;
  if (filter) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) c += key[j] >= t0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(&sm.n_cand, incl);
    int pos = __shfl_sync(0xffffffffu, base, 31) + incl - c;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (key[j] >= t0) {
        if (pos < kCandCap) sm.cand[pos] = key[j];
        ++pos;
      }
    }
  }
  __syncthreads();
  const int n_cand = sm.n_cand;

  uint32_t kth_key;
  if (filter && n_cand <= kCandCap) {
    // 3. The k-th largest candidate: ranked, one a thread, or bisected by
    // one warp. Tied candidates write the same value.
    if (n_cand <= nt) {
      if (tid < n_cand) {
        const uint32_t v = sm.cand[tid];
        int gt = 0, ge = 0;
#pragma unroll 4
        for (int j = 0; j < n_cand; ++j) {
          const uint32_t c = sm.cand[j];
          gt += c > v;
          ge += c >= v;
        }
        if (gt < k && k <= ge) sm.kth_key = v;
      }
    } else if (warp == 0) {
      const uint32_t r = bisect(t0, hi, k, 0, [&](uint32_t t, int) {
        int c = 0;
        for (int j = lane; j < n_cand; j += 32) c += sm.cand[j] >= t;
        return static_cast<int>(__reduce_add_sync(0xffffffffu, c));
      });
      if (lane == 0) sm.kth_key = r;
    }
    __syncthreads();
    kth_key = sm.kth_key;
  } else {
    // 4. The whole row, a block reduction of integer counts a step.
    kth_key = bisect(bounded ? t0 : 0u, hi, k, 0, [&](uint32_t t, int b) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < VPT; ++j) c += key[j] >= t;
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0) sm.counts[b & 1][warp] = c;
      __syncthreads();
      int total = 0;
      for (int w = 0; w < n_warps; ++w) total += sm.counts[b & 1][w];
      return total;
    });
    if (fallback != nullptr && tid == 0) atomicAdd(fallback, 1);
  }
  return kth_key;
}

// Writes kth_out[row], f[row, :], live, l0_out[row] and l1_out[row] for the
// row `hr` of S values (in device or shared memory), and adds 1 to
// *fallback (when not null) if the row took the full-row bisection. Every
// thread of the CTA must call it, with blockDim.x <= MAXT, blockDim.x * VPT
// >= S and, for VEC, S % 4 == 0 and hr and f 16- and 8-byte aligned. Every
// thread calls released() once the row is in its registers and no thread
// reads hr again. GIVEN skips the select: kth_out[row] holds the threshold
// on entry (a latent-sharded row's, found over its shards), and the
// epilogue runs from it.
template <int VPT, int MAXT, bool VEC, bool GIVEN = false, class Released>
__device__ __forceinline__ void topk_stats_row(const float* __restrict__ hr, int S, int k,
                                               long row, TopkRowSmem<MAXT>& sm,
                                               float* __restrict__ kth_out,
                                               __nv_bfloat16* __restrict__ f,
                                               int* __restrict__ live,
                                               float* __restrict__ l0_out,
                                               float* __restrict__ l1_out,
                                               int* __restrict__ fallback, Released released) {
  constexpr int RUNS = VPT / 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;

  uint32_t key[VPT];
  const uint32_t mx = row_keys<VPT, VEC>(hr, S, key);
  uint32_t kth_key;
  if constexpr (GIVEN) {
    __syncthreads();  // every thread's keys are in registers
    released();
    kth_key = float_key(kth_out[row]);
  } else {
    kth_key = select_kth_key<VPT, MAXT>(key, mx, S, k, sm.sel, fallback, released);
  }
  const float kth = key_float(kth_key);
  // x >= kth, a float compare, needs key(x) >= key(kth), or x = -0.0 beside
  // kth = +0.0 (key 0x80000000, the key of -0.0 just below it).
  const uint32_t keep_from = kth_key == 0x80000000u ? 0x7FFFFFFFu : kth_key;

  // 5. f, live, L0 and L1. A key that is not kept adds a bf16 zero to f and
  // nothing to L0 or L1 (+0.0 leaves the f32 sum as it is).
  __nv_bfloat16* fr = f + row * S;
  float l1 = 0.f;
  int l0 = 0;
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const int c = 4 * (tid + r * nt);
    uint32_t fb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = VEC ? c < S : c + q < S;
      if (in && key[4 * r + q] >= keep_from) {
        const float x = key_float(key[4 * r + q]);
        if (x >= kth) {
          fb[q] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
          if (fb[q] & 0x7FFFu) atomicOr(live + c + q, 1);
          l0 += x != 0.f;
          l1 += fabsf(x);
        }
      }
      if (!VEC && in) fr[c + q] = __ushort_as_bfloat16(static_cast<unsigned short>(fb[q]));
    }
    if (VEC && c < S)
      *reinterpret_cast<uint2*>(fr + c) = make_uint2(fb[0] | (fb[1] << 16), fb[2] | (fb[3] << 16));
  }
  l0 = __reduce_add_sync(0xffffffffu, l0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  if (lane == 0) {
    sm.l0_warp[warp] = l0;
    sm.l1_warp[warp] = l1;
  }
  __syncthreads();
  if (tid == 0) {
    int l0_total = 0;
    float l1_total = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      l0_total += sm.l0_warp[w];
      l1_total += sm.l1_warp[w];
    }
    kth_out[row] = kth;
    l0_out[row] = static_cast<float>(l0_total);
    l1_out[row] = l1_total;
  }
}

}  // namespace
