// P4: five formulations of one pass of the k-th value bisection, each a mode
// of one kernel template, `kth_ops_kernel<MODE, VPT, MAXT>`.
//
// Replaces scripts/proto_kth_ops.py `_wrap` and its five bodies:
//   kProd   `_prod_kernel`   u32 keys, unsigned compare, integer warp sum
//                            (__reduce_add_sync): K6's algorithm, K6's bits;
//   kI32key `_i32key_kernel` the sign bit flipped once at load, signed
//                            compares, the prefix built by adding bits from
//                            INT32_MIN;
//   kSubsar `_subsar_kernel` 31-bit keys (key >> 1), 31 passes, count =
//                            S + sum((key - cand) >> 31): timing only, the
//                            result drops the key's lowest bit;
//   kF32red `_f32red_kernel` the count and its warp and block sums in f32,
//                            warp shuffles in place of __reduce_add_sync;
//   kMxu    `_mxu_kernel`    the count on the tensor cores: each pass packs
//                            the thread's mask values into bf16 A fragments
//                            of mma.sync.m16n8k16 against a B fragment of
//                            ones, so every output column is a row sum of A.
// Every mode but kSubsar returns the row's exact k-th largest value.
//
// The layout is K6's (kth.cu): one CTA per row, the row's keys in registers
// (VPT a thread, thread t holds t, t + T, ...), 32 data-dependent passes,
// each ending in a block sum through shared memory and one barrier. Only the
// per-pass count differs between modes, so their times compare the count's
// instruction mix (ISETP + IADD, IADD + SHF, FADD + SHFL, HMMA) and nothing
// else.
//
// What bounds it on the card: device memory. Each element of h is read once
// (1 GiB at 16384 x 16384, about 0.32 ms at 3.35 TB/s); the output is 4
// bytes a row. The passes must stay on chip, and they set the time (P3).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "order_key.cuh"
#include "tile_mma.cuh"

namespace {

// The order of MODES in saev_tpu_torch/scripts/proto_kth_ops.py.
constexpr int kProd = 0, kI32key = 1, kSubsar = 2, kF32red = 3, kMxu = 4;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kBf16One = 0x3F80u;

__device__ __forceinline__ float warp_sum_f32(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The pass's per-thread key of a float in each mode's domain.
template <int MODE>
__device__ __forceinline__ uint32_t mode_key(float x) {
  const uint32_t u = float_key(x);
  if constexpr (MODE == kI32key) return u ^ kSign;
  else if constexpr (MODE == kSubsar) return u >> 1;
  else return u;
}

template <int MODE, int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    kth_ops_kernel(const float* __restrict__ h, int S, int k, float* __restrict__ out) {
  using Count = std::conditional_t<MODE == kF32red || MODE == kMxu, float, int>;
  constexpr int kPasses = MODE == kSubsar ? 31 : 32;
  // The key of the ragged end of a row beyond S, which adds to no count: u32
  // 0 (no candidate reaches it), INT32_MIN in the signed domain, and in the
  // 31-bit domain INT32_MAX, whose (key - cand) >> 31 is 0 (subsar counts
  // S + less with the row's true S).
  constexpr uint32_t kPad = MODE == kI32key ? kSign : MODE == kSubsar ? 0x7FFFFFFFu : 0u;
  __shared__ Count counts[2][32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const long row = blockIdx.x;
  const float* hr = h + row * S;

  uint32_t key[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + j * nt;
    key[j] = i < S ? mode_key<MODE>(hr[i]) : kPad;
  }

  // The largest prefix whose count(key >= prefix) reaches k. The signed and
  // 31-bit modes add each bit to the prefix (unsigned arithmetic, so the
  // first signed step wraps INT32_MIN + INT32_MIN to 0 as the TPU's does).
  uint32_t cur = MODE == kI32key ? kSign : 0u;
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {
    const uint32_t bit = 1u << (kPasses - 1 - p);
    const uint32_t cand = (MODE == kI32key || MODE == kSubsar) ? cur + bit : (cur | bit);
    Count c = 0;
    if constexpr (MODE == kProd) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) c += key[j] >= cand;
      c = __reduce_add_sync(0xffffffffu, c);
    } else if constexpr (MODE == kI32key) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) c += static_cast<int>(key[j]) >= static_cast<int>(cand);
      c = __reduce_add_sync(0xffffffffu, c);
    } else if constexpr (MODE == kSubsar) {
      // Minus the number of keys below cand; both lie in [0, 2^31), so the
      // difference cannot overflow.
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        c += (static_cast<int>(key[j]) - static_cast<int>(cand)) >> 31;
      c = __reduce_add_sync(0xffffffffu, c);
    } else if constexpr (MODE == kF32red) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) c += key[j] >= cand ? 1.f : 0.f;
      c = warp_sum_f32(c);
    } else {
      // A 16x16 bf16 A fragment holds 8 values a thread; B = ones makes
      // D[r][n] = sum_k A[r][k] for every n, whatever the order of the
      // values in A. Lanes with lane % 4 == 0 hold column 0 of rows
      // lane / 4 (d[0]) and lane / 4 + 8 (d[2]): summed, every row once.
      constexpr int kMmas = (VPT + 7) / 8;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t ones = kBf16One | (kBf16One << 16);
#pragma unroll
      for (int m = 0; m < kMmas; ++m) {
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 8 * m + 2 * q;
          const uint32_t lo = j < VPT && key[j] >= cand ? kBf16One : 0u;
          const uint32_t hi = j + 1 < VPT && key[j + 1] >= cand ? kBf16One : 0u;
          a[q] = lo | (hi << 16);
        }
        saev::mma_bf16(d, a, ones, ones);
      }
      c = warp_sum_f32((lane & 3) == 0 ? d[0] + d[2] : 0.f);
    }
    if (lane == 0) counts[p & 1][warp] = c;
    __syncthreads();
    Count total = 0;
    for (int w = 0; w < n_warps; ++w) total += counts[p & 1][w];
    if constexpr (MODE == kSubsar) total += S;
    if (total >= static_cast<Count>(k)) cur = cand;
  }
  if (tid == 0) {
    const uint32_t u = MODE == kI32key ? cur ^ kSign : MODE == kSubsar ? cur << 1 : cur;
    out[row] = key_float(u);
  }
}

template <int MODE, int VPT, int MAXT>
void launch(const float* h, int B, int S, int k, float* out, cudaStream_t stream) {
  int threads = (S + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  kth_ops_kernel<MODE, VPT, MAXT><<<B, threads, 0, stream>>>(h, S, k, out);
}

// K6's table of register stagings (kth.cu `dispatch`): S <= 32768.
template <int MODE>
int dispatch(const float* h, int B, int S, int k, float* out, cudaStream_t stream) {
  if (S <= 256 * 4) launch<MODE, 4, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 8) launch<MODE, 8, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 16) launch<MODE, 16, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 32) launch<MODE, 32, 256>(h, B, S, k, out, stream);
  else if (S <= 256 * 64) launch<MODE, 64, 256>(h, B, S, k, out, stream);
  else if (S <= 512 * 64) launch<MODE, 64, 512>(h, B, S, k, out, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" int saev_kth_ops(const float* h, int B, int S, int k, int mode, float* out,
                            cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  switch (mode) {
    case kProd: return dispatch<kProd>(h, B, S, k, out, stream);
    case kI32key: return dispatch<kI32key>(h, B, S, k, out, stream);
    case kSubsar: return dispatch<kSubsar>(h, B, S, k, out, stream);
    case kF32red: return dispatch<kF32red>(h, B, S, k, out, stream);
    case kMxu: return dispatch<kMxu>(h, B, S, k, out, stream);
    default: return cudaErrorInvalidValue;
  }
}
