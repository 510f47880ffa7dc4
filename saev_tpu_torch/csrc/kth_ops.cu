// P4 and P3, the pass loops of the k-th value bisection, on Hopper.
//
// P4, `kth_ops_stream_kernel<MODE, VPT, MAXT>` (and `kth_ops_kernel`, below):
// five formulations of one pass of the bisection, each a mode of one
// template. Replaces scripts/proto_kth_ops.py `_wrap` and its five bodies:
//   kProd   `_prod_kernel`   u32 keys, unsigned compare, integer sums
//                            (__reduce_add_sync): K6's answer, K6's bits;
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
// P3, `count_loop_stream_kernel<VPT, MAXT>` (and `count_loop_kernel`):
// replaces scripts/microbench_kth.py `loop_kernel` (via `count_loop`),
// sum_{p < n} count(key >= p) over int32 keys: n compare-and-count passes
// with the bisection's dependence taken out, the floor under P4's passes and
// under K1's and K6's whole-row fallback.
//
// What bounds them on the card. Bytes: each element of the batch is read
// once (1 GiB at 16384 x 16384, about 0.32 ms at 3.35 TB/s); the output is 4
// bytes a row. Instruction issue: a pass is a compare and an add a key, so
// 32 passes at 16384 x 16384 are 17.2 G instructions, 537 M warp
// instructions, about 1.0 M cycles of the card's 528 issue slots a clock
// (132 SMs x 4), 0.6 ms at 1.75 GHz: at 32 passes the passes set the time,
// at 8 the bytes.
//
// The design:
// - A CTA holds a row's keys in registers, VPT a thread in runs of 4 columns
//   (thread t: 4t..4t+3, 4(t + T).., K1's layout); the passes run over them.
// - Rows streamed behind the passes (row_stream.cuh, as K1 and K6 do): the
//   CTAs are persistent, and each row's bulk copy into shared memory lands
//   while the CTA runs the previous row's passes; the keys come from there
//   in 16-byte loads. Where S % 4 != 0 or the batch is not 16-byte aligned,
//   one CTA a row loads its keys from device memory column by column (a
//   route picked by shape, as K6's `kth_kernel`).
// - The count off one dependent chain: a thread's keys j, j + kAcc, .. add
//   to accumulator j % kAcc, summed once a pass, so a pass's adds form kAcc
//   independent chains of VPT / kAcc, each key a compare and a predicated
//   add (`add_ge`); P3's sweep over its passes the same with kLoopAcc.
//   mxu may split its products over kMxuAcc D fragments, and packs two mask
//   values in a select and a predicated or (`mask_pair`).
// - Cheaper block sums. P4's next candidate needs the pass's total, so each
//   pass keeps one barrier: lane 0 of each warp stores the warp's count in a
//   two-slot ring (`Ring`) whose shared addresses stay in registers, and
//   after the barrier every warp sums the slot with one load a lane and one
//   warp reduction. P3's passes do not depend on each other: each thread
//   sums over the passes and its keys in one sweep through its registers,
//   and the CTA takes one block sum a row. A row's first barrier
//   comes once every thread holds its keys, and lets the next row's copy
//   start.
// Pads: the ragged end of a row takes a key that adds to no count: u32 0
// (no candidate reaches it), INT32_MIN in the signed domain and in P3, and
// in the 31-bit domain INT32_MAX, whose (key - cand) >> 31 is 0 (subsar
// counts S + less with the row's true S).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "order_key.cuh"
#include "row_stream.cuh"
#include "tile_mma.cuh"

namespace {

// The order of MODES in saev_tpu_torch/scripts/proto_kth_ops.py.
constexpr int kProd = 0, kI32key = 1, kSubsar = 2, kF32red = 3, kMxu = 4;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kBf16One = 0x3F80u;
// Independent accumulators of a thread's count in a pass (P4), of its
// count over all passes (P3), and of mxu's D fragments: the fastest of
// pass_probe.py's sweep (PERF.md §6). ptxas regroups mxu's fragments
// into chains of its own choosing, and one is as fast as two or four.
constexpr int kAcc = 2;
constexpr int kLoopAcc = 8;
constexpr int kMxuAcc = 1;
// CTAs of 256 threads an SM that ptxas must leave registers for (three 64
// KB row buffers fit in shared memory); mxu's fragments need more
// registers than three CTAs leave (it spills at 80).
constexpr int kMinBlocks = 3;
constexpr int kMxuMinBlocks = 2;

template <int MODE>
using Count = std::conditional_t<MODE == kF32red || MODE == kMxu, float, int>;

template <int MODE>
constexpr uint32_t kPad = MODE == kI32key ? kSign : MODE == kSubsar ? 0x7FFFFFFFu : 0u;

__device__ __forceinline__ float warp_sum_f32(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c += (a >= b) as a compare and a predicated add, two instructions a key
// (written in C, ptxas makes it an add, a compare and a predicated move
// back, three a key). Unsigned compare into an int count (prod), signed
// (i32key), into an f32 count (f32red), and signed into an unsigned count
// (P3, whose sums wrap as int32's).
__device__ __forceinline__ void add_ge(int& c, uint32_t a, uint32_t b) {
  asm("{\n .reg .pred p;\n setp.ge.u32 p, %1, %2;\n @p add.s32 %0, %0, 1;\n}" : "+r"(c) : "r"(a), "r"(b));
}
__device__ __forceinline__ void add_ge(int& c, int a, int b) {
  asm("{\n .reg .pred p;\n setp.ge.s32 p, %1, %2;\n @p add.s32 %0, %0, 1;\n}" : "+r"(c) : "r"(a), "r"(b));
}
__device__ __forceinline__ void add_ge(float& c, uint32_t a, uint32_t b) {
  asm("{\n .reg .pred p;\n setp.ge.u32 p, %1, %2;\n @p add.f32 %0, %0, 0f3F800000;\n}" : "+f"(c) : "r"(a), "r"(b));
}
__device__ __forceinline__ void add_ge(unsigned& c, int a, int b) {
  asm("{\n .reg .pred p;\n setp.ge.s32 p, %1, %2;\n @p add.u32 %0, %0, 1;\n}" : "+r"(c) : "r"(a), "r"(b));
}

// mxu's bf16 pair: 1.0 in the low half where a >= cand, in the high half
// where b >= cand, else 0.0; two compares, a select and a predicated or.
__device__ __forceinline__ uint32_t mask_pair(uint32_t a, uint32_t b, uint32_t cand) {
  uint32_t r;
  asm("{\n .reg .pred p, q;\n setp.ge.u32 p, %1, %3;\n setp.ge.u32 q, %2, %3;\n"
      " selp.b32 %0, 0x3F800000, 0, q;\n @p or.b32 %0, %0, 0x3F80;\n}"
      : "=r"(r) : "r"(a), "r"(b), "r"(cand));
  return r;
}

// The pass's per-thread key of a float in each mode's domain.
template <int MODE>
__device__ __forceinline__ uint32_t mode_key(float x) {
  const uint32_t u = float_key(x);
  if constexpr (MODE == kI32key) return u ^ kSign;
  else if constexpr (MODE == kSubsar) return u >> 1;
  else return u;
}

// This thread's keys of the row at `row` (shared memory where VEC, in
// 16-byte loads, S % 4 == 0; else device memory, column by column): slot
// 4r + q holds column 4(t + rT) + q, `pad` where that column is past S.
template <int VPT, bool VEC, class T, class Key>
__device__ __forceinline__ void load_keys(const T* __restrict__ row, int S, uint32_t pad, uint32_t (&key)[VPT],
                                          Key to_key) {
  static_assert(VPT % 4 == 0, "a thread holds whole runs of 4 columns");
  using V = std::conditional_t<std::is_same_v<T, float>, float4, int4>;
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int r = 0; r < VPT / 4; ++r) {
    const int c = 4 * (tid + r * nt);
    if constexpr (VEC) {
      if (c < S) {
        const V v = *reinterpret_cast<const V*>(row + c);
        key[4 * r] = to_key(v.x);
        key[4 * r + 1] = to_key(v.y);
        key[4 * r + 2] = to_key(v.z);
        key[4 * r + 3] = to_key(v.w);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) key[4 * r + q] = pad;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) key[4 * r + q] = c + q < S ? to_key(row[c + q]) : pad;
    }
  }
}

// The block sums' ring: two slots of 32 counts (4 bytes each), warp w's at
// entry w; the entries past the CTA's warps stay 0. Its shared addresses
// stay in registers, so a pass spends no instructions forming them.
// Passes alternate slots, across rows too: a pass stores into the slot the
// pass before the last was read from, and every thread finished reading it
// before the last pass's barrier.
struct Ring {
  uint32_t base, mine;  // slot 0's entry 0, and this warp's
};

// Every thread calls it, and passes a block barrier before the first store.
template <class C>
__device__ __forceinline__ Ring ring_init(C (&ring)[2][32]) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 64; i += blockDim.x) ring[i >> 5][i & 31] = C(0);
  const uint32_t base = hopper::smem_u32(&ring[0][0]);
  return {base, base + 4 * (tid >> 5)};
}

// Lane 0 stores this warp's count in the slot.
__device__ __forceinline__ void ring_store(const Ring& r, int slot, uint32_t v) {
  asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %0, 0;\n @p st.shared.b32 [%1], %2;\n}"
               :: "r"(threadIdx.x & 31), "r"(r.mine + 128 * slot), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ring_load(const Ring& r, int slot, int w) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(r.base + 128 * slot + 4 * w) : "memory");
  return v;
}

// The CTA's total of a slot, in every thread: one shared load a lane, then
// one warp reduction; f32 sums in shuffles over groups of MAXT / 32 lanes
// that each hold the whole slot.
template <int MAXT, class C>
__device__ __forceinline__ C block_total(const Ring& r, int slot) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<C, float>) {
    constexpr int kW = MAXT / 32;
    float v = __uint_as_float(ring_load(r, slot, lane & (kW - 1)));
#pragma unroll
    for (int o = kW / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  } else {
    return static_cast<C>(__reduce_add_sync(0xffffffffu, ring_load(r, slot, lane)));
  }
}

// P4: this warp's count of its keys at or above cand in MODE's formulation
// (subsar: minus the keys below it), in every lane.
template <int MODE, int VPT>
__device__ __forceinline__ Count<MODE> warp_count(const uint32_t (&key)[VPT], uint32_t cand) {
  if constexpr (MODE == kMxu) {
    // A 16x16 bf16 A fragment holds 8 values a thread; B = ones makes
    // D[r][n] = sum_k A[r][k] for every n, whatever the order of the values
    // in A. Lanes with lane % 4 == 0 hold column 0 of rows lane / 4 (d[0])
    // and lane / 4 + 8 (d[2]): summed, every row once. Product m adds into
    // fragment m % kMxuAcc.
    constexpr int kMmas = (VPT + 7) / 8;
    float d[kMxuAcc][4] = {};
    const uint32_t ones = kBf16One | (kBf16One << 16);
#pragma unroll
    for (int m = 0; m < kMmas; ++m) {
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 8 * m + 2 * q;
        a[q] = j < VPT ? mask_pair(key[j], key[j + 1], cand) : 0u;
      }
      saev::mma_bf16(d[m % kMxuAcc], a, ones, ones);
    }
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < kMxuAcc; ++i) c += d[i][0] + d[i][2];
    return warp_sum_f32((threadIdx.x & 3) == 0 ? c : 0.f);
  } else {
    Count<MODE> c[kAcc] = {};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if constexpr (MODE == kI32key) add_ge(c[j % kAcc], static_cast<int>(key[j]), static_cast<int>(cand));
      // Both lie in [0, 2^31): the difference cannot overflow.
      else if constexpr (MODE == kSubsar) c[j % kAcc] += (static_cast<int>(key[j]) - static_cast<int>(cand)) >> 31;
      else add_ge(c[j % kAcc], key[j], cand);
    }
#pragma unroll
    for (int s = kAcc / 2; s > 0; s >>= 1)
#pragma unroll
      for (int i = 0; i < s; ++i) c[i] += c[i + s];
    if constexpr (MODE == kF32red) return warp_sum_f32(c[0]);
    else return __reduce_add_sync(0xffffffffu, c[0]);
  }
}

// P4: the largest prefix whose count(key >= prefix) reaches k, over the
// keys the CTA holds; every thread calls it and gets it. The signed and
// 31-bit modes add each bit to the prefix (unsigned arithmetic, so the
// first signed step wraps INT32_MIN + INT32_MIN to 0 as the TPU's does).
// `slot` alternates over the passes of every row the CTA runs.
template <int MODE, int VPT, int MAXT>
__device__ __forceinline__ uint32_t bisect_row(const uint32_t (&key)[VPT], int S, int k, const Ring& ring,
                                               int& slot) {
  constexpr int kPasses = MODE == kSubsar ? 31 : 32;
  uint32_t cur = MODE == kI32key ? kSign : 0u;
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {
    const uint32_t bit = 1u << (kPasses - 1 - p);
    const uint32_t cand = (MODE == kI32key || MODE == kSubsar) ? cur + bit : (cur | bit);
    const Count<MODE> c = warp_count<MODE, VPT>(key, cand);
    if constexpr (std::is_same_v<Count<MODE>, float>) ring_store(ring, slot, __float_as_uint(c));
    else ring_store(ring, slot, static_cast<uint32_t>(c));
    __syncthreads();
    Count<MODE> total = block_total<MAXT, Count<MODE>>(ring, slot);
    slot ^= 1;
    if constexpr (MODE == kSubsar) total += S;
    if (total >= static_cast<Count<MODE>>(k)) cur = cand;
  }
  return cur;
}

template <int MODE>
__device__ __forceinline__ float result(uint32_t cur) {
  return key_float(MODE == kI32key ? cur ^ kSign : MODE == kSubsar ? cur << 1 : cur);
}

template <int MODE, int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT != 256 ? 1 : MODE == kMxu ? kMxuMinBlocks : kMinBlocks)
    kth_ops_stream_kernel(const float* __restrict__ h, int B, int S, int k, float* __restrict__ out) {
  extern __shared__ __align__(16) float row_buf[];  // S floats
  __shared__ Count<MODE> ring_smem[2][32];
  const Ring ring = ring_init(ring_smem);  // stream_rows' first barrier follows
  int slot = 0;
  stream_rows(h, B, S, row_buf, [&](const float* hr, long row, auto released) {
    uint32_t key[VPT];
    load_keys<VPT, true>(hr, S, kPad<MODE>, key, [](float x) { return mode_key<MODE>(x); });
    __syncthreads();  // every thread holds its keys: the next row's copy may start
    released();
    const uint32_t cur = bisect_row<MODE, VPT, MAXT>(key, S, k, ring, slot);
    if (threadIdx.x == 0) out[row] = result<MODE>(cur);
  });
}

template <int MODE, int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT != 256 ? 1 : MODE == kMxu ? kMxuMinBlocks : kMinBlocks)
    kth_ops_kernel(const float* __restrict__ h, int S, int k, float* __restrict__ out) {
  __shared__ Count<MODE> ring_smem[2][32];
  const Ring ring = ring_init(ring_smem);
  int slot = 0;
  const long row = blockIdx.x;
  uint32_t key[VPT];
  load_keys<VPT, false>(h + row * S, S, kPad<MODE>, key, [](float x) { return mode_key<MODE>(x); });
  __syncthreads();  // the ring's zeros before any store
  const uint32_t cur = bisect_row<MODE, VPT, MAXT>(key, S, k, ring, slot);
  if (threadIdx.x == 0) out[row] = result<MODE>(cur);
}

// P3 on one row: n_passes sweeps of compare and add over the thread's keys
// (the ragged end INT_MIN, which no pass counts), summed over the passes in
// unsigned arithmetic (int32's wrap, defined), then one block sum.
template <int VPT, int MAXT>
__device__ __forceinline__ void count_row(const uint32_t (&kv)[VPT], int n_passes, long row, const Ring& ring,
                                          int& slot, int* __restrict__ out) {
  unsigned acc[kLoopAcc] = {};
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) add_ge(acc[j % kLoopAcc], static_cast<int>(kv[j]), p);
  }
#pragma unroll
  for (int s = kLoopAcc / 2; s > 0; s >>= 1)
#pragma unroll
    for (int i = 0; i < s; ++i) acc[i] += acc[i + s];
  ring_store(ring, slot, __reduce_add_sync(0xffffffffu, acc[0]));
  __syncthreads();
  const unsigned total = block_total<MAXT, unsigned>(ring, slot);
  slot ^= 1;
  if (threadIdx.x == 0) out[row] = static_cast<int>(total);
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == 256 ? kMinBlocks : 1)
    count_loop_stream_kernel(const int* __restrict__ key, int B, int S, int n_passes, int* __restrict__ out) {
  extern __shared__ __align__(16) float row_buf[];  // S int32 keys
  __shared__ unsigned ring_smem[2][32];
  const Ring ring = ring_init(ring_smem);  // stream_rows' first barrier follows
  int slot = 0;
  stream_rows(reinterpret_cast<const float*>(key), B, S, row_buf, [&](const float* kr, long row, auto released) {
    uint32_t kv[VPT];
    load_keys<VPT, true>(reinterpret_cast<const int*>(kr), S, static_cast<uint32_t>(INT_MIN), kv,
                         [](int x) { return static_cast<uint32_t>(x); });
    __syncthreads();  // every thread holds its keys: the next row's copy may start
    released();
    count_row<VPT, MAXT>(kv, n_passes, row, ring, slot, out);
  });
}

template <int VPT, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == 256 ? kMinBlocks : 1)
    count_loop_kernel(const int* __restrict__ key, int S, int n_passes, int* __restrict__ out) {
  __shared__ unsigned ring_smem[2][32];
  const Ring ring = ring_init(ring_smem);
  int slot = 0;
  const long row = blockIdx.x;
  uint32_t kv[VPT];
  load_keys<VPT, false>(key + row * S, S, static_cast<uint32_t>(INT_MIN), kv,
                        [](int x) { return static_cast<uint32_t>(x); });
  __syncthreads();  // the ring's zeros before any store
  count_row<VPT, MAXT>(kv, n_passes, row, ring, slot, out);
}

int threads_for(int S, int vpt) {
  const int threads = (S + vpt - 1) / vpt;
  return (threads + 31) / 32 * 32;
}

bool streams(const void* p, int S) {
  return S % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MODE, int VPT, int MAXT>
int launch(const float* h, int B, int S, int k, float* out, cudaStream_t stream) {
  const int threads = threads_for(S, VPT);
  if (!streams(h, S)) {
    kth_ops_kernel<MODE, VPT, MAXT><<<B, threads, 0, stream>>>(h, S, k, out);
    return cudaGetLastError();
  }
  return launch_stream(kth_ops_stream_kernel<MODE, VPT, MAXT>, B, S, threads, stream, h, B, S, k, out);
}

template <int VPT, int MAXT>
int launch_count(const int* key, int B, int S, int n_passes, int* out, cudaStream_t stream) {
  const int threads = threads_for(S, VPT);
  if (!streams(key, S)) {
    count_loop_kernel<VPT, MAXT><<<B, threads, 0, stream>>>(key, S, n_passes, out);
    return cudaGetLastError();
  }
  return launch_stream(count_loop_stream_kernel<VPT, MAXT>, B, S, threads, stream, key, B, S, n_passes, out);
}

// K6's table of register stagings (kth.cu `saev_kth`): S <= 32768.
template <int MODE>
int dispatch(const float* h, int B, int S, int k, float* out, cudaStream_t stream) {
  if (S <= 256 * 4) return launch<MODE, 4, 256>(h, B, S, k, out, stream);
  if (S <= 256 * 8) return launch<MODE, 8, 256>(h, B, S, k, out, stream);
  if (S <= 256 * 16) return launch<MODE, 16, 256>(h, B, S, k, out, stream);
  if (S <= 256 * 32) return launch<MODE, 32, 256>(h, B, S, k, out, stream);
  if (S <= 256 * 64) return launch<MODE, 64, 256>(h, B, S, k, out, stream);
  if (S <= 512 * 64) return launch<MODE, 64, 512>(h, B, S, k, out, stream);
  return cudaErrorInvalidValue;
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

extern "C" int saev_count_loop(const int* key, int B, int S, int n_passes, int* out, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || n_passes < 0) return cudaErrorInvalidValue;
  if (S <= 256 * 4) return launch_count<4, 256>(key, B, S, n_passes, out, stream);
  if (S <= 256 * 8) return launch_count<8, 256>(key, B, S, n_passes, out, stream);
  if (S <= 256 * 16) return launch_count<16, 256>(key, B, S, n_passes, out, stream);
  if (S <= 256 * 32) return launch_count<32, 256>(key, B, S, n_passes, out, stream);
  if (S <= 256 * 64) return launch_count<64, 256>(key, B, S, n_passes, out, stream);
  if (S <= 512 * 64) return launch_count<64, 512>(key, B, S, n_passes, out, stream);
  return cudaErrorInvalidValue;
}
