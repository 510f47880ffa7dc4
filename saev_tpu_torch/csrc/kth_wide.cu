// K1, K5 and K6 on rows wider than their narrow kernels hold (S > 32768, as
// d_sae 65536 and 131072 give): the fused TopK statistics (K1), the exact
// k-th largest value (K6) and its column-masked form (K5), by a two-level
// exact select. The narrow kernels (topk_stats.cu, kth.cu, kth_masked.cu)
// keep every row of 32768 columns or fewer; the wrappers pick this route by
// shape.
//
// Replaces, at those widths, saev_tpu/ops/pallas_topk.py `_kernel_stats`
// (K1), `_kernel` (K6) and `_kernel_masked` (K5): their Pallas bodies hold a
// whole row of any width in VMEM. Here a row of 65536 f32 is 256 KB, more
// than a CTA's registers hold (the narrow kernels keep 32768 keys) and more
// than its 227 KB of shared memory.
//
// What bounds it on the card: device memory. K6 reads h once (4 bytes an
// element: 4 GiB at 16384 x 65536, 1.3 ms at 3.35 TB/s), K5 only its
// unmasked columns, K1 reads h twice and writes f (bf16) once.
//
// What the design does about it: one CTA of 512 threads a row walks the
// row's keys in chunks of at most 16384 (32 keys a thread, runs of 4 as
// topk_row.cuh lays them out; the chunks' widths are equal up to a multiple
// of 4, so the last one is no sliver), reading each chunk straight into
// registers, with 16-byte loads where the row allows:
//  1. K5's keys are its unmasked columns alone: one CTA first lists them
//     (`compact_mask_kernel`, the mask is shared by every row), and each row
//     gathers h at the listed columns, so a masked column is neither read
//     nor selected. Past the list's end a key is 0, below every float's key,
//     so the k-th largest key is K5's answer where at least k columns are
//     unmasked, and 0, mapped to -inf, where fewer are.
//  2. A chunk of at least k keys gets its k-th largest key t_c from K6's
//     select (topk_row.cuh `select_kth_key`, with its own candidate filter
//     and in-register fallback). L = max t_c is a lower bound of the row's
//     answer: its chunk holds k keys >= L.
//  3. The chunk's keys >= max(t_c, L so far, 1) go to a buffer of kWideCap
//     candidates in shared memory. A key the buffer leaves out lies below
//     its chunk's t_c or below the L of an earlier chunk, so every key >= the
//     final L is in it, and counts over the buffer are the row's counts for
//     every threshold the select below asks about.
//  4. The k-th largest candidate: ranked one a thread up to 512 candidates
//     (a candidate below L has at least k candidates above it, so it never
//     ranks k-th), else bisected from L (`bisect`, order_key.cuh), one block
//     reduction a step.
//  5. Where the buffer overflows (a row tied at its top, a row of zeros), the
//     whole row is bisected from L instead, each step a pass over the row in
//     device memory; `fallback` counts those rows.
// K1 then walks the row once more and writes f, live, L0 and L1 with
// topk_row.cuh's per-element formulas; its L1 sums each thread's keys in
// turn, then a warp's xor tree, then the warps in turn. Every offset into a
// row is a long: at 16384 x 131072, B * S is 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_row.cuh"

namespace {

constexpr int kWideVpt = 32;       // keys a thread holds of one chunk
constexpr int kWideThreads = 512;  // threads a CTA, one CTA a row
constexpr int kWideChunk = kWideVpt * kWideThreads;  // columns a chunk holds at most
constexpr int kWideCap = 8192;     // candidates the buffer holds (32 KB)

struct WideSmem {
  SelectSmem<kWideThreads> sel;
  uint32_t cand[kWideCap];
  int n_cand;
  uint32_t kth_key;
  uint32_t top[32];
  int counts[2][32];
  float l1_warp[32];
  int l0_warp[32];
};

// This thread's keys of a chunk of `len`: h at columns 4(t + rT) + q of the
// chunk at hr, or, for K5 (MASKED), h at the columns idx lists there, in runs
// of 4; key 0 past the chunk's end. Returns their largest. VEC (not K5):
// len % 4 == 0 and hr 16-byte aligned.
template <bool VEC, bool MASKED>
__device__ __forceinline__ uint32_t chunk_keys(const float* __restrict__ hr, const int* __restrict__ idx,
                                               int len, uint32_t (&key)[kWideVpt]) {
  uint32_t mx = 0;
#pragma unroll
  for (int r = 0; r < kWideVpt / 4; ++r) {
    const int c = 4 * (threadIdx.x + r * kWideThreads);
    bool keep[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) keep[q] = c + q < len;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (VEC) {
      // keep[0] alone decides it here (len % 4 == 0), but this form keeps
      // K1's wide kernel at 4.99 ms at 16384 x 65536; `if (keep[0])` took
      // 5.66-5.69 (route_probe.py, H100 80GB HBM3, same registers).
      if (keep[0] || keep[1] || keep[2] || keep[3]) {
        const float4 x = *reinterpret_cast<const float4*>(hr + c);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (keep[q]) v[q] = hr[MASKED ? idx[c + q] : c + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      key[4 * r + q] = keep[q] ? float_key(v[q]) : 0u;
      mx = max(mx, key[4 * r + q]);
    }
  }
  return mx;
}

// The chunks of a row of n keys: n_chunks of cs, the last n - (n_chunks - 1) cs.
__host__ __device__ inline int wide_chunks(int n) { return (n + kWideChunk - 1) / kWideChunk; }
__host__ __device__ inline int wide_chunk_width(int n, int n_chunks) {
  return n_chunks > 0 ? ((n + n_chunks - 1) / n_chunks + 3) / 4 * 4 : 0;
}

// One row a CTA (blockIdx.x): kth_out[row] and, for STATS (K1), f[row, :],
// live, l0_out[row] and l1_out[row]. The row's n keys are S, in n_chunks
// chunks of cs, or for K5 the *n_live columns listed at idx, chunked here.
// GIVEN (K1's threshold entry, STATS only) skips the select: kth_out[row]
// holds the threshold on entry.
template <bool VEC, bool MASKED, bool STATS, bool GIVEN = false>
__global__ void __launch_bounds__(kWideThreads)
    wide_row_kernel(const float* __restrict__ h, const int* __restrict__ idx, const int* __restrict__ n_live,
                    int S, int k, int n_chunks, int cs, float* __restrict__ kth_out,
                    __nv_bfloat16* __restrict__ f, int* __restrict__ live, float* __restrict__ l0_out,
                    float* __restrict__ l1_out, int* __restrict__ fallback) {
  static_assert(!GIVEN || (STATS && !MASKED), "a given threshold is K1's");
  __shared__ WideSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int n_warps = kWideThreads / 32;
  const long row = blockIdx.x;
  const float* hr = h + row * S;
  uint32_t kth;
  if constexpr (GIVEN) {
    kth = float_key(kth_out[row]);
  } else {
    const int n = MASKED ? *n_live : S;
    if constexpr (MASKED) {
      n_chunks = wide_chunks(n);
      cs = wide_chunk_width(n, n_chunks);
    }
    if (tid == 0) {
      sm.n_cand = 0;
      sm.kth_key = 0;
    }
    __syncthreads();

    // 1-3. The chunks: each one's k-th largest key, the lower bound L, and
    // the candidates.
    uint32_t lower = 0, top = 0;
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * cs, len = min(cs, n - c0);
      uint32_t key[kWideVpt];
      const uint32_t mx = chunk_keys<VEC, MASKED>(MASKED ? hr : hr + c0, MASKED ? idx + c0 : nullptr, len, key);
      top = max(top, mx);
      uint32_t t = 0;
      if (len >= k) t = select_kth_key<kWideVpt, kWideThreads>(key, mx, len, k, sm.sel, nullptr, [] {});
      const uint32_t theta = max(max(t, lower), 1u);
      int c = 0;
#pragma unroll
      for (int j = 0; j < kWideVpt; ++j) c += key[j] >= theta;
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
      for (int j = 0; j < kWideVpt; ++j) {
        if (key[j] >= theta) {
          if (pos < kWideCap) sm.cand[pos] = key[j];
          ++pos;
        }
      }
      lower = max(lower, t);
      __syncthreads();  // the next chunk's select reuses sm.sel
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) sm.top[warp] = top;
    __syncthreads();
    uint32_t hi = 0;
    for (int w = 0; w < n_warps; ++w) hi = max(hi, sm.top[w]);
    const int n_cand = sm.n_cand;

    // A block-wide count: this thread's part c at bisection step b.
    auto block_count = [&](int c, int b) {
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0) sm.counts[b & 1][warp] = c;
      __syncthreads();
      int total = 0;
      for (int w = 0; w < n_warps; ++w) total += sm.counts[b & 1][w];
      return total;
    };

    // 4-5. The k-th largest key of the row.
    if (n_cand <= kWideThreads) {
      if (tid < n_cand) {
        const uint32_t v = sm.cand[tid];
        int gt = 0, ge = 0;
#pragma unroll 4
        for (int j = 0; j < n_cand; ++j) {
          const uint32_t u = sm.cand[j];
          gt += u > v;
          ge += u >= v;
        }
        if (gt < k && k <= ge) sm.kth_key = v;
      }
      __syncthreads();
      kth = sm.kth_key;
    } else if (n_cand <= kWideCap) {
      kth = bisect(lower, hi, k, 0, [&](uint32_t t, int b) {
        int c = 0;
        for (int j = tid; j < n_cand; j += kWideThreads) c += sm.cand[j] >= t;
        return block_count(c, b);
      });
    } else {
      kth = bisect(lower, hi, k, 0, [&](uint32_t t, int b) {
        int c = 0;
#pragma unroll 1
        for (int ch = 0; ch < n_chunks; ++ch) {
          const int c0 = ch * cs;
          uint32_t key[kWideVpt];
          chunk_keys<VEC, MASKED>(MASKED ? hr : hr + c0, MASKED ? idx + c0 : nullptr, min(cs, n - c0), key);
#pragma unroll
          for (int j = 0; j < kWideVpt; ++j) c += key[j] >= t;
        }
        return block_count(c, b);
      });
      if (fallback != nullptr && tid == 0) atomicAdd(fallback, 1);
    }
  }

  if constexpr (!STATS) {
    if (tid == 0) kth_out[row] = MASKED && kth == 0 ? -INFINITY : key_float(kth);
  } else {
    // K1's epilogue (topk_row.cuh `topk_stats_row`, step 5), chunk by chunk.
    const float kv = key_float(kth);
    const uint32_t keep_from = kth == 0x80000000u ? 0x7FFFFFFFu : kth;
    __nv_bfloat16* fr = f + row * S;
    float l1 = 0.f;
    int l0 = 0;
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * cs, len = min(cs, S - c0);
      uint32_t key[kWideVpt];
      chunk_keys<VEC, false>(hr + c0, nullptr, len, key);
#pragma unroll
      for (int r = 0; r < kWideVpt / 4; ++r) {
        const int c = 4 * (tid + r * kWideThreads);
        uint32_t fb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = VEC ? c < len : c + q < len;
          if (in && key[4 * r + q] >= keep_from) {
            const float x = key_float(key[4 * r + q]);
            if (x >= kv) {
              fb[q] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
              if (fb[q] & 0x7FFFu) atomicOr(live + c0 + c + q, 1);
              l0 += x != 0.f;
              l1 += fabsf(x);
            }
          }
          if (!VEC && in) fr[c0 + c + q] = __ushort_as_bfloat16(static_cast<unsigned short>(fb[q]));
        }
        if (VEC && c < len)
          *reinterpret_cast<uint2*>(fr + c0 + c) = make_uint2(fb[0] | (fb[1] << 16), fb[2] | (fb[3] << 16));
      }
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
      kth_out[row] = kv;
      l0_out[row] = static_cast<float>(l0_total);
      l1_out[row] = l1_total;
    }
  }
}

constexpr int kCompactThreads = 1024;  // one CTA lists the unmasked columns
constexpr int kCompactPer = 16;        // mask bytes a thread a pass

// idx[0 .. n) = the columns where mask is set, ascending; *n_live = n.
__global__ void __launch_bounds__(kCompactThreads)
    compact_mask_kernel(const uint8_t* __restrict__ mask, int S, int* __restrict__ idx, int* __restrict__ n_live) {
  __shared__ int warp_off[32];
  __shared__ int pass_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < S; c0 += kCompactThreads * kCompactPer) {
    const int c = c0 + tid * kCompactPer;
    bool on[kCompactPer];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < kCompactPer; ++q) {
      on[q] = c + q < S && mask[c + q] != 0;
      cnt += on[q];
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_off[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += v;
      }
      warp_off[lane] = wi - w;
      if (lane == 31) pass_total = wi;
    }
    __syncthreads();
    int pos = base + warp_off[warp] + incl - cnt;
#pragma unroll
    for (int q = 0; q < kCompactPer; ++q)
      if (on[q]) idx[pos++] = c + q;
    base += pass_total;
    __syncthreads();  // the next pass rewrites warp_off and pass_total
  }
  if (tid == 0) *n_live = base;
}

template <bool MASKED, bool STATS, bool GIVEN = false>
int launch_wide(const float* h, const int* idx, const int* n_live, int B, int S, int k, float* kth,
                __nv_bfloat16* f, int* live, float* l0, float* l1, int* fallback, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  const int n_chunks = wide_chunks(S), cs = wide_chunk_width(S, n_chunks);
  if constexpr (!MASKED) {  // K5 gathers: no 16-byte loads
    if (S % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
        (!STATS || reinterpret_cast<uintptr_t>(f) % 8 == 0)) {
      wide_row_kernel<true, MASKED, STATS, GIVEN><<<B, kWideThreads, 0, stream>>>(
          h, idx, n_live, S, k, n_chunks, cs, kth, f, live, l0, l1, fallback);
      return cudaGetLastError();
    }
  }
  wide_row_kernel<false, MASKED, STATS, GIVEN><<<B, kWideThreads, 0, stream>>>(h, idx, n_live, S, k, n_chunks, cs,
                                                                               kth, f, live, l0, l1, fallback);
  return cudaGetLastError();
}

}  // namespace

// K1 on a row of any width (the wrapper sends S > 32768 here). live must be
// zeroed by the caller; fallback, when not null, gains 1 for each row whose
// candidates overflowed the buffer and which took the whole-row bisection.
extern "C" int saev_topk_stats_wide(const float* h, int B, int S, int k, float* kth, __nv_bfloat16* f,
                                    int* live, float* l0, float* l1, int* fallback, cudaStream_t stream) {
  return launch_wide<false, true>(h, nullptr, nullptr, B, S, k, kth, f, live, l0, l1, fallback, stream);
}

// K1's threshold entry on a row of any width: kth (B floats) is read, not
// written; live must be zeroed by the caller.
extern "C" int saev_topk_stats_given_wide(const float* h, int B, int S, float* kth, __nv_bfloat16* f, int* live,
                                          float* l0, float* l1, cudaStream_t stream) {
  return launch_wide<false, true, true>(h, nullptr, nullptr, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
}

// K6 on a row of any width.
extern "C" int saev_kth_wide(const float* h, int B, int S, int k, float* out, int* fallback,
                             cudaStream_t stream) {
  return launch_wide<false, false>(h, nullptr, nullptr, B, S, k, out, nullptr, nullptr, nullptr, nullptr,
                                   fallback, stream);
}

// K5 on a row of any width: -inf where fewer than k columns are unmasked.
// idx (S ints) and n_live (1 int) are the list of unmasked columns, written
// here.
extern "C" int saev_kth_masked_wide(const float* h, const uint8_t* mask, int B, int S, int k, float* out,
                                    int* idx, int* n_live, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  compact_mask_kernel<<<1, kCompactThreads, 0, stream>>>(mask, S, idx, n_live);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_wide<true, false>(h, idx, n_live, B, S, k, out, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  stream);
}
