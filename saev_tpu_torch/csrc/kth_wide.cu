// K1, K5 and K6 on rows wider than their narrow kernels hold (S > 32768, as
// d_sae 65536 and 131072 give): the fused TopK statistics (K1), the exact
// k-th largest value (K6) and its column-masked form (K5). The narrow kernels
// (topk_stats.cu, kth.cu, kth_masked.cu) keep every row of 32768 columns or
// fewer; the wrappers pick this file by shape.
//
// Replaces, at those widths, saev_tpu/ops/pallas_topk.py `_kernel_stats`
// (K1), `_kernel` (K6) and `_kernel_masked` (K5): their Pallas bodies hold a
// whole row of any width in VMEM. Here a row of 65536 f32 is 256 KB, more
// than a CTA's registers hold (a CTA keeps 32768 keys) and more than its
// 227 KB of shared memory.
//
// What bounds it on the card: device memory. K1 reads h once and writes f
// (bf16) once: 6 GiB at 16384 x 65536, 1.92 ms at 3.35 TB/s. K6 reads h once
// (1.28 ms there). K5 needs only its unmasked columns: 0.064 ms at 5%.
//
// What the design does about it, by kernel:
//  - K1 (`wide_cluster_kernel`): a thread block cluster of C CTAs holds a
//    row, each CTA a slice of at most kSlice = 32768 columns in registers
//    (64 keys a thread, 512 threads, runs of 4 columns as topk_row.cuh lays
//    them out; equal widths, multiples of 4, but the last), so h is read once
//    and f written once: C = 2 at 65536, 4 at 131072, one CTA an SM. The
//    clusters are persistent and stream: once a CTA holds its slice, its
//    last warp starts the bulk copy (cp.async.bulk on an mbarrier) of its
//    slice of the cluster's next row. A row:
//     1. Bound. Warp 0 takes L, the k-th largest of the CTA's 512 thread
//        maxima cut to its bits down to kBoundBit (`bisect`): the slice has
//        k keys >= L, so L is at most the slice's k-th largest key and the
//        row's. That needs 2k <= T', the threads that hold a column of the
//        last (smallest) slice (more k leaves most of a slice above L); else,
//        where q = ceil(k / C) <= T', L is the least of the CTAs' q-th
//        largest maxima, exchanged over one more cluster barrier.
//     2. Filter. Each CTA writes its keys >= L to its buffer (kSliceCap),
//        with their count, L and its largest key.
//     3. One cluster barrier (`cluster_sync_shared`: it orders shared memory
//        alone, so it does not wait for the row's f stores and the next
//        copy in flight). Every CTA reads the C counts through distributed
//        shared memory and, where no buffer overflowed and the union fits
//        kUnionCap, gathers the union (one remote read a thread) keeping
//        the keys >= the largest bound, and selects their k-th largest as
//        topk_row.cuh does: ranked one a thread, or bisected by one warp.
//        Every CTA finds the same key.
//     4. Fallback. Otherwise (a row of zeros, -0.0 over half the row, no
//        bound) the cluster bisects the row in its registers from the
//        largest bound, each step one cluster barrier and the C x 16 warp
//        counts read remotely. `fallback` counts those rows.
//     5. Each CTA writes its slice of f and live, and its L0 and L1, from its
//        registers with topk_row.cuh's per-element formulas. L1 is summed in
//        a fixed order: each thread's keys in turn, a warp's xor tree, the
//        warps in turn, then the CTAs in rank order, read by rank 0's last
//        warp after the next row's barrier.
//    Rows wider than kMaxCluster slices take the walk below.
//  - K5 (`wide_masked_group_kernel`): the mask is shared by every row, so
//    the cost follows n, the unmasked columns, not S. One CTA lists them once
//    a call (`compact_mask_kernel`), then kth_masked.cu's design runs on the
//    list: persistent CTAs of kGroupWarps warps, each staging the list in
//    shared memory, G warps a row (the fewest, a power of two, whose KPL
//    keys a lane hold n), a lane issuing all its gathers before it uses
//    one, the bisection from the common prefix of the row's least and
//    largest key, a warp reduction a step and a named barrier for the group
//    alone, ended early by a step that finds exactly k keys at or above its
//    candidate (the least of them is the answer). n is read on the card:
//    the call launches the walk (n > kGroupMaxN = 32768), KPL 32 (n <= 16384)
//    and KPL 64, and each launch whose range does not hold n exits at once.
//    Fewer than k unmasked columns give -inf on every row.
//  - K6, K1's threshold entry, K5 past kGroupMaxN and K1 past kMaxCluster
//    slices (`wide_row_kernel`, the walk): one CTA of 512 threads a row walks
//    the row's keys in chunks of at most 16384 (32 keys a thread), reading
//    each chunk straight into registers, with 16-byte loads where the row
//    allows:
//     1. Each chunk of at least k keys gets its k-th largest key t_c from K6's
//        select (topk_row.cuh `select_kth_key`). L = max t_c is a lower bound
//        of the row's answer: its chunk holds k keys >= L.
//     2. The chunk's keys >= max(t_c, L so far, 1) go to a buffer of kWideCap
//        candidates. A key the buffer leaves out lies below its chunk's t_c
//        or below the L of an earlier chunk, so every key >= the final L is
//        in it.
//     3. The k-th largest candidate: ranked one a thread up to 512
//        candidates, else bisected from L, one block reduction a step.
//     4. Where the buffer overflows, the whole row is bisected from L
//        instead, each step a pass over the row in device memory; `fallback`
//        counts those rows.
//    K5's walk gathers h at the listed columns (key 0 past the list's end,
//    below every float's key, mapped to -inf where fewer than k columns are
//    unmasked). K1's epilogue there walks the row once more.
// Every offset into a row is a long: at 16384 x 131072, B * S is 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "row_stream.cuh"
#include "topk_row.cuh"

namespace {

// --- K1: a cluster of CTAs a row ---------------------------------------------------

constexpr int kSliceVpt = 64;                      // keys a thread holds of its slice
constexpr int kSliceThreads = 512;                 // threads a CTA
constexpr int kSlice = kSliceVpt * kSliceThreads;  // columns a CTA holds at most
constexpr int kMaxCluster = 8;                     // CTAs a cluster (the portable most)
constexpr int kSliceCap = 2048;                    // candidates a CTA's buffer holds
constexpr int kUnionCap = 4096;                    // candidates of the row a CTA gathers

struct ClusterSmem {
  uint32_t maxima[kSliceThreads];
  // By row parity, read by the other CTAs: this CTA's candidates, their
  // count, its bound and its largest key.
  uint32_t cand[2][kSliceCap];
  uint32_t meta[2][3];
  uint32_t uni[kUnionCap];  // every CTA's candidates, gathered
  uint32_t own[2];          // this CTA's bound and largest key
  uint32_t q_bound;         // this CTA's bound where k is above a slice's threads
  int n_local;
  uint32_t kth_key;
  int counts[2][kSliceThreads / 32];  // the whole-row bisection's, by step parity
  int l0_warp[kSliceThreads / 32];
  float l1_warp[kSliceThreads / 32];
  uint32_t part[2][2];  // this CTA's L0 and L1 (f32 bits), by row parity, read by rank 0
};

// CTAs a cluster for a row of S (the fewest slices of at most kSlice), 0
// where more than kMaxCluster would be needed; and the slices' width.
__host__ __device__ inline int cluster_ctas_for(int S) {
  const int c = (S + kSlice - 1) / kSlice;
  return c <= kMaxCluster ? c : 0;
}
__host__ __device__ inline int slice_width(int S, int C) { return ((S + C - 1) / C + 3) / 4 * 4; }

// L0 and L1 of `row` from the C CTAs' parts, which lane r of the calling
// warp of rank 0 holds for CTA r (L0, L1 as f32 bits), summed in rank order.
__device__ __forceinline__ void finish_row(uint32_t part0, uint32_t part1, long row, int C,
                                           float* __restrict__ l0_out, float* __restrict__ l1_out) {
  float l1 = 0.f;
  int l0 = 0;
  for (int r = 0; r < C; ++r) {
    l0 += static_cast<int>(__shfl_sync(0xffffffffu, part0, r));
    l1 += __uint_as_float(__shfl_sync(0xffffffffu, part1, r));
  }
  if ((threadIdx.x & 31) == 0) {
    l1_out[row] = l1;
    l0_out[row] = static_cast<float>(l0);
  }
}

// A cluster of C CTAs (the launch's cluster dimension) walks rows cluster
// id, + clusters, ..; CTA `rank` holds columns [rank * sw, rank * sw + len)
// of each. STREAM: S % 4 == 0, h 16-byte and f 8-byte aligned; the slice is
// staged in `slice_buf` (sw floats of dynamic shared memory) by bulk copy.
// Otherwise each thread reads its keys from device memory, one at a time.
// GIVEN (K1's threshold entry) skips the select: kth_out[row] holds the
// threshold on entry, and the epilogue runs from it.
template <bool STREAM, bool GIVEN>
__global__ void __launch_bounds__(kSliceThreads, 512 / kSliceThreads)
    wide_cluster_kernel(const float* __restrict__ h, int B, int S, int k, int sw, float* __restrict__ kth_out,
                        __nv_bfloat16* __restrict__ f, int* __restrict__ live, float* __restrict__ l0_out,
                        float* __restrict__ l1_out, int* __restrict__ fallback) {
  extern __shared__ __align__(16) float slice_buf[];
  __shared__ ClusterSmem sm;
  __shared__ __align__(8) uint64_t full;
  constexpr int nt = kSliceThreads, n_warps = nt / 32, MW = nt / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = static_cast<int>(hopper::cluster_ctas());
  const uint32_t rank = hopper::cluster_rank();
  const long cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int c0 = static_cast<int>(rank) * sw, len = min(sw, S - c0);
  // T', the threads that hold a column of the last slice, the smallest.
  // Where 2k <= T', each CTA's k-th largest maximum bounds its own slice's
  // k-th largest key (`own`); a larger k would leave most of a slice above
  // it. Else, where q = ceil(k / C) <= T', the least of the CTAs' q-th
  // largest maxima bounds the row's (one more cluster barrier).
  const int t_live = min(nt, (S - (C - 1) * sw + 3) / 4);
  const int q = (k + C - 1) / C;
  const bool own = 2 * k <= t_live, bounded = q <= t_live;
  const uint32_t bar = hopper::smem_u32(&full), buf = hopper::smem_u32(slice_buf);
  const uint32_t bytes = 4u * static_cast<uint32_t>(len);
  if (tid == 0) {
    sm.n_local = 0;
    if constexpr (STREAM) {
      hopper::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (cid < B) fetch_row(buf, h + cid * S + c0, bytes, bar);
    }
  }
  hopper::cluster_sync();  // every CTA of the cluster runs before any reads another's memory

  uint32_t parity = 0;
  int it = 0;
#pragma unroll 1
  for (long row = cid; row < B; row += n_clusters, ++it) {
    const int rp = it & 1;
    uint32_t key[kSliceVpt];
    uint32_t mx;
    if constexpr (STREAM) {
      hopper::mbar_wait(bar, parity);
      parity ^= 1;
      mx = row_keys<kSliceVpt, true>(slice_buf, len, key);
    } else {
      mx = row_keys<kSliceVpt, false>(h + row * S + c0, len, key);
    }
    sm.maxima[tid] = mx;
    __syncthreads();
    if constexpr (STREAM) {
      // The last warp starts the next copy, while warp 0 finds the bound.
      if (tid == nt - 32 && row + n_clusters < B) {
        // The buffer's reads are done: order them before the copy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_row(buf, h + (row + n_clusters) * S + c0, bytes, bar);
      }
    }

    uint32_t kth;
    if constexpr (GIVEN) {
      // K1's threshold entry: the row's threshold is given. The barrier only
      // hands rank 0 the row before's parts.
      kth = float_key(kth_out[row]);
      hopper::cluster_sync_shared();
      if (it > 0 && rank == 0 && warp == n_warps - 1) {
        uint32_t part0 = 0u, part1 = 0u;
        if (lane < C) {
          part0 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[rp ^ 1][0]), lane);
          part1 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[rp ^ 1][1]), lane);
        }
        finish_row(part0, part1, row - n_clusters, C, l0_out, l1_out);
      }
    } else {
      // 1. The bound L and this slice's largest key, by warp 0 alone (the
      // other warps would only contend for its issue slots).
      if (warp == 0) {
        uint32_t m[MW];
#pragma unroll
        for (int i = 0; i < MW; ++i) m[i] = sm.maxima[lane + 32 * i];
        uint32_t lo = m[0], top = m[0];
#pragma unroll
        for (int i = 1; i < MW; ++i) {
          lo = min(lo, m[i]);
          top = max(top, m[i]);
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        top = __reduce_max_sync(0xffffffffu, top);
        uint32_t t = 0;
        if (bounded) {
          t = bisect(lo, top, own ? k : q, kBoundBit, [&](uint32_t v, int) {
            int c = 0;
#pragma unroll
            for (int i = 0; i < MW; ++i) c += m[i] >= v;
            return static_cast<int>(__reduce_add_sync(0xffffffffu, c));
          });
        }
        if (lane == 0) {
          sm.own[0] = t;
          sm.own[1] = top;
        }
      }
      __syncthreads();
      uint32_t L = sm.own[0], hi = sm.own[1];
      if (bounded && !own) {
        if (tid == 0) sm.q_bound = L;
        hopper::cluster_sync_shared();  // A: every CTA's q-th largest maximum
        uint32_t b = 0xFFFFFFFFu;
        if (lane < C) b = hopper::dsmem_ld(hopper::smem_u32(&sm.q_bound), lane);
        L = __reduce_min_sync(0xffffffffu, b);
      }

      // 2. This slice's keys >= L. L > 0 keeps the ragged end's key 0 out.
      if (bounded && L > 0) {
        int c = 0;
#pragma unroll
        for (int j = 0; j < kSliceVpt; ++j) c += key[j] >= L;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        int base = 0;
        if (lane == 31) base = atomicAdd(&sm.n_local, incl);
        int pos = __shfl_sync(0xffffffffu, base, 31) + incl - c;
#pragma unroll
        for (int j = 0; j < kSliceVpt; ++j) {
          if (key[j] >= L) {
            if (pos < kSliceCap) sm.cand[rp][pos] = key[j];
            ++pos;
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        sm.meta[rp][0] = static_cast<uint32_t>(sm.n_local);
        sm.meta[rp][1] = L;
        sm.meta[rp][2] = hi;
        sm.n_local = 0;
      }
      hopper::cluster_sync_shared();  // B: every CTA's candidates, count, bound and largest key

      // 3. The union: each CTA's count and offset, and whether all fit. Every
      // CTA's bound is at most the row's k-th largest key, so their largest is
      // too. Rank 0's last warp reads the row before's L0 and L1 parts in the
      // same round trip.
      const bool finishing = it > 0 && rank == 0 && warp == n_warps - 1;
      int nc = 0;
      uint32_t b_lo = 0xFFFFFFFFu, b_max = 0u, b_hi = 0u, part0 = 0u, part1 = 0u;
      if (lane < C) {
        nc = static_cast<int>(hopper::dsmem_ld(hopper::smem_u32(&sm.meta[rp][0]), lane));
        b_lo = b_max = hopper::dsmem_ld(hopper::smem_u32(&sm.meta[rp][1]), lane);
        b_hi = hopper::dsmem_ld(hopper::smem_u32(&sm.meta[rp][2]), lane);
        if (finishing) {
          part0 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[rp ^ 1][0]), lane);
          part1 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[rp ^ 1][1]), lane);
        }
      }
      if (finishing) finish_row(part0, part1, row - n_clusters, C, l0_out, l1_out);
      int off = nc;
#pragma unroll
      for (int o = 1; o < kMaxCluster; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, off, o);
        if (lane >= o) off += v;
      }
      const int n_union = __shfl_sync(0xffffffffu, off, kMaxCluster - 1);
      off -= nc;
      const uint32_t least = __reduce_min_sync(0xffffffffu, b_lo);
      const uint32_t lower = __reduce_max_sync(0xffffffffu, b_max);
      hi = __reduce_max_sync(0xffffffffu, b_hi);
      const bool fits = bounded && least > 0 && !__any_sync(0xffffffffu, nc > kSliceCap) && n_union <= kUnionCap;
      if (fits) {
        // Candidate i of the union is candidate i - off[r] of CTA r, the last
        // CTA whose offset is at most i: one remote read a thread a round. Of
        // them the row's k-th largest key is the k-th largest of those at or
        // above `lower`: only those are kept (sm.n_local, zeroed before B).
        const uint32_t at = hopper::smem_u32(&sm.cand[rp][0]);
        for (int i0 = 0; i0 < n_union; i0 += nt) {
          const int i = i0 + tid;
          int r_i = 0, o_i = 0;
          for (int r = 1; r < C; ++r) {
            const int o = __shfl_sync(0xffffffffu, off, r);
            if (i >= o) {
              r_i = r;
              o_i = o;
            }
          }
          uint32_t v = 0;
          if (i < n_union) v = hopper::dsmem_ld(at + 4u * (i - o_i), r_i);
          const bool keep = i < n_union && v >= lower;
          const uint32_t kept = __ballot_sync(0xffffffffu, keep);
          int base = 0;
          if (lane == 0 && kept != 0) base = atomicAdd(&sm.n_local, __popc(kept));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (keep) sm.uni[base + __popc(kept & ((1u << lane) - 1u))] = v;
        }
        __syncthreads();
        const int n_kept = sm.n_local;
        // The k-th largest kept candidate: ranked, one a thread, or bisected
        // by one warp. Tied candidates write the same value.
        if (n_kept <= nt) {
          if (tid < n_kept) {
            const uint32_t v = sm.uni[tid];
            int gt = 0, ge = 0;
#pragma unroll 4
            for (int j = 0; j < n_kept; ++j) {
              const uint32_t c = sm.uni[j];
              gt += c > v;
              ge += c >= v;
            }
            if (gt < k && k <= ge) sm.kth_key = v;
          }
        } else if (warp == 0) {
          const uint32_t r = bisect(lower, hi, k, 0, [&](uint32_t v, int) {
            int c = 0;
            for (int j = lane; j < n_kept; j += 32) c += sm.uni[j] >= v;
            return static_cast<int>(__reduce_add_sync(0xffffffffu, c));
          });
          if (lane == 0) sm.kth_key = r;
        }
        __syncthreads();
        kth = sm.kth_key;
        if (tid == 0) sm.n_local = 0;
      } else {
        // 4. The row in the cluster's registers, from the bound.
        kth = bisect(lower, hi, k, 0, [&](uint32_t v, int b) {
          int c = 0;
#pragma unroll
          for (int j = 0; j < kSliceVpt; ++j) c += key[j] >= v;
          c = __reduce_add_sync(0xffffffffu, c);
          if (lane == 0) sm.counts[b & 1][warp] = c;
          hopper::cluster_sync_shared();
          int total = 0;
          for (int i = lane; i < C * n_warps; i += 32)
            total += static_cast<int>(hopper::dsmem_ld(hopper::smem_u32(&sm.counts[b & 1][i % n_warps]), i / n_warps));
          return static_cast<int>(__reduce_add_sync(0xffffffffu, total));
        });
        if (fallback != nullptr && rank == 0 && tid == 0) atomicAdd(fallback, 1);
      }
    }

    // 5. This slice's f, live, L0 and L1 (topk_row.cuh `topk_stats_row`).
    const float kv = key_float(kth);
    const uint32_t keep_from = kth == 0x80000000u ? 0x7FFFFFFFu : kth;
    __nv_bfloat16* fr = f + row * S + c0;
    float l1 = 0.f;
    int l0 = 0;
#pragma unroll
    for (int r = 0; r < kSliceVpt / 4; ++r) {
      const int c = 4 * (tid + r * nt);
      uint32_t fb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const bool in = STREAM ? c < len : c + qq < len;
        if (in && key[4 * r + qq] >= keep_from) {
          const float x = key_float(key[4 * r + qq]);
          if (x >= kv) {
            fb[qq] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
            if (fb[qq] & 0x7FFFu) atomicOr(live + c0 + c + qq, 1);
            l0 += x != 0.f;
            l1 += fabsf(x);
          }
        }
        if (!STREAM && in) fr[c + qq] = __ushort_as_bfloat16(static_cast<unsigned short>(fb[qq]));
      }
      if (STREAM && c < len)
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
      sm.part[rp][0] = static_cast<uint32_t>(l0_total);
      sm.part[rp][1] = __float_as_uint(l1_total);
      if (!GIVEN && rank == 0) kth_out[row] = kv;
    }
  }
  hopper::cluster_sync();  // the last row's parts
  if (it > 0 && rank == 0 && warp == 0) {
    uint32_t part0 = 0u, part1 = 0u;
    if (lane < C) {
      part0 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[(it - 1) & 1][0]), lane);
      part1 = hopper::dsmem_ld(hopper::smem_u32(&sm.part[(it - 1) & 1][1]), lane);
    }
    finish_row(part0, part1, cid + static_cast<long>(it - 1) * n_clusters, C, l0_out, l1_out);
  }
  hopper::cluster_sync();  // no CTA leaves while rank 0 reads its memory
}

template <bool STREAM, bool GIVEN = false>
cudaError_t cluster_config(int S, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int& clusters) {
  const int C = cluster_ctas_for(S);
  if (C == 0) return cudaErrorInvalidValue;
  const int smem = STREAM ? 4 * slice_width(S, C) : 0;
  cudaError_t e =
      cudaFuncSetAttribute(wide_cluster_kernel<STREAM, GIVEN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kSliceThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, wide_cluster_kernel<STREAM, GIVEN>, &cfg);
  if (e != cudaSuccess) return e;
  return clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// As many clusters as the card holds at once, at most B. A launch the card
// refuses returns its error; nothing falls back.
template <bool STREAM, bool GIVEN = false>
cudaError_t launch_cluster(const float* h, int B, int S, int k, float* kth, __nv_bfloat16* f, int* live, float* l0,
                           float* l1, int* fallback, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  cudaError_t e = cluster_config<STREAM, GIVEN>(S, cfg, attr, clusters);
  if (e != cudaSuccess) return e;
  const int C = cluster_ctas_for(S);
  cfg.gridDim = dim3(C * (B < clusters ? B : clusters), 1, 1);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, wide_cluster_kernel<STREAM, GIVEN>, h, B, S, k, slice_width(S, C), kth, f, live, l0,
                         l1, fallback);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// --- K5: G warps a row over the list of unmasked columns ------------------------

constexpr int kGroupWarps = 16;                    // warps a CTA
constexpr int kGroupMaxN = kGroupWarps * 32 * 64;  // unmasked columns the group route holds (KPL 64)

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The launch of KPL keys a lane takes n (*n_live) in (kGroupWarps * 32 *
// KPL / 2, kGroupWarps * 32 * KPL], KPL 32 from 0; any other n exits at
// once. A CTA stages the list's first n entries in shared memory (`cols`,
// kGroupWarps * 32 * KPL ints), then walks rows in groups of G warps as
// kth_masked.cu does. At KPL 32 the registers are held to 64, so two CTAs
// fit an SM (ptxas then spills a few keys, as kth_masked.cu's do).
template <int KPL>
__global__ void __launch_bounds__(kGroupWarps * 32, KPL == 32 ? 2 : 1)
    wide_masked_group_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                             const int* __restrict__ n_live, int B, int S, int k, float* __restrict__ out) {
  extern __shared__ int cols[];
  __shared__ int part[kGroupWarps / 2][2][kGroupWarps];  // group, step parity, warp of the group
  // Group, round parity, least or largest key, warp of the group (a round
  // whose keys are all equal runs no step, so no barrier follows its reads).
  __shared__ uint32_t ends[kGroupWarps / 2][2][2][kGroupWarps];
  const int n = *n_live;
  if (n > kGroupWarps * 32 * KPL || (KPL > 32 && n <= kGroupWarps * 32 * KPL / 2)) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = nt >> 5;
  if (n < k) {
    for (long row = static_cast<long>(blockIdx.x) * nt + tid; row < B; row += static_cast<long>(gridDim.x) * nt)
      out[row] = -INFINITY;
    return;
  }
  for (int j = tid; j < n; j += nt) cols[j] = idx[j];
  __syncthreads();

  // G warps a row; group q of this CTA takes rows blockIdx.x * groups + q,
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
    for (int i = 0; i < KPL; ++i) key[i] = __float_as_uint(hr[cols[min((i * G + g) * 32 + lane, n - 1)]]);
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
    // The k-th largest key, in [lo, hi]: `bisect` (order_key.cuh), but a
    // step that finds exactly k keys at or above its candidate ends it (the
    // k-th largest is then the least of them).
    uint32_t kth = lo;
    if (lo != hi) {
      int b = 31 - __clz(lo ^ hi);
      kth = lo & ~((2u << b) - 1u);
#pragma unroll 1
      for (; b >= 0; --b) {
        const uint32_t t = kth | (1u << b);
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
        if (c >= k) kth = t;
        if (c == k) break;
      }
      if (b >= 0) {
        uint32_t least = 0xFFFFFFFFu;
#pragma unroll
        for (int i = 0; i < KPL; ++i) least = key[i] >= kth ? min(least, key[i]) : least;
        least = __reduce_min_sync(0xffffffffu, least);
        if (G > 1) {
          // ends[q][rp] was read before the first step's barrier.
          if (lane == 0) ends[q][rp][0][g] = least;
          group_barrier(1 + q, 32 * G);
          for (int w = 0; w < G; ++w) least = min(least, ends[q][rp][0][w]);
        }
        kth = least;
      }
    }
    if (g == 0 && lane == 0) out[row] = key_float(kth);
  }
}

template <int KPL>
cudaError_t launch_group(const float* h, const int* idx, const int* n_live, int B, int S, int k, float* out,
                         cudaStream_t stream) {
  auto kernel = wide_masked_group_kernel<KPL>;
  const int smem = kGroupWarps * 32 * KPL * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroupWarps * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = (B + kGroupWarps - 1) / kGroupWarps;
  const int grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  kernel<<<grid, kGroupWarps * 32, smem, stream>>>(h, idx, n_live, B, S, k, out);
  return cudaGetLastError();
}

// --- the walk: one CTA a row, chunks of at most kWideChunk ----------------------

constexpr int kWideVpt = 32;       // keys a thread holds of one chunk
constexpr int kWideThreads = 512;  // threads a CTA
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
// chunks of cs, or for K5 the *n_live columns listed at idx, chunked here,
// where the list is longer than the group route holds. GIVEN (K1's
// threshold entry, STATS only) skips the select: kth_out[row] holds the
// threshold on entry.
template <bool VEC, bool MASKED, bool STATS, bool GIVEN = false>
__global__ void __launch_bounds__(kWideThreads)
    wide_row_kernel(const float* __restrict__ h, const int* __restrict__ idx, const int* __restrict__ n_live,
                    int S, int k, int n_chunks, int cs, float* __restrict__ kth_out,
                    __nv_bfloat16* __restrict__ f, int* __restrict__ live, float* __restrict__ l0_out,
                    float* __restrict__ l1_out, int* __restrict__ fallback) {
  static_assert(!GIVEN || (STATS && !MASKED), "a given threshold is K1's");
  // The group route takes a shorter list. An `exit` the compiler does not
  // see: a `return` here compiled the walk's loops differently and slowed
  // it on the card.
  if constexpr (MASKED) {
    if (*n_live <= kGroupMaxN) asm volatile("exit;");
  }
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

    // 1-2. The chunks: each one's k-th largest key, the lower bound L, and
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

    // 3-4. The k-th largest key of the row.
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

bool streams(const float* h, int S, const __nv_bfloat16* f) {
  return S % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(f) % 8 == 0;
}

}  // namespace

// K1 on a row of any width (the wrapper sends S > 32768 here): the cluster
// route up to kMaxCluster slices, the walk past it. live must be zeroed by
// the caller; fallback, when not null, gains 1 for each row that took the
// whole-row bisection.
extern "C" int saev_topk_stats_wide(const float* h, int B, int S, int k, float* kth, __nv_bfloat16* f,
                                    int* live, float* l0, float* l1, int* fallback, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  if (cluster_ctas_for(S) == 0)
    return launch_wide<false, true>(h, nullptr, nullptr, B, S, k, kth, f, live, l0, l1, fallback, stream);
  if (streams(h, S, f)) return launch_cluster<true>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
  return launch_cluster<false>(h, B, S, k, kth, f, live, l0, l1, fallback, stream);
}

// K1's cluster route for a row of S: its CTAs a cluster (0 where S takes the
// walk), and the clusters the card holds at once with 16-byte-aligned rows
// (or a negative CUDA error).
extern "C" int saev_wide_cluster_ctas(int S) { return S > 0 ? cluster_ctas_for(S) : 0; }
extern "C" int saev_wide_clusters(int S) {
  if (S <= 0 || cluster_ctas_for(S) == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  const cudaError_t e = S % 4 == 0 ? cluster_config<true>(S, cfg, attr, clusters)
                                   : cluster_config<false>(S, cfg, attr, clusters);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// K1's threshold entry on a row of any width, on K1's route for S (so its
// outputs are K1's bits): kth (B floats) is read, not written; live must be
// zeroed by the caller.
extern "C" int saev_topk_stats_given_wide(const float* h, int B, int S, float* kth, __nv_bfloat16* f, int* live,
                                          float* l0, float* l1, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (cluster_ctas_for(S) == 0)
    return launch_wide<false, true, true>(h, nullptr, nullptr, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  if (streams(h, S, f)) return launch_cluster<true, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
  return launch_cluster<false, true>(h, B, S, 1, kth, f, live, l0, l1, nullptr, stream);
}

// K6 on a row of any width (the walk).
extern "C" int saev_kth_wide(const float* h, int B, int S, int k, float* out, int* fallback,
                             cudaStream_t stream) {
  return launch_wide<false, false>(h, nullptr, nullptr, B, S, k, out, nullptr, nullptr, nullptr, nullptr,
                                   fallback, stream);
}

// K5 on a row of any width: -inf where fewer than k columns are unmasked.
// idx (S ints) and n_live (1 int) are the list of unmasked columns, written
// here. Four launches in order on the stream: the list, then the walk and
// the group route at 32 and 64 keys a lane, of which the one whose range
// holds n selects and the others exit at once.
extern "C" int saev_kth_masked_wide(const float* h, const uint8_t* mask, int B, int S, int k, float* out,
                                    int* idx, int* n_live, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > S) return cudaErrorInvalidValue;
  compact_mask_kernel<<<1, kCompactThreads, 0, stream>>>(mask, S, idx, n_live);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = static_cast<cudaError_t>(launch_wide<true, false>(h, idx, n_live, B, S, k, out, nullptr, nullptr, nullptr,
                                                          nullptr, nullptr, stream));
  if (e == cudaSuccess) e = launch_group<32>(h, idx, n_live, B, S, k, out, stream);
  if (e == cudaSuccess) e = launch_group<64>(h, idx, n_live, B, S, k, out, stream);
  return e;
}
