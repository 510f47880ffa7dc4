// The building blocks of P1 (encode_stats.cu), and the block sum of
// matryoshka.cu's loss partials: a 128x128 CTA output tile computed with
// bf16 mma.sync.m16n8k16 and f32 accumulation, staged through shared memory
// by cp.async in 32-deep K steps. (K2, K7 and P2 run on wgmma in
// prefix_fwd.cu and prefix_gouter.cu, K3 and K4 in dgrad.cu and wgrad.cu,
// and use none of the product.)
//
// A is K-major (rows = M, K contiguous: f in the forward, x in P1), read
// with ldmatrix; B is N-major (rows = K, N contiguous: W in the forward, W
// in P1), read with ldmatrix.trans. Shared rows are padded by 8 bf16 (16
// bytes), which makes every ldmatrix phase conflict-free for both layouts
// without a swizzle.
//
// 256 threads = 8 warps laid out 2 (M) x 4 (N); a warp owns a 64x32 sub-tile,
// i.e. 4 m16 x 4 n8 MMA tiles and 64 f32 accumulators a thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace saev {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int PAD = 8;
constexpr int WM = 64;  // warp tile rows
constexpr int WN = 32;  // warp tile cols
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;

// Shared elements of one operand stage in either layout.
constexpr int KMAJ_ELEMS = BM * (BK + PAD);   // [128][40]
constexpr int MNMAJ_ELEMS = BK * (BM + PAD);  // [32][136]
constexpr int STAGE_ELEMS = KMAJ_ELEMS > MNMAJ_ELEMS ? KMAJ_ELEMS : MNMAJ_ELEMS;

struct Acc {
  float v[MT][NT][4];
};

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a.v[i][j][q] = 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Zero the bf16 halves of a packed pair whose index (lo half: idx, hi half:
// idx + 1) falls outside [lo, hi).
__device__ __forceinline__ uint32_t mask_pair(uint32_t v, int idx, int lo, int hi) {
  uint32_t keep_lo = (idx >= lo && idx < hi) ? 0x0000FFFFu : 0u;
  uint32_t keep_hi = (idx + 1 >= lo && idx + 1 < hi) ? 0xFFFF0000u : 0u;
  return v & (keep_lo | keep_hi);
}

// Copy one operand tile into shared memory with cp.async (16 bytes a copy).
// K-major: rows r0..r0+128 of a row-major matrix with leading dim `ld`, cols
// k0..k0+32. MN-major: rows k0..k0+32, cols r0..r0+128.
template <bool KMAJOR>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long ld, long r0, long k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    int c = tid + it * THREADS;  // 512 chunks of 8 bf16
    if (KMAJOR) {
      int row = c >> 2, col = (c & 3) * 8;
      cp_async16(s + row * (BK + PAD) + col, g + (r0 + row) * ld + k0 + col);
    } else {
      int row = c >> 4, col = (c & 15) * 8;
      cp_async16(s + row * (BM + PAD) + col, g + (k0 + row) * ld + r0 + col);
    }
  }
}

// A fragment (K-major) of m16 tile `mt` (warp-relative rows m_base) at k
// offset kk.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int m_base, int kk) {
  const int l = threadIdx.x & 31;
  int row = m_base + (l & 15), col = kk + (l >> 4) * 8;
  ldsm_x4(a, s + row * (BK + PAD) + col);
}

// B fragments (N-major) of two adjacent n8 tiles (n_base, n_base + 8) at k
// offset kk: b[0], b[1] for the first tile, b[2], b[3] for the second.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* s,
                                       int n_base, int kk) {
  const int l = threadIdx.x & 31;
  int k = kk + (l & 7) + ((l >> 3) & 1) * 8, n = n_base + (l >> 4) * 8;
  ldsm_x4_t(b, s + k * (BN + PAD) + n);
}

// acc += A_tile(BM x BK) @ B_tile(BK x BN) for the tile staged in shared
// memory; MASKED zeroes A's K lanes (columns of the stage) outside
// [k_lo, k_hi): the forward's cut lanes.
template <bool MASKED>
__device__ __forceinline__ void mma_stage(Acc& acc, const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb, int k_lo, int k_hi) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      load_a(a[i], sa, wm + 16 * i, kk);
      if (MASKED) {
        // a0/a1 hold k = kk + 2*(l%4) + {0,1}; a2/a3 the same + 8.
        int k0 = kk + 2 * (l & 3);
        a[i][0] = mask_pair(a[i][0], k0, k_lo, k_hi);
        a[i][1] = mask_pair(a[i][1], k0, k_lo, k_hi);
        a[i][2] = mask_pair(a[i][2], k0 + 8, k_lo, k_hi);
        a[i][3] = mask_pair(a[i][3], k0 + 8, k_lo, k_hi);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      load_b(b, sb, wn + 8 * j, kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc.v[i][j], a[i], b[0], b[1]);
        mma_bf16(acc.v[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// acc += A[r_a .. r_a+BM, k_begin .. k_end) @ B[k_begin .. k_end, r_b .. r_b+BN)
// streamed through a two-stage cp.async pipeline. (k_end - k_begin) % BK == 0.
// `smem` holds 2 stages of A then 2 stages of B.
__device__ inline void gemm_range(Acc& acc, __nv_bfloat16* smem, const __nv_bfloat16* A, long lda,
                           long r_a, const __nv_bfloat16* B, long ldb, long r_b, long k_begin,
                           long k_end) {
  __nv_bfloat16* sa = smem;
  __nv_bfloat16* sb = smem + 2 * STAGE_ELEMS;
  const long n_k = (k_end - k_begin) / BK;
  if (n_k <= 0) return;
  load_tile<true>(sa, A, lda, r_a, k_begin);
  load_tile<false>(sb, B, ldb, r_b, k_begin);
  cp_async_commit();
  for (long t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_k) {
      load_tile<true>(sa + (cur ^ 1) * STAGE_ELEMS, A, lda, r_a, k_begin + (t + 1) * BK);
      load_tile<false>(sb + (cur ^ 1) * STAGE_ELEMS, B, ldb, r_b, k_begin + (t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma_stage<false>(acc, sa + cur * STAGE_ELEMS, sb + cur * STAGE_ELEMS, 0, BK);
    __syncthreads();
  }
}

// Deterministic sum of one float a thread over the CTA: a fixed shuffle tree
// inside each warp, then warp 0 adds the 8 warp sums in order. The result is
// valid in thread 0. `red` is 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

}  // namespace saev
