// K2-K4: the grouped Matryoshka prefix-MSE products (forward error, dgrad,
// wgrad) on bf16 operands with f32 accumulation.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_err_kernel`
// (`grouped_prefix_err`), `_dgrad_kernel` (`grouped_matmul_dgrad`) and
// `_wgrad_kernel` (`grouped_matmul_wgrad`).
//
// Notation: f (B, S) latents, W (S, D) decoder rows, J prefix cuts
// p_j = m_j * g + r_j with groups of g latents, E_j (B, D) the per-prefix
// errors, scale = 2 * t_loss / (B * J * D).
//
// What bounds them on the card: tensor-core throughput. The three products
// are about 3 * 2 * B * S * D = 1.65 TFLOP at the production shape
// (B = S = 16384, D = 1024) against 1.9 GB of operand traffic, far above the
// card's ridge point; the cut snapshots and remainder terms add at most J
// partial K steps (forward) or J tiles (backward).
//
// What the design does about it: each kernel is one 128x128-tile GEMM with
// bf16 mma.sync and a two-stage cp.async pipeline (tile_mma.cuh), one CTA per
// output tile, so no CTA depends on another and every output element is
// written by exactly one CTA (no atomics; results are bitwise reproducible).
//  - K2 walks K = S in ascending order and snapshots E_j when it crosses p_j.
//    A cut inside a 32-wide K step splits that step into K-lane-masked
//    passes, so cuts may be any integers. The loss is one partial per CTA,
//    summed by a second one-block pass in a fixed order.
//  - K3 first builds dA_G = bf16(scale * sum_{m_j > G} E_j) with one thread
//    per (b, d) walking the groups downward (the TPU kernel's descending
//    carry, as a per-element loop). The df GEMM then accumulates the masked
//    remainder products E_j @ W_G^T (columns < r_j) first, multiplies by
//    scale, and adds dA_G @ W_G^T: one accumulator, one rounding to df's type.
//  - K4 does the same for dW_G = f_G^T @ dA_G plus the row-masked remainder,
//    each CTA reducing over the whole batch.
// This is the simple, correct first version: wgmma, TMA and deeper
// pipelines are later work.

#include "tile_mma.cuh"

using namespace saev;

namespace {

constexpr int MAXJ = 64;

// --- K2: grouped prefix error ------------------------------------------------

__device__ __forceinline__ void emit_error(const Acc& acc, int j, long b0, long n0,
                                           int B, int D, const float* __restrict__ x,
                                           const float* __restrict__ bdec, float iu,
                                           __nv_bfloat16* __restrict__ e, float& lsum) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  __nv_bfloat16* ej = e + (long)j * B * D;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = b0 + wm + 16 * i + (l >> 2) + 8 * h;
        const long col = n0 + wn + 8 * t + 2 * (l & 3);
        const float2 xv = *reinterpret_cast<const float2*>(x + row * D + col);
        const float2 bv = *reinterpret_cast<const float2*>(bdec + col);
        __nv_bfloat162 ev;
        ev.x = __float2bfloat16_rn(acc.v[i][t][2 * h] + (bv.x - xv.x));
        ev.y = __float2bfloat16_rn(acc.v[i][t][2 * h + 1] + (bv.y - xv.y));
        *reinterpret_cast<__nv_bfloat162*>(ej + row * D + col) = ev;
        const float e0 = __bfloat162float(ev.x) * iu, e1 = __bfloat162float(ev.y) * iu;
        lsum += e0 * e0;
        lsum += e1 * e1;
      }
}

__global__ void __launch_bounds__(THREADS)
    prefix_err_kernel(const __nv_bfloat16* __restrict__ f,
                      const __nv_bfloat16* __restrict__ w, const float* __restrict__ x,
                      const float* __restrict__ bdec, const float* __restrict__ inv_upper,
                      const int* __restrict__ m, const int* __restrict__ r, int J, int B,
                      int S, int D, int g, __nv_bfloat16* __restrict__ e,
                      float* __restrict__ xhat, float* __restrict__ partials) {
  __shared__ __align__(16) __nv_bfloat16 smem[4 * STAGE_ELEMS];
  __shared__ int cut_p[MAXJ], cut_j[MAXJ];
  __shared__ float red[THREADS / 32];
  const long n0 = (long)blockIdx.x * BN, b0 = (long)blockIdx.y * BM;

  // Cuts in ascending order of p (stable in j), so one K walk meets them all.
  if (threadIdx.x == 0) {
    for (int j = 0; j < J; ++j) {
      const int p = m[j] * g + r[j];
      int q = j;
      while (q > 0 && cut_p[q - 1] > p) {
        cut_p[q] = cut_p[q - 1];
        cut_j[q] = cut_j[q - 1];
        --q;
      }
      cut_p[q] = p;
      cut_j[q] = j;
    }
  }
  __syncthreads();
  const float iu = *inv_upper;

  Acc acc;
  zero(acc);
  float lsum = 0.f;
  int ci = 0;
  __nv_bfloat16* sa = smem;
  __nv_bfloat16* sb = smem + 2 * STAGE_ELEMS;
  const int n_k = S / BK;
  load_tile<true>(sa, f, S, b0, 0);
  load_tile<false>(sb, w, D, n0, 0);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_k) {
      load_tile<true>(sa + (cur ^ 1) * STAGE_ELEMS, f, S, b0, (long)(t + 1) * BK);
      load_tile<false>(sb + (cur ^ 1) * STAGE_ELEMS, w, D, n0, (long)(t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* a_s = sa + cur * STAGE_ELEMS;
    const __nv_bfloat16* b_s = sb + cur * STAGE_ELEMS;
    const int k0 = t * BK;
    int lo = 0;  // lanes of this K step already in acc
    while (ci < J && cut_p[ci] < k0 + BK) {
      const int pr = cut_p[ci] - k0;
      if (pr > lo) {
        mma_stage<true, false, true>(acc, a_s, b_s, Masks{lo, pr, BM, BN}, 0);
        lo = pr;
      }
      emit_error(acc, cut_j[ci], b0, n0, B, D, x, bdec, iu, e, lsum);
      ++ci;
    }
    if (lo == 0)
      mma_stage<true, false, false>(acc, a_s, b_s, Masks{0, BK, BM, BN}, 0);
    else if (lo < BK)
      mma_stage<true, false, true>(acc, a_s, b_s, Masks{lo, BK, BM, BN}, 0);
    __syncthreads();
  }
  // Cuts at p_j = S (the full decode): the snapshot is the whole product.
  for (; ci < J; ++ci) emit_error(acc, cut_j[ci], b0, n0, B, D, x, bdec, iu, e, lsum);

  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = b0 + wm + 16 * i + (l >> 2) + 8 * h;
        const long col = n0 + wn + 8 * t + 2 * (l & 3);
        *reinterpret_cast<float2*>(xhat + row * D + col) =
            make_float2(acc.v[i][t][2 * h], acc.v[i][t][2 * h + 1]);
      }
  const float s = block_sum(lsum, red);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Fixed-order sum of the per-CTA loss partials: bitwise the same every run.
__global__ void __launch_bounds__(THREADS)
    sum_partials_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) v += partials[i];
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[0] = s;
}

// --- K3: dgrad ------------------------------------------------------------------

// dA[b, G, d] = bf16(scale * sum_{j: m_j > G} E_j[b, d]), summed while walking
// G downward: E_j enters at G = m_j - 1, in ascending j within a group.
__global__ void build_da_kernel(const __nv_bfloat16* __restrict__ e,
                                const int* __restrict__ m, const float* __restrict__ scale,
                                int J, long BD, int D, int n_groups,
                                __nv_bfloat16* __restrict__ da) {
  __shared__ int ms[MAXJ];
  if (threadIdx.x < J) ms[threadIdx.x] = m[threadIdx.x];
  __syncthreads();
  const float s = *scale;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < BD;
       idx += (long)gridDim.x * blockDim.x) {
    const long b = idx / D, d = idx - b * D;
    float run = 0.f;
    for (int G = n_groups - 1; G >= 0; --G) {
      for (int j = 0; j < J; ++j)
        if (ms[j] == G + 1) run += __bfloat162float(e[j * BD + idx]);
      da[(b * n_groups + G) * D + d] = __float2bfloat16_rn(run * s);
    }
  }
}

template <typename Out>
__device__ __forceinline__ void store_pair(Out* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                          float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <typename Out>
__device__ __forceinline__ void store_tile(const Acc& acc, Out* out, long ld, long r0,
                                           long c0) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = r0 + wm + 16 * i + (l >> 2) + 8 * h;
        const long col = c0 + wn + 8 * t + 2 * (l & 3);
        store_pair<Out>(out + row * ld + col, acc.v[i][t][2 * h], acc.v[i][t][2 * h + 1]);
      }
}

// df[:, G*g + n0 ...] for one (n tile, row tile, group) = scale * sum_{m_j = G}
// [col < r_j] E_j @ W_G^T + dA_G @ W_G^T.
template <typename Out>
__global__ void __launch_bounds__(THREADS)
    dgrad_kernel(const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ e,
                 const __nv_bfloat16* __restrict__ da, const int* __restrict__ m,
                 const int* __restrict__ r, const float* __restrict__ scale, int J, int B,
                 int S, int D, int g, int n_groups, Out* __restrict__ df) {
  __shared__ __align__(16) __nv_bfloat16 smem[4 * STAGE_ELEMS];
  __shared__ int ms[MAXJ], rs[MAXJ];
  if (threadIdx.x < J) {
    ms[threadIdx.x] = m[threadIdx.x];
    rs[threadIdx.x] = r[threadIdx.x];
  }
  __syncthreads();
  const long n0 = (long)blockIdx.x * BN, b0 = (long)blockIdx.y * BM;
  const int G = blockIdx.z;
  const long w_row = (long)G * g + n0;  // B[k = d, n] = W[w_row + n, d]

  Acc acc;
  zero(acc);
  bool any_rem = false, any_main = false;
  for (int j = 0; j < J; ++j) {
    any_main |= ms[j] > G;
    if (ms[j] == G && rs[j] > n0) {
      gemm_range<true, true, true>(acc, smem, e + (long)j * B * D, D, b0, w, D, w_row, 0,
                                   D, Masks{0, BK, BM, (int)(rs[j] - n0)});
      any_rem = true;
    }
  }
  if (any_rem) saev::scale(acc, *scale);
  if (any_main)
    gemm_range<true, true, false>(acc, smem, da + (long)G * D, (long)n_groups * D, b0,
                                  w, D, w_row, 0, D, Masks{0, BK, BM, BN});
  store_tile<Out>(acc, df, S, b0, w_row);
}

// --- K4: wgrad ------------------------------------------------------------------

// dW[G*g + s0 ..., n0 ...] = scale * sum_{m_j = G} ([s < r_j] f_G)^T @ E_j
// + f_G^T @ dA_G, reduced over the whole batch inside the CTA.
__global__ void __launch_bounds__(THREADS)
    wgrad_kernel(const __nv_bfloat16* __restrict__ f, const __nv_bfloat16* __restrict__ da,
                 const __nv_bfloat16* __restrict__ e, const int* __restrict__ m,
                 const int* __restrict__ r, const float* __restrict__ scale, int J, int B,
                 int S, int D, int g, int n_groups, float* __restrict__ dw) {
  __shared__ __align__(16) __nv_bfloat16 smem[4 * STAGE_ELEMS];
  __shared__ int ms[MAXJ], rs[MAXJ];
  if (threadIdx.x < J) {
    ms[threadIdx.x] = m[threadIdx.x];
    rs[threadIdx.x] = r[threadIdx.x];
  }
  __syncthreads();
  const long n0 = (long)blockIdx.x * BN, s0 = (long)blockIdx.y * BM;
  const int G = blockIdx.z;
  const long f_col = (long)G * g + s0;  // A[m = s, k = b] = f[b, f_col + s]

  Acc acc;
  zero(acc);
  bool any_rem = false, any_main = false;
  for (int j = 0; j < J; ++j) {
    any_main |= ms[j] > G;
    if (ms[j] == G && rs[j] > s0) {
      gemm_range<false, false, true>(acc, smem, f, S, f_col, e + (long)j * B * D, D, n0,
                                     0, B, Masks{0, BK, (int)(rs[j] - s0), BN});
      any_rem = true;
    }
  }
  if (any_rem) saev::scale(acc, *scale);
  if (any_main)
    gemm_range<false, false, false>(acc, smem, f, S, f_col, da + (long)G * D,
                                    (long)n_groups * D, n0, 0, B, Masks{0, BK, BM, BN});
  store_tile<float>(acc, dw, D, f_col, n0);
}

bool shapes_ok(int J, int B, int S, int D, int g) {
  return J > 0 && J <= MAXJ && B > 0 && B % BM == 0 && D > 0 && D % BN == 0 && g > 0 &&
         g % BM == 0 && S % g == 0;
}

}  // namespace

extern "C" int saev_prefix_err(const __nv_bfloat16* f, const __nv_bfloat16* w,
                               const float* x, const float* bdec, const float* inv_upper,
                               const int* m, const int* r, int J, int B, int S, int D,
                               int g, __nv_bfloat16* e, float* xhat, float* partials,
                               float* loss_sum, cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  dim3 grid(D / BN, B / BM);
  prefix_err_kernel<<<grid, THREADS, 0, stream>>>(f, w, x, bdec, inv_upper, m, r, J, B, S,
                                                  D, g, e, xhat, partials);
  sum_partials_kernel<<<1, THREADS, 0, stream>>>(partials, grid.x * grid.y, loss_sum);
  return cudaGetLastError();
}

extern "C" int saev_dgrad(const __nv_bfloat16* w, const __nv_bfloat16* e, const int* m,
                          const int* r, const float* scale, int J, int B, int S, int D,
                          int g, int df_bf16, void* df, __nv_bfloat16* da,
                          cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  const int n_groups = S / g;
  const long bd = (long)B * D;
  build_da_kernel<<<(int)((bd + 255) / 256 < 65536 ? (bd + 255) / 256 : 65536), 256, 0,
                    stream>>>(e, m, scale, J, bd, D, n_groups, da);
  dim3 grid(g / BN, B / BM, n_groups);
  if (df_bf16)
    dgrad_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        w, e, da, m, r, scale, J, B, S, D, g, n_groups,
        static_cast<__nv_bfloat16*>(df));
  else
    dgrad_kernel<float><<<grid, THREADS, 0, stream>>>(w, e, da, m, r, scale, J, B, S, D,
                                                       g, n_groups, static_cast<float*>(df));
  return cudaGetLastError();
}

extern "C" int saev_wgrad(const __nv_bfloat16* f, const __nv_bfloat16* da,
                          const __nv_bfloat16* e, const int* m, const int* r,
                          const float* scale, int J, int B, int S, int D, int g, float* dw,
                          cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  const int n_groups = S / g;
  dim3 grid(D / BN, g / BM, n_groups);
  wgrad_kernel<<<grid, THREADS, 0, stream>>>(f, da, e, m, r, scale, J, B, S, D, g,
                                             n_groups, dw);
  return cudaGetLastError();
}
