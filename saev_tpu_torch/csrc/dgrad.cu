// K3: the grouped Matryoshka dgrad for Hopper. One call is two launches: the
// dA build, then df by wgmma fed through TMA.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_dgrad_kernel`
// (`grouped_matmul_dgrad`).
//
// Notation as in prefix_fwd.cu: W (S, D) decoder rows, E_j (B, D) the
// per-prefix errors, cuts p_j = m_j * g + r_j with groups of g latents. It
// computes
//   dA_G     = bf16(scale * sum_{j: m_j > G} E_j)    (B, n_groups, D), for K4;
//   df[:, G] = dA_G @ W_G^T + scale * sum_{j: m_j = G} [col < r_j] E_j @ W_G^T,
// rounded once to df's type (bf16 or f32).
//
// What bounds it on the card (production shape B = S = 16384, D = 1024,
// g = 1024, J = 10):
//  - the dA build moves bytes: E read once (J*B*D*2 = 335 MB), dA written
//    once (B*16*D*2 = 537 MB), 0.26 ms at 3.35 TB/s;
//  - the product is tensor-core work: 2*B*S*D = 0.55 TFLOP, plus 2*B*r_j*D
//    for each cut's remainder, 0.56 ms at 989 TFLOP/s.
//
// What the design does about it:
//  - build_da_vec_kernel: one thread owns 8 consecutive d of one row. It
//    walks the groups downward, adds the E_j that enter at each group (16-byte
//    loads, E_j at G = m_j - 1 in ascending j) into 8 f32 sums, and stores
//    each dA_G slice as one 16-byte vector. The f32 adds per element and the
//    one rounding are those of the plain version, so dA is its bits.
//  - dgrad_wgmma_kernel: one 128 x 128 df tile a CTA (rows of B, latents of
//    group G), a plain grid with no persistence: every CTA walks the same
//    K = D. A producer warp streams 64-deep K steps of the A operand (dA_G,
//    or E_j for a remainder pass) and of W_G with TMA into a ring of 3 stages
//    of 32 KB, 128-byte swizzled, with full and empty mbarriers. Two consumer
//    warpgroups own 64 rows each and run wgmma m64n128k16: both operands
//    K-major bf16 in shared memory, f32 accumulators in registers. At 3
//    stages two CTAs fit on an SM, so one CTA's epilogue overlaps another's
//    mainloop. The remainder passes (cuts of group G with r_j > n0) run
//    first, in ascending r_j, into the one accumulator: after each pass the
//    columns >= r_j are zeroed, which masks the newest term and keeps the
//    earlier ones (their columns lie below a smaller r). Then the
//    accumulator is scaled, and the main product dA_G @ W_G^T adds into it.
//    The epilogue stores pairs straight from the accumulator fragment. Every
//    df element is written by one CTA: no atomics, the same bits every run.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = TILE;  // rows of B a CTA
constexpr int TN = TILE;  // latents a CTA

template <typename Out>
__device__ __forceinline__ void store_pair(Out* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// --- the dA build -----------------------------------------------------------------

__global__ void __launch_bounds__(256)
    build_da_vec_kernel(const __nv_bfloat16* __restrict__ e, const int* __restrict__ m,
                        const float* __restrict__ scale, int J, int B, int D, int n_groups,
                        __nv_bfloat16* __restrict__ da) {
  extern __shared__ int ms[];  // J entries
  for (int j = threadIdx.x; j < J; j += blockDim.x) ms[j] = m[j];
  __syncthreads();
  const long bd = (long)B * D;
  const long idx = 8 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (idx >= bd) return;
  const long b = idx / D, d = idx - b * D;
  const float s = *scale;
  float run[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) run[q] = 0.f;
  for (int G = n_groups - 1; G >= 0; --G) {
    for (int j = 0; j < J; ++j) {
      if (ms[j] != G + 1) continue;
      const uint4 raw = *reinterpret_cast<const uint4*>(e + j * bd + idx);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(v[q]);
        run[2 * q] += f.x;
        run[2 * q + 1] += f.y;
      }
    }
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = __floats2bfloat162_rn(run[2 * q] * s, run[2 * q + 1] * s);
    *reinterpret_cast<uint4*>(da + (b * n_groups + G) * D + d) = out;
  }
}

// --- the df product ---------------------------------------------------------------

// CTA (n tile blockIdx.x, row tile blockIdx.y, group blockIdx.z). Maps:
// map_w over W as (D, S), box (64, 128); map_e over E as (D, B, J), box
// (64, 128, 1); map_da over dA as (D, n_groups, B), box (64, 1, 128).
// Dynamic shared memory: the ring (SMEM_BYTES), then the remainder table
// (rem_r, rem_j: 8 J bytes).
template <typename Out>
__global__ void __launch_bounds__(THREADS, 2)
    dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_e,
                       const __grid_constant__ CUtensorMap map_da, const int* __restrict__ m,
                       const int* __restrict__ r, const float* __restrict__ scale, int J, int S,
                       int D, int g, Out* __restrict__ df) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int n_rem_s, any_main_s;
  int* rem_r = reinterpret_cast<int*>(smem_raw + SMEM_BYTES);
  int* rem_j = rem_r + J;

  const int n0 = blockIdx.x * TN, b0 = blockIdx.y * TM, G = blockIdx.z;
  const int w_row = G * g + n0;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  // The cuts of this group whose remainder reaches this tile, by ascending r
  // (stable in j): every thread ranks its share of them.
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int rj = r[j];
    if (m[j] != G || rj <= n0) continue;
    int q = 0;
    for (int i = 0; i < J; ++i) {
      const int ri = r[i];
      q += m[i] == G && ri > n0 && (ri < rj || (ri == rj && i < j));
    }
    rem_r[q] = rj;
    rem_j[q] = j;
  }
  if (threadIdx.x == 0) {
    // How many there are, and whether any cut lies above the group (dA_G != 0).
    int n = 0, main = 0;
    for (int j = 0; j < J; ++j) {
      main |= m[j] > G;
      n += m[j] == G && r[j] > n0;
    }
    n_rem_s = n;
    any_main_s = main;
    init_ring(full, empty);
  }
  __syncthreads();
  const int n_rem = n_rem_s;
  const int n_pass = n_rem + any_main_s;
  const int n_k = D / TK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == CONSUMER_WARPS) {
    // Producer: step `it` of the whole sequence fills stage it % STAGES once
    // the consumers have released that stage's previous fill.
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < n_pass; ++p)
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t a_dst = ring + s * STAGE_BYTES, b_dst = a_dst + TILE_BYTES;
          const uint32_t bar = smem_u32(&full[s]);
          mbar_wait(smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, STAGE_BYTES);
          if (p < n_rem)
            tma_load_3d(a_dst, &map_e, bar, kt * TK, b0, rem_j[p]);
          else
            tma_load_3d(a_dst, &map_da, bar, kt * TK, G, b0);
          tma_load_2d(b_dst, &map_w, bar, kt * TK, w_row);
        }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  int it = 0;
  for (int p = 0; p < n_pass; ++p) {
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
      const uint64_t da = kmajor_desc(ring + s * STAGE_BYTES + wg * HALF_BYTES);
      const uint64_t db = kmajor_desc(ring + s * STAGE_BYTES + TILE_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wgmma_m64n128k16<0, 0>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }
    if (p < n_rem) {
      const int rr = rem_r[p] - n0;  // columns of this tile below r_j
#pragma unroll
      for (int i = 0; i < NACC / 4; ++i) {
        const int c = 8 * i + 2 * (lane & 3);
        if (c >= rr) acc[4 * i] = acc[4 * i + 2] = 0.f;
        if (c + 1 >= rr) acc[4 * i + 1] = acc[4 * i + 3] = 0.f;
      }
      if (p == n_rem - 1) {
        const float sc = *scale;
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] *= sc;
      }
    }
  }

  const long row = b0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    const long col = w_row + 8 * i + 2 * (lane & 3);
    store_pair<Out>(df + row * S + col, acc[4 * i], acc[4 * i + 1]);
    store_pair<Out>(df + (row + 8) * S + col, acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// --- host side --------------------------------------------------------------------

template <typename Out>
cudaError_t launch_dgrad(dim3 grid, const CUtensorMap& mw, const CUtensorMap& me,
                         const CUtensorMap& mda, const int* m, const int* r, const float* scale,
                         int J, int S, int D, int g, void* df, cudaStream_t stream) {
  const int smem = SMEM_BYTES + 8 * J;
  const cudaError_t err = cudaFuncSetAttribute(
      dgrad_wgmma_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dgrad_wgmma_kernel<Out><<<grid, THREADS, smem, stream>>>(
      mw, me, mda, m, r, scale, J, S, D, g, static_cast<Out*>(df));
  return cudaGetLastError();
}

}  // namespace

// df (B, S) in bf16 (df_bf16) or f32, dA (B, S / g, D) bf16. The shapes
// kernels of prefix_fwd.cu take: B, D and g multiples of 128, g dividing S,
// 1 <= J <= MAX_CUTS.
extern "C" int saev_dgrad(const __nv_bfloat16* w, const __nv_bfloat16* e, const int* m,
                          const int* r, const float* scale, int J, int B, int S, int D,
                          int g, int df_bf16, void* df, __nv_bfloat16* da,
                          cudaStream_t stream) {
  if (!(J > 0 && J <= MAX_CUTS && B > 0 && B % TM == 0 && D > 0 && D % 128 == 0 && g > 0 &&
        g % TN == 0 && S % g == 0))
    return cudaErrorInvalidValue;
  const int n_groups = S / g;
  const long n_vec = (long)B * D / 8;
  build_da_vec_kernel<<<(unsigned)((n_vec + 255) / 256), 256, 4 * J, stream>>>(e, m, scale, J, B, D,
                                                                                n_groups, da);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mw, me, mda;
  const cuuint64_t row = (cuuint64_t)D * 2;  // bytes
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)S}, w_strides[1] = {row};
  const cuuint32_t w_box[2] = {TK, TN};
  const cuuint64_t e_dims[3] = {(cuuint64_t)D, (cuuint64_t)B, (cuuint64_t)J};
  const cuuint64_t e_strides[2] = {row, row * B};
  const cuuint32_t e_box[3] = {TK, TM, 1};
  const cuuint64_t da_dims[3] = {(cuuint64_t)D, (cuuint64_t)n_groups, (cuuint64_t)B};
  const cuuint64_t da_strides[2] = {row, row * n_groups};
  const cuuint32_t da_box[3] = {TK, 1, TM};
  if (!make_map(&mw, w, 2, w_dims, w_strides, w_box) ||
      !make_map(&me, e, 3, e_dims, e_strides, e_box) ||
      !make_map(&mda, da, 3, da_dims, da_strides, da_box))
    return cudaErrorInvalidValue;
  const dim3 grid(g / TN, B / TM, n_groups);
  return df_bf16 ? launch_dgrad<__nv_bfloat16>(grid, mw, me, mda, m, r, scale, J, S, D, g, df,
                                               stream)
                 : launch_dgrad<float>(grid, mw, me, mda, m, r, scale, J, S, D, g, df, stream);
}
