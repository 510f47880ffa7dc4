// K4: the grouped Matryoshka wgrad for Hopper. One call is two launches: the
// products by wgmma fed through TMA, then a fixed-order combine.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_wgrad_kernel`
// (`grouped_matmul_wgrad`).
//
// Notation as in prefix_fwd.cu: f (B, S) latents, dA (B, n_groups, D) from
// K3, E_j (B, D) the per-prefix errors, cuts p_j = m_j * g + r_j with groups
// of g latents. It computes, in f32,
//   dW_G = f_G^T @ dA_G + scale * sum_{j: m_j = G} ([s < r_j] f_G)^T @ E_j.
//
// What bounds it on the card (production shape B = S = 16384, D = 1024,
// g = 1024, J = 10): the main term is 2*B*S*D = 0.55 TFLOP of dense
// tensor-core work (0.56 ms at 989 TFLOP/s), each cut's remainder adds
// 2*B*D*128 for every 128-latent tile below r_j; f, dA and E are read about
// once (1.4 GB, 0.42 ms at 3.35 TB/s).
//
// What the design does about it:
//  - Equal work items on a plain grid. An item is one 128 x 128 output tile
//    reduced over the whole batch (K = B). Remainder slots (j, s-tile,
//    d-tile) come first in the grid, then main items (G, s-tile, d-tile). A
//    main item stores f_G^T @ dA_G straight into dW. A remainder slot is live
//    when m_j < n_groups and r_j > s0: it computes f_{m_j}^T @ E_j for its
//    tile and stores it into the f32 workspace (J, g, D) with the rows at or
//    above r_j zeroed; a slot that is not live exits at once. So no CTA
//    carries more than one whole-batch pass, however the cuts fall: short
//    prefixes, which sample_prefixes favours, put many cuts in one group.
//  - wgrad_combine_kernel: for each dW tile with a live remainder,
//    dW = dW + scale * (sum over j ascending of the partials), the plain
//    version's association, with no contraction into an FMA. No atomics: the
//    same bits every run.
//  - The mainloop is K3's (hopper.cuh): one TMA producer warp, a 3-stage ring
//    of 32 KB, 128-byte swizzle, two consumer warpgroups on wgmma m64n128k16,
//    two CTAs an SM. The contraction runs over the batch, the outer
//    dimension of f, dA and E, so both operands are MN-major: a stage holds
//    64 batch rows of f's 128 latents (A, as two 64 x 64 boxes) and of dA_G's
//    or E_j's 128 d (B, the same), and wgmma reads both transposed.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int COMBINE_THREADS = 256;

// Item blockIdx.x: remainder slots first, then main items, each laid out
// (j or G, s-tile, d-tile) with the d-tile fastest. Maps: map_f over f as
// (S, B), box (64, 64); map_da over dA as (D, n_groups, B), box (64, 1, 64);
// map_e over E as (D, B, J), box (64, 64, 1).
__global__ void __launch_bounds__(THREADS, 2)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_f,
                       const __grid_constant__ CUtensorMap map_da,
                       const __grid_constant__ CUtensorMap map_e, const int* __restrict__ m,
                       const int* __restrict__ r, int J, int B, int D, int g, int n_groups,
                       float* __restrict__ dw, float* __restrict__ ws) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int n_d = D / TILE, per = (g / TILE) * n_d;  // items per j or per G
  const int n_slots = J * per;
  const bool rem = (int)blockIdx.x < n_slots;
  const int q = rem ? blockIdx.x : blockIdx.x - n_slots;
  const int a = q / per, t = q - a * per;  // a: j (remainder) or G (main)
  const int s0 = (t / n_d) * TILE, d0 = (t % n_d) * TILE;
  int G = a, rr = TILE;  // rows of the tile below r_j
  if (rem) {
    const int mj = m[a], rj = r[a];
    if (mj >= n_groups || rj <= s0) return;  // every thread of the CTA alike
    G = mj;
    rr = rj - s0;
  }
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  if (threadIdx.x == 0) init_ring(full, empty);
  __syncthreads();
  const int n_k = B / TK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == CONSUMER_WARPS) {
    // Producer: K step kt fills stage kt % STAGES once the consumers have
    // released that stage's previous fill.
    if (lane == 0) {
      const int f_col = G * g + s0;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES, b0 = kt * TK;
        const uint32_t a_dst = ring + s * STAGE_BYTES, b_dst = a_dst + TILE_BYTES;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(a_dst, &map_f, bar, f_col, b0);
        tma_load_2d(a_dst + HALF_BYTES, &map_f, bar, f_col + 64, b0);
        if (rem) {
          tma_load_3d(b_dst, &map_e, bar, d0, b0, a);
          tma_load_3d(b_dst + HALF_BYTES, &map_e, bar, d0 + 64, b0, a);
        } else {
          tma_load_3d(b_dst, &map_da, bar, d0, G, b0);
          tma_load_3d(b_dst + HALF_BYTES, &map_da, bar, d0 + 64, G, b0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    // A: this warpgroup's 64 latents (one box); B: 128 d (two boxes).
    const uint64_t da = mnmajor_desc(ring + s * STAGE_BYTES + wg * HALF_BYTES);
    const uint64_t db = mnmajor_desc(ring + s * STAGE_BYTES + TILE_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) wgmma_m64n128k16<1, 1>(acc, da + 128 * kk, db + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // Row of the tile (a latent) and where the tile goes: dW, or the
  // workspace slice of cut j with the rows at or above r_j zeroed.
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float* out = rem ? ws + ((long)a * g + s0) * D + d0 : dw + ((long)G * g + s0) * D + d0;
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + (long)row * D + col) =
        row < rr ? make_float2(acc[4 * i], acc[4 * i + 1]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(out + (long)(row + 8) * D + col) =
        row + 8 < rr ? make_float2(acc[4 * i + 2], acc[4 * i + 3]) : make_float2(0.f, 0.f);
  }
}

// CTA (d-tile blockIdx.x, s-tile blockIdx.y, group blockIdx.z): if any
// remainder of the group reaches this tile, dW += scale * (sum over those j
// ascending of their partials). A thread owns V float4 of the tile and
// walks the partials in the outer loop, so its V loads of one partial are
// in flight together (the deepest tile sums nine at the sampled cuts).
__global__ void __launch_bounds__(COMBINE_THREADS)
    wgrad_combine_kernel(const float* __restrict__ ws, const int* __restrict__ m,
                         const int* __restrict__ r, const float* __restrict__ scale, int J, int D,
                         int g, float* __restrict__ dw) {
  constexpr int V = TILE * TILE / 4 / COMBINE_THREADS;
  const int d0 = blockIdx.x * TILE, s0 = blockIdx.y * TILE, G = blockIdx.z;
  // The first cut whose remainder reaches this tile (the same j for every
  // thread), then the others in ascending j.
  int j0 = 0;
  while (j0 < J && !(m[j0] == G && r[j0] > s0)) ++j0;
  if (j0 == J) return;
  const long slice = (long)g * D;
  long off[V];
  float4 sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int v = threadIdx.x + i * COMBINE_THREADS;
    const int row = v / (TILE / 4), c = 4 * (v % (TILE / 4));
    off[i] = (long)(s0 + row) * D + d0 + c;
    sum[i] = *reinterpret_cast<const float4*>(ws + j0 * slice + off[i]);
  }
  for (int j = j0 + 1; j < J; ++j) {
    if (m[j] != G || r[j] <= s0) continue;
    const float* part = ws + j * slice;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(part + off[i]);
      sum[i].x = __fadd_rn(sum[i].x, p.x);
      sum[i].y = __fadd_rn(sum[i].y, p.y);
      sum[i].z = __fadd_rn(sum[i].z, p.z);
      sum[i].w = __fadd_rn(sum[i].w, p.w);
    }
  }
  const float sc = *scale;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float4* o = reinterpret_cast<float4*>(dw + G * slice + off[i]);
    float4 v4 = *o;
    v4.x = __fadd_rn(v4.x, __fmul_rn(sc, sum[i].x));
    v4.y = __fadd_rn(v4.y, __fmul_rn(sc, sum[i].y));
    v4.z = __fadd_rn(v4.z, __fmul_rn(sc, sum[i].z));
    v4.w = __fadd_rn(v4.w, __fmul_rn(sc, sum[i].w));
    *o = v4;
  }
}

}  // namespace

// dW (S, D) f32; ws (J, g, D) f32 workspace for the remainder partials,
// which the call overwrites where it reads. The shapes prefix_fwd.cu's
// kernels take: B, D and g multiples of 128, g dividing S, 1 <= J <= MAX_CUTS.
extern "C" int saev_wgrad(const __nv_bfloat16* f, const __nv_bfloat16* da,
                          const __nv_bfloat16* e, const int* m, const int* r,
                          const float* scale, int J, int B, int S, int D, int g, float* dw,
                          float* ws, cudaStream_t stream) {
  if (!(J > 0 && J <= MAX_CUTS && B > 0 && B % TILE == 0 && D > 0 && D % TILE == 0 && g > 0 &&
        g % TILE == 0 && S % g == 0))
    return cudaErrorInvalidValue;
  const int n_groups = S / g;
  CUtensorMap mf, mda, me;
  const cuuint64_t row = (cuuint64_t)D * 2;  // bytes
  const cuuint64_t f_dims[2] = {(cuuint64_t)S, (cuuint64_t)B}, f_strides[1] = {(cuuint64_t)S * 2};
  const cuuint32_t f_box[2] = {64, TK};
  const cuuint64_t da_dims[3] = {(cuuint64_t)D, (cuuint64_t)n_groups, (cuuint64_t)B};
  const cuuint64_t da_strides[2] = {row, row * n_groups};
  const cuuint32_t da_box[3] = {64, 1, TK};
  const cuuint64_t e_dims[3] = {(cuuint64_t)D, (cuuint64_t)B, (cuuint64_t)J};
  const cuuint64_t e_strides[2] = {row, row * B};
  const cuuint32_t e_box[3] = {64, TK, 1};
  if (!make_map(&mf, f, 2, f_dims, f_strides, f_box) ||
      !make_map(&mda, da, 3, da_dims, da_strides, da_box) ||
      !make_map(&me, e, 3, e_dims, e_strides, e_box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wgrad_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int per = (g / TILE) * (D / TILE);
  wgrad_wgmma_kernel<<<(J + n_groups) * per, THREADS, SMEM_BYTES, stream>>>(
      mf, mda, me, m, r, J, B, D, g, n_groups, dw, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_combine_kernel<<<dim3(D / TILE, g / TILE, n_groups), COMBINE_THREADS, 0, stream>>>(
      ws, m, r, scale, J, D, g, dw);
  return cudaGetLastError();
}
