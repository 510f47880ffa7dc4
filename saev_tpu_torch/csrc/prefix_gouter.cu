// P2, the group-outer Matryoshka forward error, for Hopper: one launch on
// K2's wgmma + TMA walk, with W multicast across a cluster of two row tiles.
//
// Replaces scripts/proto_gouter.py `_err_kernel_gouter`
// (`grouped_prefix_err_gouter`). Notation as in prefix_fwd.cu: f (B, S)
// latents, W (S, D) decoder rows, x (B, D) targets, J cuts p_j = m_j g + r_j.
// It computes
//   E_j      = bf16((b_dec - x) + f[:, :p_j] @ W[:p_j])   (J, B, D),
//   err_full = (b_dec - x) + f @ W                         (B, D) f32,
//   loss_sum = sum (f32(E_j) * inv_upper)^2.
//
// What bounds it on the card (B = S = 16384, D = 1024, J = 10): the bytes it
// must move, f's nonzeros, W, x, E and err_full (0.31 ms at 3.35 TB/s); as a
// dense product on the tensor cores it cannot go under 2 B S D / 989 TFLOP/s
// = 0.56 ms. The TPU kernel walks the groups outermost so that W is fetched
// once for many row tiles; K2 (prefix_fwd.cu) gives each of its 128 row
// tiles the whole walk, so every row tile reads all of W (32 MB) from L2,
// about 4 GB of K2's L2 traffic.
//
// What the design does about it:
//  - K2's walk (prefix_walk.cuh, hopper.cuh): one 128 x 128 tile a CTA, a
//    3-stage ring of 32 KB filled by TMA from thread 0, two warpgroups on
//    wgmma m64n128k16, the cut snapshots at 16-lane steps with a correction
//    below the cut, the branch to a snapshot taken on a warp vote.
//  - The accumulator starts at b_dec - x (x read once a tile) and stays in
//    registers for the whole walk: a snapshot is bf16(acc + correction), with
//    no x read, and err_full is stored once at the end. (The earlier P2
//    launched once a group and carried the f32 sum through device memory,
//    16 read-modify-write passes over 64 MB.)
//  - Clusters of two CTAs on adjacent row tiles of one d tile: each loads its
//    own f tile (16 KB a stage) and one half of the stage's W tile (8 KB),
//    multicast to both, so each W byte leaves L2 once for two row tiles.
//    A stage's full barrier counts its own f and both W halves; its empty
//    barrier takes one arrival of each consumer warp of both CTAs (a warp
//    releases a stage locally and on its partner, by a remote arrive),
//    because the partner's next multicast writes into this CTA's stage.
//    Barriers are set up on both CTAs before either copies (a cluster
//    barrier), and neither exits while the other may still write into it
//    or arrive on it (a cluster barrier at the end). An odd row-tile count
//    gives the last cluster an idle partner: it takes part in the W loads
//    and releases, loads no f and stores nothing.
//  - The loss is one partial a CTA, summed in a fixed order
//    (matryoshka.cu's sum_partials_kernel): the same bits every run.

#include "prefix_walk.cuh"

cudaError_t saev_sum_partials(const float* partials, int n, float* out, cudaStream_t stream);

namespace {

constexpr int CLUSTER = 2;  // row tiles a cluster; W is multicast to both

// Thread 0 fills stage kt % STAGES with K step kt once both CTAs' warps have
// released it: its own f rows (one box, none for the idle partner) and its
// half of W's 128 columns (one 64 x 64 box), multicast to both CTAs.
__device__ __forceinline__ void load_stage_mc(int kt, uint32_t ring, uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* map_f, const CUtensorMap* map_w, int b0,
                                              int n0, uint32_t rank, bool live) {
  const int s = kt % STAGES;
  const uint32_t a_dst = ring + s * STAGE_BYTES, b_dst = a_dst + TILE_BYTES;
  const uint32_t bar = smem_u32(&full[s]);
  mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
  // The warps' reads of the stage (the snapshots' corrections) come before
  // the copies' writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, live ? STAGE_BYTES : TILE_BYTES);
  if (live) tma_load_2d(a_dst, map_f, bar, kt * TK, b0);
  tma_load_2d_multicast(b_dst + rank * HALF_BYTES, map_w, bar, n0 + 64 * rank, kt * TK, (1u << CLUSTER) - 1);
}

// CTA (d tile blockIdx.x, row tile blockIdx.y); clusters of CLUSTER row
// tiles. Maps as K2's: map_f over f as (S, B), box (64, 128); map_w over W
// as (D, S), box (64, 64). Dynamic shared memory: the ring, then the sorted
// cuts (8 J bytes).
__global__ void __launch_bounds__(FWD_THREADS, 2)
    gouter_wgmma_kernel(const __grid_constant__ CUtensorMap map_f, const __grid_constant__ CUtensorMap map_w,
                        const float* x, const float* bdec, const float* __restrict__ inv_upper,
                        const int* __restrict__ m, const int* __restrict__ r, int J, int B, int S, int D, int g,
                        __nv_bfloat16* __restrict__ e, float* __restrict__ err, float* __restrict__ partials) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float red[CONSUMER_WARPS];
  int* cut_p = reinterpret_cast<int*>(smem_raw + SMEM_BYTES);
  int* cut_j = cut_p + J;

  const int n0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const bool live = b0 < B;
  const int n_cuts = live ? J : 0;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_k = S / TK;

  sort_cuts(m, r, n_cuts, g, cut_p, cut_j);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CLUSTER * CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < STAGES - 1 && kt < n_k; ++kt)
      load_stage_mc(kt, ring, full, empty, &map_f, &map_w, b0, n0, rank, live);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int row_l = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // the thread's first row
  const long slice_bytes = (long)B * D * 2;
  // acc = b_dec - x, in the wgmma fragment's layout.
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.f, 0.f);
      if (live) {
        const float2 xv = *reinterpret_cast<const float2*>(x + (long)(b0 + row_l + 8 * h) * D + col);
        const float2 bv = *reinterpret_cast<const float2*>(bdec + col);
        v = make_float2(__fsub_rn(bv.x, xv.x), __fsub_rn(bv.y, xv.y));
      }
      acc[4 * i + 2 * h] = v.x;
      acc[4 * i + 2 * h + 1] = v.y;
    }
  }
  const float iu = *inv_upper;
  float lsum = 0.f;
  int ci = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    if (threadIdx.x == 0 && kt + STAGES - 1 < n_k)
      load_stage_mc(kt + STAGES - 1, ring, full, empty, &map_f, &map_w, b0, n0, rank, live);
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t stage = ring + s * STAGE_BYTES;
    const uint64_t da = kmajor_desc(stage + wg * HALF_BYTES);
    const uint64_t db = mnmajor_desc(stage + TILE_BYTES);
    const int k0 = kt * TK;
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      const int k_end = k0 + 16 * (kk + 1);
      if (__any_sync(0xffffffffu, ci < n_cuts && cut_p[ci] < k_end)) {
        wgmma_commit();
        wgmma_wait_all();
        int c1 = ci + 1;
        while (c1 < n_cuts && cut_p[c1] < k_end) ++c1;
        snapshots<Store::kAcc>(acc, stage, k0, 16 * kk, cut_p, cut_j, ci, c1, row_l, b0, n0, D, e, slice_bytes,
                               nullptr, nullptr, iu, lsum, lane);
        ci = c1;
      }
      wgmma_fence();
      wgmma_m64n128k16<0, 1>(acc, da + 2 * kk, db + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) {
      mbar_arrive(smem_u32(&empty[s]));
      mbar_arrive_cluster(smem_u32(&empty[s]), peer);
    }
  }
  // Cuts at p_j = S: the snapshot is the whole sum.
  if (ci < n_cuts)
    snapshots<Store::kAcc>(acc, 0, S, 0, cut_p, cut_j, ci, n_cuts, row_l, b0, n0, D, e, slice_bytes, nullptr,
                           nullptr, iu, lsum, lane);
  if (live)
    snapshots<Store::kF32>(acc, 0, 0, 0, nullptr, nullptr, 0, 1, row_l, b0, n0, D, err, 0, nullptr, nullptr, 0.f,
                           lsum, lane);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  if (threadIdx.x == 0 && live) {
    float sum = 0.f;
    for (int w = 0; w < CONSUMER_WARPS; ++w) sum += red[w];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
  cluster_sync();  // the partner may still multicast into this CTA or arrive on its barriers
}

}  // namespace

// P2. partials holds (B / 128) * (D / 128) floats; x and b_dec 8-byte
// aligned. One cluster launch (a row tile more where B / 128 is odd), then
// the fixed-order sum of the partials.
extern "C" int saev_prefix_err_gouter(const __nv_bfloat16* f, const __nv_bfloat16* w, const float* x,
                                      const float* bdec, const float* inv_upper, const int* m, const int* r,
                                      int J, int B, int S, int D, int g, __nv_bfloat16* e, float* err,
                                      float* partials, float* loss_sum, cudaStream_t stream) {
  if (!(J > 0 && J <= MAX_CUTS && B > 0 && B % TILE == 0 && D > 0 && D % TILE == 0 && g > 0 && g % TILE == 0 &&
        S % g == 0 && S % TK == 0))
    return cudaErrorInvalidValue;
  CUtensorMap mf, mw;
  const cuuint64_t f_dims[2] = {(cuuint64_t)S, (cuuint64_t)B}, f_strides[1] = {(cuuint64_t)S * 2};
  const cuuint32_t f_box[2] = {TK, TILE};
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)S}, w_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t w_box[2] = {64, TK};
  if (!make_map(&mf, f, 2, f_dims, f_strides, f_box) || !make_map(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const int smem = SMEM_BYTES + 8 * J;
  cudaError_t err_code =
      cudaFuncSetAttribute(gouter_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err_code != cudaSuccess) return err_code;
  const int row_tiles = B / TILE;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D / TILE, (row_tiles + CLUSTER - 1) / CLUSTER * CLUSTER, 1);
  cfg.blockDim = dim3(FWD_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CLUSTER;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err_code = cudaLaunchKernelEx(&cfg, gouter_wgmma_kernel, mf, mw, x, bdec, inv_upper, m, r, J, B, S, D, g, e, err,
                                partials);
  if (err_code != cudaSuccess) return err_code;
  err_code = cudaGetLastError();
  if (err_code != cudaSuccess) return err_code;
  return saev_sum_partials(partials, row_tiles * (D / TILE), loss_sum, stream);
}
