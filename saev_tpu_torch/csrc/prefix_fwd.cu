// K2 and K7 for Hopper: the grouped Matryoshka prefix-MSE forward products
// (error, base) on wgmma fed through TMA.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_err_kernel`
// (`grouped_prefix_err`) and `_base_kernel` (`grouped_prefix_base`).
//
// Notation: f (B, S) latents, W (S, D) decoder rows, x (B, D) targets, J
// prefix cuts p_j = m_j * g + r_j with groups of g latents.
// K2 computes
//   E_j       = bf16(f[:, :p_j] @ W[:p_j] + (b_dec - x))     (J, B, D),
//   xhat      = f @ W                                         (B, D) f32,
//   loss_sum  = sum (f32(E_j) * inv_upper)^2;
// K7 the same walk with base_j = f[:, :p_j] @ W[:p_j] (f32, or rounded to
// bf16) in place of E_j, and no loss.
//
// What bounds it on the card (production shape B = S = 16384, D = 1024,
// J = 10): the bytes it must move, f's nonzeros, W, x and E (0.31 ms at
// 3.35 TB/s). A dense product on the tensor cores cannot go under
// 2 * B * S * D / 989 TFLOP/s = 0.56 ms; that is this design's floor.
//
// What the design does about it:
//  - The mainloop is K3's and K4's (hopper.cuh): one 128 x 128 f32 tile a
//    CTA, blockIdx.x the d tile (fastest) and blockIdx.y the row tile, so
//    the 8 CTAs of a row tile share its f rows in L2. A 3-stage ring of 32 KB
//    stages (128-byte swizzle, full and empty mbarriers) is filled by TMA;
//    two warpgroups own 64 rows each and run wgmma m64n128k16 on every
//    stage. A = f is K-major (one 64 x 128 box a stage, K3's descriptor);
//    B = W is MN-major, since d is contiguous (two 64 x 64 boxes a stage,
//    K4's descriptor).
//  - No producer warp: thread 0 issues each stage's three TMA loads when
//    the warps release the stage two steps ahead. With a ninth warp, 18 warps
//    an SM put 5 on one of its four register files, which caps a thread at
//    96 registers, and the snapshots spill there; with 16 warps the cap is
//    128, and nothing spills at two CTAs an SM.
//  - Cut snapshots at 16-lane steps. The walk meets the cuts in ascending p
//    (stable in j). Before the k16 step that holds a cut p it waits for the
//    steps issued so far and snapshots acc plus a correction
//    sum_{k = 16 floor(p / 16)}^{p - 1} f[row, k] W[k, col] of at most 15
//    lanes on CUDA cores, read from the stage already in shared memory; acc
//    itself is left as it is. All the cuts of one k16 step are snapshotted
//    in one pass (the sampled prefixes put five in the first), their
//    corrections one FMA chain. A cut on a multiple of 16 needs no
//    correction; a cut at p = S is snapshotted after the walk. The branch to
//    a snapshot is taken on a warp vote: a branch the compiler cannot prove
//    warp-uniform before a wgmma makes it serialize every wgmma of the
//    kernel (ptxas C7520). K7's base_j is the same acc + correction, so its
//    xhat is K2's bit for bit and bf16(base_j + (b_dec - x)) is K2's E_j: K2
//    adds (b_dec - x) to that f32 sum before it rounds.
//  - Whole-sector epilogue. A quad of lanes holds 8 consecutive columns of a
//    row as four pairs; two shuffle rounds hand each lane all 8 columns of
//    one of them. Then each lane reads x and b_dec as float4, and writes 16
//    bytes of E (two float4 of base or xhat): a store instruction covers 64
//    contiguous bytes of each of 8 rows (E) or 128 (f32), whole sectors.
//    The loss is one partial a CTA, summed in a fixed order by
//    matryoshka.cu's sum_partials_kernel: the same bits every run.

#include "prefix_walk.cuh"

// The fixed-order sum of per-CTA loss partials (matryoshka.cu; P2 shares it).
cudaError_t saev_sum_partials(const float* partials, int n, float* out, cudaStream_t stream);

namespace {

using namespace hopper;

enum class Mode {
  kErr,       // K2: E_j = bf16(acc + b_dec - x), loss partials
  kBaseF32,   // K7: base_j = acc (f32)
  kBaseBf16,  // K7: base_j = bf16(acc)
};

// Thread 0 fills stage kt % STAGES with K step kt once the warps have
// released that stage's previous fill: f's 128 rows (one box) and W's 128
// columns (two boxes), 64 lanes deep.
__device__ __forceinline__ void load_stage(int kt, uint32_t ring, uint64_t* full, uint64_t* empty,
                                           const CUtensorMap* map_f, const CUtensorMap* map_w,
                                           int b0, int n0) {
  const int s = kt % STAGES;
  const uint32_t a_dst = ring + s * STAGE_BYTES, b_dst = a_dst + TILE_BYTES;
  const uint32_t bar = smem_u32(&full[s]);
  mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
  // The warps' reads of the stage (the snapshots' corrections) come before
  // the copy's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load_2d(a_dst, map_f, bar, kt * TK, b0);
  tma_load_2d(b_dst, map_w, bar, n0, kt * TK);
  tma_load_2d(b_dst + HALF_BYTES, map_w, bar, n0 + 64, kt * TK);
}

// CTA (d tile blockIdx.x, row tile blockIdx.y) walks K = S. Maps: map_f over
// f as (S, B), box (64, 128); map_w over W as (D, S), box (64, 64). `out` is
// E (bf16) or base (f32 or bf16), (J, B, D). Dynamic shared memory: the ring
// (SMEM_BYTES), then the cuts sorted by p (cut_p, then cut_j: 8 J bytes).
template <Mode MODE>
__global__ void __launch_bounds__(FWD_THREADS, 2)
    prefix_wgmma_kernel(const __grid_constant__ CUtensorMap map_f,
                        const __grid_constant__ CUtensorMap map_w, const float* x,
                        const float* bdec, const float* __restrict__ inv_upper,
                        const int* __restrict__ m, const int* __restrict__ r, int J, int B, int S,
                        int D, int g, void* __restrict__ out, float* __restrict__ xhat,
                        float* __restrict__ partials) {
  constexpr Store kCut =
      MODE == Mode::kErr ? Store::kE : (MODE == Mode::kBaseF32 ? Store::kF32 : Store::kBf16);
  constexpr int kOutBytes = kCut == Store::kF32 ? 4 : 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float red[CONSUMER_WARPS];
  int* cut_p = reinterpret_cast<int*>(smem_raw + SMEM_BYTES);

  const int n0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_k = S / TK;

  // Cuts in ascending order of p (stable in j), so one K walk meets them all.
  sort_cuts(m, r, J, g, cut_p, cut_p + J);
  if (threadIdx.x == 0) {
    init_ring(full, empty);
    for (int kt = 0; kt < STAGES - 1 && kt < n_k; ++kt)
      load_stage(kt, ring, full, empty, &map_f, &map_w, b0, n0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int row_l = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // the thread's first row
  const long slice_bytes = (long)B * D * kOutBytes;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float lsum = 0.f;
  int ci = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    // The stage the previous K step used takes K step kt + STAGES - 1.
    if (threadIdx.x == 0 && kt + STAGES - 1 < n_k)
      load_stage(kt + STAGES - 1, ring, full, empty, &map_f, &map_w, b0, n0);
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t stage = ring + s * STAGE_BYTES;
    const uint64_t da = kmajor_desc(stage + wg * HALF_BYTES);
    const uint64_t db = mnmajor_desc(stage + TILE_BYTES);
    const int k0 = kt * TK;
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      // The cuts inside k16 step kk: wait for the steps below, snapshot.
      // The vote makes the branch warp-uniform to the compiler, which
      // otherwise serializes every wgmma of the kernel.
      const int k_end = k0 + 16 * (kk + 1);
      if (__any_sync(0xffffffffu, ci < J && cut_p[ci] < k_end)) {
        wgmma_commit();
        wgmma_wait_all();
        int c1 = ci + 1;
        while (c1 < J && cut_p[c1] < k_end) ++c1;
        // cut_j's address is formed here, not held through the walk.
        snapshots<kCut>(acc, stage, k0, 16 * kk, cut_p, cut_p + opaque(J), ci, c1, row_l, b0, n0, D, out,
                        slice_bytes, x, bdec, MODE == Mode::kErr ? *inv_upper : 0.f, lsum, lane);
        ci = c1;
      }
      wgmma_fence();
      wgmma_m64n128k16<0, 1>(acc, da + 2 * kk, db + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }
  // Cuts at p_j = S (the full decode): the snapshot is the whole product.
  if (ci < J)
    snapshots<kCut>(acc, 0, S, 0, cut_p, cut_p + J, ci, J, row_l, b0, n0, D, out, slice_bytes, x,
                    bdec, MODE == Mode::kErr ? *inv_upper : 0.f, lsum, lane);
  snapshots<Store::kF32>(acc, 0, 0, 0, nullptr, nullptr, 0, 1, row_l, b0, n0, D, xhat, 0, nullptr,
                         nullptr, 0.f, lsum, lane);

  if constexpr (MODE == Mode::kErr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) red[warp] = lsum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < CONSUMER_WARPS; ++w) sum += red[w];
      partials[blockIdx.y * gridDim.x + blockIdx.x] = sum;
    }
  }
}

bool shapes_ok(int J, int B, int S, int D, int g) {
  return J > 0 && J <= MAX_CUTS && B > 0 && B % TILE == 0 && D > 0 && D % TILE == 0 && g > 0 &&
         g % TILE == 0 && S % g == 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <Mode MODE>
cudaError_t launch(const __nv_bfloat16* f, const __nv_bfloat16* w, const float* x,
                   const float* bdec, const float* inv_upper, const int* m, const int* r, int J,
                   int B, int S, int D, int g, void* out, float* xhat, float* partials,
                   cudaStream_t stream) {
  CUtensorMap mf, mw;
  const cuuint64_t f_dims[2] = {(cuuint64_t)S, (cuuint64_t)B}, f_strides[1] = {(cuuint64_t)S * 2};
  const cuuint32_t f_box[2] = {TK, TILE};
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)S}, w_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t w_box[2] = {64, TK};
  if (!make_map(&mf, f, 2, f_dims, f_strides, f_box) ||
      !make_map(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const int smem = SMEM_BYTES + 8 * J;
  const cudaError_t err = cudaFuncSetAttribute(
      prefix_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  prefix_wgmma_kernel<MODE><<<dim3(D / TILE, B / TILE), FWD_THREADS, smem, stream>>>(
      mf, mw, x, bdec, inv_upper, m, r, J, B, S, D, g, out, xhat, partials);
  return cudaGetLastError();
}

template <Mode MODE>
int occupancy() {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(prefix_wgmma_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, prefix_wgmma_kernel<MODE>,
                                                        FWD_THREADS, SMEM_BYTES);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// K2. partials holds (B / 128) * (D / 128) floats. x and b_dec are read as
// float4: 16-byte aligned.
extern "C" int saev_prefix_err(const __nv_bfloat16* f, const __nv_bfloat16* w,
                               const float* x, const float* bdec, const float* inv_upper,
                               const int* m, const int* r, int J, int B, int S, int D,
                               int g, __nv_bfloat16* e, float* xhat, float* partials,
                               float* loss_sum, cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(bdec)) return cudaErrorMisalignedAddress;
  const cudaError_t err = launch<Mode::kErr>(f, w, x, bdec, inv_upper, m, r, J, B, S, D, g, e,
                                             xhat, partials, stream);
  if (err != cudaSuccess) return err;
  return saev_sum_partials(partials, (B / TILE) * (D / TILE), loss_sum, stream);
}

// K7: base (J, B, D) in bf16 (base_bf16) or f32.
extern "C" int saev_prefix_base(const __nv_bfloat16* f, const __nv_bfloat16* w,
                                const int* m, const int* r, int J, int B, int S, int D,
                                int g, int base_bf16, void* base, float* xhat,
                                cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  return base_bf16 ? launch<Mode::kBaseBf16>(f, w, nullptr, nullptr, nullptr, m, r, J, B, S, D,
                                             g, base, xhat, nullptr, stream)
                   : launch<Mode::kBaseF32>(f, w, nullptr, nullptr, nullptr, m, r, J, B, S, D, g,
                                            base, xhat, nullptr, stream);
}

// The resident CTAs an SM of K2's product (mode 0) or K7's (1: f32 base,
// 2: bf16 base) at its block size and shared memory; negative on an error.
extern "C" int saev_prefix_occupancy(int mode) {
  return mode == 0 ? occupancy<Mode::kErr>()
                   : (mode == 1 ? occupancy<Mode::kBaseF32>() : occupancy<Mode::kBaseBf16>());
}
