// K2 and K7 for Hopper: the grouped Matryoshka prefix-MSE forward products
// (error, base) on wgmma fed through TMA.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_err_kernel`
// (`grouped_prefix_err`) and `_base_kernel` (`grouped_prefix_base`).
//
// Notation as in matryoshka.cu: f (B, S) latents, W (S, D) decoder rows, x
// (B, D) targets, J prefix cuts p_j = m_j * g + r_j with groups of g latents.
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

#include "hopper.cuh"

// The fixed-order sum of per-CTA loss partials (matryoshka.cu; P2 shares it).
cudaError_t saev_sum_partials(const float* partials, int n, float* out, cudaStream_t stream);

namespace {

using namespace hopper;

constexpr int MAXJ = 64;
constexpr int STEPS = TK / 16;  // k16 steps of wgmma a stage

enum class Mode {
  kErr,       // K2: E_j = bf16(acc + b_dec - x), loss partials
  kBaseF32,   // K7: base_j = acc (f32)
  kBaseBf16,  // K7: base_j = bf16(acc)
};
enum class Store { kE, kF32, kBf16 };

// a[i] is the pair of columns 2 * (lane % 4) + {0, 1} of column group i of a
// row; afterwards a[c] is the pair 2c + {0, 1} of column group lane % 4, so
// the lane holds all 8 columns of that group in order. Two butterfly
// rounds: across lane bit 0, then bit 1.
__device__ __forceinline__ void quad_transpose(float2 (&a)[4], int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 send = b0 ? a[2 * i] : a[2 * i + 1];
    const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                   __shfl_xor_sync(0xffffffffu, send.y, 1));
    if (b0)
      a[2 * i] = got;
    else
      a[2 * i + 1] = got;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float2 send = b1 ? a[c] : a[2 + c];
    const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 2),
                                   __shfl_xor_sync(0xffffffffu, send.y, 2));
    if (b1)
      a[c] = got;
    else
      a[2 + c] = got;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 values from shared memory (32-bit addresses), as f32.
__device__ __forceinline__ float lds_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float2 lds_bf16x2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}

// The loss terms (f32(e) * inv_upper)^2 of a packed pair of bf16 errors.
__device__ __forceinline__ float loss_terms(uint32_t word, float iu) {
  const float e0 = __uint_as_float(word << 16) * iu, e1 = __uint_as_float(word & 0xFFFF0000u) * iu;
  return e0 * e0 + e1 * e1;
}

// v, opaque to the compiler: values derived from it are computed where it
// is used, not once before the K walk and held in registers through it.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(v));
  return v;
}

// The snapshots of the cuts c0 .. c1 - 1 (sorted by p) of one 16-lane step:
// the thread's accumulator rows row_l and row_l + 8 of the tile, plus, for
// each cut, the correction over lanes [k_lo, p_c - k0) of the stage at
// shared address `stage`. The correction is one FMA chain from k_lo, so
// each cut's sum continues the previous one's: the same bits as a chain of
// its own. Each snapshot goes to out + j_c * slice_bytes (E_j, base_j; xhat
// with cut_j null), rows b0 + row, columns n0 + col, leading dimension D.
// kE adds (b_dec - x), read once for all the cuts, before it rounds, and
// adds the loss terms to lsum. With cut_p null, one snapshot of acc alone.
//
// Stage layout (128-byte swizzle: the 16-byte chunk c of a 128-byte row r
// lies at chunk c ^ (r % 8)): f rows of 64 lanes at stage + row * 128; W as
// two boxes of 64 lanes x 64 columns at stage + 16 KB + (col / 64) * 8 KB +
// lane * 128.
template <Store ST>
__device__ __forceinline__ void snapshots(const float (&acc)[NACC], uint32_t stage, int k0,
                                          int k_lo, const int* cut_p, const int* cut_j, int c0,
                                          int c1, int row_l, int b0, int n0, int D, void* out,
                                          long slice_bytes, const float* x, const float* bdec,
                                          float iu, float& lsum, int lane) {
  row_l = opaque(row_l);
  b0 = opaque(b0);
  n0 = opaque(n0);
  D = opaque(D);
  lane = opaque(lane);
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = row_l + 8 * h;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = n0 + 8 * (4 * t + q);  // the 8 columns this lane stores
      const long at = (long)(b0 + rl) * D + col;
      float bx[8];
      if constexpr (ST == Store::kE) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 xv = reinterpret_cast<const float4*>(x + at)[half];
          const float4 bv = reinterpret_cast<const float4*>(bdec + col)[half];
          bx[4 * half] = __fsub_rn(bv.x, xv.x);
          bx[4 * half + 1] = __fsub_rn(bv.y, xv.y);
          bx[4 * half + 2] = __fsub_rn(bv.z, xv.z);
          bx[4 * half + 3] = __fsub_rn(bv.w, xv.w);
        }
      }
      float2 c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = make_float2(0.f, 0.f);
      int k = k_lo;
      for (int ci = c0; ci < c1; ++ci) {
        const int k_hi = cut_p == nullptr ? k_lo : cut_p[ci] - k0;
#pragma unroll 1
        for (; k < k_hi; ++k) {  // at most 15 lanes, loads not hoisted
          const float fk =
              lds_bf16(stage + rl * 128 + ((((k >> 3) ^ rl) & 7) << 4) + (k & 7) * 2);
          const uint32_t w_row = stage + TILE_BYTES + k * 128 + 4 * q;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int grp = 4 * t + i;  // 8-column group of the tile
            const float2 w = lds_bf16x2(w_row + (grp >> 3) * HALF_BYTES + (((grp ^ k) & 7) << 4));
            c[i].x = __fmaf_rn(fk, w.x, c[i].x);
            c[i].y = __fmaf_rn(fk, w.y, c[i].y);
          }
        }
        float2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = 4 * (4 * t + i) + 2 * h;
          v[i] = k > k_lo ? make_float2(__fadd_rn(acc[a], c[i].x), __fadd_rn(acc[a + 1], c[i].y))
                          : make_float2(acc[a], acc[a + 1]);
        }
        quad_transpose(v, lane);
        uint8_t* o = static_cast<uint8_t*>(out) + (cut_j == nullptr ? 0 : cut_j[ci] * slice_bytes);
        if constexpr (ST == Store::kE) {
          const uint4 pk = make_uint4(pack_bf16(__fadd_rn(v[0].x, bx[0]), __fadd_rn(v[0].y, bx[1])),
                                      pack_bf16(__fadd_rn(v[1].x, bx[2]), __fadd_rn(v[1].y, bx[3])),
                                      pack_bf16(__fadd_rn(v[2].x, bx[4]), __fadd_rn(v[2].y, bx[5])),
                                      pack_bf16(__fadd_rn(v[3].x, bx[6]), __fadd_rn(v[3].y, bx[7])));
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(o) + at) = pk;
          lsum += loss_terms(pk.x, iu);
          lsum += loss_terms(pk.y, iu);
          lsum += loss_terms(pk.z, iu);
          lsum += loss_terms(pk.w, iu);
        } else if constexpr (ST == Store::kF32) {
          float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(o) + at);
          dst[0] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
          dst[1] = make_float4(v[2].x, v[2].y, v[3].x, v[3].y);
        } else {
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(o) + at) =
              make_uint4(pack_bf16(v[0].x, v[0].y), pack_bf16(v[1].x, v[1].y),
                         pack_bf16(v[2].x, v[2].y), pack_bf16(v[3].x, v[3].y));
        }
      }
    }
  }
}

constexpr int FWD_THREADS = 32 * CONSUMER_WARPS;  // two warpgroups, no producer warp

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
// E (bf16) or base (f32 or bf16), (J, B, D).
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
  __shared__ int cut_p[MAXJ], cut_j[MAXJ];
  __shared__ float red[CONSUMER_WARPS];

  const int n0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_k = S / TK;

  if (threadIdx.x == 0) {
    // Cuts in ascending order of p (stable in j), so one K walk meets them all.
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
        snapshots<kCut>(acc, stage, k0, 16 * kk, cut_p, cut_j, ci, c1, row_l, b0, n0, D, out,
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
    snapshots<kCut>(acc, 0, S, 0, cut_p, cut_j, ci, J, row_l, b0, n0, D, out, slice_bytes, x,
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
  return J > 0 && J <= MAXJ && B > 0 && B % TILE == 0 && D > 0 && D % TILE == 0 && g > 0 &&
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
  const cudaError_t err = cudaFuncSetAttribute(
      prefix_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  prefix_wgmma_kernel<MODE><<<dim3(D / TILE, B / TILE), FWD_THREADS, SMEM_BYTES, stream>>>(
      mf, mw, x, bdec, inv_upper, m, r, J, B, S, D, g, out, xhat, partials);
  return cudaGetLastError();
}

template <Mode MODE>
int occupancy() {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(prefix_wgmma_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, prefix_wgmma_kernel<MODE>, FWD_THREADS,
                                                        SMEM_BYTES);
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
