// K3: the grouped Matryoshka dgrad for Hopper. One call is two launches: the
// dA build, then df by wgmma fed through TMA.
//
// Replaces saev_tpu/ops/pallas_matryoshka.py `_dgrad_kernel`
// (`grouped_matmul_dgrad`).
//
// Notation as in matryoshka.cu: W (S, D) decoder rows, E_j (B, D) the
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXJ = 64;
constexpr int TM = 128;  // rows of B a CTA
constexpr int TN = 128;  // latents a CTA
constexpr int TK = 64;   // K step: one 128-byte swizzled bf16 row a TMA box
constexpr int STAGES = 3;
constexpr int TILE_BYTES = TM * TK * 2;  // one operand of one stage, 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // and one producer warp
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
constexpr int NACC = 64;  // f32 accumulators a thread: 64 x 128 over 128 threads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of the given parity has completed. A wait that never
// ends (a copy that never lands) traps after 2^26 tries, so the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------------

// Shared-memory descriptor of a K-major bf16 tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset), the leading offset unused (encoded 1). The tile starts on
// a 1 KB boundary; a K offset of 16 elements inside the 128-byte row adds 32
// bytes (2 in the encoded address).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulators in place around the asynchronous product, so that
// the compiler moves no read or write of them across the fence or the wait.
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), both K-major bf16 in
// shared memory. Fragment: warp w of the warpgroup holds rows 16w + lane/4
// (d[4i], d[4i+1]) and 16w + lane/4 + 8 (d[4i+2], d[4i+3]) of columns
// 8i + 2*(lane%4) + {0, 1}.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[NACC], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

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
  __shared__ int ms[MAXJ];
  if (threadIdx.x < J) ms[threadIdx.x] = m[threadIdx.x];
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
template <typename Out>
__global__ void __launch_bounds__(THREADS, 2)
    dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_e,
                       const __grid_constant__ CUtensorMap map_da, const int* __restrict__ m,
                       const int* __restrict__ r, const float* __restrict__ scale, int J, int S,
                       int D, int g, Out* __restrict__ df) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int rem_j[MAXJ], rem_r[MAXJ];
  __shared__ int n_rem_s, any_main_s;

  const int n0 = blockIdx.x * TN, b0 = blockIdx.y * TM, G = blockIdx.z;
  const int w_row = G * g + n0;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  if (threadIdx.x == 0) {
    // The cuts of this group whose remainder reaches this tile, by ascending
    // r (stable in j); and whether any cut lies above the group (dA_G != 0).
    int n = 0, main = 0;
    for (int j = 0; j < J; ++j) {
      const int mj = m[j], rj = r[j];
      main |= mj > G;
      if (mj == G && rj > n0) {
        int q = n++;
        while (q > 0 && rem_r[q - 1] > rj) {
          rem_r[q] = rem_r[q - 1];
          rem_j[q] = rem_j[q - 1];
          --q;
        }
        rem_r[q] = rj;
        rem_j[q] = j;
      }
    }
    n_rem_s = n;
    any_main_s = main;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      const uint64_t da = sw128_desc(ring + s * STAGE_BYTES + wg * (TILE_BYTES / 2));
      const uint64_t db = sw128_desc(ring + s * STAGE_BYTES + TILE_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
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

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 map of `rank` dims (innermost first; byte strides of dims 1..) with
// the 128-byte swizzle, which the box's 64-element inner extent fills.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Out>
cudaError_t launch_dgrad(dim3 grid, const CUtensorMap& mw, const CUtensorMap& me,
                         const CUtensorMap& mda, const int* m, const int* r, const float* scale,
                         int J, int S, int D, int g, void* df, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dgrad_wgmma_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dgrad_wgmma_kernel<Out><<<grid, THREADS, SMEM_BYTES, stream>>>(
      mw, me, mda, m, r, scale, J, S, D, g, static_cast<Out*>(df));
  return cudaGetLastError();
}

}  // namespace

// df (B, S) in bf16 (df_bf16) or f32, dA (B, S / g, D) bf16. The shapes
// matryoshka.cu's kernels take: B, D and g multiples of 128, g dividing S,
// 1 <= J <= 64.
extern "C" int saev_dgrad(const __nv_bfloat16* w, const __nv_bfloat16* e, const int* m,
                          const int* r, const float* scale, int J, int B, int S, int D,
                          int g, int df_bf16, void* df, __nv_bfloat16* da,
                          cudaStream_t stream) {
  if (!(J > 0 && J <= MAXJ && B > 0 && B % TM == 0 && D > 0 && D % 128 == 0 && g > 0 &&
        g % TN == 0 && S % g == 0))
    return cudaErrorInvalidValue;
  const int n_groups = S / g;
  const long n_vec = (long)B * D / 8;
  build_da_vec_kernel<<<(unsigned)((n_vec + 255) / 256), 256, 0, stream>>>(e, m, scale, J, B, D,
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
