// The Hopper building blocks of K2 and K7 (prefix_fwd.cu), P2
// (prefix_gouter.cu), K3 (dgrad.cu) and K4 (wgrad.cu): mbarriers, TMA loads
// (P2's multicast across a cluster), wgmma shared-memory descriptors, the
// m64n128k16 product, the sorted prefix cuts, and tensor maps encoded
// without a link against libcuda; K1 (topk_stats.cu) streams its rows with
// `bulk_load`; P1 (encode_stats.cu) runs the mainloop with one warpgroup of
// 64 rows a CTA.
//
// The kernels run one mainloop: a 128 x 128 f32 output tile a CTA, one TMA
// producer warp filling a ring of STAGES stages of 32 KB (two 16 KB operand
// tiles, 64 deep in K, 128-byte swizzled), and two consumer warpgroups that
// each own 64 rows of the tile and run wgmma m64n128k16 on every stage.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int TILE = 128;  // rows and columns of a CTA's output tile
constexpr int TK = 64;     // K step: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int TILE_BYTES = TILE * TK * 2;  // one operand of one stage, 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;  // 64 x 64 bf16, one TMA box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // and one producer warp
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
constexpr int NACC = 64;  // f32 accumulators a thread: 64 x 128 over 128 threads
// Prefix cuts a call takes: K2's, K7's, P2's and K3's cut tables live in
// dynamic shared memory beside the ring, 8 bytes a cut (64 KB at most).
constexpr int MAX_CUTS = 8192;

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

// One contiguous copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, counted on `bar`'s transactions.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread 0 sets up the ring's barriers: a full barrier a stage completed by
// the producer's one arrival and the TMA bytes, an empty barrier a stage
// completed by one arrival of each consumer warp. The caller syncs after.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(smem_u32(&full[s]), 1);
    mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// --- thread block clusters (P2, prefix_gouter.cu; K1's wide route, kth_wide.cu) ---

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// The 32-bit word at shared address `addr` of CTA `cta` of the cluster (the
// same offset as in this CTA), read through distributed shared memory.
__device__ __forceinline__ uint32_t dsmem_ld(uint32_t addr, uint32_t cta) {
  uint32_t v;
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %1, %2;\n"
      " ld.shared::cluster.u32 %0, [remote];\n}\n"
      : "=r"(v)
      : "r"(addr), "r"(cta)
      : "memory");
  return v;
}
// Every thread of every CTA of the cluster; also a barrier of the CTA.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// cluster_sync that orders shared memory alone: each thread's writes to its
// CTA's shared memory before it against the cluster's reads after it. The
// full barrier's release also waits for this CTA's global stores and bulk
// copies in flight, which K1's wide route has at every row
// (scripts/select_probe.py `k1_wide_variants` times both). Needs PTX ISA
// 8.6 (CUDA 12.8).
__device__ __forceinline__ void cluster_sync_shared() {
  asm volatile(
      "fence.release.sync_restrict::shared::cta.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n"
      "fence.acquire.sync_restrict::shared::cluster.cluster;\n" ::: "memory");
}
// One arrival on the mbarrier at shared address `bar` of CTA `cta` of the
// cluster (the same offset as in this CTA), with the default (CTA-scope)
// release, as CUTLASS's ClusterBarrier::arrive does: P2 with a
// cluster-scope release ran slower than K2 on the card.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// A 2-D TMA load into the shared address `dst` of every CTA of the cluster
// in `cta_mask`, each counting the bytes it receives on its own mbarrier at
// `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                      int c0, int c1, uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(cta_mask)
      : "memory");
}

// --- prefix cuts -------------------------------------------------------------------

// The J cuts p_j = m_j * g + r_j in ascending order of p, stable in j, into
// cut_p and cut_j (shared memory), so one K walk meets them all: every
// thread of the CTA ranks its share of the cuts. The caller syncs after.
__device__ __forceinline__ void sort_cuts(const int* __restrict__ m, const int* __restrict__ r, int J, int g,
                                          int* cut_p, int* cut_j) {
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int p = m[j] * g + r[j];
    int q = 0;
    for (int i = 0; i < J; ++i) {
      const int pi = m[i] * g + r[i];
      q += pi < p || (pi == p && i < j);
    }
    cut_p[q] = p;
    cut_j[q] = j;
  }
}

// --- wgmma ------------------------------------------------------------------------

// Shared-memory descriptor of a bf16 tile written by TMA with the 128-byte
// swizzle, starting on a 1 KB boundary: address >> 4 in bits 0-13, the
// leading offset in bits 16-29 and the stride offset in bits 32-45 (both in
// 16-byte units), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}

// K-major (K contiguous, rows of 128 bytes): 8-row groups 1024 bytes apart
// (the stride offset), the leading offset unused (encoded 1). A K offset of
// 16 elements inside the 128-byte row adds 32 bytes (2 in the encoded
// address).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major (M or N contiguous): each TMA box is 64 K rows of 128 bytes (64
// elements of M or N), so 8-row groups along K lie 1024 bytes apart (the
// stride offset) and the next 64 elements along M or N lie one box, 8 KB,
// further (the leading offset). A K offset of 16 rows adds 16 x 128 bytes =
// 2 KB (128 in the encoded address). The canonical layout of CuTe's
// make_gmma_desc<GMMA::Major::MN> for the 128-byte swizzle.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, HALF_BYTES, 1024);
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
// Wait for every committed group but the latest (P1's walk keeps one in
// flight).
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pin the accumulators in place around the asynchronous product, so that
// the compiler moves no read or write of them across the fence or the wait.
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), bf16 in shared memory,
// A K-major (TRANS_A 0) or M-major (1), B K-major (TRANS_B 0) or N-major (1).
// Fragment: warp w of the warpgroup holds rows 16w + lane/4 (d[4i],
// d[4i+1]) and 16w + lane/4 + 8 (d[4i+2], d[4i+3]) of columns
// 8i + 2*(lane%4) + {0, 1}.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[NACC], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// --- tensor maps ------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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
inline bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
