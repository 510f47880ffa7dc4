// P1 for Hopper: the encoder product fused with K1's TopK statistics, on
// wgmma fed through TMA, with the row select in the product's epilogue.
//
// Replaces scripts/proto_encode_stats.py `_kernel` (via
// `encode_stats_pallas`): h = bf16(x) @ W_enc + b_enc with bf16 operands
// (x rounded to nearest even) and f32 accumulation, the bias added in f32,
// then K1's statistics of that same h: kth, f = bf16(where(h >= kth, h, 0))
// (ties kept), live, L0 = count(h >= kth and h != 0) and L1 = sum |f32 f|.
// h is an output too.
//
// What bounds it on the card (B = S = 16384, D = 1024): the product's
// tensor-core work, 2 B D S = 0.55 TFLOP, 0.556 ms at 989 TFLOP/s. The
// bytes it must move are h written once (1 GiB), f written once (0.5 GiB),
// x and W read (64 and 32 MB): 0.48 ms at 3.35 TB/s, under the product. A
// design that writes h and reads it back for the select adds 1 GiB, a byte
// floor of 0.80 ms; this one never reads h back, save for the rare rows
// named below.
//
// What the design does about it:
//  - A first launch rounds x to bf16 into the caller's scratch (B, D), so
//    TMA can feed the product.
//  - One CTA owns 64 rows and walks every 128-column tile of W in turn, so a
//    row's select state lives on one SM; two CTAs share an SM, so one's
//    epilogue, select and stores run while the other's product does. The
//    mainloop is K2's (prefix_fwd.cu, helpers of hopper.cuh and
//    prefix_walk.cuh) for one warpgroup: a 3-stage ring of 24 KB stages
//    (128-byte swizzle), x K-major (one 64 x 64 box a stage) and W MN-major
//    (two 64 x 64 boxes), wgmma m64n128k16 with one group kept in flight,
//    and thread 0 issuing each stage's loads two steps ahead on one flat
//    sequence of (column tile, K step), so the next tile's first stages
//    land while this tile's epilogue runs. h and f are stored streaming
//    (evict-first in L2). D need not be a multiple of 64: TMA fills the
//    last stage's lanes past D with zeros.
//  - The select in the epilogue, with no read-back. While a tile's product
//    runs, the CTA writes that tile of f as bf16 zeros. After it, the quad
//    of lanes that holds a row (two rows a quad) adds b_enc, writes h from
//    the accumulator's fragment (a lane's pair of columns beside its quad's,
//    a whole 32-byte sector a row) and forms each value's order key
//    (order_key.cuh).
//    Each row keeps a lower bound L and a candidate buffer in shared memory
//    (kCap keys and their columns): the buffer holds exactly the keys seen
//    so far that are >= L (with -0.0 beside an L of +0.0, as `keep_from` in
//    topk_row.cuh), appended in a fixed order (lane, then column) by a scan
//    over the quad. L is the k-th largest key seen at the last prune: any k
//    keys of the row bound its k-th largest from below, so L only rises and
//    every key >= the final kth is kept. When a tile's keys >= L would take
//    a row's buffer past kCap (the high-water mark is the cap itself), the
//    warp prunes all 16 of its rows (the branch on a warp vote, so ptxas
//    sees it uniform): the quad bisects the k-th largest key of the buffer
//    and the tile's keys (`quad_bisect`, both rows of every quad in one
//    loop, counts in four independent sums) down to bit kPruneBit, a lower
//    bound of it, as the new L, and on to bit 0 for a row whose keys >= the
//    cut bound would still pass the cap; it compacts the buffer in place in
//    index order to the keys >= L, then appends the tile's.
//  - After the last tile, each row's kth is the k-th largest of its buffer
//    (the same bisection); after a block barrier (the zeros of f come
//    first) the quad scatters the kept entries into f, sets live with
//    atomicOr and sums L0 and L1 in a fixed order.
//  - An exact route picked by the data. A row whose buffer cannot hold the
//    keys >= its pruned L (ties at L past kCap: a zero row, a row tied at
//    its top), and every row when k > kCap, is flagged; after the walk, and
//    a fence and barrier, the CTA runs K1's row routine (topk_row.cuh, VPT
//    keys a thread over 128 threads) on each flagged row's h read back from
//    device memory, and adds the rows to `exact` when it is not null. Both
//    routes are this kernel's; the plain version never runs on the card.
// Every output is the same bits in every run: the product's sums have a
// fixed order, the select is exact, live is an atomicOr, and L1 is summed
// in a fixed order (each lane's entries in index order, then the quad's
// xor tree). Shared memory a CTA: the ring (73 KB) and the buffers (38 KB);
// 256 CTAs of 128 threads at B = 16384, two an SM on 132 SMs. The flagged
// rows' K1 routine reuses the ring's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefix_walk.cuh"
#include "topk_row.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                          // rows a CTA owns: one warpgroup's wgmma tile
constexpr int kThreads = 128;                      // that warpgroup; its thread 0 also issues the loads
constexpr int kWarps = kThreads / 32;
constexpr int A_BYTES = kRows * TK * 2;            // x's rows of a stage, one 64 x 64 box (8 KB)
constexpr int kStageBytes = A_BYTES + TILE_BYTES;  // and W's 128 columns, two boxes (24 KB)
constexpr int RING_BYTES = STAGES * kStageBytes + 1024;  // + slack to align the ring to 1 KB
constexpr int kCap = 96;              // candidate keys a row's buffer holds
constexpr int kPruneBit = 16;         // a prune's bound keeps its bits from 31 down to this one, where that fits
constexpr int kKeyStride = kCap + 4;  // u32 a row's keys take: the 8 rows of a warp's access on distinct banks
constexpr int kColStride = kCap + 8;  // u16 a row's columns take
constexpr int kShare = kCap / 4;      // buffer entries a lane of the quad holds: j = 4 i + lane % 4
constexpr int kKeys = 32;             // keys of a row a lane holds after a tile: 16 pairs of columns
constexpr int BUF_BYTES = kRows * kKeyStride * 4 + kRows * kColStride * 2;
constexpr int DYN_SMEM = RING_BYTES + BUF_BYTES;
constexpr unsigned FULL = 0xffffffffu;
static_assert(kCap % 4 == 0, "a lane of the quad holds a whole share of the buffer");
// The SM's 228 KB hold two CTAs: each one's dynamic shared memory, its
// barriers and flags, and the 1 KB the card reserves a CTA.
static_assert(2 * (DYN_SMEM + 1024 + 1024) <= 228 * 1024, "two CTAs an SM");

// x (n4 float4) to bf16, rounded to nearest even.
__global__ void encode_round_kernel(const float4* __restrict__ x, uint2* __restrict__ xb, long n4) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4; i += (long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    xb[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// Thread 0 fills stage g % STAGES with step g of the walk (column tile
// g / n_k, K step g % n_k) once the warps have released that stage's
// previous fill: x's 64 rows (one box) and W's 128 columns (two boxes), 64
// lanes deep.
__device__ __forceinline__ void load_step(int g, int n_k, uint32_t ring, uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* map_x, const CUtensorMap* map_w, int b0) {
  const int s = g % STAGES, k0 = (g % n_k) * TK, n0 = (g / n_k) * TILE;
  const uint32_t a_dst = ring + s * kStageBytes, b_dst = a_dst + A_BYTES;
  const uint32_t bar = smem_u32(&full[s]);
  mbar_wait(smem_u32(&empty[s]), ((g / STAGES) & 1) ^ 1);
  mbar_expect_tx(bar, kStageBytes);
  tma_load_2d(a_dst, map_x, bar, k0, b0);
  tma_load_2d(b_dst, map_w, bar, n0, k0);
  tma_load_2d(b_dst + HALF_BYTES, map_w, bar, n0 + 64, k0);
}

// The lowest key a row's buffer holds beside a bound L: L itself, or the key
// of -0.0 (0x7FFFFFFF) beside an L of +0.0 (0x80000000), since -0.0 >= +0.0
// as floats (topk_row.cuh's keep_from).
__device__ __forceinline__ uint32_t from_key(uint32_t lower) {
  return lower == 0x80000000u ? 0x7FFFFFFFu : lower;
}

__device__ __forceinline__ int quad_sum(int c) {
  c += __shfl_xor_sync(FULL, c, 1);
  return c + __shfl_xor_sync(FULL, c, 2);
}

// c += (a >= b): a compare and a predicated add (ptxas makes three
// instructions of the C form, kth_ops.cu's add_ge says).
__device__ __forceinline__ void add_ge(int& c, uint32_t a, uint32_t b) {
  asm("{\n .reg .pred p;\n setp.ge.u32 p, %1, %2;\n @p add.s32 %0, %0, 1;\n}" : "+r"(c) : "r"(a), "r"(b));
}

// The quad's two rows' buffer shares (entry j = 4 i + lane % 4 of row r,
// below n[r]) in registers, 0 past n[r].
__device__ __forceinline__ void quad_load(const uint32_t* keys, int row_l, const int (&n)[2], int q,
                                          uint32_t (&bk)[2][kShare]) {
  __syncwarp();  // the quad's appends come before these reads
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kShare; ++i)
      bk[r][i] = 4 * i + q < n[r] ? keys[(row_l + 8 * r) * kKeyStride + 4 * i + q] : 0u;
}

// Each row's count, over its quad, of its buffer share and, WITH_KEYS, its
// tile keys that are >= t[r]: four independent sums a lane.
template <bool WITH_KEYS>
__device__ __forceinline__ void quad_counts(const uint32_t (&bk)[2][kShare], const uint32_t (&key)[2][kKeys],
                                            const uint32_t (&t)[2], int (&c)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int a[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kShare; ++i) add_ge(a[i & 3], bk[r][i], t[r]);
    if constexpr (WITH_KEYS) {
#pragma unroll
      for (int e = 0; e < kKeys; ++e) add_ge(a[e & 3], key[r][e], t[r]);
    }
    c[r] = quad_sum((a[0] + a[1]) + (a[2] + a[3]));
  }
}

// Each row's bounds of its k-th largest key: lo, its L (0 for a row not
// held), and hi, the largest key of its buffer and, WITH_KEYS, tile (0 for
// a row not held); top[r] is the highest bit where they differ (-1 where
// they are equal) and cur[r] their common prefix, the bisection's start
// (order_key.cuh's `bisect`).
template <bool WITH_KEYS>
__device__ __forceinline__ void quad_bounds(const uint32_t (&bk)[2][kShare], const uint32_t (&key)[2][kKeys],
                                            const uint32_t (&lower)[2], const bool (&held)[2], int (&top)[2],
                                            uint32_t (&cur)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t hi = 0;
#pragma unroll
    for (int i = 0; i < kShare; ++i) hi = max(hi, bk[r][i]);
    if constexpr (WITH_KEYS) {
#pragma unroll
      for (int e = 0; e < kKeys; ++e) hi = max(hi, key[r][e]);
    }
    hi = max(hi, __shfl_xor_sync(FULL, hi, 1));
    hi = max(hi, __shfl_xor_sync(FULL, hi, 2));
    const uint32_t lo = held[r] ? lower[r] : 0u;
    hi = held[r] ? hi : 0u;
    top[r] = lo == hi ? -1 : 31 - __clz(lo ^ hi);
    cur[r] = top[r] < 0 ? lo : lo & ~((2u << top[r]) - 1u);
  }
}

// Bits b_start down to b_end of each active row's bisection (order_key.cuh's
// `bisect`; one row a quad, two a lane, every lane of the warp in step):
// cur[r] takes bit b, for b <= top[r], where count(cur[r] | bit b) >= k.
template <bool WITH_KEYS>
__device__ __forceinline__ void quad_bisect(const uint32_t (&bk)[2][kShare], const uint32_t (&key)[2][kKeys],
                                            const int (&top)[2], const bool (&active)[2], int k, int b_start,
                                            int b_end, uint32_t (&cur)[2]) {
#pragma unroll 1
  for (int b = b_start; b >= b_end; --b) {
    const uint32_t cand[2] = {cur[0] | (1u << b), cur[1] | (1u << b)};
    int c[2];
    quad_counts<WITH_KEYS>(bk, key, cand, c);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (active[r] && b <= top[r] && c[r] >= k) cur[r] = cand[r];
  }
}

// Keeps the buffer's entries >= from, in place and in index order (entry j
// moves to the count of kept entries below it, never above j, and every
// lane has read its entry of a group of four before any writes); returns
// the new count. Every lane of the warp calls it; rows not `held` keep
// nothing.
__device__ __forceinline__ int quad_compact(uint32_t* buf, uint16_t* cbuf, int n, uint32_t from, bool held,
                                            int lane) {
  const int q = lane & 3;
  int base = 0;
#pragma unroll 4
  for (int i = 0; i < kShare; ++i) {
    const int j = 4 * i + q;
    const bool in = held && j < n;
    const uint32_t kv = in ? buf[j] : 0u;
    const uint16_t cv = in ? cbuf[j] : 0;
    const bool keep = in && kv >= from;
    const unsigned mine = (__ballot_sync(FULL, keep) >> (lane & ~3)) & 0xFu;
    __syncwarp();
    if (keep) {
      const int pos = base + __popc(mine & ((1u << q) - 1u));
      buf[pos] = kv;
      cbuf[pos] = cv;
    }
    __syncwarp();
    base += __popc(mine);
  }
  return base;
}

// This lane's tile keys >= from, counted, and their place among the quad's
// (lanes in order): *excl the count of the lanes below, *total the quad's.
__device__ __forceinline__ void quad_scan(const uint32_t (&key)[kKeys], uint32_t from, bool held, int q,
                                          int* excl, int* total) {
  int c = 0;
#pragma unroll
  for (int e = 0; e < kKeys; ++e) c += key[e] >= from;
  c = held ? c : 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o, 4);
    if (q >= o) incl += v;
  }
  *excl = incl - c;
  *total = __shfl_sync(FULL, incl, 3, 4);
}

// Thread 0 sets up the ring's barriers: a full barrier a stage completed by
// the producer's one arrival and the TMA bytes, an empty barrier a stage by
// one arrival of each warp (hopper.cuh's init_ring, for one warpgroup).
__device__ __forceinline__ void init_ring_one_group(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(smem_u32(&full[s]), 1);
    mbar_init(smem_u32(&empty[s]), kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// CTA blockIdx.x owns rows b0 .. b0 + 63 and walks S / 128 column tiles.
// Maps: map_x over bf16 x as (D, B), box (64, 64); map_w over W as (S, D),
// box (64, 64). Dynamic shared memory: the ring (RING_BYTES), then the keys
// (64 rows x kKeyStride u32) and columns (64 x kColStride u16) of the rows'
// buffers.
template <int VPT>
__global__ void __launch_bounds__(kThreads, 2)
    encode_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                              const float* __restrict__ b_enc, int D, int S, int k, float* __restrict__ h,
                              float* __restrict__ kth_out, __nv_bfloat16* __restrict__ f, int* __restrict__ live,
                              float* __restrict__ l0_out, float* __restrict__ l1_out, int* __restrict__ exact) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int exact_row[kRows];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw + RING_BYTES);
  uint16_t* cols = reinterpret_cast<uint16_t*>(smem_raw + RING_BYTES + kRows * kKeyStride * 4);

  const int b0 = blockIdx.x * kRows;
  const int n_k = (D + TK - 1) / TK, n_tiles = S / TILE, n_steps = n_tiles * n_k;
  if (threadIdx.x == 0) {
    init_ring_one_group(full, empty);
    for (int g = 0; g < STAGES - 1 && g < n_steps; ++g)
      load_step(g, n_k, ring, full, empty, &map_x, &map_w, b0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int row_l = warp * 16 + (lane >> 2);  // the quad's rows: row_l and row_l + 8
  // Each row's state, the same in the four lanes of its quad: the bound L,
  // the buffer's count, and whether the row stays on the filter.
  uint32_t lower[2] = {0u, 0u};
  int n_buf[2] = {0, 0};
  bool held[2] = {k <= kCap, k <= kCap};
  float acc[NACC];
  uint32_t key[2][kKeys];

  for (int j = 0; j < n_tiles; ++j) {
    // The tile's K walk.
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int n0 = j * TILE;
    for (int kt = 0; kt < n_k; ++kt) {
      const int g = j * n_k + kt;
      const int s = g % STAGES;
      mbar_wait(smem_u32(&full[s]), (g / STAGES) & 1);
      const uint32_t stage = ring + s * kStageBytes;
      const uint64_t da = kmajor_desc(stage);
      const uint64_t db = mnmajor_desc(stage + A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) wgmma_m64n128k16<0, 1>(acc, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      // This step's share of the tile's zeros of f (8 16-byte stores a
      // thread a tile), written while the product runs.
      for (int e = kt; e < 8; e += n_k) {
        const int u = threadIdx.x + kThreads * e;
        __stcs(reinterpret_cast<uint4*>(f + (long)(b0 + (u >> 4)) * S + n0 + (u & 15) * 8), make_uint4(0u, 0u, 0u, 0u));
      }
      // One group stays in flight: the previous step's is done, and its
      // stage takes step g + STAGES - 1, which runs into the next column
      // tile (at a tile's first step the previous tile released it).
      wgmma_wait_one();
      if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(g - 1) % STAGES]));
      if (threadIdx.x == 0 && g + STAGES - 1 < n_steps)
        load_step(g + STAGES - 1, n_k, ring, full, empty, &map_x, &map_w, b0);
    }
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[(j * n_k + n_k - 1) % STAGES]));

    // The tile's epilogue: h written, the keys formed.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // The fragment's pair of columns 8 (4 t + i) + 2 q + {0, 1} of each
        // of the quad's rows: the quad stores a whole 32-byte sector a row.
        const int col = n0 + 8 * (4 * t + i) + 2 * q;
        const float2 bv = *reinterpret_cast<const float2*>(b_enc + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int a = 4 * (4 * t + i) + 2 * hh;
          const float o0 = __fadd_rn(acc[a], bv.x), o1 = __fadd_rn(acc[a + 1], bv.y);
          // Streamed: evicted from L2 first.
          __stcs(reinterpret_cast<float2*>(h + (long)(b0 + row_l + 8 * hh) * S + col), make_float2(o0, o1));
          key[hh][8 * t + 2 * i] = float_key(o0);
          key[hh][8 * t + 2 * i + 1] = float_key(o1);
        }
      }
    }

    // Append the keys >= L to each row's buffer, pruning first where that
    // would pass the cap.
    int excl[2], total[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) quad_scan(key[hh], from_key(lower[hh]), held[hh], q, &excl[hh], &total[hh]);
    const bool over = (held[0] && n_buf[0] + total[0] > kCap) || (held[1] && n_buf[1] + total[1] > kCap);
    if (__any_sync(FULL, over)) {
      // The new L: the k-th largest key of the buffer and the tile, its
      // bits below kPruneBit cleared (and no lower than L) where the keys
      // at or above that fit the cap, else all of its bits.
      uint32_t bk[2][kShare], cur[2], from[2];
      int top[2], c[2];
      quad_load(keys, row_l, n_buf, q, bk);
      quad_bounds<true>(bk, key, lower, held, top, cur);
      quad_bisect<true>(bk, key, top, held, k, __reduce_max_sync(FULL, max(top[0], top[1])), kPruneBit, cur);
      cur[0] = max(cur[0], lower[0]);  // the cut bound, never below the old one
      cur[1] = max(cur[1], lower[1]);
      from[0] = max(from_key(cur[0]), 1u);
      from[1] = max(from_key(cur[1]), 1u);
      quad_counts<true>(bk, key, from, c);
      const bool exact_bound[2] = {held[0] && c[0] > kCap, held[1] && c[1] > kCap};
      if (__any_sync(FULL, exact_bound[0] || exact_bound[1]))
        quad_bisect<true>(bk, key, top, exact_bound, k, kPruneBit - 1, 0, cur);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_l + 8 * hh;
        lower[hh] = held[hh] ? cur[hh] : lower[hh];
        n_buf[hh] = quad_compact(keys + r * kKeyStride, cols + r * kColStride, n_buf[hh], from_key(lower[hh]),
                                 held[hh], lane);
        quad_scan(key[hh], from_key(lower[hh]), held[hh], q, &excl[hh], &total[hh]);
        held[hh] = held[hh] && n_buf[hh] + total[hh] <= kCap;
      }
    }
    if (!__any_sync(FULL, total[0] + total[1] > 0)) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_l + 8 * hh;
      const uint32_t from = from_key(lower[hh]);
      int pos = n_buf[hh] + excl[hh];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t kv = key[hh][8 * t + e];
          if (held[hh] && kv >= from) {
            keys[r * kKeyStride + pos] = kv;
            cols[r * kColStride + pos] = static_cast<uint16_t>(n0 + 8 * (4 * t + (e >> 1)) + 2 * q + (e & 1));
            ++pos;
          }
        }
      if (held[hh]) n_buf[hh] += total[hh];
    }
  }

  // Each held row's kth: the k-th largest key of its buffer.
  uint32_t kth_key[2];
  {
    uint32_t bk[2][kShare];
    int top[2];
    quad_load(keys, row_l, n_buf, q, bk);
    quad_bounds<false>(bk, key, lower, held, top, kth_key);
    quad_bisect<false>(bk, key, top, held, k, __reduce_max_sync(FULL, max(top[0], top[1])), 0, kth_key);
  }
  if (q == 0) {
    exact_row[row_l] = !held[0];
    exact_row[row_l + 8] = !held[1];
  }
  __syncthreads();  // the tiles' zeros of f land before the kept values
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row_l + 8 * hh;
    const long row = b0 + r;
    const uint32_t keep_from = from_key(kth_key[hh]);
    const float kth = key_float(kth_key[hh]);
    float l1 = 0.f;
    int l0 = 0;
    for (int i = 0; i < kShare; ++i) {
      const int jj = 4 * i + q;
      if (held[hh] && jj < n_buf[hh]) {
        const uint32_t kv = keys[r * kKeyStride + jj];
        if (kv >= keep_from) {
          const float x = key_float(kv);
          if (x >= kth) {
            const int c = cols[r * kColStride + jj];
            const __nv_bfloat16 fb = __float2bfloat16_rn(x);
            f[row * S + c] = fb;
            if (__bfloat16_as_ushort(fb) & 0x7FFFu) atomicOr(live + c, 1);
            l0 += x != 0.f;
            l1 += fabsf(x);
          }
        }
      }
    }
    l0 = quad_sum(l0);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    if (held[hh] && q == 0) {
      kth_out[row] = kth;
      l0_out[row] = static_cast<float>(l0);
      l1_out[row] = l1;
    }
  }

  // The rows that took the exact route: K1's row routine on their h, read
  // back, in the ring's shared memory (every TMA copy has landed and been
  // read).
  __threadfence();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  TopkRowSmem<kThreads>& sm = *reinterpret_cast<TopkRowSmem<kThreads>*>(smem_raw + (ring - smem_u32(smem_raw)));
  int n_exact = 0;
#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    if (!exact_row[r]) continue;
    const long row = b0 + r;
    topk_stats_row<VPT, kThreads, true>(h + row * S, S, k, row, sm, kth_out, f, live, l0_out, l1_out, nullptr,
                                           [] {});
    __syncthreads();
    ++n_exact;
  }
  if (threadIdx.x == 0 && exact != nullptr && n_exact > 0) atomicAdd(exact, n_exact);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int VPT>
cudaError_t launch(const float* x, const __nv_bfloat16* w, const float* b_enc, int B, int D, int S, int k,
                   __nv_bfloat16* xb, float* h, float* kth, __nv_bfloat16* f, int* live, float* l0, float* l1,
                   int* exact, cudaStream_t stream) {
  const long n4 = (long)B * D / 4;
  const long blocks = (n4 + 255) / 256;
  encode_round_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint2*>(xb), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)B}, x_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t x_box[2] = {TK, kRows};
  const cuuint64_t w_dims[2] = {(cuuint64_t)S, (cuuint64_t)D}, w_strides[1] = {(cuuint64_t)S * 2};
  const cuuint32_t w_box[2] = {64, TK};
  if (!make_map(&mx, xb, 2, x_dims, x_strides, x_box) || !make_map(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(encode_stats_wgmma_kernel<VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DYN_SMEM);
  if (err != cudaSuccess) return err;
  encode_stats_wgmma_kernel<VPT><<<B / kRows, kThreads, DYN_SMEM, stream>>>(mx, mw, b_enc, D, S, k, h, kth, f,
                                                                             live, l0, l1, exact);
  return cudaGetLastError();
}

}  // namespace

// live must be zeroed by the caller; xb is a (B, D) bf16 scratch buffer;
// exact, when not null, gains 1 for each row that took the exact route.
// Every pointer 16-byte aligned.
extern "C" int saev_encode_stats(const float* x, const __nv_bfloat16* w, const float* b_enc, int B, int D, int S,
                                 int k, __nv_bfloat16* xb, float* h, float* kth, __nv_bfloat16* f, int* live,
                                 float* l0, float* l1, int* exact, cudaStream_t stream) {
  if (B <= 0 || B % kRows != 0 || D <= 0 || D % 32 != 0 || S <= 0 || S % TILE != 0 || k <= 0 || k > S)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b_enc) || !aligned16(xb) || !aligned16(h) || !aligned16(f))
    return cudaErrorMisalignedAddress;
  if (S <= kThreads * 4) return launch<4>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  if (S <= kThreads * 8) return launch<8>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  if (S <= kThreads * 16) return launch<16>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  if (S <= kThreads * 32) return launch<32>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  if (S <= kThreads * 64) return launch<64>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  if (S <= kThreads * 128) return launch<128>(x, w, b_enc, B, D, S, k, xb, h, kth, f, live, l0, l1, exact, stream);
  return cudaErrorInvalidValue;
}
