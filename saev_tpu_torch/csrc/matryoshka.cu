// P2, the group-outer Matryoshka forward error on bf16 operands with f32
// accumulation, and the fixed-order sum of per-CTA loss partials that P2
// and K2 share. K2 and K7, the forward error and base, are prefix_fwd.cu;
// K3, the dgrad, is dgrad.cu; K4, the wgrad, is wgrad.cu.
//
// Replaces scripts/proto_gouter.py `_err_kernel_gouter`
// (`grouped_prefix_err_gouter`).
//
// Notation: f (B, S) latents, W (S, D) decoder rows, J prefix cuts
// p_j = m_j * g + r_j with groups of g latents, E_j (B, D) the per-prefix
// errors.
//
// What bounds it on the card: tensor-core throughput. The product is about
// 2 * B * S * D = 0.55 TFLOP at the production shape (B = S = 16384,
// D = 1024) against well under 1 GB of operand traffic, far above the card's
// ridge point; the cut snapshots add at most J partial K steps.
//
// What the design does about it: one 128x128-tile GEMM with bf16 mma.sync
// and a two-stage cp.async pipeline (tile_mma.cuh), one CTA per output tile,
// so no CTA depends on another and every output element is written by
// exactly one CTA (no atomics; results are bitwise reproducible). It walks
// one group's K range per launch, launched once per group in ascending
// order. A CUDA block cannot carry a (B, D) running sum across the grid, so
// the f32 accumulator lives in device memory (the err_full output, 64 MB at
// the production shape): each launch loads its tile of it (at group 0:
// b_dec - x), adds f_G @ W_G, snapshots E_j = bf16(acc) when the walk
// crosses p_j (a cut inside a 32-wide K step splits that step into
// K-lane-masked passes, so cuts may be any integers; p_j = S after the last
// group), and stores it back. Bytes: W_G (2 MB bf16) is read by all 128 row
// tiles of a launch while it sits in L2, so W leaves device memory about
// once (32 MB) where K2's 128 row tiles each stream all of W (4 GB through
// L2); against that P2 adds 16 read-modify-write passes over the 64 MB
// accumulator (2 GB of device-memory traffic), 16 launch tails and 16
// pipeline fills. The loss is one partial per CTA per group, summed in a
// fixed order, so repeated runs give the same bits. P2 is a bench kernel:
// it stays on this mma.sync template (K2 moved to wgmma and TMA).

#include "tile_mma.cuh"

using namespace saev;

namespace {

constexpr int MAXJ = 64;

// The f32 accumulator tile stored as it is.
__device__ __forceinline__ void store_tile(const Acc& acc, float* out, long ld, long r0, long c0) {
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
        *reinterpret_cast<float2*>(out + row * ld + col) =
            make_float2(acc.v[i][t][2 * h], acc.v[i][t][2 * h + 1]);
      }
}

// E_j = bf16(acc) for one output tile (the accumulator already starts at
// b_dec - x), and its loss terms (f32(E_j) * inv_upper)^2 added to lsum.
__device__ __forceinline__ void emit_error(const Acc& acc, int j, long b0, long n0, int B, int D,
                                           float iu, __nv_bfloat16* __restrict__ e, float& lsum) {
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
        __nv_bfloat162 ev;
        ev.x = __float2bfloat16_rn(acc.v[i][t][2 * h]);
        ev.y = __float2bfloat16_rn(acc.v[i][t][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ej + row * D + col) = ev;
        const float e0 = __bfloat162float(ev.x) * iu, e1 = __bfloat162float(ev.y) * iu;
        lsum += e0 * e0;
        lsum += e1 * e1;
      }
}

// The accumulator at the start of a group: b_dec - x at group 0, else the
// running sum the previous group's launch stored.
__device__ __forceinline__ void load_run(Acc& acc, long b0, long n0, int D, bool first,
                                         const float* __restrict__ x,
                                         const float* __restrict__ bdec,
                                         const float* __restrict__ run) {
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
        float2 v;
        if (first) {
          const float2 xv = *reinterpret_cast<const float2*>(x + row * D + col);
          const float2 bv = *reinterpret_cast<const float2*>(bdec + col);
          v = make_float2(bv.x - xv.x, bv.y - xv.y);
        } else {
          v = *reinterpret_cast<const float2*>(run + row * D + col);
        }
        acc.v[i][t][2 * h] = v.x;
        acc.v[i][t][2 * h + 1] = v.y;
      }
}

// One 128x128 output tile (row tile blockIdx.y, d_model tile blockIdx.x) over
// the K range [k_begin, k_end) of f @ W, one group's. The cuts p_j inside
// that range are snapshotted as the walk crosses them; the cuts at p_j = S
// after the walk when k_end == S. acc_io is the running sum, read and written.
__global__ void __launch_bounds__(THREADS)
    gouter_kernel(const __nv_bfloat16* __restrict__ f, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ x, const float* __restrict__ bdec,
                  const float* __restrict__ inv_upper, const int* __restrict__ m,
                  const int* __restrict__ r, int J, int B, int S, int D, int g, int k_begin,
                  int k_end, __nv_bfloat16* __restrict__ e, float* __restrict__ acc_io,
                  float* __restrict__ partials) {
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
  load_run(acc, b0, n0, D, k_begin == 0, x, bdec, acc_io);
  float lsum = 0.f;
  int ci = 0;
  while (ci < J && cut_p[ci] < k_begin) ++ci;  // cuts of earlier groups
  __nv_bfloat16* sa = smem;
  __nv_bfloat16* sb = smem + 2 * STAGE_ELEMS;
  const int n_k = (k_end - k_begin) / BK;
  load_tile<true>(sa, f, S, b0, k_begin);
  load_tile<false>(sb, w, D, n0, k_begin);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_k) {
      load_tile<true>(sa + (cur ^ 1) * STAGE_ELEMS, f, S, b0, k_begin + (long)(t + 1) * BK);
      load_tile<false>(sb + (cur ^ 1) * STAGE_ELEMS, w, D, n0, k_begin + (long)(t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* a_s = sa + cur * STAGE_ELEMS;
    const __nv_bfloat16* b_s = sb + cur * STAGE_ELEMS;
    const int k0 = k_begin + t * BK;
    int lo = 0;  // lanes of this K step already in acc
    while (ci < J && cut_p[ci] < k0 + BK) {
      const int pr = cut_p[ci] - k0;
      if (pr > lo) {
        mma_stage<true>(acc, a_s, b_s, lo, pr);
        lo = pr;
      }
      emit_error(acc, cut_j[ci], b0, n0, B, D, iu, e, lsum);
      ++ci;
    }
    if (lo == 0)
      mma_stage<false>(acc, a_s, b_s, 0, BK);
    else if (lo < BK)
      mma_stage<true>(acc, a_s, b_s, lo, BK);
    __syncthreads();
  }
  // Cuts at p_j = S (the full decode): the snapshot is the whole sum.
  if (k_end == S)
    for (; ci < J; ++ci) emit_error(acc, cut_j[ci], b0, n0, B, D, iu, e, lsum);

  store_tile(acc, acc_io, D, b0, n0);
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

bool shapes_ok(int J, int B, int S, int D, int g) {
  return J > 0 && J <= MAXJ && B > 0 && B % BM == 0 && D > 0 && D % BN == 0 && g > 0 &&
         g % BM == 0 && S % g == 0;
}

}  // namespace

cudaError_t saev_sum_partials(const float* partials, int n, float* out, cudaStream_t stream) {
  sum_partials_kernel<<<1, THREADS, 0, stream>>>(partials, n, out);
  return cudaGetLastError();
}

// P2: one launch per group, in ascending order on one stream; err carries the
// running sum from each launch to the next. partials holds n_groups * (B/BM)
// * (D/BN) floats.
extern "C" int saev_prefix_err_gouter(const __nv_bfloat16* f, const __nv_bfloat16* w,
                                      const float* x, const float* bdec,
                                      const float* inv_upper, const int* m, const int* r,
                                      int J, int B, int S, int D, int g, __nv_bfloat16* e,
                                      float* err, float* partials, float* loss_sum,
                                      cudaStream_t stream) {
  if (!shapes_ok(J, B, S, D, g)) return cudaErrorInvalidValue;
  dim3 grid(D / BN, B / BM);
  const int n_tiles = grid.x * grid.y, n_groups = S / g;
  for (int G = 0; G < n_groups; ++G) {
    gouter_kernel<<<grid, THREADS, 0, stream>>>(f, w, x, bdec, inv_upper, m, r, J, B, S, D, g,
                                                G * g, (G + 1) * g, e, err,
                                                partials + (long)G * n_tiles);
    const cudaError_t code = cudaGetLastError();
    if (code != cudaSuccess) return code;
  }
  return saev_sum_partials(partials, n_groups * n_tiles, loss_sum, stream);
}
