// The K walk's snapshot of prefix cuts, shared by K2 and K7 (prefix_fwd.cu)
// and P2 (prefix_gouter.cu): each CTA walks K = S for one 128 x 128 f32
// tile on wgmma (hopper.cuh) and, before the k16 step that holds a cut p,
// stores acc plus a correction of the at most 15 lanes below p, read from
// the stage already in shared memory (prefix_fwd.cu's header says why).
#pragma once

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STEPS = TK / 16;  // k16 steps of wgmma a stage

enum class Store { kE, kF32, kBf16, kAcc };

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
// adds the loss terms to lsum; kAcc (P2, whose acc starts at b_dec - x)
// rounds acc plus the correction as kBf16 does and adds the loss terms.
// With cut_p null, one snapshot of acc alone.
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
          const uint4 pk = make_uint4(pack_bf16(v[0].x, v[0].y), pack_bf16(v[1].x, v[1].y),
                                      pack_bf16(v[2].x, v[2].y), pack_bf16(v[3].x, v[3].y));
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(o) + at) = pk;
          if constexpr (ST == Store::kAcc) {
            lsum += loss_terms(pk.x, iu);
            lsum += loss_terms(pk.y, iu);
            lsum += loss_terms(pk.z, iu);
            lsum += loss_terms(pk.w, iu);
          }
        }
      }
    }
  }
}

constexpr int FWD_THREADS = 32 * CONSUMER_WARPS;  // two warpgroups, no producer warp

}  // namespace
