// The tensor-core form of the walk's triangle test: the card's counterpart of
// the MXU_TRITEST form of rustlight_tpu/accel/pallas_walk.py:_test_rows
// (:591-597), where ao = [o, 1] . rows and ad = [d, 0] . rows are two
// [64, 4] x [4, 3K] matrix products at f32 accuracy and the rest of the test
// is unchanged.
//
// A tile's 64 rays are four m16 row blocks; each of the block's two warps
// takes two of them (its own 32 rays) against all KC = 384 triangles of the
// staged cluster, eight triangles (one n8 column block per row kind N, U, V)
// at a time, with mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32: the
// contraction depth 4 is exactly [o, 1] or [d, 0].
//
// Accuracy: one TF32 pass keeps 11 significand bits (about 3 decimal digits)
// and must never decide a hit. Each operand is split x = hi + lo, hi =
// cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and a product is the three
// passes lo.hi + hi.lo + hi.hi accumulated in f32 (the small terms first):
// the card's analogue of the reference's Precision.HIGHEST. The dropped
// lo.lo term and lo's own rounding leave about 2^-22 of each term. The
// ray operand's constant 1 and 0 are exact and have lo = 0.
//
// Fragment layout (PTX ISA, m16n8k4 .tf32), g = lane / 4, q = lane % 4:
//   A 16x4 row-major: a0 = A[g][q], a1 = A[g + 8][q];
//   B 4x8:            b0 = B[q][g];
//   C 16x8:           c0 = C[g][2q], c1 = C[g][2q + 1],
//                     c2 = C[g + 8][2q], c3 = C[g + 8][2q + 1].
// A thread so holds, for each of its four rays (slot s = 2 * mt + h: lane
// 8 * s + g of the warp), the six products of two triangles, and computes t,
// u, v and the validity of those pairs by itself. B for row kind b of
// triangles j0 .. j0 + 7 is word (3 * (j0 + g) + b) * 4 + q of the staged
// rows: the 32 lanes read 32 distinct banks.
//
// After the products, t, u, v, valid follow tri_test.cuh (IEEE f32, no
// contraction). The per-ray minimum keeps the lowest column on ties: a
// thread scans its columns in ascending order with a strict <, the four
// threads of a row merge (t, column) pairs by shuffles, and the winner goes
// to the ray's own thread by one more round of shuffles.
//
// This form is not bit-identical to the _dot4 form of tri_test.cuh.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri_test.cuh"

namespace rl {
namespace walk {

constexpr int TILE = 64;          // rays per tile, one thread per ray
constexpr int WARPS = TILE / 32;
constexpr int KC = 384;           // triangles per cluster

constexpr unsigned FULL = 0xffffffffu;

// The A fragments of the warp's 32 rays, hi and lo parts, and each slot's
// tnear: constant through a walk.
struct MmaRays {
  uint32_t o_hi[4], o_lo[4], d_hi[4], d_lo[4];
  float tnear[4];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += A (a0, a1) x B (b), one m16n8k4 TF32 pass with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// c = A x B at f32 accuracy: three passes over the split operands.
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t* a_hi,
                                       const uint32_t* a_lo, uint32_t b_hi,
                                       uint32_t b_lo) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  mma_tf32(c, a_lo[0], a_lo[1], b_hi);
  mma_tf32(c, a_hi[0], a_hi[1], b_lo);
  mma_tf32(c, a_hi[0], a_hi[1], b_hi);
}

// Every thread of the warp calls this with its own ray.
__device__ __forceinline__ MmaRays mma_rays(const Ray& ray) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  MmaRays m;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int src = 8 * s + g;
    const float ox = __shfl_sync(FULL, ray.ox, src);
    const float oy = __shfl_sync(FULL, ray.oy, src);
    const float oz = __shfl_sync(FULL, ray.oz, src);
    const float dx = __shfl_sync(FULL, ray.dx, src);
    const float dy = __shfl_sync(FULL, ray.dy, src);
    const float dz = __shfl_sync(FULL, ray.dz, src);
    m.tnear[s] = __shfl_sync(FULL, ray.tnear, src);
    const float o4 = q == 0 ? ox : q == 1 ? oy : q == 2 ? oz : 1.0f;
    const float d4 = q == 0 ? dx : q == 1 ? dy : q == 2 ? dz : 0.0f;
    split_tf32(o4, m.o_hi[s], m.o_lo[s]);
    split_tf32(d4, m.d_hi[s], m.d_lo[s]);
  }
  return m;
}

// The B fragments of triangles j0 .. j0 + 7 of the staged cluster `f`
// ([KC][3][4] floats), one per row kind, split.
struct MmaCols {
  uint32_t hi[3], lo[3];
};

__device__ __forceinline__ MmaCols mma_cols(const float* f, int j0) {
  const int lane = threadIdx.x & 31;
  MmaCols c;
#pragma unroll
  for (int b = 0; b < 3; ++b)
    split_tf32(f[(3 * (j0 + (lane >> 2)) + b) * 4 + (lane & 3)], c.hi[b],
               c.lo[b]);
  return c;
}

// The six products of row block mt (slots 2 mt, 2 mt + 1) with the columns
// `c`: acc[2 b] = [o, 1] . kind b, acc[2 b + 1] = [d, 0] . kind b.
__device__ __forceinline__ void mma_products(const MmaRays& m, int mt,
                                             const MmaCols& c,
                                             float (&acc)[6][4]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    mma_3x(acc[2 * b], &m.o_hi[2 * mt], &m.o_lo[2 * mt], c.hi[b], c.lo[b]);
    mma_3x(acc[2 * b + 1], &m.d_hi[2 * mt], &m.d_lo[2 * mt], c.hi[b],
           c.lo[b]);
  }
}

// tri_test.cuh's test from the six products of one (ray, triangle) pair.
__device__ __forceinline__ bool test_products(float no, float nd, float uo,
                                              float ud, float vo, float vd,
                                              float tnear, float tcap,
                                              float& t, float& u, float& v) {
  if (!(fabsf(nd) > 1e-20f)) return false;
  t = __fdiv_rn(-no, nd);
  if (!(t > tnear && t < tcap)) return false;
  u = __fadd_rn(uo, __fmul_rn(t, ud));
  v = __fadd_rn(vo, __fmul_rn(t, vd));
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
}

// The whole warp scans the staged cluster for its 32 rays: on return the
// calling thread has its own ray's nearest valid hit below `cap` (its own
// ray's t cap; -inf takes the ray out): j < KC, with t, u, v; j = KC for
// none. The lowest column wins among equal t.
__device__ __forceinline__ void mma_scan_closest(const float4* s_rows,
                                                 const MmaRays& m, float cap,
                                                 float& t_out, int& j_out,
                                                 float& u_out, float& v_out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const float* f = reinterpret_cast<const float*>(s_rows);
  float caps[4], bt[4], bu[4], bv[4];
  int bj[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    caps[s] = __shfl_sync(FULL, cap, 8 * s + g);
    bt[s] = CUDART_INF_F; bu[s] = 0.0f; bv[s] = 0.0f; bj[s] = KC;
  }
  for (int j0 = 0; j0 < KC; j0 += 8) {
    const MmaCols cols = mma_cols(f, j0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[6][4];
      mma_products(m, mt, cols, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 2 * mt + (e >> 1);
        float t, u, v;
        if (test_products(acc[0][e], acc[1][e], acc[2][e], acc[3][e],
                          acc[4][e], acc[5][e], m.tnear[s], caps[s], t, u,
                          v) && t < bt[s]) {
          bt[s] = t; bu[s] = u; bv[s] = v; bj[s] = j0 + 2 * q + (e & 1);
        }
      }
    }
  }
  // the four threads of a row merge: the smaller t, then the lower column
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ot = __shfl_xor_sync(FULL, bt[s], off);
      const int oj = __shfl_xor_sync(FULL, bj[s], off);
      const float ou = __shfl_xor_sync(FULL, bu[s], off);
      const float ov = __shfl_xor_sync(FULL, bv[s], off);
      if (ot < bt[s] || (ot == bt[s] && oj < bj[s])) {
        bt[s] = ot; bj[s] = oj; bu[s] = ou; bv[s] = ov;
      }
    }
  }
  // lane 8 s + g owns the row that the threads 4 g .. 4 g + 3 hold in slot s
  const int own = lane >> 3, src = 4 * (lane & 7);
  t_out = CUDART_INF_F; j_out = KC; u_out = 0.0f; v_out = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float t = __shfl_sync(FULL, bt[s], src);
    const int j = __shfl_sync(FULL, bj[s], src);
    const float u = __shfl_sync(FULL, bu[s], src);
    const float v = __shfl_sync(FULL, bv[s], src);
    if (s == own) { t_out = t; j_out = j; u_out = u; v_out = v; }
  }
}

// The whole warp scans the staged cluster: whether the calling thread's own
// ray has a valid hit below `cap` (its own ray's tfar; -inf takes it out).
__device__ __forceinline__ bool mma_scan_anyhit(const float4* s_rows,
                                                const MmaRays& m, float cap) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const float* f = reinterpret_cast<const float*>(s_rows);
  float caps[4];
  int hit[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    caps[s] = __shfl_sync(FULL, cap, 8 * s + g);
    hit[s] = 0;
  }
  for (int j0 = 0; j0 < KC; j0 += 8) {
    const MmaCols cols = mma_cols(f, j0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[6][4];
      mma_products(m, mt, cols, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 2 * mt + (e >> 1);
        float t, u, v;
        if (test_products(acc[0][e], acc[1][e], acc[2][e], acc[3][e],
                          acc[4][e], acc[5][e], m.tnear[s], caps[s], t, u, v))
          hit[s] = 1;
      }
    }
  }
  const int own = lane >> 3, src = 4 * (lane & 7);
  bool out = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int h = hit[s];
    h |= __shfl_xor_sync(FULL, h, 1);
    h |= __shfl_xor_sync(FULL, h, 2);
    h = __shfl_sync(FULL, h, src);
    if (s == own) out = h != 0;
  }
  return out;
}

}  // namespace walk
}  // namespace rl
