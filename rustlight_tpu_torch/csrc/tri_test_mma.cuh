// The tensor-core form of the walk's triangle test: the card's counterpart of
// the MXU_TRITEST form of rustlight_tpu/accel/pallas_walk.py:_test_rows
// (:591-597), where ao = [o, 1] . rows and ad = [d, 0] . rows are two
// [64, 4] x [4, 3K] matrix products at f32 accuracy and the rest of the test
// is unchanged.
//
// A warp takes its 32 rays as two m16 row blocks against KC = 384 triangles,
// eight triangles (one n8 column block per row kind N, U, V) at a time, with
// mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32: the contraction depth
// 4 is exactly [o, 1] or [d, 0]. The rays of a warp may test different
// clusters (SPAN below): one for the whole warp (the tile walks K3, K3w, K5,
// the sub-tiled walk at 32-ray groups, the pair walk), one per row block of
// 16 rays, or one per slot of 8 rays. A row block whose two slots test two
// clusters runs once per cluster and keeps the rows of each slot (twice
// the products).
//
// Accuracy: one TF32 pass keeps 11 significand bits and must never decide a
// hit. Each operand is split into three TF32 parts, x = hi + mid + lo
// exactly (hi = cvt.rna.tf32(x), mid and lo the same of what is left: 11 +
// 11 bits and the last two), and a product is the six passes whose terms
// reach down to 2^-22 of the result: the five small ones, mid.mid, lo.hi,
// hi.lo, mid.hi, hi.mid, accumulated in one f32 accumulator, and hi.hi in
// another, the two then added in f32 (IEEE). The dropped terms are below
// 2^-33 of the result. Kept apart, the small sum is not cut by the tensor
// core's own accumulation of the large terms: on an H100 that order leaves
// t outside rtol 1e-5 of the exact t (the products in float64) on 378 of
// 37,813 hit lanes of a divergent wavefront, one accumulator for all six on
// 2,486, the two-way split's three passes on 11,390, and a plain f32 matmul
// on 7,006 (PERF.md section 6; the laboratory keeps every form measured,
// walk_lab.cu). The ray side is split once a walk; the rows side as a visit
// reads them. The ray operand's constant 1 and 0 are exact and have zero
// mid and lo parts.
//
// Fragment layout (PTX ISA, m16n8k4 .tf32), g = lane / 4, q = lane % 4:
//   A 16x4 row-major: a0 = A[g][q], a1 = A[g + 8][q];
//   B 4x8:            b0 = B[q][g];
//   C 16x8:           c0 = C[g][2q], c1 = C[g][2q + 1],
//                     c2 = C[g + 8][2q], c3 = C[g + 8][2q + 1].
// A thread so holds, for each of its four rays (slot s = 2 * mt + h: lane
// 8 * s + g of the warp), the six products of two triangles, and computes t,
// u, v and the validity of those pairs by itself. B for row kind b of
// triangles j0 .. j0 + 7 is word (3 * (j0 + g) + b) * 4 + q of the
// cluster's rows: the 32 lanes read 32 distinct banks.
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
// triangles per cluster: the walk tables' K, 384 unless the library is
// built with -DRL_KC=<k> (ops/native.py:load_cuda(k)); a multiple of 128,
// so that NB, each split form's columns a thread (KC / P, P <= 8) and each
// warp's column blocks of a tensor-core visit (NB / W, W <= 8) stay whole
#ifndef RL_KC
#define RL_KC 384
#endif
constexpr int KC = RL_KC;
static_assert(KC > 0 && KC % 128 == 0, "RL_KC: a multiple of 128");
constexpr int NB = KC / 8;        // n8 column blocks of a cluster
constexpr int PARTS = 3;          // TF32 parts of an operand

constexpr unsigned FULL = 0xffffffffu;

// The A fragments of the warp's 32 rays, by part, and each slot's tnear:
// constant through a walk.
struct MmaRays {
  uint32_t o[PARTS][4], d[PARTS][4];
  float tnear[4];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = p[0] + p[1] + p[2] exactly, each part a TF32 value. Each remainder is
// exact (Sterbenz: a part is its remainder rounded to 11 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t (&p)[PARTS]) {
  p[0] = to_tf32(x);
  const float r = __fsub_rn(x, __uint_as_float(p[0]));
  p[1] = to_tf32(r);
  p[2] = to_tf32(__fsub_rn(r, __uint_as_float(p[1])));
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

// Slot s of the fragments: the ray (ox .. dz, tnear) that lane 8 s + g of
// the calling thread's row g holds; q picks the component.
__device__ __forceinline__ void mma_slot(MmaRays& m, int s, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float tnear) {
  const int q = threadIdx.x & 3;
  m.tnear[s] = tnear;
  uint32_t po[PARTS], pd[PARTS];
  split_tf32(q == 0 ? ox : q == 1 ? oy : q == 2 ? oz : 1.0f, po);
  split_tf32(q == 0 ? dx : q == 1 ? dy : q == 2 ? dz : 0.0f, pd);
#pragma unroll
  for (int k = 0; k < PARTS; ++k) {
    m.o[k][s] = po[k];
    m.d[k][s] = pd[k];
  }
}

// Every thread of the warp calls this with its own ray.
__device__ __forceinline__ MmaRays mma_rays(const Ray& ray) {
  const int g = (threadIdx.x & 31) >> 2;
  MmaRays m;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int src = 8 * s + g;
    mma_slot(m, s, __shfl_sync(FULL, ray.ox, src),
             __shfl_sync(FULL, ray.oy, src), __shfl_sync(FULL, ray.oz, src),
             __shfl_sync(FULL, ray.dx, src), __shfl_sync(FULL, ray.dy, src),
             __shfl_sync(FULL, ray.dz, src),
             __shfl_sync(FULL, ray.tnear, src));
  }
  return m;
}

// The same fragments for the 32 rays base .. base + 31 of o, d [n, 3] and
// tnear [n], read from memory: for a warp that does not hold those rays
// (the split visit below). Bit for bit those of mma_rays.
__device__ __forceinline__ MmaRays mma_rays_at(const float* __restrict__ o,
                                               const float* __restrict__ d,
                                               const float* __restrict__ tnear,
                                               int base) {
  const int g = (threadIdx.x & 31) >> 2;
  MmaRays m;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const size_t k = static_cast<size_t>(base + 8 * s + g);
    mma_slot(m, s, o[3 * k], o[3 * k + 1], o[3 * k + 2], d[3 * k],
             d[3 * k + 1], d[3 * k + 2], tnear[k]);
  }
  return m;
}

// The same for the 32 rays idx[0 .. 31] (an entry below 0 stands for ray
// `fallback`): for rays laid out through an index (the pair walk's
// cluster runs). Bit for bit those of mma_rays over the same rays.
__device__ __forceinline__ MmaRays mma_rays_idx(const float* __restrict__ o,
                                                const float* __restrict__ d,
                                                const float* __restrict__ tnear,
                                                const int* __restrict__ idx,
                                                int fallback) {
  const int g = (threadIdx.x & 31) >> 2;
  MmaRays m;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = idx[8 * s + g];
    const size_t k = static_cast<size_t>(i >= 0 ? i : fallback);
    mma_slot(m, s, o[3 * k], o[3 * k + 1], o[3 * k + 2], d[3 * k],
             d[3 * k + 1], d[3 * k + 2], tnear[k]);
  }
  return m;
}

// The B fragments of triangles j0 .. j0 + 7 of the cluster whose rows
// ([KC][3][4] floats, staged or in the table) start at `f`: per row kind,
// its parts.
struct MmaCols {
  uint32_t b[3][PARTS];
};

__device__ __forceinline__ MmaCols mma_cols(const float* f, int j0) {
  const int lane = threadIdx.x & 31;
  MmaCols c;
#pragma unroll
  for (int b = 0; b < 3; ++b)
    split_tf32(f[(3 * (j0 + (lane >> 2)) + b) * 4 + (lane & 3)], c.b[b]);
  return c;
}

// c = A x B at f32 accuracy from the parts a[k] = {a0, a1} and b[k]: the
// five small passes in one accumulator, hi.hi in another, added in f32.
__device__ __forceinline__ void mma_f32(float (&c)[4],
                                        const uint32_t (&a)[PARTS][2],
                                        const uint32_t (&b)[PARTS]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  mma_tf32(s, a[1][0], a[1][1], b[1]);
  mma_tf32(s, a[2][0], a[2][1], b[0]);
  mma_tf32(s, a[0][0], a[0][1], b[2]);
  mma_tf32(s, a[1][0], a[1][1], b[0]);
  mma_tf32(s, a[0][0], a[0][1], b[1]);
  mma_tf32(c, a[0][0], a[0][1], b[0]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], s[e]);
}

// The six products of row block mt (slots 2 mt, 2 mt + 1) with the columns
// `c`: acc[2 b] = [o, 1] . kind b, acc[2 b + 1] = [d, 0] . kind b.
__device__ __forceinline__ void mma_products(const MmaRays& m, int mt,
                                             const MmaCols& c,
                                             float (&acc)[6][4]) {
  uint32_t ao[PARTS][2], ad[PARTS][2];
#pragma unroll
  for (int k = 0; k < PARTS; ++k) {
    ao[k][0] = m.o[k][2 * mt]; ao[k][1] = m.o[k][2 * mt + 1];
    ad[k][0] = m.d[k][2 * mt]; ad[k][1] = m.d[k][2 * mt + 1];
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    mma_f32(acc[2 * b], ao, c.b[b]);
    mma_f32(acc[2 * b + 1], ad, c.b[b]);
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

// Per slot of the calling thread: the best (t, column, u, v) so far; for an
// any-hit scan a column below KC marks a hit.
struct MmaBest {
  float t[4], u[4], v[4];
  int j[4];
};

// Row block mt against the columns `cols` (triangles j0 .. j0 + 7), for the
// slots h of the block with bit h of `hsel` set.
template <bool ANY>
__device__ __forceinline__ void mma_step(const MmaRays& m, int mt,
                                         const MmaCols& cols, int j0,
                                         unsigned hsel, const float (&caps)[4],
                                         MmaBest& b) {
  const int q = (threadIdx.x & 31) & 3;
  float acc[6][4];
  mma_products(m, mt, cols, acc);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = 2 * mt + (e >> 1);
    float t, u, v;
    if (((hsel >> (e >> 1)) & 1u) &&
        test_products(acc[0][e], acc[1][e], acc[2][e], acc[3][e], acc[4][e],
                      acc[5][e], m.tnear[s], caps[s], t, u, v) &&
        (ANY || t < b.t[s])) {
      b.t[s] = t; b.u[s] = u; b.v[s] = v; b.j[s] = j0 + 2 * q + (e & 1);
    }
  }
}

// The split visit's step (split_mma in walk_common.cuh, one cluster for
// the warp): both row blocks (those with `live` slots) against triangles
// j0 .. j0 + 7 of the rows at `f`, the products one row kind at a time (N,
// then U, then V; each product as mma_products forms it), so that the B
// parts of one kind and the accumulators of four products are live, and
// a block of 512 threads keeps all of it in its 128 registers a thread.
// Then tri_test.cuh's test as test_products (IEEE f32, no contraction),
// and the same updates in the same order as mma_step.
template <bool ANY>
__device__ __forceinline__ void mma_step_lean(const MmaRays& m,
                                              const float* f, int j0,
                                              const bool (&live)[2],
                                              const float (&caps)[4],
                                              MmaBest& b) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  float t[2][4], u[2][4];
  bool ok[2][4];
#pragma unroll
  for (int kind = 0; kind < 3; ++kind) {
    uint32_t bp[PARTS];
    split_tf32(f[(3 * (j0 + (lane >> 2)) + kind) * 4 + q], bp);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!live[mt]) continue;
      uint32_t ao[PARTS][2], ad[PARTS][2];
#pragma unroll
      for (int k = 0; k < PARTS; ++k) {
        ao[k][0] = m.o[k][2 * mt]; ao[k][1] = m.o[k][2 * mt + 1];
        ad[k][0] = m.d[k][2 * mt]; ad[k][1] = m.d[k][2 * mt + 1];
      }
      float co[4], cd[4];
      mma_f32(co, ao, bp);
      mma_f32(cd, ad, bp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 2 * mt + (e >> 1);
        if (kind == 0) {
          t[mt][e] = __fdiv_rn(-co[e], cd[e]);
          ok[mt][e] = fabsf(cd[e]) > 1e-20f && t[mt][e] > m.tnear[s] &&
                      t[mt][e] < caps[s];
        } else if (kind == 1) {
          u[mt][e] = __fadd_rn(co[e], __fmul_rn(t[mt][e], cd[e]));
        } else {
          const float v = __fadd_rn(co[e], __fmul_rn(t[mt][e], cd[e]));
          if (ok[mt][e] && u[mt][e] >= 0.0f && v >= 0.0f &&
              __fadd_rn(u[mt][e], v) <= 1.0f && (ANY || t[mt][e] < b.t[s])) {
            b.t[s] = t[mt][e]; b.u[s] = u[mt][e]; b.v[s] = v;
            b.j[s] = j0 + 2 * q + (e & 1);
          }
        }
      }
    }
  }
}

// The whole warp scans, each of its rays against the cluster whose rows
// start at its own `c_rows`, which is the same for the SPAN (32, 16 or 8)
// adjacent lanes of an aligned group, over the column blocks b0 .. b1 - 1
// (triangles 8 b0 .. 8 b1 - 1; all NB by default). On return the calling
// thread has its own ray's nearest valid hit below `cap` (its own ray's t
// cap; -inf takes the ray out) among those columns: j < KC, with t, u, v;
// j = KC for none. The lowest column wins among equal t. With ANY, j < KC
// says only that there is a hit. A slot with no cap skips its products,
// and a warp with none skips the scan. LEAN takes mma_step_lean (the split
// visit's).
template <int SPAN, bool ANY, bool LEAN = false>
__device__ __forceinline__ void mma_scan(const float* c_rows,
                                         const MmaRays& m, float cap,
                                         float& t_out, int& j_out,
                                         float& u_out, float& v_out,
                                         int b0 = 0, int b1 = NB) {
  static_assert(SPAN == 32 || SPAN == 16 || SPAN == 8, "SPAN: 32, 16 or 8");
  static_assert(SPAN == 32 || !LEAN, "the lean step takes one cluster");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  // a slot (8 rays) takes part when one of its rays has a cap
  const unsigned live = __ballot_sync(FULL, cap > -CUDART_INF_F);
  const float* f[4];
  float caps[4];
  MmaBest b;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    caps[s] = __shfl_sync(FULL, cap, 8 * s + g);
    f[s] = SPAN == 32 ? c_rows
                      : reinterpret_cast<const float*>(__shfl_sync(
                            FULL, reinterpret_cast<unsigned long long>(c_rows),
                            (8 * s) & ~(SPAN - 1)));
    b.t[s] = CUDART_INF_F; b.u[s] = 0.0f; b.v[s] = 0.0f; b.j[s] = KC;
  }
  const bool slot[4] = {(live & 0xffu) != 0, (live & 0xff00u) != 0,
                        (live & 0xff0000u) != 0, (live & 0xff000000u) != 0};
  const bool live_mt[2] = {slot[0] || slot[1], slot[2] || slot[3]};
  for (int j0 = 8 * b0; live && j0 < 8 * b1; j0 += 8) {
    if constexpr (LEAN) {
      mma_step_lean<ANY>(m, f[0], j0, live_mt, caps, b);
    } else if constexpr (SPAN == 32) {
      const MmaCols cols = mma_cols(f[0], j0);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (live_mt[mt]) mma_step<ANY>(m, mt, cols, j0, 3u, caps, b);
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* fa = f[2 * mt];
        const float* fb = f[2 * mt + 1];
        if (SPAN == 16 || fa == fb) {
          if (live_mt[mt])
            mma_step<ANY>(m, mt, mma_cols(fa, j0), j0, 3u, caps, b);
        } else {
          if (slot[2 * mt])
            mma_step<ANY>(m, mt, mma_cols(fa, j0), j0, 1u, caps, b);
          if (slot[2 * mt + 1])
            mma_step<ANY>(m, mt, mma_cols(fb, j0), j0, 2u, caps, b);
        }
      }
    }
  }
  // the four threads of a row merge: the smaller t, then the lower column
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ot = __shfl_xor_sync(FULL, b.t[s], off);
      const int oj = __shfl_xor_sync(FULL, b.j[s], off);
      const float ou = __shfl_xor_sync(FULL, b.u[s], off);
      const float ov = __shfl_xor_sync(FULL, b.v[s], off);
      if (ot < b.t[s] || (ot == b.t[s] && oj < b.j[s])) {
        b.t[s] = ot; b.j[s] = oj; b.u[s] = ou; b.v[s] = ov;
      }
    }
  }
  // lane 8 s + g owns the row that the threads 4 g .. 4 g + 3 hold in slot s
  const int own = lane >> 3, src = 4 * (lane & 7);
  t_out = CUDART_INF_F; j_out = KC; u_out = 0.0f; v_out = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float t = __shfl_sync(FULL, b.t[s], src);
    const int j = __shfl_sync(FULL, b.j[s], src);
    const float u = __shfl_sync(FULL, b.u[s], src);
    const float v = __shfl_sync(FULL, b.v[s], src);
    if (s == own) { t_out = t; j_out = j; u_out = u; v_out = v; }
  }
}

template <int SPAN = 32>
__device__ __forceinline__ void mma_scan_closest(const float* c_rows,
                                                 const MmaRays& m, float cap,
                                                 float& t_out, int& j_out,
                                                 float& u_out, float& v_out) {
  mma_scan<SPAN, false>(c_rows, m, cap, t_out, j_out, u_out, v_out);
}

// Whether the calling thread's own ray has a valid hit below `cap` (its own
// ray's tfar; -inf takes it out).
template <int SPAN = 32>
__device__ __forceinline__ bool mma_scan_anyhit(const float* c_rows,
                                                const MmaRays& m, float cap) {
  float t, u, v;
  int j;
  mma_scan<SPAN, true>(c_rows, m, cap, t, j, u, v);
  return j < KC;
}

}  // namespace walk
}  // namespace rl
