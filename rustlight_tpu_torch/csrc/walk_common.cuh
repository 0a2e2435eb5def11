// Pieces of the tile walk shared by the one-level kernels (walk_trace.cu,
// K3/K4 and their wide pop), the two-level kernels (walk_hier.cu, K5), the
// sub-tiled kernels (walk_sub.cu, K6) and the sparse-visit kernels
// (walk_sparse.cu, K7).
//
// A tile is TILE = 64 rays walked by one block of NT = P x 64 threads: P
// threads a ray (P = 1 in the one-thread kernels, P > 1 in the split ones
// of every source), the ray's P threads side by side in a
// warp (ray threadIdx.x / P, lane threadIdx.x % P). Entries are packed: the
// float bits of a non-negative entry distance with the low mantissa bits
// replaced by an id (ID_BITS = 14 for clusters or supers, CHILD_BITS = 7 for
// the children of an opened super), +inf bits for no entry. Non-negative
// floats order as their int32 bits, so every pop is an int32 min.
// Arithmetic is IEEE f32 without contraction (__fmul_rn, __fsub_rn,
// __fadd_rn, __fdiv_rn) and min/max propagate NaN as torch.minimum/maximum
// do, so the kernels are bit-identical to the plain versions in
// ops/walk_trace.py and ops/walk_hier.py.
//
// A visit's triangle test has two forms, chosen by a template flag of
// visit_closest / visit_anyhit: the _dot4 form of tri_test.cuh, one thread a
// ray (the default, and the bit-identical one), and the tensor-core form of
// tri_test_mma.cuh, a warp for its 32 rays. The split kernels take the
// split forms of both (split_closest / split_anyhit, split_mma below).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri_test_mma.cuh"

namespace rl {
namespace walk {

// TILE, WARPS and KC (64 rays, 2 warps, 384 triangles per cluster) come from
// tri_test_mma.cuh
constexpr int ID_BITS = 14;
constexpr int ID_MASK = (1 << ID_BITS) - 1;
constexpr int INF_BITS = 0x7f800000;

// min/max that propagate NaN, as torch.minimum/torch.maximum do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

// The min of v over the block's NT threads; red holds NT / 32 partials.
template <int NT = TILE>
__device__ __forceinline__ int block_min(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // every thread has read red from the last reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = min(r, red[w]);
  return r;
}

template <int NT = TILE>
__device__ __forceinline__ int block_max(int v, int* red) {
  return -block_min<NT>(-v, red);  // v >= 0: the bits of non-negative floats
}

struct TileRays {
  float o[3][TILE];
  float inv[3][TILE];
  float tnear[TILE];
  float tfar[TILE];
};

__device__ __forceinline__ float slab_inv(float d) {
  const float dd = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return __fdiv_rn(1.0f, dd);
}

// Ray threadIdx.x / P of the tile into s, written by its first thread.
template <int P = 1>
__device__ __forceinline__ void load_tile(const Ray& ray, TileRays& s) {
  if (threadIdx.x % P) return;
  const int k = threadIdx.x / P;
  s.o[0][k] = ray.ox; s.o[1][k] = ray.oy; s.o[2][k] = ray.oz;
  s.inv[0][k] = slab_inv(ray.dx);
  s.inv[1][k] = slab_inv(ray.dy);
  s.inv[2][k] = slab_inv(ray.dz);
  s.tnear[k] = ray.tnear;
  s.tfar[k] = ray.tfar;
}

// Whether ray j of the tile enters the box [l, h] below cap: its slab entry
// max(tmin, tnear[j]), counted where tmax >= entry and entry < cap.
__device__ __forceinline__ bool slab_entry(const float l[3], const float h[3],
                                           const TileRays& r, int j, float cap,
                                           float& entry) {
  float tmin = -CUDART_INF_F, tmax = CUDART_INF_F;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = __fmul_rn(__fsub_rn(l[ax], r.o[ax][j]), r.inv[ax][j]);
    const float t1 = __fmul_rn(__fsub_rn(h[ax], r.o[ax][j]), r.inv[ax][j]);
    tmin = nan_max(tmin, nan_min(t0, t1));
    tmax = nan_min(tmax, nan_max(t0, t1));
  }
  entry = nan_max(tmin, r.tnear[j]);
  return tmax >= entry && entry < cap;
}

// Minimum over the tile's rays j of the slab entry into the box [l, h],
// each capped by cap[j]; +inf if no ray enters.
__device__ __forceinline__ float min_entry(const float l[3], const float h[3],
                                           const TileRays& r,
                                           const float* cap) {
  float e = CUDART_INF_F;
  for (int j = 0; j < TILE; ++j) {
    float entry;
    if (slab_entry(l, h, r, j, cap[j], entry)) e = fminf(e, entry);
  }
  return e;
}

// ------------------------------------------------ the split entry pass
//
// The entry pass of the split K3w and K7 kernels (walk_trace.cu: wide_walk,
// walk_sparse.cu: sparse_walk), where it is the largest part of the work
// (Cp x 64 slab tests a tile). A ray's data are two float4, so a slab test
// reads them with two 16-byte loads, broadcast over the warp, and min/max
// are PTX's min.NaN / max.NaN, one instruction each: a NaN operand gives
// the canonical NaN, as nan_min/nan_max do, and other operands give
// fminf/fmaxf's result. The first axis's running limits start at -inf /
// +inf and take t0, t1's min and max as they are (nan_max(-inf, x) is x up
// to a NaN's payload, which no caller reads: a NaN limit fails the test).
// The same operations in the same order as slab_entry, so the same entry
// and the same verdict.

struct TileRays4 {
  float4 o[TILE];     // ox, oy, oz, tnear
  float4 inv[TILE];   // 1 / dx, 1 / dy, 1 / dz (slab_inv), tfar
};

// Ray threadIdx.x / P of the tile into s, written by its first thread.
template <int P>
__device__ __forceinline__ void load_tile4(const Ray& ray, TileRays4& s) {
  if (threadIdx.x % P) return;
  const int k = threadIdx.x / P;
  s.o[k] = make_float4(ray.ox, ray.oy, ray.oz, ray.tnear);
  s.inv[k] = make_float4(slab_inv(ray.dx), slab_inv(ray.dy),
                         slab_inv(ray.dz), ray.tfar);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// slab_entry of ray (ro, ri) (TileRays4's two float4) below its tfar.
__device__ __forceinline__ bool slab_entry4(const float l[3], const float h[3],
                                            float4 ro, float4 ri,
                                            float& entry) {
  const float o[3] = {ro.x, ro.y, ro.z}, inv[3] = {ri.x, ri.y, ri.z};
  float tmin, tmax;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = __fmul_rn(__fsub_rn(l[ax], o[ax]), inv[ax]);
    const float t1 = __fmul_rn(__fsub_rn(h[ax], o[ax]), inv[ax]);
    if (ax == 0) {
      tmin = min_nan(t0, t1);
      tmax = max_nan(t0, t1);
    } else {
      tmin = max_nan(tmin, min_nan(t0, t1));
      tmax = min_nan(tmax, max_nan(t0, t1));
    }
  }
  entry = max_nan(tmin, ro.w);
  return tmax >= entry && entry < ri.w;
}

// The packed entry of box `id` (id_mask = its id bits) at distance e.
__device__ __forceinline__ int pack_entry(float e, int id, int id_mask) {
  if (!isfinite(e)) return INF_BITS;
  // + 0 maps a -0 entry to +0, so its bits sort as the smallest
  const float z = __fadd_rn(fmaxf(e, 0.0f), 0.0f);
  return (__float_as_int(z) & ~id_mask) | id;
}

// s_ent[c] = packed tile entry of box c of [lo, hi] ([3, cp] f32; boxes at
// or past n_real are pads), capped by each ray's tfar. Thread c % NT writes
// entry c.
template <int NT = TILE>
__device__ inline void tile_entries(const float* __restrict__ lo,
                                    const float* __restrict__ hi, int cp,
                                    int n_real, const TileRays& r,
                                    int* s_ent) {
  for (int c = threadIdx.x; c < cp; c += NT) {
    int bits = INF_BITS;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      bits = pack_entry(min_entry(l, h, r, r.tfar), c, ID_MASK);
    }
    s_ent[c] = bits;
  }
}

// Pops the smallest of the n entries; returns its bits (INF_BITS once all
// are popped). Every thread has scanned s_ent before block_min's second
// barrier. OWNER = false: thread 0 clears the popped entry, and the caller
// puts a barrier between this pop and the next scan, which publishes the
// clear. OWNER = true: the thread that scans entry c (c % NT) clears it, so
// the next pop needs no barrier before it (the split kernels).
template <int NT = TILE, bool OWNER = false>
__device__ __forceinline__ int pop_min(int* s_ent, int n, int id_mask,
                                       int* red) {
  int m = INF_BITS;
  for (int c = threadIdx.x; c < n; c += NT) m = min(m, s_ent[c]);
  m = block_min<NT>(m, red);
  const int owner = OWNER ? (m & id_mask) % NT : 0;
  if (threadIdx.x == owner && m != INF_BITS) s_ent[m & id_mask] = INF_BITS;
  return m;
}

// Stages cluster csel's rows if any thread of the block wants them;
// returns whether it did. The first barrier also ends the last visit.
template <int NT = TILE>
__device__ __forceinline__ bool stage(const float4* __restrict__ rows,
                                      int csel, bool want, float4* s_rows) {
  if (!__syncthreads_or(want)) return false;
  const float4* src = rows + static_cast<size_t>(csel) * (3 * KC);
  for (int k = threadIdx.x; k < 3 * KC; k += NT) s_rows[k] = src[k];
  __syncthreads();
  return true;
}

// One ray against the KC triangles of cluster csel, whose rows are at
// c_rows (staged, or in the table): the lowest column wins inside the
// cluster, a strict < against best_t across clusters.
__device__ __forceinline__ void scan_closest(const float4* c_rows,
                                             const int* __restrict__ ids,
                                             int csel, const Ray& ray,
                                             float& best_t, int& best_i,
                                             float& best_u, float& best_v) {
  float bt = best_t, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  for (int j = 0; j < KC; ++j) {
    float t, u, v;
    if (test_tri(&c_rows[3 * j], ray, bt, t, u, v)) {
      bt = t; bj = j; bu = u; bv = v;
    }
  }
  if (bj >= 0) {
    best_t = bt;
    best_i = ids[static_cast<size_t>(csel) * KC + bj];
    best_u = bu;
    best_v = bv;
  }
}

// Whether the ray hits any of the KC triangles at c_rows in (tnear, tfar).
__device__ __forceinline__ bool scan_anyhit(const float4* c_rows,
                                            const Ray& ray) {
  for (int j = 0; j < KC; ++j) {
    float t, u, v;
    if (test_tri(&c_rows[3 * j], ray, ray.tfar, t, u, v)) return true;
  }
  return false;
}

// One closest-hit visit of cluster csel by the block's tile. MMA takes the
// tensor-core form of the test, with the warp's ray fragments `m`.
template <bool MMA = false>
__device__ __forceinline__ void visit_closest(
    const float4* __restrict__ rows, const int* __restrict__ ids, int csel,
    const Ray& ray, float4* s_rows, float& best_t, int& best_i,
    float& best_u, float& best_v, const MmaRays& m = MmaRays{}) {
  const bool want = ray.tnear < best_t;
  if (!stage(rows, csel, want, s_rows)) return;
  if constexpr (MMA) {
    if (!__any_sync(FULL, want)) return;
    float t, u, v;
    int j;
    mma_scan_closest(reinterpret_cast<const float*>(s_rows), m,
                     want ? best_t : -CUDART_INF_F, t, j, u, v);
    if (j < KC) {
      best_t = t;
      best_i = ids[static_cast<size_t>(csel) * KC + j];
      best_u = u;
      best_v = v;
    }
  } else {
    if (!want) return;
    scan_closest(s_rows, ids, csel, ray, best_t, best_i, best_u, best_v);
  }
}

// One any-hit visit of cluster csel against (tnear, tfar); occ is sticky,
// so occluded rays skip the test.
template <bool MMA = false>
__device__ __forceinline__ void visit_anyhit(const float4* __restrict__ rows,
                                             int csel, const Ray& ray,
                                             float4* s_rows, bool& occ,
                                             const MmaRays& m = MmaRays{}) {
  const bool want = !occ && ray.tnear < ray.tfar;
  if (!stage(rows, csel, want, s_rows)) return;
  if constexpr (MMA) {
    if (!__any_sync(FULL, want)) return;
    if (mma_scan_anyhit(reinterpret_cast<const float*>(s_rows), m,
                        want ? ray.tfar : -CUDART_INF_F))
      occ = true;
  } else {
    if (!want) return;
    if (scan_anyhit(s_rows, ray)) occ = true;
  }
}

// ------------------------------------------------------------- split visit
//
// The split kernels test a visit's KC triangles with P threads a ray: lane q
// of a ray scans the columns j = q, q + P, q + 2P, ... in ascending order
// with the serial rule (a strict < against its running cap, which starts at
// the visit's best_t). Then a butterfly over the ray's P lanes keeps the
// least t, and the lowest column among equal t: (t, j) beats (t', j') when
// t < t' or t == t' and j < j'. The serial scan's winner is the first
// column with the least t below the cap, which is that same pair, so the
// split visit's result is the serial one bit for bit, the winner's own u, v
// and id included. t is compared as a float, not by its bits: a caller may
// pass tnear < 0, so t may be negative. Every lane ends with the winner, so
// best_t stays equal across a ray's lanes. Every thread of the warp calls
// these (the shuffles are warp-wide); lanes whose ray does not want the
// visit enter with want = false and leave best unchanged.

template <int P>
__device__ __forceinline__ void split_closest(const float4* c_rows,
                                              const int* __restrict__ ids,
                                              int csel, const Ray& ray,
                                              bool want, float& best_t,
                                              int& best_i, float& best_u,
                                              float& best_v) {
  float bt = best_t, bu = 0.0f, bv = 0.0f;
  int bj = KC;
  if (want) {
    for (int j = threadIdx.x % P; j < KC; j += P) {
      float t, u, v;
      if (test_tri(&c_rows[3 * j], ray, bt, t, u, v)) {
        bt = t; bj = j; bu = u; bv = v;
      }
    }
  }
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL, bt, off);
    const int oj = __shfl_xor_sync(FULL, bj, off);
    const float ou = __shfl_xor_sync(FULL, bu, off);
    const float ov = __shfl_xor_sync(FULL, bv, off);
    if (ot < bt || (ot == bt && oj < bj)) {
      bt = ot; bj = oj; bu = ou; bv = ov;
    }
  }
  if (bj < KC) {
    best_t = bt;
    best_i = ids[static_cast<size_t>(csel) * KC + bj];
    best_u = bu;
    best_v = bv;
  }
}

// Any hit: each lane stops at its first hit; an OR over the ray's lanes.
template <int P>
__device__ __forceinline__ void split_anyhit(const float4* c_rows,
                                             const Ray& ray, bool want,
                                             bool& occ) {
  int hit = 0;
  if (want) {
    for (int j = threadIdx.x % P; j < KC; j += P) {
      float t, u, v;
      if (test_tri(&c_rows[3 * j], ray, ray.tfar, t, u, v)) {
        hit = 1;
        break;
      }
    }
  }
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
    hit |= __shfl_xor_sync(FULL, hit, off);
  if (hit) occ = true;
}

// ---------------------------------------------- split tensor-core visit
//
// The tensor-core test (tri_test_mma.cuh) split over warps by columns. With
// P threads a ray, the rays of a 32-ray set sit on P consecutive warps. The
// set's rays fall into groups of GS rays, each with its own cluster (GS =
// 32: the whole set, as in the tile walk and in K6 at sub 2; 16 or 8: K6 at
// sub 4 or 8), and the W = GS P / 32 warps of a group split its NB column
// blocks: its warp wi takes blocks [wi NB / W, (wi + 1) NB / W). Each warp
// runs mma_scan for all 32 rays of its set (their fragments read from
// memory) with the caps of its group's rays from mx.cap and -inf for the
// others, so the products, t, u and v of each column are the same
// instructions on the same operands as in the one-warp scan, and it keeps
// each ray's (t, column) minimum over its columns. The ray's W partials
// then merge through mx.part in column order: t smaller, or t equal and
// the column lower. That is the serial winner, so the result is the
// one-warp scan's bit for bit. `sync` is a barrier over the threads that
// share mx (the block, or one group of K6); the caller writes the caps of
// its rays (put_cap) and passes a barrier before the call. Every thread of
// the group calls it; on return each has its own ray's result as mma_scan
// gives it.

struct MmaPart {
  float t, u, v;
  int j;
};

// Shared memory of the split visit, in the dynamic block after the rows:
// each ray's cap, and a partial per warp and lane.
struct MmaScratch {
  float* cap;       // [TILE]
  MmaPart* part;    // [NT]
};

template <int NT>
__host__ __device__ constexpr int mma_scratch_f4() {
  return (TILE * sizeof(float) + NT * sizeof(MmaPart)) / sizeof(float4);
}

__device__ __forceinline__ MmaScratch mma_scratch(float4* at) {
  return {reinterpret_cast<float*>(at),
          reinterpret_cast<MmaPart*>(at + TILE / 4)};
}

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// The fragments of the calling warp's 32-ray set (warp / P) of tile `tile`
// (the block's own, unless the block walks several tiles).
template <int P>
__device__ __forceinline__ MmaRays set_rays(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const float* __restrict__ tnear,
                                            int tile = blockIdx.x) {
  return mma_rays_at(o, d, tnear, tile * TILE + (threadIdx.x >> 5) / P * 32);
}

template <int P, int GS, bool ANY, typename Sync>
__device__ __forceinline__ void split_mma(const float* c_rows,
                                          const MmaRays& m,
                                          const MmaScratch& mx, Sync sync,
                                          float& t, int& j, float& u,
                                          float& v) {
  static_assert(GS * P >= 32, "a warp must lie in one group");
  constexpr int W = GS * P / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ray_l = (w / P) * 32 + lane;      // the tile ray lane L stands for
  const float cap = ray_l / GS == w / W ? mx.cap[ray_l] : -CUDART_INF_F;
  MmaPart q;
  mma_scan<32, ANY, true>(c_rows, m, cap, q.t, q.j, q.u, q.v,
                          (w % W) * NB / W, (w % W + 1) * NB / W);
  mx.part[threadIdx.x] = q;
  sync();
  const int r = threadIdx.x / P;
  const MmaPart* part = mx.part + (r / GS) * W * 32 + (r & 31);
  t = CUDART_INF_F; j = KC; u = 0.0f; v = 0.0f;
  for (int k = 0; k < W; ++k) {
    const MmaPart p = part[k * 32];
    if (p.t < t || (p.t == t && p.j < j)) {
      t = p.t; j = p.j; u = p.u; v = p.v;
    }
  }
}

// The caller's half of the split visit: ray threadIdx.x / P's cap, written
// by its first thread.
template <int P>
__device__ __forceinline__ void put_cap(const MmaScratch& mx, bool want,
                                        float cap) {
  if (threadIdx.x % P == 0)
    mx.cap[threadIdx.x / P] = want ? cap : -CUDART_INF_F;
}

// ------------------------------------------------------ feeding the rows
//
// Where a split kernel's visit finds its cluster's rows. Both feeds are
// handed every cluster one visit ahead (prefetch), in the pop order, and
// then take the visit's own rows (take): the pop order does not depend on a
// visit's result, only the stop test does, so the next cluster is known a
// visit early. The caller pops between two takes (pop_min's barriers end
// the visit before a slot is filled again).

// The stage of walk_common: one slot, copied by the block at the visit,
// skipped when no thread wants it.
template <int NT>
struct StageFeed {
  float4* slot;
  __device__ void init() {}
  __device__ __forceinline__ void prefetch(const float4*, int) {}
  // cluster csel's rows (the cluster prefetched before the last one), or
  // nullptr when no ray of the block wants them
  __device__ __forceinline__ const float4* take(const float4* rows, int csel,
                                                bool want) {
    return stage<NT>(rows, csel, want, slot) ? slot : nullptr;
  }
  // the same for a visit that every warp reads when one ray wants it (the
  // split tensor-core visit); its first barrier publishes the caps
  __device__ __forceinline__ const float4* take_all(const float4* rows,
                                                    int csel, bool want) {
    return take(rows, csel, want);
  }
  __device__ void drain() {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Thread 0's half of a bulk copy of cluster c's 3 x KC float4 (18,432 B)
// into `slot`, completing on the mbarrier `bar` (one arrival, the issuer's
// expect_tx, and the bytes). The caller has ended every read of the slot
// (a barrier) and the slot's last copy has completed; the fence orders
// those reads (generic proxy) before the copy (async proxy).
__device__ __forceinline__ void bulk_rows(float4* slot, uint64_t* bar,
                                          const float4* rows, int c) {
  constexpr uint32_t BYTES = 3 * KC * sizeof(float4);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(BYTES)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(slot)),
      "l"(rows + static_cast<size_t>(c) * (3 * KC)), "r"(BYTES),
      "r"(smem_u32(bar))
      : "memory");
}

// Thread 0 sets up n mbarriers of one arrival each.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < n; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bar[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// A two-slot ring of cluster rows in shared memory, filled one visit ahead
// by Hopper's bulk asynchronous copy: thread 0 issues one
// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes for the
// cluster's contiguous 3 x KC float4 (18,432 B), and the copy's completion
// arrives on the slot's mbarrier (one arrival, the issuer's expect_tx, and
// the bytes). Copy k goes to slot k & 1 and completes phase k >> 1 of its
// barrier, so every thread knows the parity to wait on from the count n of
// copies issued, which all threads keep alike. Before copy k thread 0
// waits for copy k - 2 (the slot's last), whose visit the caller's pops
// have ended; a ray that wants a visit waits for its copy, one that does
// not skips it. A copy no ray then wants (or the one popped after the
// stop) is read and dropped: cluster_of clamps every id to a real slot of
// the table. drain() waits for the copies in flight before the block
// exits.
struct RingFeed {
  float4* slot;       // two slots of 3 x KC float4
  uint64_t* bar;      // two mbarriers
  int n = 0;          // copies issued
  __device__ void init() { mbar_init(bar, 2); }
  __device__ __forceinline__ void prefetch(const float4* rows, int c) {
    if (threadIdx.x == 0) {
      const int s = n & 1;
      if (n >= 2) mbar_wait(&bar[s], ((n - 2) >> 1) & 1);
      bulk_rows(slot + s * 3 * KC, &bar[s], rows, c);
    }
    ++n;
  }
  // the rows of the cluster prefetched before the last one (copy n - 2)
  __device__ __forceinline__ const float4* take(const float4*, int,
                                                bool want) {
    const int k = n - 2;
    if (want) mbar_wait(&bar[k & 1], (k >> 1) & 1);
    return slot + (k & 1) * 3 * KC;
  }
  // the rows for every thread when any ray of the block wants them (the
  // barrier publishes the caps), else nullptr
  __device__ __forceinline__ const float4* take_all(const float4* rows,
                                                    int csel, bool want) {
    return __syncthreads_or(want) ? take(rows, csel, true) : nullptr;
  }
  __device__ void drain() {
    if (threadIdx.x == 0)
      for (int k = max(n - 2, 0); k < n; ++k)
        mbar_wait(&bar[k & 1], (k >> 1) & 1);
  }
};

// The shared memory of a split kernel: the tile's rays, the block's NT / 32
// partials and the ring's two mbarriers (static); the rows' slots (one for
// the stage, two for the ring) and then the heap of entries (dynamic).
template <int NT>
struct SplitShared {
  TileRays ray;
  uint64_t bar[2];
  int red[NT / 32];
};

template <int NT, bool RING>
using Feed = typename std::conditional<RING, RingFeed, StageFeed<NT>>::type;

template <bool RING>
__host__ __device__ constexpr int feed_slots() { return RING ? 2 : 1; }

template <int NT, bool RING>
__device__ __forceinline__ Feed<NT, RING> make_feed(float4* s_dyn,
                                                    uint64_t* bar) {
  Feed<NT, RING> f;
  f.slot = s_dyn;
  if constexpr (RING) f.bar = bar;
  return f;
}

__device__ __forceinline__ void write_closest(int i, float best_t, int best_i,
                                              float best_u, float best_v,
                                              float* t_out, int* tri_out,
                                              float* u_out, float* v_out) {
  t_out[i] = best_i >= 0 ? best_t : CUDART_INF_F;
  tri_out[i] = best_i;
  // + 0 maps a -0 barycentric to +0, as the reference's masked sum does
  u_out[i] = __fadd_rn(best_u, 0.0f);
  v_out[i] = __fadd_rn(best_v, 0.0f);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Whether an entry point's (p threads a ray, ring) names the split form
// (P, RING) that it was built with.
template <int P, bool RING>
inline bool is_form(int p, int ring) {
  return p == P && (ring != 0) == RING;
}

// Launches `kernel` as `blocks` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory on `stream`; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_threads(Kernel kernel, int blocks, int threads, size_t smem,
                   void* stream, Args... args) {
  if (const int err = set_smem(kernel, smem)) return err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The same with TILE threads a block.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, size_t smem, void* stream,
           Args... args) {
  return launch_threads(kernel, blocks, TILE, smem, stream, args...);
}

}  // namespace walk
}  // namespace rl
