// Pieces of the tile walk shared by the one-level kernels (walk_trace.cu,
// K3/K4 and their wide pop), the two-level kernels (walk_hier.cu, K5), the
// sub-tiled kernels (walk_sub.cu, K6) and the sparse-visit kernels
// (walk_sparse.cu, K7).
//
// A tile is TILE = 64 rays walked by one block of 64 threads, one thread per
// ray. Entries are packed: the float bits of a non-negative entry distance
// with the low mantissa bits replaced by an id (ID_BITS = 14 for clusters or
// supers, CHILD_BITS = 7 for the children of an opened super), +inf bits for
// no entry. Non-negative floats order as their int32 bits, so every pop is an
// int32 min. Arithmetic is IEEE f32 without contraction (__fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn) and min/max propagate NaN as
// torch.minimum/maximum do, so the kernels are bit-identical to the plain
// versions in ops/walk_trace.py and ops/walk_hier.py.
//
// A visit's triangle test has two forms, chosen by a template flag of
// visit_closest / visit_anyhit: the _dot4 form of tri_test.cuh, one thread a
// ray (the default, and the bit-identical one), and the tensor-core form of
// tri_test_mma.cuh, a warp for its 32 rays.
#pragma once

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

__device__ __forceinline__ int block_min(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // every thread has read red from the last reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < WARPS; ++w) r = min(r, red[w]);
  return r;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  return -block_min(-v, red);  // v >= 0: the bits of non-negative floats
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

__device__ __forceinline__ void load_tile(const Ray& ray, TileRays& s) {
  const int k = threadIdx.x;
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

// The packed entry of box `id` (id_mask = its id bits) at distance e.
__device__ __forceinline__ int pack_entry(float e, int id, int id_mask) {
  if (!isfinite(e)) return INF_BITS;
  // + 0 maps a -0 entry to +0, so its bits sort as the smallest
  const float z = __fadd_rn(fmaxf(e, 0.0f), 0.0f);
  return (__float_as_int(z) & ~id_mask) | id;
}

// s_ent[c] = packed tile entry of box c of [lo, hi] ([3, cp] f32; boxes at
// or past n_real are pads), capped by each ray's tfar.
__device__ inline void tile_entries(const float* __restrict__ lo,
                                    const float* __restrict__ hi, int cp,
                                    int n_real, const TileRays& r,
                                    int* s_ent) {
  for (int c = threadIdx.x; c < cp; c += TILE) {
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
// barrier; the caller puts a barrier between this pop and the next scan,
// which publishes the clear.
__device__ __forceinline__ int pop_min(int* s_ent, int n, int id_mask,
                                       int* red) {
  int m = INF_BITS;
  for (int c = threadIdx.x; c < n; c += TILE) m = min(m, s_ent[c]);
  m = block_min(m, red);
  if (threadIdx.x == 0 && m != INF_BITS) s_ent[m & id_mask] = INF_BITS;
  return m;
}

// Stages cluster csel's rows if any thread of the block wants them;
// returns whether it did. The first barrier also ends the last visit.
__device__ __forceinline__ bool stage(const float4* __restrict__ rows,
                                      int csel, bool want, float4* s_rows) {
  if (!__syncthreads_or(want)) return false;
  const float4* src = rows + static_cast<size_t>(csel) * (3 * KC);
  for (int k = threadIdx.x; k < 3 * KC; k += TILE) s_rows[k] = src[k];
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

// Launches `kernel` as `blocks` blocks of TILE threads with `smem` bytes of
// dynamic shared memory on `stream`; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, size_t smem, void* stream,
           Args... args) {
  if (const int err = set_smem(kernel, smem)) return err;
  kernel<<<blocks, TILE, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace walk
}  // namespace rl
