// Sub-tiled tile walk for Hopper (sm_90a): closest hit and any hit over
// clustered walk tables, each 64-ray tile walked as SUB independent groups.
//
// Replaces the TPU kernels
// rustlight_tpu/accel/pallas_walk.py:_closest_kernel_sub and
// :_anyhit_kernel_sub (K6). Tables and rays are those of walk_trace.cu; the
// tables have at most 640 clusters (the reference's resident tables).
//
// The schedule is the reference's: the tile's 64 rays split into SUB (2, 4
// or 8) contiguous groups of GS = 64 / SUB rays; the entry pass gives each
// group its own packed entries (the minimum over the group's rays only,
// heap s * Cp of SUB * Cp * 4 B of dynamic shared memory); each group pops
// front to back, visits two clusters per termination check, and stops when
// its popped entry reaches the largest best t among its own rays, or after
// Cp pairs. Nothing one group does changes another's result. The reference
// runs the groups one after another; here they run side by side: one block
// of 64 threads per tile, one thread per ray, a group being GS adjacent
// lanes of a warp (the whole warp at SUB = 2). A warp runs its groups in
// lockstep: every pop and threshold is a shuffle reduction over the GS lanes
// of a group (xor offsets below GS stay inside it), executed by the whole
// warp, and a group that has stopped keeps its state and skips its visits
// until the warp's last group stops. The two warps of a block never meet
// after the entry pass.
//
// Groups of one warp visit different clusters at the same time, so a visit
// does not stage: each thread reads its cluster's rows straight from the
// table (all lanes of a group read the same address, one transaction per
// group), through L1 and L2, which hold the 6.3 MB of rows of a 131k-
// triangle scene. Without the 18 KB stage a block needs only its heaps and
// the tile's rays, so many blocks share an SM.
//
// Arithmetic is IEEE f32 without contraction and min/max propagate NaN as
// torch.minimum/maximum do (walk_common.cuh), so the results are
// bit-identical to the plain version in ops/walk_sub.py, which is the
// one-level walk at a tile of GS rays.
//
// With MMA a visit takes the tensor-core form of the triangle test
// (tri_test_mma.cuh, not bit-identical): mma.sync is warp-collective, so the
// whole warp scans whenever one of its groups has a ray that wants the
// visit, each group against its own cluster's rows, read from the table.
// A group of 32 lanes is the warp (one cluster, as the tile walk's scan); a
// group of 16 is an m16 row block, which takes the B fragments of its own
// cluster, so the mma.sync count is the same; a group of 8 is half a row
// block, which runs once per cluster of its two groups (twice the products)
// unless both groups visit the same one. Lanes of a stopped group, rays
// with tnear >= best t and occluded rays enter the scan with a cap of -inf,
// and a slot of 8 rays with no cap skips its products.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a SUB it was not built for.

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using namespace rl::walk;
using rl::Ray;
using rl::load_ray;

constexpr unsigned FULL = 0xffffffffu;

template <int GS>
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// s_ent[s * cp + c] = packed entry of cluster c for group s: the minimum
// over rays s * GS .. s * GS + GS - 1 of the slab entry, capped by tfar.
template <int SUB>
__device__ inline void group_entries(const float* __restrict__ lo,
                                     const float* __restrict__ hi, int cp,
                                     int n_real, const TileRays& r,
                                     int* s_ent) {
  constexpr int GS = TILE / SUB;
  for (int c = threadIdx.x; c < cp; c += TILE) {
    const bool real = c < n_real;
    float l[3] = {0.0f, 0.0f, 0.0f}, h[3] = {0.0f, 0.0f, 0.0f};
    if (real) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        l[ax] = lo[ax * cp + c];
        h[ax] = hi[ax * cp + c];
      }
    }
#pragma unroll 1
    for (int s = 0; s < SUB; ++s) {
      float e = CUDART_INF_F;
      for (int j = s * GS; real && j < (s + 1) * GS; ++j) {
        float entry;
        if (slab_entry(l, h, r, j, r.tfar[j], entry)) e = fminf(e, entry);
      }
      s_ent[s * cp + c] = pack_entry(e, c, ID_MASK);
    }
  }
}

// The group's pop: its GS lanes scan its heap, reduce, and its first lane
// clears the popped slot. Groups that have stopped (`active` false, uniform
// over a group) take part in the shuffles only and return INF_BITS. The
// __syncwarp publishes the clear to the group's next scan.
template <int GS>
__device__ __forceinline__ int group_pop(int* heap, int cp, bool active) {
  const int gl = threadIdx.x & (GS - 1);
  int m = INF_BITS;
  if (active)
    for (int c = gl; c < cp; c += GS) m = min(m, heap[c]);
  m = group_min<GS>(m);
  if (active && gl == 0 && m != INF_BITS) heap[m & ID_MASK] = INF_BITS;
  __syncwarp();
  return m;
}

template <int SUB, bool MMA>
__global__ void __launch_bounds__(TILE)
walk_sub_closest_kernel(const float* __restrict__ lo,
                        const float* __restrict__ hi, int cp, int n_real,
                        const float4* __restrict__ rows,
                        const int* __restrict__ ids,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int GS = TILE / SUB;
  extern __shared__ int s_ent[];
  __shared__ TileRays s_ray;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s_ray);
  __syncthreads();
  group_entries<SUB>(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  int* heap = s_ent + (threadIdx.x / GS) * cp;
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int emin = group_pop<GS>(heap, cp, true);
  int thresh = -group_min<GS>(-__float_as_int(best_t));
  int nv = 0;
  bool active = (emin & ~ID_MASK) < thresh;
  while (__any_sync(FULL, active)) {
    for (int half = 0; half < 2; ++half) {
      const bool want = active && ray.tnear < best_t;
      const int csel = min(emin & ID_MASK, cp - 1);
      const float4* c_rows = rows + static_cast<size_t>(csel) * (3 * KC);
      if constexpr (MMA) {
        if (__any_sync(FULL, want)) {
          float t, u, v;
          int j;
          mma_scan_closest<GS>(reinterpret_cast<const float*>(c_rows), m,
                               want ? best_t : -CUDART_INF_F, t, j, u, v);
          if (j < KC) {
            best_t = t;
            best_i = ids[static_cast<size_t>(csel) * KC + j];
            best_u = u;
            best_v = v;
          }
        }
      } else if (want) {
        scan_closest(c_rows, ids, csel, ray, best_t, best_i, best_u, best_v);
      }
      const int m = group_pop<GS>(heap, cp, active);
      if (active) emin = m;
    }
    const int th = -group_min<GS>(-__float_as_int(best_t));
    if (active) {
      thresh = th;
      ++nv;
      active = nv < cp && (emin & ~ID_MASK) < thresh;
    }
  }
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
}

template <int SUB, bool MMA>
__global__ void __launch_bounds__(TILE)
walk_sub_anyhit_kernel(const float* __restrict__ lo,
                       const float* __restrict__ hi, int cp, int n_real,
                       const float4* __restrict__ rows,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar,
                       bool* __restrict__ occ_out) {
  constexpr int GS = TILE / SUB;
  extern __shared__ int s_ent[];
  __shared__ TileRays s_ray;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s_ray);
  __syncthreads();
  group_entries<SUB>(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  int* heap = s_ent + (threadIdx.x / GS) * cp;
  bool occ = false;
  int emin = group_pop<GS>(heap, cp, true);
  int thresh = -group_min<GS>(-__float_as_int(ray.tfar));
  int nv = 0;
  bool active = (emin & ~ID_MASK) < thresh;
  while (__any_sync(FULL, active)) {
    for (int half = 0; half < 2; ++half) {
      const bool want = active && !occ && ray.tnear < ray.tfar;
      const float4* c_rows =
          rows + static_cast<size_t>(min(emin & ID_MASK, cp - 1)) * (3 * KC);
      if constexpr (MMA) {
        if (__any_sync(FULL, want) &&
            mma_scan_anyhit<GS>(reinterpret_cast<const float*>(c_rows), m,
                                want ? ray.tfar : -CUDART_INF_F))
          occ = true;
      } else if (want && scan_anyhit(c_rows, ray)) {
        occ = true;
      }
      const int m = group_pop<GS>(heap, cp, active);
      if (active) emin = m;
    }
    const int th = -group_min<GS>(occ ? 0 : -__float_as_int(ray.tfar));
    if (active) {
      thresh = th;
      ++nv;
      active = nv < cp && (emin & ~ID_MASK) < thresh;
    }
  }
  occ_out[i] = occ;
}

template <int SUB>
int launch_closest(const void* lo, const void* hi, int cp, int n_real,
                   const void* rows, const void* ids, const void* o,
                   const void* d, const void* tnear, const void* tfar, int n,
                   int mma, void* t_out, void* tri_out, void* u_out,
                   void* v_out, void* stream) {
  return launch(
      mma ? walk_sub_closest_kernel<SUB, true>
          : walk_sub_closest_kernel<SUB, false>,
      n / TILE, static_cast<size_t>(SUB) * cp * sizeof(int), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
}

template <int SUB>
int launch_anyhit(const void* lo, const void* hi, int cp, int n_real,
                  const void* rows, const void* o, const void* d,
                  const void* tnear, const void* tfar, int n, int mma,
                  void* occ_out, void* stream) {
  return launch(
      mma ? walk_sub_anyhit_kernel<SUB, true>
          : walk_sub_anyhit_kernel<SUB, false>,
      n / TILE, static_cast<size_t>(SUB) * cp * sizeof(int), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<bool*>(occ_out));
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads); sub is 2, 4 or 8. mma != 0
// takes the tensor-core form of the triangle test.
extern "C" int rl_walk_sub_closest(int sub, const void* lo, const void* hi,
                                   int cp, int n_real, const void* rows,
                                   const void* ids, const void* o,
                                   const void* d, const void* tnear,
                                   const void* tfar, int n, int mma,
                                   void* t_out, void* tri_out, void* u_out,
                                   void* v_out, void* stream) {
  switch (sub) {
    case 2:
      return launch_closest<2>(lo, hi, cp, n_real, rows, ids, o, d, tnear,
                               tfar, n, mma, t_out, tri_out, u_out, v_out,
                               stream);
    case 4:
      return launch_closest<4>(lo, hi, cp, n_real, rows, ids, o, d, tnear,
                               tfar, n, mma, t_out, tri_out, u_out, v_out,
                               stream);
    case 8:
      return launch_closest<8>(lo, hi, cp, n_real, rows, ids, o, d, tnear,
                               tfar, n, mma, t_out, tri_out, u_out, v_out,
                               stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rl_walk_sub_anyhit(int sub, const void* lo, const void* hi,
                                  int cp, int n_real, const void* rows,
                                  const void* o, const void* d,
                                  const void* tnear, const void* tfar, int n,
                                  int mma, void* occ_out, void* stream) {
  switch (sub) {
    case 2:
      return launch_anyhit<2>(lo, hi, cp, n_real, rows, o, d, tnear, tfar, n,
                              mma, occ_out, stream);
    case 4:
      return launch_anyhit<4>(lo, hi, cp, n_real, rows, o, d, tnear, tfar, n,
                              mma, occ_out, stream);
    case 8:
      return launch_anyhit<8>(lo, hi, cp, n_real, rows, o, d, tnear, tfar, n,
                              mma, occ_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
