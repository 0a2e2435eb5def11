// The one-level closest-hit tile walk (K3/K4) as kernel templates, shared
// by walk_trace.cu (the production kernels) and walk_lab.cu (the counted
// kernel of the roofline tools). The schedule is described in walk_trace.cu.
//
// walk_closest_kernel: one thread a ray, the visit's rows staged at the
// visit. MMA: the tensor-core form of the visit's triangle test
// (tri_test_mma.cuh). walk_closest_split_kernel: P threads a ray (the split
// visit of walk_common.cuh, of either test) and, with RING, the ring of
// cluster rows filled one visit ahead (built as CLOSEST_P and CLOSEST_RING
// below, for both tests). COUNT: also
// write the tile's visit count, 2 per loop iteration, to every lane of
// nv_out (rustlight_tpu/tools/perf/roofline.py: _closest_kernel_counted);
// nv_out is not read otherwise.
#pragma once

#include "walk_common.cuh"

namespace rl {
namespace walk {

// The split forms of the one-level walk that this library builds (P threads
// a ray, RING): the faster on an H100 on the main path's wavefronts (PERF.md
// section 6), as ops/walk_trace.py:PRODUCTION_FORMS names them. The
// closest-hit form also serves the counted and floor walks of walk_lab.cu.
constexpr int CLOSEST_P = 8;
constexpr bool CLOSEST_RING = false;
constexpr int ANYHIT_P = 8;
constexpr bool ANYHIT_RING = true;

__device__ __forceinline__ int cluster_of(int bits, int cp) {
  return min(bits & ID_MASK, cp - 1);
}

template <bool MMA, bool COUNT>
__global__ void __launch_bounds__(TILE)
walk_closest_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                    int cp, int n_real, const float4* __restrict__ rows,
                    const int* __restrict__ ids, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tnear,
                    const float* __restrict__ tfar,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int* __restrict__ nv_out) {
  extern __shared__ int s_ent[];
  __shared__ float4 s_rows[3 * KC];
  __shared__ TileRays s_ray;
  __shared__ int s_red[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s_ray);
  __syncthreads();
  tile_entries(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  // best_t starts at tfar and only decreases: it is the t cap
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int emin = pop_min(s_ent, cp, ID_MASK, s_red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(best_t), s_red);
  int nv = 0;
  for (; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      visit_closest<MMA>(rows, ids, csel, ray, s_rows, best_t, best_i, best_u,
                         best_v, m);
      emin = pop_min(s_ent, cp, ID_MASK, s_red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(__float_as_int(best_t), s_red);
  }
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
  if constexpr (COUNT) nv_out[i] = 2 * nv;
}

// P threads a ray, NT = P x TILE threads a block. Dynamic shared memory:
// the feed's slots (feed_slots<RING>() x 3 x KC float4), with MMA the split
// tensor-core visit's caps and partials (mma_scratch_f4<NT>() float4), then
// the heap of Cp entries. Every cluster is popped a visit ahead and handed
// to the feed (the ring starts its copy then); the visit order, the stop
// test and the results are walk_closest_kernel's. MMA: the visit is the
// tensor-core test split over the P warps of each 32-ray set by columns
// (walk_common.cuh: split_mma), bit for bit walk_closest_kernel<true, ·>'s.
template <bool COUNT, int P, bool RING, bool MMA = false>
__global__ void __launch_bounds__(P * TILE)
walk_closest_split_kernel(const float* __restrict__ lo,
                          const float* __restrict__ hi, int cp, int n_real,
                          const float4* __restrict__ rows,
                          const int* __restrict__ ids,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tnear,
                          const float* __restrict__ tfar,
                          float* __restrict__ t_out, int* __restrict__ tri_out,
                          float* __restrict__ u_out, float* __restrict__ v_out,
                          int* __restrict__ nv_out) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ SplitShared<NT> s;
  float4* s_mma = s_dyn + feed_slots<RING>() * 3 * KC;
  const MmaScratch mx = mma_scratch(s_mma);
  int* s_ent =
      reinterpret_cast<int*>(s_mma + (MMA ? mma_scratch_f4<NT>() : 0));
  auto feed = make_feed<NT, RING>(s_dyn, s.bar);
  feed.init();
  const int i = blockIdx.x * TILE + threadIdx.x / P;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile<P>(ray, s.ray);
  __syncthreads();
  tile_entries<NT>(lo, hi, cp, n_real, s.ray, s_ent);
  __syncthreads();

  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int emin = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
  int csel = cluster_of(emin, cp);
  feed.prefetch(rows, csel);
  int enext = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
  int cnext = cluster_of(enext, cp);
  int thresh = block_max<NT>(__float_as_int(best_t), s.red);
  int nv = 0;
  for (; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      feed.prefetch(rows, cnext);
      const bool want = ray.tnear < best_t;
      if constexpr (MMA) {
        put_cap<P>(mx, want, best_t);
        if (const float4* c_rows = feed.take_all(rows, csel, want)) {
          float t, u, v;
          int j;
          split_mma<P, 32, false>(reinterpret_cast<const float*>(c_rows),
                                  set_rays<P>(o, d, tnear), mx, BlockSync{},
                                  t, j, u, v);
          if (j < KC) {
            best_t = t;
            best_i = ids[static_cast<size_t>(csel) * KC + j];
            best_u = u;
            best_v = v;
          }
        }
      } else if (const float4* c_rows = feed.take(rows, csel, want)) {
        split_closest<P>(c_rows, ids, csel, ray, want, best_t, best_i, best_u,
                         best_v);
      }
      emin = enext;
      csel = cnext;
      enext = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
      cnext = cluster_of(enext, cp);
    }
    thresh = block_max<NT>(__float_as_int(best_t), s.red);
  }
  feed.drain();
  if (threadIdx.x % P) return;
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
  if constexpr (COUNT) nv_out[i] = 2 * nv;
}

}  // namespace walk
}  // namespace rl
