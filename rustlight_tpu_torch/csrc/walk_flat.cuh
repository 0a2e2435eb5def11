// The one-level closest-hit tile walk (K3/K4) as a kernel template, shared
// by walk_trace.cu (the production kernel) and walk_lab.cu (the counted
// kernel of the roofline tools). The schedule is described in walk_trace.cu.
//
// MMA: the tensor-core form of the visit's triangle test (tri_test_mma.cuh).
// COUNT: also write the tile's visit count, 2 per loop iteration, to every
// lane of nv_out (rustlight_tpu/tools/perf/roofline.py:
// _closest_kernel_counted); nv_out is not read otherwise.
#pragma once

#include "walk_common.cuh"

namespace rl {
namespace walk {

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

}  // namespace walk
}  // namespace rl
