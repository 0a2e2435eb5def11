// Ray-cluster pair intersection for Hopper (sm_90a): each pair's closest hit
// and any hit inside its one cluster.
//
// Replaces the TPU kernels
// rustlight_tpu/accel/pair_walk.py:_pair_closest_kernel and
// :_pair_anyhit_kernel (K8). A pair is a ray (o, d, tnear, tcap) and a
// cluster id into the walk tables of walk_trace.cu (rows [Cp*KC, 3, 4] f32,
// ids [Cp*KC] i32). Each pair gets the ray's closest hit among the
// cluster's KC = 384 triangles with t in (tnear, tcap), the lowest column
// among equal t; or whether there is any such hit. Pairs whose id lies
// outside [0, n_real) are inert: t = inf, tri = -1, not occluded.
//
// The reference walks a tile of 64 pairs through the tile's distinct cluster
// ids in ascending order, testing all 64 rays against each and keeping the
// result only where the id matches: that loop exists to share one row fetch
// among a tile's pairs on a machine whose only fast shape is [64, 3K]. A
// pair's result depends on nothing but its own ray, cluster and cap, so
// here a warp takes a pair: 32 lanes x 12 triangles, lane l testing columns
// l, l + 32, ... straight from the table (L1/L2; the pairs arrive sorted, so
// neighbours share clusters), then one shuffle reduction over (t bits,
// column) picks the least t and, among equals, the lowest column, which is
// the serial scan's winner. t > tnear >= 0, so t orders as its bits. A
// block of 64 threads takes a tile of 64 pairs, each of its two warps 32 of
// them in turn; inert pairs cost one load.
//
// Arithmetic is IEEE f32 without contraction (tri_test.cuh), so the results
// are bit-identical to the plain versions in ops/pair_trace.py.
//
// The tensor-core form of the test (tri_test_mma.cuh, not bit-identical)
// needs the 16 rays of a fragment to share a cluster, which one pair a warp
// cannot give. A pair's result depends only on its own ray, cluster and
// cap, so the wrapper sorts the live pairs by cluster id and lays them out
// in runs of 32 of one cluster (perm: the original pair of each slot, -1
// for a pad); a warp (pair_mma_kernel) scans its 32 rays against its one
// cluster straight from the table and writes each result to its original
// pair. Inert pairs never enter: the wrapper fills their miss. (The
// reference's schedule, a 64-pair tile walking its distinct cluster ids
// with the other pairs' caps at -inf, took 2.6x as long at km = 8 on an
// H100: PERF.md section 6.)
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "walk_common.cuh"

namespace {

namespace w = rl::walk;

using rl::Ray;
using rl::load_ray;
using rl::test_tri;

constexpr int PAIR_TILE = 64;
constexpr int KC = 384;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PAIR_TILE)
pair_closest_kernel(int n_real, const float4* __restrict__ rows,
                    const int* __restrict__ ids, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tnear,
                    const float* __restrict__ tcap,
                    const int* __restrict__ cid, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * PAIR_TILE + (threadIdx.x >> 5) * 32;
  for (int p = first; p < first + 32; ++p) {
    const int c = cid[p];
    float bt = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
    int bi = -1;
    if (c >= 0 && c < n_real) {
      const Ray ray = load_ray(p, o, d, tnear, tcap);
      if (ray.tnear < ray.tfar) {
        const float4* c_rows = rows + static_cast<size_t>(c) * (3 * KC);
        float lt = ray.tfar, lu = 0.0f, lv = 0.0f;
        int lj = -1;
        for (int j = lane; j < KC; j += 32) {
          float t, u, v;
          if (test_tri(&c_rows[3 * j], ray, lt, t, u, v)) {
            lt = t; lj = j; lu = u; lv = v;
          }
        }
        unsigned long long key =
            lj >= 0 ? (static_cast<unsigned long long>(__float_as_uint(lt))
                       << 32) | static_cast<unsigned>(lj)
                    : ~0ull;
        for (int off = 16; off > 0; off >>= 1)
          key = min(key, __shfl_xor_sync(FULL, key, off));
        if (key != ~0ull) {
          const int j = static_cast<int>(key & 0xffffffffull);
          bt = __uint_as_float(static_cast<unsigned>(key >> 32));
          bu = __shfl_sync(FULL, lu, j & 31);   // column j is lane j % 32's
          bv = __shfl_sync(FULL, lv, j & 31);
          bi = ids[static_cast<size_t>(c) * KC + j];
        }
      }
    }
    if (lane == 0) {
      t_out[p] = bt;
      tri_out[p] = bi;
      // + 0 maps a -0 barycentric to +0, as the walk kernels' output does
      u_out[p] = __fadd_rn(bu, 0.0f);
      v_out[p] = __fadd_rn(bv, 0.0f);
    }
  }
}

__global__ void __launch_bounds__(PAIR_TILE)
pair_anyhit_kernel(int n_real, const float4* __restrict__ rows,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tnear,
                   const float* __restrict__ tfar,
                   const int* __restrict__ cid, bool* __restrict__ occ_out) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * PAIR_TILE + (threadIdx.x >> 5) * 32;
  for (int p = first; p < first + 32; ++p) {
    const int c = cid[p];
    bool occ = false;
    if (c >= 0 && c < n_real) {
      const Ray ray = load_ray(p, o, d, tnear, tfar);
      if (ray.tnear < ray.tfar) {
        const float4* c_rows = rows + static_cast<size_t>(c) * (3 * KC);
        bool hit = false;
        for (int j = lane; j < KC && !hit; j += 32) {
          float t, u, v;
          hit = test_tri(&c_rows[3 * j], ray, ray.tfar, t, u, v);
        }
        occ = __any_sync(FULL, hit);
      }
    }
    if (lane == 0) occ_out[p] = occ;
  }
}

// The sorted schedule: slot k of the layout is pair perm[k] (-1: a pad);
// the 32 slots of a warp hold pairs of one cluster, the first a real pair
// unless the whole warp is padding.
template <bool ANY>
__global__ void __launch_bounds__(PAIR_TILE)
pair_mma_kernel(const float4* __restrict__ rows, const int* __restrict__ ids,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tnear,
                const float* __restrict__ tcap, const int* __restrict__ cid,
                const int* __restrict__ perm, float* __restrict__ t_out,
                int* __restrict__ tri_out, float* __restrict__ u_out,
                float* __restrict__ v_out, bool* __restrict__ occ_out) {
  const int p = perm[blockIdx.x * PAIR_TILE + threadIdx.x];
  const int lead = __shfl_sync(FULL, p, 0);
  if (lead < 0) return;                  // warp-uniform: padding only
  const int c = cid[lead];
  const Ray ray = load_ray(p >= 0 ? p : lead, o, d, tnear, tcap);
  const bool want = p >= 0 && ray.tnear < ray.tfar;
  const w::MmaRays m = w::mma_rays(ray);
  if (!__any_sync(FULL, want)) return;  // the wrapper filled the misses
  const float* c_rows =
      reinterpret_cast<const float*>(rows + static_cast<size_t>(c) * (3 * KC));
  const float cap = want ? ray.tfar : -CUDART_INF_F;
  if constexpr (ANY) {
    const bool occ = w::mma_scan_anyhit<32>(c_rows, m, cap);
    if (p >= 0) occ_out[p] = occ;
  } else {
    float t, u, v;
    int j;
    w::mma_scan_closest<32>(c_rows, m, cap, t, j, u, v);
    if (p >= 0 && j < KC) {
      t_out[p] = t;
      tri_out[p] = ids[static_cast<size_t>(c) * KC + j];
      // + 0 maps a -0 barycentric to +0, as the walk kernels' output does
      u_out[p] = __fadd_rn(u, 0.0f);
      v_out[p] = __fadd_rn(v, 0.0f);
    }
  }
}

}  // namespace

// m must be a multiple of 64 (the caller pads with inert pairs).
extern "C" int rl_pair_closest(int n_real, const void* rows, const void* ids,
                               const void* o, const void* d,
                               const void* tnear, const void* tcap,
                               const void* cid, int m, void* t_out,
                               void* tri_out, void* u_out, void* v_out,
                               void* stream) {
  pair_closest_kernel<<<m / PAIR_TILE, PAIR_TILE, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n_real, static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tcap),
      static_cast<const int*>(cid), static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_pair_anyhit(int n_real, const void* rows, const void* o,
                              const void* d, const void* tnear,
                              const void* tfar, const void* cid, int m,
                              void* occ_out, void* stream) {
  pair_anyhit_kernel<<<m / PAIR_TILE, PAIR_TILE, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n_real, static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<const int*>(cid),
      static_cast<bool*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core form over the layout perm of n_slots slots (a multiple of
// 64; see pair_mma_kernel); writes the live pairs only. any_hit picks the
// outputs: occ_out, or t/tri/u/v_out.
extern "C" int rl_pair_mma(int any_hit, const void* rows, const void* ids,
                           const void* o, const void* d, const void* tnear,
                           const void* tcap, const void* cid,
                           const void* perm, int n_slots, void* t_out,
                           void* tri_out, void* u_out, void* v_out,
                           void* occ_out, void* stream) {
  const auto k = any_hit ? pair_mma_kernel<true> : pair_mma_kernel<false>;
  k<<<n_slots / PAIR_TILE, PAIR_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tcap),
      static_cast<const int*>(cid), static_cast<const int*>(perm),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<bool*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}
