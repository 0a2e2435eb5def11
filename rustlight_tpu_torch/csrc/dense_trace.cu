// Dense ray-triangle intersection for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernels rustlight_tpu/ops/pallas_trace.py:_trace_kernel
// (closest hit) and :_anyhit_kernel (any hit), and their XLA form
// rustlight_tpu/accel/dense.py:_intersect_impl.
//
// The ray-triangle test (tri_test.cuh) is the one the walk kernels use.
// Closest hit keeps the smallest t, the lowest index on a tie (strict less
// over ascending triangles), and reports t = inf, idx = -1 on a miss. Any
// hit stops at the first valid triangle.
//
// Design: one thread per ray; the block stages the rows in shared memory,
// TRI_CHUNK triangles at a time, and every thread loops over them in order.
// At the Cornell box's 40 triangles the kernel is bound by launch latency
// and by the per-ray state it reads and writes (about 48 bytes a ray), not
// by arithmetic; at the dense tier's ceiling of 1024 triangles it becomes
// bound by FP32 issue. Rays with !(tnear < tfar), such as the inert lanes
// (tfar = 0) the integrator hands in for dead paths, cannot hit and skip
// the loop; a block whose rays are all inert skips the staging too.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri_test.cuh"

namespace {

using rl::Ray;
using rl::load_ray;
using rl::test_tri;

constexpr int BLOCK = 256;
constexpr int TRI_CHUNK = 512;  // 512 * 48 B = 24 KB of shared memory

__global__ void __launch_bounds__(BLOCK)
dense_closest_kernel(const float4* __restrict__ rows, int n_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar, int n,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 s_rows[3 * TRI_CHUNK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Ray ray = {};
  bool live = false;
  if (i < n) {
    ray = load_ray(i, o, d, tnear, tfar);
    live = ray.tnear < ray.tfar;
  }
  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += TRI_CHUNK) {
      const int cnt = min(TRI_CHUNK, n_tris - base);
      __syncthreads();
      for (int k = threadIdx.x; k < 3 * cnt; k += BLOCK)
        s_rows[k] = rows[3 * base + k];
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (test_tri(&s_rows[3 * j], ray, ray.tfar, t, u, v) && t < best_t) {
          best_t = t;
          best_i = base + j;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  if (i < n) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
    // + 0 maps a -0 barycentric to +0, as the reference's masked sum does
    u_out[i] = __fadd_rn(best_u, 0.0f);
    v_out[i] = __fadd_rn(best_v, 0.0f);
  }
}

__global__ void __launch_bounds__(BLOCK)
dense_anyhit_kernel(const float4* __restrict__ rows, int n_tris,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tnear,
                    const float* __restrict__ tfar, int n,
                    bool* __restrict__ occ_out) {
  __shared__ float4 s_rows[3 * TRI_CHUNK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Ray ray = {};
  bool live = false;
  if (i < n) {
    ray = load_ray(i, o, d, tnear, tfar);
    live = ray.tnear < ray.tfar;
  }
  bool occ = false;
  for (int base = 0; base < n_tris; base += TRI_CHUNK) {
    // the block leaves as soon as none of its rays still needs a test
    if (!__syncthreads_or(live && !occ)) break;
    const int cnt = min(TRI_CHUNK, n_tris - base);
    for (int k = threadIdx.x; k < 3 * cnt; k += BLOCK)
      s_rows[k] = rows[3 * base + k];
    __syncthreads();
    if (live && !occ) {
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (test_tri(&s_rows[3 * j], ray, ray.tfar, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
  }
  if (i < n) occ_out[i] = occ;
}

}  // namespace

extern "C" int rl_dense_closest(const void* rows, int n_tris, const void* o,
                                const void* d, const void* tnear,
                                const void* tfar, int n, void* t_out,
                                void* idx_out, void* u_out, void* v_out,
                                void* stream) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  dense_closest_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), n_tris, static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), n, static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_dense_anyhit(const void* rows, int n_tris, const void* o,
                               const void* d, const void* tnear,
                               const void* tfar, int n, void* occ_out,
                               void* stream) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  dense_anyhit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), n_tris, static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), n, static_cast<bool*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}
