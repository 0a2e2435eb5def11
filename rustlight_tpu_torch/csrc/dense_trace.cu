// Dense ray-triangle intersection for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernels rustlight_tpu/ops/pallas_trace.py:_trace_kernel
// (closest hit) and :_anyhit_kernel (any hit), and their XLA form
// rustlight_tpu/accel/dense.py:_intersect_impl.
//
// Every ray is tested against every triangle's Baldwin-Weber rows with the
// arithmetic of tri_test.cuh (no FMA contraction, IEEE division), so the
// results are bit-identical to the plain versions in ops/dense_trace.py.
// Closest hit keeps the smallest t, the lowest index on a tie, and reports
// t = inf, idx = -1 on a miss. Any hit reports whether any triangle is hit.
//
// What bounds it: FP32 issue. A full test is some 45 unfused FP32
// operations (the kernels must round as the plain versions do, so no
// FMA), one issue slot each, and a warp pays every path that any of its
// lanes takes; the bytes (48 a ray) weigh only at a few triangles, where
// the launch, the ray loads and the staging of the rows do too. The design
// takes work off the paths that coherent wavefronts share:
//  - the best hit as the cap: the closest hit tests t against
//    min(tfar, best t), so a triangle behind the current best hit skips
//    its barycentrics (strict less over ascending indices still keeps the
//    lowest index on a tie);
//  - exact rejects before the division (any hit, rays with tnear >= 0):
//    a triangle whose t would be <= 0, or >= tfar, is dropped after its
//    two dot products (keep()). In the closest hit they cost more on
//    divergent rays than they save, and are left out;
//  - no + 0 * w: the d sums' last term is +-0 for a finite w and NaN
//    otherwise; stage() gives a triangle with a non-finite w a NaN N row,
//    and the tests leave the term out (six operations a full test);
//  - one ray a thread, 256 threads, the triangle loop unrolled by 4 for
//    independent work; the rows staged in shared memory once per block,
//    TRI_CHUNK triangles at a time. A block whose rays are all inert
//    (!(tnear < tfar), as the integrator hands in for dead paths) skips
//    the staging, and the any hit leaves as soon as none of its rays needs
//    a test.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri_test.cuh"

namespace {

using rl::Ray;
using rl::load_ray;

constexpr int BLOCK = 256;
constexpr int TRI_CHUNK = 512;  // 512 * 48 B = 24 KB of shared memory

// 1 + 2^-22: covers the two roundings of keep()'s magnitude test
constexpr float MAG_MARGIN = 1.0f + 1.0f / 4194304.0f;
// below this cap the magnitude test is skipped (mag_cap)
constexpr float MAG_MIN_CAP = 1.0f / 288230376151711744.0f;  // 2^-58

// The cap that keep()'s magnitude test multiplies by |Nd|: RN(cap * M),
// with M = MAG_MARGIN, for a ray with tnear >= 0; +inf (no magnitude
// test) for a ray with tnear < 0 or a cap below 2^-58.
__device__ __forceinline__ float mag_cap(float cap, bool pos) {
  return pos && cap >= MAG_MIN_CAP ? __fmul_rn(cap, MAG_MARGIN)
                                   : CUDART_INF_F;
}

// Whether a test may be a valid hit, given No, Nd, the ray's lo (0 if
// tnear >= 0, else -inf) and capm (mag_cap of tfar). With s = -no with its
// sign flipped where nd < 0, t = RN(-no / nd) = RN(s / |nd|); the test is
// dropped unless |nd| > 1e-20 (the plain test itself) and lo < s < p,
// p = RN(|nd| * capm). Each drop is exact:
//  - s <= lo = 0 (s = +-0, or -no and nd of opposite signs): t <= 0 or
//    t = -0, and t > tnear >= 0 fails. A NaN s never passes; its t is NaN.
//    With lo = -inf only s = -inf or NaN is dropped: t = -inf or NaN.
//  - s >= p: with u = 2^-24 and cap >= 2^-58, capm = RN(cap M) >=
//    cap M (1 - u), and since |nd| > 1e-20 > 2^-67 the product |nd| capm
//    exceeds 2^-125, in the normal range, so p >= |nd| capm (1 - u) >=
//    |nd| cap M (1 - u)^2 >= |nd| cap, as M = 1 + 4u > 1 / (1 - u)^2.
//    So s / |nd| >= cap and, RN being monotone and cap a float,
//    t >= cap: t < cap fails. Where capm or p is +inf (cap = inf, an
//    overflowing product, or no magnitude test) only s = +inf is dropped,
//    whose t is +inf or NaN.
__device__ __forceinline__ bool keep(float no, float nd, float lo,
                                     float capm) {
  const float s = __uint_as_float(__float_as_uint(no) ^
                                  (~__float_as_uint(nd) & 0x80000000u));
  return (fabsf(nd) > 1e-20f) & (s > lo) & (s < __fmul_rn(fabsf(nd), capm));
}

// Stage triangles [base, base + cnt) into shared memory (the caller
// syncs). tri_test.cuh's sums end in + 0 * w for the d terms: +-0 where w
// is finite, which leaves the sum as it is but for the sign of a zero (a
// zero Nd fails |Nd| > 1e-20, and a zero Ud or Vd changes neither the
// tests nor the +0-folded output), and NaN where it is not, which no hit
// survives. So a triangle with a non-finite w gets a NaN N row (no ray
// hits it) and the kernels leave the + 0 * w out.
__device__ __forceinline__ void stage(float4* s_rows, const float4* rows,
                                      int base, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += BLOCK) {
    float4 n = rows[3 * (base + k)];
    const float4 u = rows[3 * (base + k) + 1], v = rows[3 * (base + k) + 2];
    if (!(isfinite(n.w) && isfinite(u.w) && isfinite(v.w)))
      n = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    s_rows[3 * k] = n;
    s_rows[3 * k + 1] = u;
    s_rows[3 * k + 2] = v;
  }
}

// ((x * r.x + y * r.y) + z * r.z) + w, unfused.
__device__ __forceinline__ float dot3w(const float4 r, float x, float y,
                                       float z, float w) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, r.x), __fmul_rn(y, r.y)),
                __fmul_rn(z, r.z)),
      w);
}

// ((x * r.x + y * r.y) + z * r.z), unfused.
__device__ __forceinline__ float dot3(const float4 r, float x, float y,
                                      float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, r.x), __fmul_rn(y, r.y)),
                   __fmul_rn(z, r.z));
}

// One ray against one staged triangle: whether it is a valid hit in
// (ray.tnear, cap), with t, u, v set when it is; REJECT: keep() before the
// division (lo, capm as it takes them), else only |Nd| > 1e-20.
template <bool REJECT>
__device__ __forceinline__ bool test(const float4* row, const Ray& ray,
                                     float lo, float cap, float capm,
                                     float& t, float& u, float& v) {
  const float4 n = row[0];
  const float nd = dot3(n, ray.dx, ray.dy, ray.dz);
  const float no = dot3w(n, ray.ox, ray.oy, ray.oz, n.w);
  if (REJECT ? !keep(no, nd, lo, capm) : !(fabsf(nd) > 1e-20f)) return false;
  t = __fdiv_rn(-no, nd);
  if (!(t > ray.tnear && t < cap)) return false;
  const float4 r1 = row[1], r2 = row[2];
  u = __fadd_rn(dot3w(r1, ray.ox, ray.oy, ray.oz, r1.w),
                __fmul_rn(t, dot3(r1, ray.dx, ray.dy, ray.dz)));
  v = __fadd_rn(dot3w(r2, ray.ox, ray.oy, ray.oz, r2.w),
                __fmul_rn(t, dot3(r2, ray.dx, ray.dy, ray.dz)));
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
}

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
  float cap = ray.tfar;   // then the best hit's t
  float best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += TRI_CHUNK) {
      const int cnt = min(TRI_CHUNK, n_tris - base);
      __syncthreads();
      stage(s_rows, rows, base, cnt);
      __syncthreads();
      if (!live) continue;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (test<false>(&s_rows[3 * j], ray, 0.0f, cap, 0.0f, t, u, v)) {
          cap = t;
          best_i = base + j;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  if (i < n) {
    t_out[i] = best_i >= 0 ? cap : CUDART_INF_F;
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
  const bool pos = ray.tnear >= 0.0f;
  const float lo = pos ? 0.0f : -CUDART_INF_F;
  const float capm = mag_cap(ray.tfar, pos);
  bool occ = false;
  for (int base = 0; base < n_tris; base += TRI_CHUNK) {
    // the block leaves as soon as none of its rays still needs a test
    if (!__syncthreads_or(live && !occ)) break;
    const int cnt = min(TRI_CHUNK, n_tris - base);
    stage(s_rows, rows, base, cnt);
    __syncthreads();
    if (live && !occ) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (test<true>(&s_rows[3 * j], ray, lo, ray.tfar, capm, t, u, v)) {
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
