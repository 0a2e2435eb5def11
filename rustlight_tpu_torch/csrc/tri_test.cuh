// The Baldwin-Weber ray-triangle test shared by the dense and walk kernels.
//
// Each triangle is three rows [N4 | U4 | V4] (three float4, 48 bytes). For a
// ray (o, d) with o4 = [o, 1], d4 = [d, 0]:
//   No = o4.N, Nd = d4.N, t = -No / Nd, u = o4.U + t * d4.U, v likewise;
// the hit is valid when |Nd| > 1e-20, tnear < t < tcap, u >= 0, v >= 0 and
// u + v <= 1.
//
// The dot products sum in the reference's _dot4 order,
// ((x0*r0 + x1*r1) + x2*r2) + x3*r3, with __fmul_rn/__fadd_rn so that no
// FMA contraction happens, and t uses IEEE division: the results are
// bit-identical to the plain PyTorch versions in ops/dense_trace.py and
// ops/walk_trace.py.
#pragma once

#include <cuda_runtime.h>

namespace rl {

struct Ray {
  float ox, oy, oz, dx, dy, dz, tnear, tfar;
};

__device__ __forceinline__ Ray load_ray(int i, const float* o, const float* d,
                                        const float* tnear,
                                        const float* tfar) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.tnear = tnear[i];
  r.tfar = tfar[i];
  return r;
}

__device__ __forceinline__ float dot4_o(const float4 r, const Ray& ray) {
  float s = __fadd_rn(__fmul_rn(ray.ox, r.x), __fmul_rn(ray.oy, r.y));
  s = __fadd_rn(s, __fmul_rn(ray.oz, r.z));
  return __fadd_rn(s, __fmul_rn(1.0f, r.w));
}

__device__ __forceinline__ float dot4_d(const float4 r, const Ray& ray) {
  float s = __fadd_rn(__fmul_rn(ray.dx, r.x), __fmul_rn(ray.dy, r.y));
  s = __fadd_rn(s, __fmul_rn(ray.dz, r.z));
  return __fadd_rn(s, __fmul_rn(0.0f, r.w));
}

// The test of one triangle against t in (ray.tnear, tcap); returns whether
// it is a valid hit, with t, u, v set when it is.
__device__ __forceinline__ bool test_tri(const float4* rows, const Ray& ray,
                                         float tcap, float& t, float& u,
                                         float& v) {
  const float nd = dot4_d(rows[0], ray);
  if (!(fabsf(nd) > 1e-20f)) return false;
  t = __fdiv_rn(-dot4_o(rows[0], ray), nd);
  if (!(t > ray.tnear && t < tcap)) return false;
  u = __fadd_rn(dot4_o(rows[1], ray), __fmul_rn(t, dot4_d(rows[1], ray)));
  v = __fadd_rn(dot4_o(rows[2], ray), __fmul_rn(t, dot4_d(rows[2], ray)));
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
}

}  // namespace rl
