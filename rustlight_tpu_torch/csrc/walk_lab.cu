// The walk tier's laboratory kernels for Hopper (sm_90a): the instruments of
// the roofline tools (rustlight_tpu_torch/tools/perf/).
//
// Replaces the TPU kernels of rustlight_tpu's tools/perf/roofline.py:
// _closest_kernel_counted (:58, also called from tools/perf/tree_lab.py:80),
// _floor_kernel (:119) and _fma_kernel (:163).
//
//   - counted: the production closest-hit walk (the kernel template of
//     walk_flat.cuh, COUNT = true) with one more output, the tile's visit
//     count, 2 per loop iteration, written to every lane. Its hits are the
//     production kernel's, bit for bit.
//   - floor: the same visit (stage + scan + best update: visit_closest of
//     walk_common.cuh) under a free schedule: nv_total visits a tile with
//     csel = i % cp, no entry pass, no pops, no threshold. Its time is what
//     the visits cost when the traversal logic is free, so production /
//     floor is the schedule's overhead. Bit-identical to its plain version
//     in ops/walk_lab.py.
//   - fma_peak: two independent chains per element of a [64, 3 KC] f32
//     block, a = a * 1.000001 + 0.5 and b = b * 0.999999 + 0.25 from a = x,
//     b = x + 1, `iters` steps, y = a + b, with real fmaf: it measures the
//     card's f32 FMA rate on the visit's tile shape. Every block computes
//     the same block and block 0 writes it. A thread holds FMA_ELEMS = 8
//     elements, 16 independent chains, in registers at a time: an SM's four
//     schedulers each need 4 independent FMAs in flight to cover the
//     pipeline's latency, and 8 warps a block with 16 chains a thread give
//     every scheduler 32. The store also fires on a NaN sum, so no block's
//     chain can be dropped as unused.
//   - mma_products: the tensor-core form's two products (tri_test_mma.cuh)
//     for one tile of 64 rays and one cluster, written out as ao, ad
//     [64, 3 KC] (column b * KC + j: row kind b of triangle j): the probe
//     that checks the fragment layout and measures the split's accuracy.
//
// What bounds them: counted and floor, the ray-triangle tests, as the
// production walk (walk_trace.cu); fma_peak, the FMA pipes by construction.
// With mma set, counted and floor take the tensor-core visit.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "walk_flat.cuh"

namespace {

using namespace rl::walk;
using rl::Ray;
using rl::load_ray;

template <bool MMA>
__global__ void __launch_bounds__(TILE)
walk_floor_kernel(int cp, int nv_total, const float4* __restrict__ rows,
                  const int* __restrict__ ids, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ tnear,
                  const float* __restrict__ tfar, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out) {
  __shared__ float4 s_rows[3 * KC];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  for (int k = 0; k < nv_total; ++k)
    visit_closest<MMA>(rows, ids, k % cp, ray, s_rows, best_t, best_i, best_u,
                       best_v, m);
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
}

constexpr int FMA_THREADS = 256;
constexpr int FMA_ELEMS = 8;
constexpr int FMA_BLOCK = TILE * 3 * KC;   // elements of the [64, 3 KC] block

__global__ void __launch_bounds__(FMA_THREADS)
fma_peak_kernel(const float* __restrict__ x, int iters, float* __restrict__ y) {
  for (int base = threadIdx.x * FMA_ELEMS; base < FMA_BLOCK;
       base += FMA_THREADS * FMA_ELEMS) {
    float a[FMA_ELEMS], b[FMA_ELEMS];
#pragma unroll
    for (int e = 0; e < FMA_ELEMS; ++e) {
      a[e] = x[base + e];
      b[e] = __fadd_rn(a[e], 1.0f);
    }
    for (int k = 0; k < iters; ++k) {
#pragma unroll
      for (int e = 0; e < FMA_ELEMS; ++e) {
        a[e] = fmaf(a[e], 1.000001f, 0.5f);
        b[e] = fmaf(b[e], 0.999999f, 0.25f);
      }
    }
#pragma unroll
    for (int e = 0; e < FMA_ELEMS; ++e) {
      const float sum = __fadd_rn(a[e], b[e]);
      if (blockIdx.x == 0 || isnan(sum)) y[base + e] = sum;
    }
  }
}

// One block of TILE threads: rows [KC][3] float4 of one cluster, rays o, d
// [64, 3]; ao, ad [64, 3 KC].
__global__ void __launch_bounds__(TILE)
mma_products_kernel(const float4* __restrict__ rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    float* __restrict__ ao, float* __restrict__ ad) {
  __shared__ float4 s_rows[3 * KC];
  for (int k = threadIdx.x; k < 3 * KC; k += TILE) s_rows[k] = rows[k];
  __syncthreads();
  const int i = threadIdx.x;
  const Ray ray = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                   d[3 * i], d[3 * i + 1], d[3 * i + 2], 0.0f, 0.0f};
  const MmaRays m = mma_rays(ray);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const float* f = reinterpret_cast<const float*>(s_rows);
  for (int j0 = 0; j0 < KC; j0 += 8) {
    const MmaCols cols = mma_cols(f, j0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[6][4];
      mma_products(m, mt, cols, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 32 * warp + 16 * mt + 8 * (e >> 1) + g;
        const int j = j0 + 2 * q + (e & 1);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          ao[r * (3 * KC) + b * KC + j] = acc[2 * b][e];
          ad[r * (3 * KC) + b * KC + j] = acc[2 * b + 1][e];
        }
      }
    }
  }
}

}  // namespace

// The production closest-hit walk with the per-tile visit count in nv_out
// [n] int32. n must be a multiple of 64.
extern "C" int rl_walk_closest_counted(
    const void* lo, const void* hi, int cp, int n_real, const void* rows,
    const void* ids, const void* o, const void* d, const void* tnear,
    const void* tfar, int n, int mma, void* t_out, void* tri_out, void* u_out,
    void* v_out, void* nv_out, void* stream) {
  return launch(
      mma ? walk_closest_kernel<true, true> : walk_closest_kernel<false, true>,
      n / TILE, static_cast<size_t>(cp) * sizeof(int), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(nv_out));
}

extern "C" int rl_walk_floor(int cp, int nv_total, const void* rows,
                             const void* ids, const void* o, const void* d,
                             const void* tnear, const void* tfar, int n,
                             int mma, void* t_out, void* tri_out, void* u_out,
                             void* v_out, void* stream) {
  return launch(
      mma ? walk_floor_kernel<true> : walk_floor_kernel<false>, n / TILE, 0,
      stream, cp, nv_total, static_cast<const float4*>(rows),
      static_cast<const int*>(ids), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
}

// x, y: [64, 3 KC] f32.
extern "C" int rl_fma_peak(const void* x, int iters, int blocks, void* y,
                           void* stream) {
  fma_peak_kernel<<<blocks, FMA_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), iters, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_mma_products(const void* rows, const void* o, const void* d,
                               void* ao, void* ad, void* stream) {
  mma_products_kernel<<<1, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<float*>(ao),
      static_cast<float*>(ad));
  return static_cast<int>(cudaGetLastError());
}
