// The walk tier's laboratory kernels for Hopper (sm_90a): the instruments of
// the roofline tools (rustlight_tpu_torch/tools/perf/).
//
// Replaces the TPU kernels of rustlight_tpu's tools/perf/roofline.py:
// _closest_kernel_counted (:58, also called from tools/perf/tree_lab.py:80),
// _floor_kernel (:119) and _fma_kernel (:163).
//
//   - counted: the production closest-hit walk (the kernel templates of
//     walk_flat.cuh, COUNT = true, in the form the wrapper passes: the
//     split form by default, or one thread a ray) with one more output, the tile's
//     visit count, 2 per loop iteration, written to every lane. Its hits
//     are the production kernel's, bit for bit.
//   - floor: the same visit (walk_floor_kernel: stage + scan + best update,
//     visit_closest of walk_common.cuh; walk_floor_split_kernel: the split
//     visit at the closest-hit kernel's P threads a ray and feed) under a free
//     schedule: nv_total visits a tile with csel = i % cp, no entry pass,
//     no pops, no threshold. Its time is what the visits cost when the
//     traversal logic is free, so production / floor, at the same P and
//     feed, is the schedule's overhead. Bit-identical to its plain version
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
//   - the candidate forms of those products (form_products below; form 4
//     is tri_test_mma.cuh:mma_products itself, held to the probe above bit
//     for bit by the smoke run): mma_form_lanes gives ao and ad of row kind
//     N for n lanes, each against its own triangle (a warp's 32 lanes as
//     the 32 columns of its row blocks, the diagonal kept), so t = -ao / ad
//     of each lane's hit can be held to the _dot4 form's and to the exact
//     one; mma_form_visits times each form on `nvis` visits a tile (stage,
//     split, products, a sum of them): the instruments that chose the
//     production form.
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

// The floor at P threads a ray with the split visit and the feed of the
// production form (walk_common.cuh): cluster k % cp at visit k, the next
// one handed to the feed a visit ahead, a barrier after each visit (the
// production kernel's pops end a visit so).
template <int P, bool RING>
__global__ void __launch_bounds__(P * TILE)
walk_floor_split_kernel(int cp, int nv_total, const float4* __restrict__ rows,
                        const int* __restrict__ ids,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ uint64_t s_bar[2];
  const int i = blockIdx.x * TILE + threadIdx.x / P;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  auto feed = make_feed<NT, RING>(s_dyn, s_bar);
  feed.init();
  __syncthreads();
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  feed.prefetch(rows, 0);
  for (int k = 0; k < nv_total; ++k) {
    feed.prefetch(rows, (k + 1) % cp);
    const bool want = ray.tnear < best_t;
    if (const float4* c_rows = feed.take(rows, k % cp, want))
      split_closest<P>(c_rows, ids, k % cp, ray, want, best_t, best_i, best_u,
                       best_v);
    if constexpr (RING) __syncthreads();
  }
  feed.drain();
  if (threadIdx.x % P) return;
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

// The candidate forms of the products. 0-5 run on the TF32 tensor cores
// (mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32) from operands split
// into TF32 parts as tri_test_mma.cuh:split_tf32 splits them, x = hi + mid
// + lo (the two-part forms take hi and mid, the remainder rounded to TF32,
// as their hi and lo):
//   0: lo.hi + hi.lo + hi.hi, one accumulator (PR 5's form);
//   1: lo.lo + lo.hi + hi.lo + hi.hi, one accumulator;
//   2: lo.hi + hi.lo in one accumulator, hi.hi in another, added in f32;
//   3: the six passes of the three-part split down to 2^-22 (mid.mid,
//      lo.hi, hi.lo, mid.hi, hi.mid, hi.hi), one accumulator;
//   4: those five small passes in one accumulator, hi.hi in another, added:
//      tri_test_mma.cuh:mma_products itself (PRODUCTION_FORM);
//   5: those five small passes in one accumulator, hi.hi as four passes of
//      one column of A each (each an exact product), the four added in f32
//      in column order, then the small sum;
//   6: one pass on the FP64 tensor cores (mma.sync.aligned.m8n8k4 .f64, a
//      slot of 8 rays a pass), each product exact and the sum in f64, then
//      rounded to f32.
constexpr int PRODUCTION_FORM = 4;
constexpr int FP64_FORM = 6;

template <int FORM>
__device__ __forceinline__ void form_f32(float (&c)[4],
                                         const uint32_t (&a)[PARTS][2],
                                         const uint32_t (&b)[PARTS]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  float (&small)[4] = FORM == 2 || FORM == 5 ? s : c;
  if constexpr (FORM == 1) mma_tf32(small, a[1][0], a[1][1], b[1]);
  if constexpr (FORM >= 3) {
    mma_tf32(small, a[1][0], a[1][1], b[1]);
    mma_tf32(small, a[2][0], a[2][1], b[0]);
    mma_tf32(small, a[0][0], a[0][1], b[2]);
  }
  mma_tf32(small, a[1][0], a[1][1], b[0]);
  mma_tf32(small, a[0][0], a[0][1], b[1]);
  if constexpr (FORM == 5) {
    // a thread holds column q of A: one pass per column k of hi.hi
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(h, q == k ? a[0][0] : 0u, q == k ? a[0][1] : 0u, b[0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = k ? __fadd_rn(c[e], h[e]) : h[e];
    }
  } else {
    mma_tf32(c, a[0][0], a[0][1], b[0]);
  }
  if constexpr (FORM == 2 || FORM == 5) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], s[e]);
  }
}

// c0, c1 += A (a) x B (b), one m8n8k4 pass on the FP64 tensor cores.
__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// The f32 operand of slot s from its three parts (exact in f64).
__device__ __forceinline__ double whole(const uint32_t (&p)[PARTS][4], int s) {
  return static_cast<double>(__uint_as_float(p[0][s]))
         + static_cast<double>(__uint_as_float(p[1][s]))
         + static_cast<double>(__uint_as_float(p[2][s]));
}

// The products of row block mt in form FORM with the columns of triangles
// j0 .. j0 + 7 of the rows at f, in mma_products' layout.
template <int FORM>
__device__ __forceinline__ void form_products(const MmaRays& m, int mt,
                                              const float* f, int j0,
                                              float (&acc)[6][4]) {
  const int lane = threadIdx.x & 31;
  const int col = (3 * (j0 + (lane >> 2))) * 4 + (lane & 3);
  if constexpr (FORM == PRODUCTION_FORM) {
    mma_products(m, mt, mma_cols(f, j0), acc);
  } else if constexpr (FORM == FP64_FORM) {
    // C 8x8: c0 = C[g][2q], c1 = C[g][2q + 1]; slot 2 mt + h's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double ao = whole(m.o, 2 * mt + h), ad = whole(m.d, 2 * mt + h);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const double bb = f[col + 4 * b];
        double o0 = 0.0, o1 = 0.0, d0 = 0.0, d1 = 0.0;
        mma_f64(o0, o1, ao, bb);
        mma_f64(d0, d1, ad, bb);
        acc[2 * b][2 * h] = __double2float_rn(o0);
        acc[2 * b][2 * h + 1] = __double2float_rn(o1);
        acc[2 * b + 1][2 * h] = __double2float_rn(d0);
        acc[2 * b + 1][2 * h + 1] = __double2float_rn(d1);
      }
    }
  } else {
    uint32_t ao[PARTS][2], ad[PARTS][2];
#pragma unroll
    for (int k = 0; k < PARTS; ++k) {
      ao[k][0] = m.o[k][2 * mt]; ao[k][1] = m.o[k][2 * mt + 1];
      ad[k][0] = m.d[k][2 * mt]; ad[k][1] = m.d[k][2 * mt + 1];
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      uint32_t p[PARTS];
      split_tf32(f[col + 4 * b], p);
      form_f32<FORM>(acc[2 * b], ao, p);
      form_f32<FORM>(acc[2 * b + 1], ad, p);
    }
  }
}

// Lane i's ray against its own triangle tri_rows[i] ([3] float4, N first):
// no[i] = [o, 1] . N, nd[i] = [d, 0] . N. Warp lanes 8 nb + g are the
// columns of column block nb, whose diagonal holds slot nb's rays.
template <int FORM>
__global__ void __launch_bounds__(TILE)
mma_form_lanes_kernel(const float4* __restrict__ tri_rows,
                      const float* __restrict__ o, const float* __restrict__ d,
                      float* __restrict__ no, float* __restrict__ nd) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int base = i & ~31;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const Ray ray = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                   d[3 * i], d[3 * i + 1], d[3 * i + 2], 0.0f, 0.0f};
  const MmaRays m = mma_rays(ray);
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    float acc[6][4];
    form_products<FORM>(m, nb >> 1,
                        reinterpret_cast<const float*>(tri_rows
                                                       + 3 * (base + 8 * nb)),
                        0, acc);
    if (q == (g >> 1)) {
      const int e = 2 * (nb & 1) + (g & 1);
      no[base + 8 * nb + g] = acc[0][e];
      nd[base + 8 * nb + g] = acc[1][e];
    }
  }
}

// nvis visits a tile of cluster (tile + k) % cp: stage, then every product
// of the visit in the form, summed: out[i / 32] is the sum of the products
// of warp i / 32's 32 rays.
template <int FORM>
__global__ void __launch_bounds__(TILE)
mma_form_visits_kernel(const float4* __restrict__ rows, int cp, int nvis,
                       const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  __shared__ float4 s_rows[3 * KC];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                   d[3 * i], d[3 * i + 1], d[3 * i + 2], 0.0f, 0.0f};
  const MmaRays m = mma_rays(ray);
  const float* f = reinterpret_cast<const float*>(s_rows);
  float sum = 0.0f;
  for (int k = 0; k < nvis; ++k) {
    const float4* src = rows + static_cast<size_t>((blockIdx.x + k) % cp)
                                   * (3 * KC);
    __syncthreads();
    for (int r = threadIdx.x; r < 3 * KC; r += TILE) s_rows[r] = src[r];
    __syncthreads();
    for (int j0 = 0; j0 < KC; j0 += 8) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[6][4];
        form_products<FORM>(m, mt, f, j0, acc);
#pragma unroll
        for (int b = 0; b < 6; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum += acc[b][e];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(FULL, sum, off);
  if ((threadIdx.x & 31) == 0) out[i / 32] = sum;
}

template <int FORM>
int launch_form_lanes(const void* tri_rows, const void* o, const void* d,
                      int n, void* no, void* nd, void* stream) {
  mma_form_lanes_kernel<FORM><<<n / TILE, TILE, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tri_rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<float*>(no),
      static_cast<float*>(nd));
  return static_cast<int>(cudaGetLastError());
}

template <int FORM>
int launch_form_visits(const void* rows, int cp, int nvis, const void* o,
                       const void* d, int n, void* out, void* stream) {
  mma_form_visits_kernel<FORM><<<n / TILE, TILE, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), cp, nvis, static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The production closest-hit walk with the per-tile visit count in nv_out
// [n] int32, in the form (p, ring) and with the smem of walk_trace.cu's
// rl_walk_closest. n must be a multiple of 64.
extern "C" int rl_walk_closest_counted(
    const void* lo, const void* hi, int cp, int n_real, const void* rows,
    const void* ids, const void* o, const void* d, const void* tnear,
    const void* tfar, int n, int mma, int p, int ring, int smem, void* t_out,
    void* tri_out, void* u_out, void* v_out, void* nv_out, void* stream) {
  const bool one = p == 1 && !ring;
  if (!one && (mma || !is_form<CLOSEST_P, CLOSEST_RING>(p, ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      one ? (mma ? walk_closest_kernel<true, true>
                 : walk_closest_kernel<false, true>)
          : walk_closest_split_kernel<true, CLOSEST_P, CLOSEST_RING>,
      n / TILE, p * TILE, static_cast<size_t>(smem), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(nv_out));
}

// The floor walk, in the form (p, ring) as above: smem holds the feed's
// slots (the one-thread-a-ray form stages into static memory).
extern "C" int rl_walk_floor(int cp, int nv_total, const void* rows,
                             const void* ids, const void* o, const void* d,
                             const void* tnear, const void* tfar, int n,
                             int mma, int p, int ring, int smem, void* t_out,
                             void* tri_out, void* u_out, void* v_out,
                             void* stream) {
  const bool one = p == 1 && !ring;
  if (!one && (mma || !is_form<CLOSEST_P, CLOSEST_RING>(p, ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      one ? (mma ? walk_floor_kernel<true> : walk_floor_kernel<false>)
          : walk_floor_split_kernel<CLOSEST_P, CLOSEST_RING>,
      n / TILE, p * TILE, static_cast<size_t>(smem), stream, cp, nv_total,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
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

// tri_rows [n][3] float4 (each lane's triangle), o, d [n, 3]; no, nd [n].
// n must be a multiple of 64; form in 0 .. 6 (form_products).
extern "C" int rl_mma_form_lanes(int form, const void* tri_rows, const void* o,
                                 const void* d, int n, void* no, void* nd,
                                 void* stream) {
  switch (form) {
    case 0: return launch_form_lanes<0>(tri_rows, o, d, n, no, nd, stream);
    case 1: return launch_form_lanes<1>(tri_rows, o, d, n, no, nd, stream);
    case 2: return launch_form_lanes<2>(tri_rows, o, d, n, no, nd, stream);
    case 3: return launch_form_lanes<3>(tri_rows, o, d, n, no, nd, stream);
    case 4: return launch_form_lanes<4>(tri_rows, o, d, n, no, nd, stream);
    case 5: return launch_form_lanes<5>(tri_rows, o, d, n, no, nd, stream);
    case 6: return launch_form_lanes<6>(tri_rows, o, d, n, no, nd, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows: the walk tables' rows [cp * KC][3] float4; o, d [n, 3]; out [n / 32].
extern "C" int rl_mma_form_visits(int form, const void* rows, int cp,
                                  int nvis, const void* o, const void* d,
                                  int n, void* out, void* stream) {
  switch (form) {
    case 0: return launch_form_visits<0>(rows, cp, nvis, o, d, n, out, stream);
    case 1: return launch_form_visits<1>(rows, cp, nvis, o, d, n, out, stream);
    case 2: return launch_form_visits<2>(rows, cp, nvis, o, d, n, out, stream);
    case 3: return launch_form_visits<3>(rows, cp, nvis, o, d, n, out, stream);
    case 4: return launch_form_visits<4>(rows, cp, nvis, o, d, n, out, stream);
    case 5: return launch_form_visits<5>(rows, cp, nvis, o, d, n, out, stream);
    case 6: return launch_form_visits<6>(rows, cp, nvis, o, d, n, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
