// Tile-walk ray-triangle intersection for Hopper (sm_90a): closest hit and
// any hit over clustered walk tables.
//
// Replaces the TPU kernels rustlight_tpu/accel/pallas_walk.py:_closest_kernel
// and :_anyhit_kernel (K3, tables resident in VMEM) and :_closest_kernel_hbm
// and :_anyhit_kernel_hbm (K4, cluster blocks in HBM, one DMA per visit).
// That split is TPU memory placement; on the card the tables always live in
// device memory and each visit stages one cluster into shared memory, which
// is what K4's DMA does, so this one kernel pair stands for both.
//
// Tables (accel/walk.py): Cp clusters of KC = 384 triangles, rows
// [Cp*KC, 3, 4] f32 (each triangle as the dense kernels' three float4),
// ids [Cp*KC] i32 (-1 in pad slots, whose rows are zero and never hit),
// cluster bounds lo/hi [3, Cp] f32; the first n_real clusters are real.
//
// One block of TILE = 64 threads per 64-ray tile, one thread per ray, in the
// order the caller passes the rays (RAY_TILE of the reference). The schedule
// is the reference kernels', so the visit order, and the winner on exact
// ties, are theirs:
//   - entry pass (_tile_entries): for every cluster, the minimum over the
//     tile's rays of the slab entry max(tmin, tnear), valid where
//     tmax >= entry and entry < tfar; its float bits with the cluster id
//     packed into the low ID_BITS = 14 bits, +inf bits where no ray enters
//     or the cluster is a pad. Held as int32 in dynamic shared memory
//     (Cp * 4 B, 64 KB at 2^14 clusters).
//   - pop (_pop_min): a block-wide min over those bits; the popped entry is
//     cleared (its id locates it, so this is the reference's clear by bit
//     equality); csel = bits & 0x3FFF, clamped to Cp - 1.
//   - visit (_test_rows): the cluster's 384 triangles are staged into shared
//     memory (18 KB) and each thread tests its ray in column order with the
//     shared Baldwin-Weber test (tri_test.cuh) against t in (tnear, best_t):
//     the lowest column wins inside a cluster, a strict < across clusters.
//   - two visits per termination check; then the threshold becomes the
//     block max of best-t bits (any hit: of occ ? 0 : tfar), and the walk
//     stops when the popped entry with its id bits cleared reaches it, or
//     after Cp pairs.
// Arithmetic is IEEE f32 without contraction (__fmul_rn/__fadd_rn/__fdiv_rn)
// and min/max propagate NaN as torch.minimum/maximum do, so the results are
// bit-identical to the plain versions in ops/walk_trace.py.
//
// What bounds it: the ray-triangle tests, visits x 64 x 384 per tile at
// about 25 f32 operations each; the tables are 6.3 MB of rows at 131k
// triangles and 29 MB at 608k, plus a quarter of that in ids, and both fit
// the 50 MB L2, so after the first touch a visit's 18 KB stage is an L2
// read. The design keeps all per-visit traffic in shared memory and
// registers; rays that cannot improve (tnear >= best_t, occluded, inert
// tfar = 0 lanes) skip the test, and a visit no ray of the block needs skips
// the stage. The entry pass costs Cp x 64 slab tests per tile. Known
// limits, left to a later change: 64 threads a block leaves the SMs under
// a third occupied, and tiles that walk far keep their SM after the others
// finish.
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

constexpr int TILE = 64;
constexpr int WARPS = TILE / 32;
constexpr int KC = 384;
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

__device__ void load_tile(const Ray& ray, TileRays& s) {
  const int k = threadIdx.x;
  s.o[0][k] = ray.ox; s.o[1][k] = ray.oy; s.o[2][k] = ray.oz;
  s.inv[0][k] = slab_inv(ray.dx);
  s.inv[1][k] = slab_inv(ray.dy);
  s.inv[2][k] = slab_inv(ray.dz);
  s.tnear[k] = ray.tnear;
  s.tfar[k] = ray.tfar;
}

// s_ent[c] = packed tile entry of cluster c (see the header comment)
__device__ void tile_entries(const float* __restrict__ lo,
                             const float* __restrict__ hi, int cp, int n_real,
                             const TileRays& r, int* s_ent) {
  for (int c = threadIdx.x; c < cp; c += TILE) {
    int bits = INF_BITS;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      float e = CUDART_INF_F;
      for (int j = 0; j < TILE; ++j) {
        float tmin = -CUDART_INF_F, tmax = CUDART_INF_F;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float t0 = __fmul_rn(__fsub_rn(l[ax], r.o[ax][j]), r.inv[ax][j]);
          const float t1 = __fmul_rn(__fsub_rn(h[ax], r.o[ax][j]), r.inv[ax][j]);
          tmin = nan_max(tmin, nan_min(t0, t1));
          tmax = nan_min(tmax, nan_max(t0, t1));
        }
        const float entry = nan_max(tmin, r.tnear[j]);
        if (tmax >= entry && entry < r.tfar[j]) e = fminf(e, entry);
      }
      if (isfinite(e)) {
        // + 0 maps a -0 entry to +0, so its bits sort as the smallest
        const float z = __fadd_rn(fmaxf(e, 0.0f), 0.0f);
        bits = (__float_as_int(z) & ~ID_MASK) | c;
      }
    }
    s_ent[c] = bits;
  }
}

// Pops the smallest entry; returns its bits (INF_BITS once all are popped).
__device__ __forceinline__ int pop_min(int* s_ent, int cp, int* red) {
  int m = INF_BITS;
  for (int c = threadIdx.x; c < cp; c += TILE) m = min(m, s_ent[c]);
  m = block_min(m, red);
  // every thread has scanned s_ent before block_min's second barrier; the
  // next scan follows a visit, whose barrier publishes this store
  if (threadIdx.x == 0 && m != INF_BITS) s_ent[m & ID_MASK] = INF_BITS;
  return m;
}

__device__ __forceinline__ int cluster_of(int bits, int cp) {
  return min(bits & ID_MASK, cp - 1);
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

__global__ void __launch_bounds__(TILE)
walk_closest_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                    int cp, int n_real, const float4* __restrict__ rows,
                    const int* __restrict__ ids, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tnear,
                    const float* __restrict__ tfar,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ int s_ent[];
  __shared__ float4 s_rows[3 * KC];
  __shared__ TileRays s_ray;
  __shared__ int s_red[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile(ray, s_ray);
  __syncthreads();
  tile_entries(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  // best_t starts at tfar and only decreases: it is the t cap
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int emin = pop_min(s_ent, cp, s_red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(best_t), s_red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      const bool want = ray.tnear < best_t;
      if (stage(rows, csel, want, s_rows) && want) {
        float bt = best_t, bu = 0.0f, bv = 0.0f;
        int bj = -1;
        for (int j = 0; j < KC; ++j) {
          float t, u, v;
          if (test_tri(&s_rows[3 * j], ray, bt, t, u, v)) {
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
      emin = pop_min(s_ent, cp, s_red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(__float_as_int(best_t), s_red);
  }
  const bool hit = best_i >= 0;
  t_out[i] = hit ? best_t : CUDART_INF_F;
  tri_out[i] = best_i;
  // + 0 maps a -0 barycentric to +0, as the reference's masked sum does
  u_out[i] = __fadd_rn(best_u, 0.0f);
  v_out[i] = __fadd_rn(best_v, 0.0f);
}

__global__ void __launch_bounds__(TILE)
walk_anyhit_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                   int cp, int n_real, const float4* __restrict__ rows,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tnear,
                   const float* __restrict__ tfar, bool* __restrict__ occ_out) {
  extern __shared__ int s_ent[];
  __shared__ float4 s_rows[3 * KC];
  __shared__ TileRays s_ray;
  __shared__ int s_red[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile(ray, s_ray);
  __syncthreads();
  tile_entries(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  bool occ = false;
  int emin = pop_min(s_ent, cp, s_red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(ray.tfar), s_red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      const bool want = !occ && ray.tnear < ray.tfar;
      if (stage(rows, csel, want, s_rows) && want) {
        for (int j = 0; j < KC; ++j) {
          float t, u, v;
          if (test_tri(&s_rows[3 * j], ray, ray.tfar, t, u, v)) {
            occ = true;
            break;
          }
        }
      }
      emin = pop_min(s_ent, cp, s_red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(occ ? 0 : __float_as_int(ray.tfar), s_red);
  }
  occ_out[i] = occ;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads).
extern "C" int rl_walk_closest(const void* lo, const void* hi, int cp,
                               int n_real, const void* rows, const void* ids,
                               const void* o, const void* d, const void* tnear,
                               const void* tfar, int n, void* t_out,
                               void* tri_out, void* u_out, void* v_out,
                               void* stream) {
  const size_t smem = static_cast<size_t>(cp) * sizeof(int);
  if (const int err = set_smem(walk_closest_kernel, smem)) return err;
  walk_closest_kernel<<<n / TILE, TILE, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_walk_anyhit(const void* lo, const void* hi, int cp,
                              int n_real, const void* rows, const void* o,
                              const void* d, const void* tnear,
                              const void* tfar, int n, void* occ_out,
                              void* stream) {
  const size_t smem = static_cast<size_t>(cp) * sizeof(int);
  if (const int err = set_smem(walk_anyhit_kernel, smem)) return err;
  walk_anyhit_kernel<<<n / TILE, TILE, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<bool*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}
