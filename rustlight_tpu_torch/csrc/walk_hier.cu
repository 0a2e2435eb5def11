// Two-level tile walk for Hopper (sm_90a): closest hit and any hit over
// walk tables past 2^14 clusters.
//
// Replaces the TPU kernels rustlight_tpu/accel/pallas_walk.py:
// _closest_kernel_hbm_hier and :_anyhit_kernel_hbm_hier, with
// :_child_entries (K5).
//
// Tables (accel/walk.py): the one-level tables (rows [Cp*KC, 3, 4] f32,
// ids [Cp*KC] i32, cluster bounds lo/hi [3, Cp]; the first n_real clusters
// are real) and the super tables: slo/shi [3, Sp] f32, the bounds of SUP =
// 128 consecutive clusters (the union of the real ones), n_sup real supers
// padded to Sp, a multiple of 128.
//
// One block per 64-ray tile, in the order the caller passes the rays: P x
// 64 threads, P threads a ray, in the split form the wrappers launch by
// default (walk_hier_closest_split_kernel at HIER_CLOSEST_P,
// walk_hier_anyhit_split_kernel at HIER_ANYHIT_P), or 64, one thread a ray
// (the tensor-core visit, and the form the smoke run times beside the split
// one). The schedule is the reference's, so the
// visit order, and the winner on exact ties, are its:
//   - super entry pass: the one-level entry pass (walk_common.cuh) over
//     slo/shi with n_real = n_sup and 14 id bits, capped by the static tfar,
//     into Sp ints of dynamic shared memory (1 KB at 18,816 clusters, 4 KB
//     at the ceiling of 2^17);
//   - super loop: while the popped super entry with its id bits cleared is
//     below thresh (the block max of best-t bits; any hit: of occ ? 0 :
//     tfar) and fewer than Sp supers were opened;
//   - opening super s (_child_entries): its 128 children base + l, base =
//     s * 128, get entries from lo/hi, real where base + l < n_real, with 7
//     id bits, each ray's entry counted where entry < cap: its current
//     best_t (any hit: occ ? 0 : tfar, taken as the super opens). The caps
//     of the 64 rays sit in shared memory; each thread computes two
//     children;
//   - child loop: two visits per check, while the popped child entry with
//     its 7 id bits cleared is below th (starting at thresh, then the block
//     max after each pair) and fewer than 128 pairs ran; a popped child is
//     min(base + l, n_real - 1), so an exhausted heap re-tests child base,
//     as the reference does;
//   - visits: as the one-level walk's (the cluster's 384 triangles in
//     shared memory, tested in column order, or by P threads a ray and a
//     (t, column) min; any hit against tfar).
//
// What bounds it: past 2^14 clusters the tables are more than 302 MB of rows
// and 25 MB of ids (347 MB and 29 MB at the 5.7M-triangle sphere grid's
// 18,816 clusters), far past the 50 MB L2, so each visit's 18 KB of rows
// is a read from HBM. Per visit a tile does 64 x 384 ray-triangle tests
// (about 25 f32 operations each) against 19.5 KB read, so the tests, not
// the bytes, bound it on paper; in the one-thread kernel the latency of a
// visit (384 serial tests a thread) and the tail of the longest tiles did.
// The split form takes P threads a ray, as the one-level walk's. It stages
// a visit's rows at the visit: a ring of rows filled a visit ahead (the
// one-level any-hit kernel's) would start over at every super, whose
// children get their entries only when it opens, and on an H100 it made K5
// 2-5% slower on the main path's wavefronts (PERF.md section 6). The super
// and child entries live in shared memory, rays that cannot improve skip
// the tests, and a visit no ray of the block needs skips its copy. With mma
// set, a visit takes the tensor-core form of the triangle test
// (tri_test_mma.cuh), which is not bit-identical.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using namespace rl::walk;
using rl::Ray;
using rl::load_ray;

constexpr int SUP = 128;
constexpr int CHILD_MASK = SUP - 1;   // 7 id bits

// s_child[l] = packed entry of child base + l of the opened super, each
// ray j counted where its entry < s_cap[j]. Thread l % NT writes entry l.
template <int NT = TILE>
__device__ __forceinline__ void child_entries(const float* __restrict__ lo,
                                              const float* __restrict__ hi,
                                              int cp, int n_real, int base,
                                              const TileRays& r,
                                              const float* s_cap,
                                              int* s_child) {
  for (int l = threadIdx.x; l < SUP; l += NT) {
    const int c = base + l;
    int bits = INF_BITS;
    if (c < n_real) {
      const float lb[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float hb[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      bits = pack_entry(min_entry(lb, hb, r, s_cap), l, CHILD_MASK);
    }
    s_child[l] = bits;
  }
}

__device__ __forceinline__ int child_of(int bits, int base, int n_real) {
  return min(base + (bits & CHILD_MASK), n_real - 1);
}

__device__ __forceinline__ int super_base(int bits, int sp) {
  return min(bits & ID_MASK, sp - 1) * SUP;
}

struct HierShared {
  float4 rows[3 * KC];
  TileRays ray;
  float cap[TILE];
  int child[SUP];
  int red[WARPS];
};

template <bool MMA>
__global__ void __launch_bounds__(TILE)
walk_hier_closest_kernel(const float* __restrict__ slo,
                         const float* __restrict__ shi, int sp, int n_sup,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi, int cp, int n_real,
                         const float4* __restrict__ rows,
                         const int* __restrict__ ids,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tnear,
                         const float* __restrict__ tfar,
                         float* __restrict__ t_out, int* __restrict__ tri_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  extern __shared__ int s_sup[];
  __shared__ HierShared s;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s.ray);
  __syncthreads();
  tile_entries(slo, shi, sp, n_sup, s.ray, s_sup);
  __syncthreads();

  // best_t starts at tfar and only decreases: it is the t cap
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int semin = pop_min(s_sup, sp, ID_MASK, s.red);
  int thresh = block_max(__float_as_int(best_t), s.red);
  for (int ns = 0; ns < sp && (semin & ~ID_MASK) < thresh; ++ns) {
    const int base = super_base(semin, sp);
    s.cap[threadIdx.x] = best_t;
    __syncthreads();
    child_entries(lo, hi, cp, n_real, base, s.ray, s.cap, s.child);
    __syncthreads();
    int cemin = pop_min(s.child, SUP, CHILD_MASK, s.red);
    int csel = child_of(cemin, base, n_real);
    int th = thresh;
    for (int ni = 0; ni < SUP && (cemin & ~CHILD_MASK) < th; ++ni) {
      for (int half = 0; half < 2; ++half) {
        visit_closest<MMA>(rows, ids, csel, ray, s.rows, best_t, best_i,
                           best_u, best_v, m);
        cemin = pop_min(s.child, SUP, CHILD_MASK, s.red);
        csel = child_of(cemin, base, n_real);
      }
      th = block_max(__float_as_int(best_t), s.red);
    }
    semin = pop_min(s_sup, sp, ID_MASK, s.red);
    thresh = block_max(__float_as_int(best_t), s.red);
  }
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
}

template <bool MMA>
__global__ void __launch_bounds__(TILE)
walk_hier_anyhit_kernel(const float* __restrict__ slo,
                        const float* __restrict__ shi, int sp, int n_sup,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi, int cp, int n_real,
                        const float4* __restrict__ rows,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar,
                        bool* __restrict__ occ_out) {
  extern __shared__ int s_sup[];
  __shared__ HierShared s;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s.ray);
  __syncthreads();
  tile_entries(slo, shi, sp, n_sup, s.ray, s_sup);
  __syncthreads();

  bool occ = false;
  int semin = pop_min(s_sup, sp, ID_MASK, s.red);
  int thresh = block_max(__float_as_int(ray.tfar), s.red);
  for (int ns = 0; ns < sp && (semin & ~ID_MASK) < thresh; ++ns) {
    const int base = super_base(semin, sp);
    s.cap[threadIdx.x] = occ ? 0.0f : ray.tfar;
    __syncthreads();
    child_entries(lo, hi, cp, n_real, base, s.ray, s.cap, s.child);
    __syncthreads();
    int cemin = pop_min(s.child, SUP, CHILD_MASK, s.red);
    int csel = child_of(cemin, base, n_real);
    int th = thresh;
    for (int ni = 0; ni < SUP && (cemin & ~CHILD_MASK) < th; ++ni) {
      for (int half = 0; half < 2; ++half) {
        visit_anyhit<MMA>(rows, csel, ray, s.rows, occ, m);
        cemin = pop_min(s.child, SUP, CHILD_MASK, s.red);
        csel = child_of(cemin, base, n_real);
      }
      th = block_max(occ ? 0 : __float_as_int(ray.tfar), s.red);
    }
    semin = pop_min(s_sup, sp, ID_MASK, s.red);
    thresh = block_max(occ ? 0 : __float_as_int(ray.tfar), s.red);
  }
  occ_out[i] = occ;
}

// ------------------------------------------------------------ split form

// The split forms built (P threads a ray): the faster on an H100 on the
// main path's wavefronts (PERF.md section 6), as ops/walk_trace.py:
// PRODUCTION_FORMS names them.
constexpr int HIER_CLOSEST_P = 4;
constexpr int HIER_ANYHIT_P = 8;

// The static shared memory of the split kernels; the dynamic part is the
// stage's slot, then the super heap (Sp ints).
template <int NT>
struct HierSplitShared {
  TileRays ray;
  float cap[TILE];
  int child[SUP];
  int red[NT / 32];
};

// P threads a ray (the split visit of walk_common.cuh). Inside a super's
// child loop every child is popped a visit ahead, as in the one-level split
// kernels. The visit order, the stop tests and the results are
// walk_hier_closest_kernel's.
template <int P>
__global__ void __launch_bounds__(P * TILE)
walk_hier_closest_split_kernel(const float* __restrict__ slo,
                               const float* __restrict__ shi, int sp,
                               int n_sup, const float* __restrict__ lo,
                               const float* __restrict__ hi, int cp,
                               int n_real, const float4* __restrict__ rows,
                               const int* __restrict__ ids,
                               const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ tnear,
                               const float* __restrict__ tfar,
                               float* __restrict__ t_out,
                               int* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ HierSplitShared<NT> s;
  int* s_sup = reinterpret_cast<int*>(s_dyn + 3 * KC);
  StageFeed<NT> feed{s_dyn};
  const int i = blockIdx.x * TILE + threadIdx.x / P;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile<P>(ray, s.ray);
  __syncthreads();
  tile_entries<NT>(slo, shi, sp, n_sup, s.ray, s_sup);
  __syncthreads();

  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int semin = pop_min<NT, true>(s_sup, sp, ID_MASK, s.red);
  int thresh = block_max<NT>(__float_as_int(best_t), s.red);
  for (int ns = 0; ns < sp && (semin & ~ID_MASK) < thresh; ++ns) {
    const int base = super_base(semin, sp);
    if (threadIdx.x % P == 0) s.cap[threadIdx.x / P] = best_t;
    __syncthreads();
    child_entries<NT>(lo, hi, cp, n_real, base, s.ray, s.cap, s.child);
    __syncthreads();
    int cemin = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
    int csel = child_of(cemin, base, n_real);
    int cenext = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
    int cnext = child_of(cenext, base, n_real);
    int th = thresh;
    for (int ni = 0; ni < SUP && (cemin & ~CHILD_MASK) < th; ++ni) {
      for (int half = 0; half < 2; ++half) {
        const bool want = ray.tnear < best_t;
        if (const float4* c_rows = feed.take(rows, csel, want))
          split_closest<P>(c_rows, ids, csel, ray, want, best_t, best_i,
                           best_u, best_v);
        cemin = cenext;
        csel = cnext;
        cenext = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
        cnext = child_of(cenext, base, n_real);
      }
      th = block_max<NT>(__float_as_int(best_t), s.red);
    }
    semin = pop_min<NT, true>(s_sup, sp, ID_MASK, s.red);
    thresh = block_max<NT>(__float_as_int(best_t), s.red);
  }
  if (threadIdx.x % P == 0)
    write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                  v_out);
}

template <int P>
__global__ void __launch_bounds__(P * TILE)
walk_hier_anyhit_split_kernel(const float* __restrict__ slo,
                              const float* __restrict__ shi, int sp,
                              int n_sup, const float* __restrict__ lo,
                              const float* __restrict__ hi, int cp,
                              int n_real, const float4* __restrict__ rows,
                              const float* __restrict__ o,
                              const float* __restrict__ d,
                              const float* __restrict__ tnear,
                              const float* __restrict__ tfar,
                              bool* __restrict__ occ_out) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ HierSplitShared<NT> s;
  int* s_sup = reinterpret_cast<int*>(s_dyn + 3 * KC);
  StageFeed<NT> feed{s_dyn};
  const int i = blockIdx.x * TILE + threadIdx.x / P;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile<P>(ray, s.ray);
  __syncthreads();
  tile_entries<NT>(slo, shi, sp, n_sup, s.ray, s_sup);
  __syncthreads();

  bool occ = false;
  int semin = pop_min<NT, true>(s_sup, sp, ID_MASK, s.red);
  int thresh = block_max<NT>(__float_as_int(ray.tfar), s.red);
  for (int ns = 0; ns < sp && (semin & ~ID_MASK) < thresh; ++ns) {
    const int base = super_base(semin, sp);
    if (threadIdx.x % P == 0) s.cap[threadIdx.x / P] = occ ? 0.0f : ray.tfar;
    __syncthreads();
    child_entries<NT>(lo, hi, cp, n_real, base, s.ray, s.cap, s.child);
    __syncthreads();
    int cemin = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
    int csel = child_of(cemin, base, n_real);
    int cenext = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
    int cnext = child_of(cenext, base, n_real);
    int th = thresh;
    for (int ni = 0; ni < SUP && (cemin & ~CHILD_MASK) < th; ++ni) {
      for (int half = 0; half < 2; ++half) {
        const bool want = !occ && ray.tnear < ray.tfar;
        if (const float4* c_rows = feed.take(rows, csel, want))
          split_anyhit<P>(c_rows, ray, want, occ);
        cemin = cenext;
        csel = cnext;
        cenext = pop_min<NT, true>(s.child, SUP, CHILD_MASK, s.red);
        cnext = child_of(cenext, base, n_real);
      }
      th = block_max<NT>(occ ? 0 : __float_as_int(ray.tfar), s.red);
    }
    semin = pop_min<NT, true>(s_sup, sp, ID_MASK, s.red);
    thresh = block_max<NT>(occ ? 0 : __float_as_int(ray.tfar), s.red);
  }
  if (threadIdx.x % P == 0) occ_out[i] = occ;
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads). mma != 0 takes the
// tensor-core form of the triangle test (tri_test_mma.cuh; the one-thread
// form only). p threads a ray and ring name the form as in walk_trace.cu:
// (1, 0) the one-thread-a-ray kernel, else the split form built here (at
// HIER_CLOSEST_P or HIER_ANYHIT_P, no ring), with smem from
// ops/walk_trace.py:launch_geometry; cudaErrorInvalidValue for a form not
// built.
extern "C" int rl_walk_hier_closest(const void* slo, const void* shi, int sp,
                                    int n_sup, const void* lo, const void* hi,
                                    int cp, int n_real, const void* rows,
                                    const void* ids, const void* o,
                                    const void* d, const void* tnear,
                                    const void* tfar, int n, int mma, int p,
                                    int ring, int smem, void* t_out,
                                    void* tri_out, void* u_out, void* v_out,
                                    void* stream) {
  const bool one = p == 1 && !ring;
  if (!one && (mma || !is_form<HIER_CLOSEST_P, false>(p, ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      one ? (mma ? walk_hier_closest_kernel<true>
                 : walk_hier_closest_kernel<false>)
          : walk_hier_closest_split_kernel<HIER_CLOSEST_P>,
      n / TILE, p * TILE, static_cast<size_t>(smem), stream,
      static_cast<const float*>(slo), static_cast<const float*>(shi), sp,
      n_sup, static_cast<const float*>(lo), static_cast<const float*>(hi), cp,
      n_real, static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
}

extern "C" int rl_walk_hier_anyhit(const void* slo, const void* shi, int sp,
                                   int n_sup, const void* lo, const void* hi,
                                   int cp, int n_real, const void* rows,
                                   const void* o, const void* d,
                                   const void* tnear, const void* tfar, int n,
                                   int mma, int p, int ring, int smem,
                                   void* occ_out, void* stream) {
  const bool one = p == 1 && !ring;
  if (!one && (mma || !is_form<HIER_ANYHIT_P, false>(p, ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      one ? (mma ? walk_hier_anyhit_kernel<true>
                 : walk_hier_anyhit_kernel<false>)
          : walk_hier_anyhit_split_kernel<HIER_ANYHIT_P>,
      n / TILE, p * TILE, static_cast<size_t>(smem), stream,
      static_cast<const float*>(slo), static_cast<const float*>(shi), sp,
      n_sup, static_cast<const float*>(lo), static_cast<const float*>(hi), cp,
      n_real, static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<bool*>(occ_out));
}
