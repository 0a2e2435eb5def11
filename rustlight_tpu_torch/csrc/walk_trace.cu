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
// One block per 64-ray tile, in the order the caller passes the rays
// (RAY_TILE of the reference): P x 64 threads, P threads a ray, in the
// split form that the wrappers launch by default (walk_flat.cuh:
// walk_closest_split_kernel, walk_anyhit_split_kernel below, with either
// form of the triangle test), or 64, one thread a ray (walk_closest_kernel,
// walk_anyhit_kernel: the form the smoke run times beside the split one).
// The schedule is the reference kernels', so the visit order, and the
// winner on exact ties, are theirs:
//   - entry pass (_tile_entries): for every cluster, the minimum over the
//     tile's rays of the slab entry max(tmin, tnear), valid where
//     tmax >= entry and entry < tfar; its float bits with the cluster id
//     packed into the low ID_BITS = 14 bits, +inf bits where no ray enters
//     or the cluster is a pad. Held as int32 in dynamic shared memory
//     (Cp * 4 B, 64 KB at 2^14 clusters).
//   - pop (_pop_min): a block-wide min over those bits; the popped entry is
//     cleared (its id locates it, so this is the reference's clear by bit
//     equality); csel = bits & 0x3FFF, clamped to Cp - 1.
//   - visit (_test_rows): the cluster's 384 triangles are in shared memory
//     (18 KB) and a ray's threads test it with the shared Baldwin-Weber test
//     (tri_test.cuh) against t in (tnear, best_t): one thread in column
//     order, or P threads each every P-th column, then a (t, column) min
//     over them (walk_common.cuh: the split visit); either way the lowest
//     column wins inside a cluster, a strict < across clusters.
//   - two visits per termination check; then the threshold becomes the
//     block max of best-t bits (any hit: of occ ? 0 : tfar), and the walk
//     stops when the popped entry with its id bits cleared reaches it, or
//     after Cp pairs.
// The entry pass, pops, staging and visits live in walk_common.cuh, shared
// with the two-level kernels (walk_hier.cu); the closest-hit kernel itself is
// the template of walk_flat.cuh, shared with the roofline tools' counted
// kernel (walk_lab.cu). With mma set, a visit takes the tensor-core form of
// the triangle test (tri_test_mma.cuh), which is not bit-identical to the
// _dot4 form; its split visit (walk_common.cuh: split_mma, the set's P
// warps each taking NB / P column blocks of all 32 rays, merged by (t,
// column)) is bit-identical to the one-thread tensor-core kernel's, which
// runs 48 column blocks a warp alone. Arithmetic is IEEE f32 without
// contraction and min/max propagate NaN as torch.minimum/maximum do, so the
// results are bit-identical to the plain versions in ops/walk_trace.py.
//
// What bounds it: the ray-triangle tests, visits x 64 x 384 per tile at
// about 25 f32 operations each; the tables are 6.3 MB of rows at 131k
// triangles and 29 MB at 608k, plus a quarter of that in ids, and both fit
// the 50 MB L2; at 4.9M triangles (16,000 clusters) they are 295 MB, read
// from HBM. One wave of 1,024 tiles ends with its longest tiles (110 visits
// against a mean of 25 on a divergent wavefront), which then run nearly
// alone on their SMs, so a visit's latency, not the card's throughput, set
// the one-thread kernel's time: 384 serial tests a thread, each with an
// IEEE division. The split form attacks that latency: P = 8 threads a ray
// cut a visit's chain to 48 tests and give the SM 8 times the warps; the
// entry pass and the pops stride over 512 threads. The any-hit kernel's
// rows come through a two-slot ring filled a visit ahead by one bulk copy
// (walk_common.cuh: RingFeed), so a visit waits on no copy and takes two
// block barriers (the pops') instead of four. The closest-hit kernel
// stages its rows at the visit: on an H100 the ring did not beat the stage
// there by more than the spread of the timings, on tables in L2 or in HBM
// (PERF.md section 6). Rays that cannot improve (tnear >= best_t,
// occluded, inert tfar = 0 lanes) skip the tests. What bounds the split
// kernels now: still the tests, at about a tenth of the f32 rate; lanes of
// a warp whose ray does not want a visit idle through it, and the test's
// early exits diverge. The entry pass costs Cp x 64 slab tests per tile.
//
// The wide pop (the same TPU kernels with wide=True, for tables past 2^14
// clusters that do not take the two-level walk): entries are the plain bits
// of max(entry, 0), no id packed. A pop is a block-wide min over (bits,
// column), so the lowest column wins among equal entries, and clears that
// one slot; an empty heap pops column 0, as the reference's does, for a
// visit that can change nothing. The stop test compares the bits
// unstripped. The heaps of Cp x 4 B are in dynamic shared memory, or, when
// `heap` is given, in a slice per block of that device buffer; the grid is
// bounded by the caller and a block walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... so that the buffer stays bounded too.
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
  MmaRays m{};
  if constexpr (MMA) m = mma_rays(ray);
  load_tile(ray, s_ray);
  __syncthreads();
  tile_entries(lo, hi, cp, n_real, s_ray, s_ent);
  __syncthreads();

  bool occ = false;
  int emin = pop_min(s_ent, cp, ID_MASK, s_red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(ray.tfar), s_red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      visit_anyhit<MMA>(rows, csel, ray, s_rows, occ, m);
      emin = pop_min(s_ent, cp, ID_MASK, s_red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(occ ? 0 : __float_as_int(ray.tfar), s_red);
  }
  occ_out[i] = occ;
}

// The split form of walk_anyhit_kernel (walk_closest_split_kernel's
// layout): any hit is an OR over a ray's P lanes, and a lane stops at its
// first hit; MMA: the split tensor-core visit, an OR over the set's warps.
template <int P, bool RING, bool MMA = false>
__global__ void __launch_bounds__(P * TILE)
walk_anyhit_split_kernel(const float* __restrict__ lo,
                         const float* __restrict__ hi, int cp, int n_real,
                         const float4* __restrict__ rows,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tnear,
                         const float* __restrict__ tfar,
                         bool* __restrict__ occ_out) {
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

  bool occ = false;
  int emin = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
  int csel = cluster_of(emin, cp);
  feed.prefetch(rows, csel);
  int enext = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
  int cnext = cluster_of(enext, cp);
  int thresh = block_max<NT>(__float_as_int(ray.tfar), s.red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      feed.prefetch(rows, cnext);
      const bool want = !occ && ray.tnear < ray.tfar;
      if constexpr (MMA) {
        put_cap<P>(mx, want, ray.tfar);
        if (const float4* c_rows = feed.take_all(rows, csel, want)) {
          float t, u, v;
          int j;
          split_mma<P, 32, true>(reinterpret_cast<const float*>(c_rows),
                                 set_rays<P>(o, d, tnear), mx, BlockSync{}, t,
                                 j, u, v);
          if (j < KC) occ = true;
        }
      } else if (const float4* c_rows = feed.take(rows, csel, want)) {
        split_anyhit<P>(c_rows, ray, want, occ);
      }
      emin = enext;
      csel = cnext;
      enext = pop_min<NT, true>(s_ent, cp, ID_MASK, s.red);
      cnext = cluster_of(enext, cp);
    }
    thresh = block_max<NT>(occ ? 0 : __float_as_int(ray.tfar), s.red);
  }
  feed.drain();
  if (threadIdx.x % P == 0) occ_out[i] = occ;
}

// --------------------------------------------------------------- wide pop

__device__ __forceinline__ long long block_min64(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // every thread has read red from the last reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = red[0];
  for (int w = 1; w < WARPS; ++w) r = min(r, red[w]);
  return r;
}

// heap[c] = plain entry bits of cluster c (pack_entry with no id bits).
__device__ inline void tile_entries_wide(const float* __restrict__ lo,
                                         const float* __restrict__ hi, int cp,
                                         int n_real, const TileRays& r,
                                         int* heap) {
  for (int c = threadIdx.x; c < cp; c += TILE) {
    int bits = INF_BITS;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      bits = pack_entry(min_entry(l, h, r, r.tfar), 0, 0);
    }
    heap[c] = bits;
  }
}

// Pops the smallest entry, the lowest column among equals: returns its bits
// and sets csel; an empty heap gives INF_BITS and column 0. The caller puts
// a barrier between this pop and the next scan.
__device__ __forceinline__ int pop_min_wide(int* heap, int cp, long long* red,
                                            int& csel) {
  long long m = (static_cast<long long>(INF_BITS) << 32);
  for (int c = threadIdx.x; c < cp; c += TILE)
    m = min(m, (static_cast<long long>(heap[c]) << 32) | c);
  m = block_min64(m, red);
  csel = static_cast<int>(m & 0xffffffffll);
  if (threadIdx.x == 0) heap[csel] = INF_BITS;
  return static_cast<int>(m >> 32);
}

struct WideShared {
  float4 rows[3 * KC];
  TileRays ray;
  long long red[WARPS];
};

template <bool MMA>
__global__ void __launch_bounds__(TILE)
walk_closest_wide_kernel(const float* __restrict__ lo,
                         const float* __restrict__ hi, int cp, int n_real,
                         const float4* __restrict__ rows,
                         const int* __restrict__ ids,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tnear,
                         const float* __restrict__ tfar, int tiles,
                         int* heap_mem, float* __restrict__ t_out,
                         int* __restrict__ tri_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  extern __shared__ int s_heap[];
  __shared__ WideShared s;
  int* red = reinterpret_cast<int*>(s.red);
  int* heap = heap_mem ? heap_mem + static_cast<size_t>(blockIdx.x) * cp
                       : s_heap;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i = tile * TILE + threadIdx.x;
    const Ray ray = load_ray(i, o, d, tnear, tfar);
    MmaRays m{};
    if constexpr (MMA) m = mma_rays(ray);
    __syncthreads();  // the last tile's walk has ended
    load_tile(ray, s.ray);
    __syncthreads();
    tile_entries_wide(lo, hi, cp, n_real, s.ray, heap);
    __syncthreads();

    float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1, csel;
    int emin = pop_min_wide(heap, cp, s.red, csel);
    int thresh = block_max(__float_as_int(best_t), red);
    for (int nv = 0; nv < cp && emin < thresh; ++nv) {
      for (int half = 0; half < 2; ++half) {
        visit_closest<MMA>(rows, ids, csel, ray, s.rows, best_t, best_i,
                           best_u, best_v, m);
        emin = pop_min_wide(heap, cp, s.red, csel);
      }
      thresh = block_max(__float_as_int(best_t), red);
    }
    write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                  v_out);
  }
}

template <bool MMA>
__global__ void __launch_bounds__(TILE)
walk_anyhit_wide_kernel(const float* __restrict__ lo,
                        const float* __restrict__ hi, int cp, int n_real,
                        const float4* __restrict__ rows,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar, int tiles,
                        int* heap_mem, bool* __restrict__ occ_out) {
  extern __shared__ int s_heap[];
  __shared__ WideShared s;
  int* red = reinterpret_cast<int*>(s.red);
  int* heap = heap_mem ? heap_mem + static_cast<size_t>(blockIdx.x) * cp
                       : s_heap;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i = tile * TILE + threadIdx.x;
    const Ray ray = load_ray(i, o, d, tnear, tfar);
    MmaRays m{};
    if constexpr (MMA) m = mma_rays(ray);
    __syncthreads();  // the last tile's walk has ended
    load_tile(ray, s.ray);
    __syncthreads();
    tile_entries_wide(lo, hi, cp, n_real, s.ray, heap);
    __syncthreads();

    bool occ = false;
    int csel;
    int emin = pop_min_wide(heap, cp, s.red, csel);
    int thresh = block_max(__float_as_int(ray.tfar), red);
    for (int nv = 0; nv < cp && emin < thresh; ++nv) {
      for (int half = 0; half < 2; ++half) {
        visit_anyhit<MMA>(rows, csel, ray, s.rows, occ, m);
        emin = pop_min_wide(heap, cp, s.red, csel);
      }
      thresh = block_max(occ ? 0 : __float_as_int(ray.tfar), red);
    }
    occ_out[i] = occ;
  }
}

// The kernel of a form: (1, 0) one thread a ray, else the split form built
// (mma: the split tensor-core visit). RL_LAB_FORMS also builds the split
// tensor-core visit at P = 2 and 4 with the production feed, and the
// closest hit's at its P with the other feed, for tools/perf/sub_forms.py;
// nullptr for a form not built.
using ClosestKernel = decltype(&walk_closest_kernel<false, false>);

ClosestKernel closest_kernel(int mma, int p, int ring) {
  if (p == 1 && !ring)
    return mma ? walk_closest_kernel<true, false>
               : walk_closest_kernel<false, false>;
  if (is_form<CLOSEST_P, CLOSEST_RING>(p, ring))
    return mma ? walk_closest_split_kernel<false, CLOSEST_P, CLOSEST_RING,
                                           true>
               : walk_closest_split_kernel<false, CLOSEST_P, CLOSEST_RING,
                                           false>;
#ifdef RL_LAB_FORMS
  if (mma && is_form<4, CLOSEST_RING>(p, ring))
    return walk_closest_split_kernel<false, 4, CLOSEST_RING, true>;
  if (mma && is_form<2, CLOSEST_RING>(p, ring))
    return walk_closest_split_kernel<false, 2, CLOSEST_RING, true>;
  if (mma && is_form<CLOSEST_P, !CLOSEST_RING>(p, ring))
    return walk_closest_split_kernel<false, CLOSEST_P, !CLOSEST_RING, true>;
#endif
  return nullptr;
}

using AnyhitKernel = decltype(&walk_anyhit_kernel<false>);

AnyhitKernel anyhit_kernel(int mma, int p, int ring) {
  if (p == 1 && !ring)
    return mma ? walk_anyhit_kernel<true> : walk_anyhit_kernel<false>;
  if (is_form<ANYHIT_P, ANYHIT_RING>(p, ring))
    return mma ? walk_anyhit_split_kernel<ANYHIT_P, ANYHIT_RING, true>
               : walk_anyhit_split_kernel<ANYHIT_P, ANYHIT_RING, false>;
#ifdef RL_LAB_FORMS
  if (mma && is_form<4, ANYHIT_RING>(p, ring))
    return walk_anyhit_split_kernel<4, ANYHIT_RING, true>;
  if (mma && is_form<2, ANYHIT_RING>(p, ring))
    return walk_anyhit_split_kernel<2, ANYHIT_RING, true>;
#endif
  return nullptr;
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads). mma != 0 takes the
// tensor-core form of the triangle test. p threads a ray and ring name the
// form: (1, 0) the one-thread-a-ray kernel, else the split form this
// library builds (walk_flat.cuh: CLOSEST_P and CLOSEST_RING, ANYHIT_P and
// ANYHIT_RING; with mma, the split tensor-core visit); smem is the dynamic
// shared memory the wrapper computed for it (ops/walk_trace.py:
// launch_geometry). Returns cudaErrorInvalidValue for a form not built.
extern "C" int rl_walk_closest(const void* lo, const void* hi, int cp,
                               int n_real, const void* rows, const void* ids,
                               const void* o, const void* d, const void* tnear,
                               const void* tfar, int n, int mma, int p,
                               int ring, int smem, void* t_out, void* tri_out,
                               void* u_out, void* v_out, void* stream) {
  const auto kernel = closest_kernel(mma, p, ring);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      kernel, n / TILE, p * TILE, static_cast<size_t>(smem), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(nullptr));
}

extern "C" int rl_walk_anyhit(const void* lo, const void* hi, int cp,
                              int n_real, const void* rows, const void* o,
                              const void* d, const void* tnear,
                              const void* tfar, int n, int mma, int p,
                              int ring, int smem, void* occ_out,
                              void* stream) {
  const auto kernel = anyhit_kernel(mma, p, ring);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  return launch_threads(
      kernel, n / TILE, p * TILE, static_cast<size_t>(smem), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), static_cast<bool*>(occ_out));
}

// The wide pop: `blocks` blocks walk the n / 64 tiles; `heap` is null (heaps
// in shared memory) or a device buffer of blocks * cp ints.
extern "C" int rl_walk_closest_wide(const void* lo, const void* hi, int cp,
                                    int n_real, const void* rows,
                                    const void* ids, const void* o,
                                    const void* d, const void* tnear,
                                    const void* tfar, int n, int mma,
                                    void* heap, int blocks, void* t_out,
                                    void* tri_out, void* u_out, void* v_out,
                                    void* stream) {
  return launch(
      mma ? walk_closest_wide_kernel<true> : walk_closest_wide_kernel<false>,
      blocks, heap ? 0 : static_cast<size_t>(cp) * sizeof(int), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar),
      n / TILE, static_cast<int*>(heap), static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
}

extern "C" int rl_walk_anyhit_wide(const void* lo, const void* hi, int cp,
                                   int n_real, const void* rows, const void* o,
                                   const void* d, const void* tnear,
                                   const void* tfar, int n, int mma,
                                   void* heap, int blocks, void* occ_out,
                                   void* stream) {
  return launch(
      mma ? walk_anyhit_wide_kernel<true> : walk_anyhit_wide_kernel<false>,
      blocks, heap ? 0 : static_cast<size_t>(cp) * sizeof(int), stream,
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), n / TILE, static_cast<int*>(heap),
      static_cast<bool*>(occ_out));
}
