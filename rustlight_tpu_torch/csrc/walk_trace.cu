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
// The wide pop (K3w: the same TPU kernels with wide=True, _tile_entries
// :540-541, _pop_min :548-575, for tables past 2^14 clusters, up to 2^17,
// that do not take the two-level walk): entries are the plain bits of
// max(entry, 0), no id packed. A pop is a block-wide min over (bits <<
// 32 | column), so the lowest column wins among equal entries, and clears
// that one slot; an empty heap pops column 0, as the reference's does, for a
// visit that can change nothing. The stop test compares the bits
// unstripped. The heaps of Cp x 4 B are in dynamic shared memory, or, when
// `heap` is given, in a slice per block of that device buffer; the grid is
// bounded by the caller and a block walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... so that the buffer stays bounded too.
//
// What bounds the wide pop on the card: at 18,816 clusters (grid5p7M) the
// visits' tests are 0.24 / 0.16 ms of a wavefront's work at 67 TFLOP/s,
// and the entry pass adds Cp x 64 slab tests a tile (1.2 G, about 0.4 ms),
// so its work is bound by operations as K3's is. The one-thread form
// (walk_closest_wide_kernel, walk_anyhit_wide_kernel: 64 threads, two
// warps) took 15.6 / 10.8 ms on grid5p7M's camera / AO wavefronts (NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md section 6): each thread ran 294
// clusters of the entry pass and read 294 entries a pop, a block-wide min
// over two warps, then 384 serial tests a visit; a 75 KB heap in shared
// memory left two such blocks an SM, so it lived in device memory. The split
// form (wide_walk below) is K3's layout over the wide heap: P = 8 threads a
// ray, 512 a block, the entry pass and each pop strided over all of them
// (37 entries a thread at 18,816), the min over 16 warp partials, the pop
// taken a visit ahead and cleared by the thread that scans the slot, the
// split visit of either test (walk_common.cuh: split_closest, split_anyhit,
// split_mma), the rows staged (closest) or in the ring (any hit). The entry
// pass reads a ray as two float4 and takes min/max as PTX's min.NaN /
// max.NaN (walk_common.cuh: slab_entry4): 2.4x faster than the one-thread
// form's arithmetic on the same data, bit for bit. A 75 KB heap in shared
// memory now still leaves 32 warps an SM (16 with the ring), and took the
// same time as one in device memory, so the one-thread form's rule stands
// (ops/walk_trace.py:_WIDE_SHARED_MAX). A pop over the minima of chunks of
// 32 entries saved at most 6% (PERF.md section 6) and was not kept. Every
// form is bit for bit the one-thread kernel of its test. Measured on
// grid5p7M's camera / AO wavefronts (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md section 6, tools/perf/split_forms.py): 4.6 / 3.5 ms against the
// one-thread form's 15.7 / 10.8 (heaps in device memory), 33-46% of it the
// entry pass (1.5-1.6 ms), 9-12% the pops, the rest the visits.
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

// The split forms of the wide pop this library builds (P threads a ray,
// RING), as ops/walk_trace.py:PRODUCTION_FORMS names them.
constexpr int WIDE_CLOSEST_P = 8;
constexpr bool WIDE_CLOSEST_RING = false;
constexpr int WIDE_ANYHIT_P = 8;
constexpr bool WIDE_ANYHIT_RING = true;

template <int NT = TILE>
__device__ __forceinline__ long long block_min64(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // every thread has read red from the last reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = min(r, red[w]);
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

// The same by the split kernels' NT threads (slab_entry4); thread c % NT
// writes entry c.
template <int NT>
__device__ inline void tile_entries_wide4(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int cp, int n_real,
                                          const TileRays4& r, int* heap) {
  for (int c = threadIdx.x; c < cp; c += NT) {
    int bits = INF_BITS;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      float e = CUDART_INF_F;
      for (int j = 0; j < TILE; ++j) {
        float entry;
        if (slab_entry4(l, h, r.o[j], r.inv[j], entry)) e = fminf(e, entry);
      }
      bits = pack_entry(e, 0, 0);
    }
    heap[c] = bits;
  }
}

// Pops the smallest entry, the lowest column among equals: returns its bits
// and sets csel; an empty heap gives INF_BITS and column 0. OWNER = false:
// thread 0 clears the popped slot, and the caller puts a barrier between
// this pop and the next scan. OWNER = true: the thread that scans the slot
// (csel % NT) clears it, so the next pop needs no barrier before it.
template <int NT = TILE, bool OWNER = false>
__device__ __forceinline__ int pop_min_wide(int* heap, int cp, long long* red,
                                            int& csel) {
  long long m = (static_cast<long long>(INF_BITS) << 32);
  for (int c = threadIdx.x; c < cp; c += NT)
    m = min(m, (static_cast<long long>(heap[c]) << 32) | c);
  m = block_min64<NT>(m, red);
  csel = static_cast<int>(m & 0xffffffffll);
  if (threadIdx.x == (OWNER ? csel % NT : 0)) heap[csel] = INF_BITS;
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

// ------------------------------------------------------ wide pop, split

template <int NT>
struct WideSplitShared {
  TileRays4 ray;
  uint64_t bar[2];
  long long red[NT / 32];
};

struct WideArgs {
  const float* lo;
  const float* hi;
  int cp, n_real;
  const float4* rows;
  const int* ids;
  const float* o;
  const float* d;
  const float* tnear;
  const float* tfar;
  int tiles;
  int* heap;           // null: the heaps in shared memory
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  bool* occ_out;
};

// A block's heap of the split wide walk: its slice of a.heap in device
// memory, or the dynamic shared memory past the feed's slots (and with MMA
// the split tensor-core visit's scratch).
template <int NT, bool RING, bool MMA>
__device__ __forceinline__ int* wide_heap(const WideArgs& a, float4* s_dyn) {
  if (a.heap) return a.heap + static_cast<size_t>(blockIdx.x) * a.cp;
  return reinterpret_cast<int*>(s_dyn + feed_slots<RING>() * 3 * KC +
                                (MMA ? mma_scratch_f4<NT>() : 0));
}

// The start of a tile of the split wide walk: once the last tile's walk has
// ended, the tile's rays into shared memory and the entry pass into the
// heap. Returns this thread's ray.
template <int P>
__device__ __forceinline__ Ray wide_tile_entries(const WideArgs& a, int tile,
                                                 TileRays4& s_ray, int* heap) {
  const Ray ray = load_ray(tile * TILE + threadIdx.x / P, a.o, a.d, a.tnear,
                           a.tfar);
  __syncthreads();
  load_tile4<P>(ray, s_ray);
  __syncthreads();
  tile_entries_wide4<P * TILE>(a.lo, a.hi, a.cp, a.n_real, s_ray, heap);
  return ray;
}

// The split form of the wide walk: walk_closest_split_kernel's layout (P
// threads a ray, NT = P x TILE, the pop a visit ahead and cleared by the
// thread that scans the slot, the feed, the split visit of either test)
// over the wide heap, a block walking tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... Dynamic shared memory: the feed's slots, with MMA the
// split tensor-core visit's scratch, then the heap unless it is in device
// memory (a.heap: Cp ints a block). Thread c % NT writes and scans entry c,
// so a pop needs no barrier before it. The feed's count of copies runs on
// across tiles, so its slots' mbarrier phases need no re-arming; each tile
// drains its copies in flight before the next tile's first barrier.
template <bool ANY, int P, bool RING, bool MMA>
__device__ __forceinline__ void wide_walk(const WideArgs& a) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ WideSplitShared<NT> s;
  float4* s_mma = s_dyn + feed_slots<RING>() * 3 * KC;
  const MmaScratch mx = mma_scratch(s_mma);
  int* heap = wide_heap<NT, RING, MMA>(a, s_dyn);
  int* red = reinterpret_cast<int*>(s.red);
  auto feed = make_feed<NT, RING>(s_dyn, s.bar);
  feed.init();
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const Ray ray = wide_tile_entries<P>(a, tile, s.ray, heap);
    float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1, csel, cnext;
    bool occ = false;
    int emin = pop_min_wide<NT, true>(heap, a.cp, s.red, csel);
    feed.prefetch(a.rows, csel);
    int enext = pop_min_wide<NT, true>(heap, a.cp, s.red, cnext);
    int thresh = block_max<NT>(__float_as_int(ray.tfar), red);
    for (int nv = 0; nv < a.cp && emin < thresh; ++nv) {
      for (int half = 0; half < 2; ++half) {
        feed.prefetch(a.rows, cnext);
        const float cap = ANY ? ray.tfar : best_t;
        const bool want = !occ && ray.tnear < cap;
        if constexpr (MMA) {
          put_cap<P>(mx, want, cap);
          if (const float4* c_rows = feed.take_all(a.rows, csel, want)) {
            float t, u, v;
            int j;
            split_mma<P, 32, ANY>(reinterpret_cast<const float*>(c_rows),
                                  set_rays<P>(a.o, a.d, a.tnear, tile), mx,
                                  BlockSync{}, t, j, u, v);
            if (j < KC) {
              if constexpr (ANY) {
                occ = true;
              } else {
                best_t = t;
                best_i = a.ids[static_cast<size_t>(csel) * KC + j];
                best_u = u;
                best_v = v;
              }
            }
          }
        } else if (const float4* c_rows = feed.take(a.rows, csel, want)) {
          if constexpr (ANY)
            split_anyhit<P>(c_rows, ray, want, occ);
          else
            split_closest<P>(c_rows, a.ids, csel, ray, want, best_t, best_i,
                             best_u, best_v);
        }
        emin = enext;
        csel = cnext;
        enext = pop_min_wide<NT, true>(heap, a.cp, s.red, cnext);
      }
      thresh = block_max<NT>(
          ANY ? (occ ? 0 : __float_as_int(ray.tfar)) : __float_as_int(best_t),
          red);
    }
    feed.drain();
    if (threadIdx.x % P) continue;
    const int i = tile * TILE + threadIdx.x / P;
    if constexpr (ANY)
      a.occ_out[i] = occ;
    else
      write_closest(i, best_t, best_i, best_u, best_v, a.t_out, a.tri_out,
                    a.u_out, a.v_out);
  }
}

template <int P, bool RING, bool MMA>
__global__ void __launch_bounds__(P * TILE)
walk_closest_wide_split_kernel(const WideArgs a) {
  wide_walk<false, P, RING, MMA>(a);
}

template <int P, bool RING, bool MMA>
__global__ void __launch_bounds__(P * TILE)
walk_anyhit_wide_split_kernel(const WideArgs a) {
  wide_walk<true, P, RING, MMA>(a);
}

template <bool ANY, int P, bool RING, bool MMA>
int launch_wide(const WideArgs& a, int blocks, int smem, void* stream) {
  if constexpr (ANY)
    return launch_threads(walk_anyhit_wide_split_kernel<P, RING, MMA>, blocks,
                          P * TILE, static_cast<size_t>(smem), stream, a);
  else
    return launch_threads(walk_closest_wide_split_kernel<P, RING, MMA>,
                          blocks, P * TILE, static_cast<size_t>(smem), stream,
                          a);
}

#ifdef RL_LAB_FORMS
// The laboratory forms of the production split wide walk, with its layout,
// heap and dynamic shared memory, that split its time
// (tools/perf/split_forms.py): LAB 1 returns after the entry pass and the
// first pop; LAB 2 also pops as many visits as visits[tile] says (the
// plain version's count, which the production walk's equals), with the
// termination checks' reductions, and tests nothing. Both write the last
// popped bits (t_out, or occ_out: whether they are finite).
template <bool ANY, int P, bool RING, int LAB>
__global__ void __launch_bounds__(P * TILE)
walk_wide_lab_kernel(const WideArgs a, const int* visits) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ WideSplitShared<NT> s;
  int* heap = wide_heap<NT, RING, false>(a, s_dyn);
  int* red = reinterpret_cast<int*>(s.red);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    [[maybe_unused]] const Ray ray =
        wide_tile_entries<P>(a, tile, s.ray, heap);
    int csel, cnext;
    int out = pop_min_wide<NT, true>(heap, a.cp, s.red, csel);
    if constexpr (LAB == 2) {
      int enext = pop_min_wide<NT, true>(heap, a.cp, s.red, cnext);
      int thresh = block_max<NT>(__float_as_int(ray.tfar), red);
      for (int nv = 0; nv < visits[tile]; nv += 2) {
        const int emin = pop_min_wide<NT, true>(heap, a.cp, s.red, csel);
        enext = pop_min_wide<NT, true>(heap, a.cp, s.red, cnext);
        thresh = block_max<NT>(emin ^ cnext, red);
      }
      out = enext ^ thresh;
    }
    if (threadIdx.x % P) continue;
    const int i = tile * TILE + threadIdx.x / P;
    if constexpr (ANY)
      a.occ_out[i] = out != INF_BITS;
    else
      a.t_out[i] = __int_as_float(out);
  }
}
#endif

// A wide launch in form (p, ring): (1, 0) the one-thread kernels, else the
// split form this library builds (mma: the split tensor-core visit);
// RL_LAB_FORMS also builds the _dot4 form at P = 4 and with the other
// feed. cudaErrorInvalidValue for a form not built.
template <bool ANY>
int launch_wide_form(const WideArgs& a, int mma, int p, int ring, int blocks,
                     int smem, void* stream) {
  constexpr int WP = ANY ? WIDE_ANYHIT_P : WIDE_CLOSEST_P;
  constexpr bool WR = ANY ? WIDE_ANYHIT_RING : WIDE_CLOSEST_RING;
  if (p == WP && (ring != 0) == WR)
    return mma ? launch_wide<ANY, WP, WR, true>(a, blocks, smem, stream)
               : launch_wide<ANY, WP, WR, false>(a, blocks, smem, stream);
#ifdef RL_LAB_FORMS
  if (!mma && p == WP)
    return launch_wide<ANY, WP, !WR, false>(a, blocks, smem, stream);
  if (!mma && p == 4 && (ring != 0) == WR)
    return launch_wide<ANY, 4, WR, false>(a, blocks, smem, stream);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
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

// The triangles per cluster this library was built for (RL_KC): the
// wrappers refuse walk tables of another K (ops/native.py:check_lib_k).
extern "C" int rl_kc() { return KC; }

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
// in shared memory) or a device buffer of blocks x Cp ints. (p, ring) name
// the form as in rl_walk_closest (the split ones: WIDE_CLOSEST_P ...
// above), and smem is the dynamic shared memory the wrapper computed
// (ops/walk_trace.py:launch_geometry). Returns cudaErrorInvalidValue for a
// form not built.
extern "C" int rl_walk_closest_wide(const void* lo, const void* hi, int cp,
                                    int n_real, const void* rows,
                                    const void* ids, const void* o,
                                    const void* d, const void* tnear,
                                    const void* tfar, int n, int mma, int p,
                                    int ring, int smem, void* heap,
                                    int blocks, void* t_out, void* tri_out,
                                    void* u_out, void* v_out, void* stream) {
  if (p == 1 && !ring)
    return launch(
        mma ? walk_closest_wide_kernel<true> : walk_closest_wide_kernel<false>,
        blocks, static_cast<size_t>(smem), stream,
        static_cast<const float*>(lo), static_cast<const float*>(hi), cp,
        n_real, static_cast<const float4*>(rows), static_cast<const int*>(ids),
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tnear), static_cast<const float*>(tfar),
        n / TILE, static_cast<int*>(heap), static_cast<float*>(t_out),
        static_cast<int*>(tri_out), static_cast<float*>(u_out),
        static_cast<float*>(v_out));
  const WideArgs a{static_cast<const float*>(lo),
                   static_cast<const float*>(hi),
                   cp,
                   n_real,
                   static_cast<const float4*>(rows),
                   static_cast<const int*>(ids),
                   static_cast<const float*>(o),
                   static_cast<const float*>(d),
                   static_cast<const float*>(tnear),
                   static_cast<const float*>(tfar),
                   n / TILE,
                   static_cast<int*>(heap),
                   static_cast<float*>(t_out),
                   static_cast<int*>(tri_out),
                   static_cast<float*>(u_out),
                   static_cast<float*>(v_out),
                   nullptr};
  return launch_wide_form<false>(a, mma, p, ring, blocks, smem, stream);
}

extern "C" int rl_walk_anyhit_wide(const void* lo, const void* hi, int cp,
                                   int n_real, const void* rows, const void* o,
                                   const void* d, const void* tnear,
                                   const void* tfar, int n, int mma, int p,
                                   int ring, int smem, void* heap, int blocks,
                                   void* occ_out, void* stream) {
  if (p == 1 && !ring)
    return launch(
        mma ? walk_anyhit_wide_kernel<true> : walk_anyhit_wide_kernel<false>,
        blocks, static_cast<size_t>(smem), stream,
        static_cast<const float*>(lo), static_cast<const float*>(hi), cp,
        n_real, static_cast<const float4*>(rows),
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tnear), static_cast<const float*>(tfar),
        n / TILE, static_cast<int*>(heap), static_cast<bool*>(occ_out));
  const WideArgs a{static_cast<const float*>(lo),
                   static_cast<const float*>(hi),
                   cp,
                   n_real,
                   static_cast<const float4*>(rows),
                   nullptr,
                   static_cast<const float*>(o),
                   static_cast<const float*>(d),
                   static_cast<const float*>(tnear),
                   static_cast<const float*>(tfar),
                   n / TILE,
                   static_cast<int*>(heap),
                   nullptr,
                   nullptr,
                   nullptr,
                   nullptr,
                   static_cast<bool*>(occ_out)};
  return launch_wide_form<true>(a, mma, p, ring, blocks, smem, stream);
}

#ifdef RL_LAB_FORMS
// The laboratory forms of the production split wide walk (walk_wide_lab_kernel
// above; lab 1 or 2) over the arguments of rl_walk_closest_wide, `any`
// choosing the test: `out` is the t_out or occ_out it writes, `visits` the
// visits of each tile that lab 2 pops.
extern "C" int rl_walk_wide_lab(int any, int lab, const void* lo,
                                const void* hi, int cp, int n_real,
                                const void* o, const void* d,
                                const void* tnear, const void* tfar, int n,
                                const void* visits, int smem, void* heap,
                                int blocks, void* out, void* stream) {
  WideArgs a{};
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.cp = cp;
  a.n_real = n_real;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.tnear = static_cast<const float*>(tnear);
  a.tfar = static_cast<const float*>(tfar);
  a.tiles = n / TILE;
  a.heap = static_cast<int*>(heap);
  a.t_out = static_cast<float*>(out);
  a.occ_out = static_cast<bool*>(out);
  const int* v = static_cast<const int*>(visits);
  const size_t sm = static_cast<size_t>(smem);
  if (any) {
    constexpr int P = WIDE_ANYHIT_P;
    constexpr bool R = WIDE_ANYHIT_RING;
    if (lab == 1)
      return launch_threads(walk_wide_lab_kernel<true, P, R, 1>, blocks,
                            P * TILE, sm, stream, a, v);
    if (lab == 2)
      return launch_threads(walk_wide_lab_kernel<true, P, R, 2>, blocks,
                            P * TILE, sm, stream, a, v);
  } else {
    constexpr int P = WIDE_CLOSEST_P;
    constexpr bool R = WIDE_CLOSEST_RING;
    if (lab == 1)
      return launch_threads(walk_wide_lab_kernel<false, P, R, 1>, blocks,
                            P * TILE, sm, stream, a, v);
    if (lab == 2)
      return launch_threads(walk_wide_lab_kernel<false, P, R, 2>, blocks,
                            P * TILE, sm, stream, a, v);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
