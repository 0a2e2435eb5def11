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
// pair's result depends on nothing but its own ray, cluster and cap, so the
// card takes the pairs in another order.
//
// The split form (pair_split_kernel, what the wrappers launch): the wrapper
// sorts the live pairs by cluster id on the device and lays them out in runs
// of RUN = 64 slots of one cluster (perm: the original pair of each slot,
// -1 for a pad; ops/pair_trace.py:_cluster_runs); inert pairs never enter,
// and the wrapper fills their miss. A block of P x 64 threads takes a run:
// it stages the cluster's 18 KB of rows once into shared memory by one bulk
// copy completed on an mbarrier (walk_common.cuh: bulk_rows), skipped when
// no pair of the run wants it, and tests them with P threads a pair
// (walk_common.cuh: split_closest, split_anyhit; the (t, column) minimum is
// the serial scan's winner) or, with MMA, with the tensor-core test split
// over the P warps of each 32-pair set by column blocks (split_mma), bit for
// bit the one-thread tensor-core kernel below. Each result goes to its
// original pair. The laboratory forms (RL_LAB_FORMS: P = 4; a block walking
// RUNS consecutive runs and copying only when the cluster changes; the same
// with a two-slot ring that copies the next run's cluster while the current
// one is tested; the tensor-core test at P = 8, 4, 2, 1 warps a 32-pair
// set) are timed against it by tools/perf/split_forms.py.
//
// What bounds it: the tests, about 25 f32 operations each, 384 a live pair
// (65 M at km = 8 on grid122k's spread wavefront: 24 us at 67 TFLOP/s). The
// parent's form (pair_closest_kernel, pair_anyhit_kernel below: a warp a
// pair, lane l testing columns l, l + 32, ... straight from the table, then
// a shuffle reduction over (t bits, column)) read a cluster's 18 KB of rows
// through L1/L2 for every pair, about 3.1 GB a launch at km = 8, and walked
// its 32 pairs one after the other, inert ones included; the split form
// reads them once a run. t > tnear >= 0 in the pair walk, but the split
// visit compares t as a float, so it holds for any tnear. The parent's
// kernels stay as the yardstick the wrappers' private _form reaches.
//
// Arithmetic is IEEE f32 without contraction (tri_test.cuh), so the _dot4
// results are bit-identical to the plain versions in ops/pair_trace.py.
//
// The tensor-core form of the test (tri_test_mma.cuh, not bit-identical to
// the _dot4 form) needs the 16 rays of a fragment to share a cluster. Its
// yardstick, pair_mma_kernel, takes the same layout in runs of 32 and scans
// a run's 32 rays one thread a ray, a warp alone over all 48 column blocks,
// straight from the table. (The reference's schedule, a 64-pair tile
// walking its distinct cluster ids with the other pairs' caps at -inf, took
// 2.6x as long at km = 8 on an H100: PERF.md section 6.)
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "walk_common.cuh"

namespace {

using namespace rl::walk;

using rl::Ray;
using rl::load_ray;
using rl::test_tri;

constexpr int PAIR_TILE = 64;

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
  const MmaRays m = mma_rays(ray);
  if (!__any_sync(FULL, want)) return;  // the wrapper filled the misses
  const float* c_rows =
      reinterpret_cast<const float*>(rows + static_cast<size_t>(c) * (3 * KC));
  const float cap = want ? ray.tfar : -CUDART_INF_F;
  if constexpr (ANY) {
    const bool occ = mma_scan_anyhit<32>(c_rows, m, cap);
    if (p >= 0) occ_out[p] = occ;
  } else {
    float t, u, v;
    int j;
    mma_scan_closest<32>(c_rows, m, cap, t, j, u, v);
    if (p >= 0 && j < KC) {
      t_out[p] = t;
      tri_out[p] = ids[static_cast<size_t>(c) * KC + j];
      // + 0 maps a -0 barycentric to +0, as the walk kernels' output does
      u_out[p] = __fadd_rn(u, 0.0f);
      v_out[p] = __fadd_rn(v, 0.0f);
    }
  }
}

// ------------------------------------------------------------ split form

constexpr int RUN = TILE;   // pairs of one cluster a run: a block's set

// The split forms this library builds: P threads a pair, one run a block,
// the rows staged at the run; PAIR_MMA_P warps a 32-pair set for the
// tensor-core test (ops/pair_trace.py:PRODUCTION_FORM, MMA_FORM). Each the
// faster on an H100 on the main path's pairs, the kernel alone in turns
// (PERF.md section 6): P = 4 and 4 runs a block, with or without the ring,
// tied or lost for the _dot4 test; for the tensor-core one P = 8 and 4
// lost to the one-thread kernel (the split adds barriers, scratch and the
// merge to a scan that 16,000 warps already fill the card with, and 512
// threads at 102 registers leave one block an SM), P = 2 and 1 beat it.
constexpr int PAIR_P = 8;
constexpr int PAIR_MMA_P = 2;

struct PairArgs {
  const float4* rows;
  const int* ids;
  const float* o;
  const float* d;
  const float* tnear;
  const float* tcap;
  const int* cid;
  const int* perm;
  int n_runs;
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  bool* occ_out;
};

// A block of P x RUN threads takes the RUNS consecutive runs
// blockIdx.x x RUNS, ...; thread k of a run's pair slot k / P is its lane
// k % P. A run whose first slot is a pad is past the end of the layout, as
// is every run after it. Dynamic shared memory: the rows' slots (two with
// RING, else one), then with MMA the split tensor-core visit's scratch.
// The stage copies a run's cluster when it differs from the one in the
// slot and some pair of the run wants it. The ring issues the copy of the
// next run's cluster, when it differs, before the current run's tests;
// every copy issued is for a run the block then tests, and each thread
// waits for it there, so none is in flight at the exit. Copy k goes to slot
// k & 1 (k with no ring) and completes phase k >> 1 (k) of its barrier.
template <bool ANY, bool MMA, int P, int RUNS, bool RING>
__global__ void __launch_bounds__(P * RUN)
pair_split_kernel(const PairArgs a) {
  extern __shared__ float4 s_dyn[];
  __shared__ uint64_t s_bar[2];
  const MmaScratch mx = mma_scratch(s_dyn + (RING ? 2 : 1) * 3 * KC);
  const int r0 = blockIdx.x * RUNS;
  const int r1 = min(r0 + RUNS, a.n_runs);
  if (a.perm[r0 * RUN] < 0) return;          // block-uniform: padding only
  mbar_init(s_bar, RING ? 2 : 1);
  __syncthreads();
  int copies = 0, staged = -1, slot = 0;     // alike in every thread
  if constexpr (RING) {
    if (threadIdx.x == 0)
      bulk_rows(s_dyn, s_bar, a.rows, a.cid[a.perm[r0 * RUN]]);
    copies = 1;
  }
  for (int r = r0; r < r1; ++r) {
    const int* run = a.perm + r * RUN;
    const int lead = run[0];
    if (lead < 0) break;                     // block-uniform
    const int c = a.cid[lead];
    const int p = run[threadIdx.x / P];
    const Ray ray = load_ray(p >= 0 ? p : lead, a.o, a.d, a.tnear, a.tcap);
    const bool want = p >= 0 && ray.tnear < ray.tfar;
    if constexpr (MMA) put_cap<P>(mx, want, ray.tfar);
    // ends the last run's reads of the slots and of mx; publishes the caps
    const bool any = __syncthreads_or(want);
    if constexpr (RING) {
      if (c != staged) {                     // copy copies - 1 holds c
        if (staged >= 0) slot ^= 1;
        staged = c;
        mbar_wait(&s_bar[slot], ((copies - 1) >> 1) & 1);
      }
      const int nl = r + 1 < r1 ? run[RUN] : -1;
      const int cn = nl >= 0 ? a.cid[nl] : c;
      if (cn != c) {
        if (threadIdx.x == 0)
          bulk_rows(s_dyn + (slot ^ 1) * 3 * KC, &s_bar[slot ^ 1], a.rows, cn);
        ++copies;
      }
      if (!any) continue;
    } else {
      if (!any) continue;
      if (c != staged) {
        if (threadIdx.x == 0) bulk_rows(s_dyn, s_bar, a.rows, c);
        mbar_wait(s_bar, copies & 1);
        ++copies;
        staged = c;
      }
    }
    const float4* c_rows = s_dyn + slot * 3 * KC;
    float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1;
    bool occ = false;
    if constexpr (MMA) {
      float t, u, v;
      int j;
      split_mma<P, 32, ANY>(
          reinterpret_cast<const float*>(c_rows),
          mma_rays_idx(a.o, a.d, a.tnear, run + (threadIdx.x >> 5) / P * 32,
                       lead),
          mx, BlockSync{}, t, j, u, v);
      if (j < KC) {
        occ = true;
        if constexpr (!ANY) {
          best_t = t;
          best_i = a.ids[static_cast<size_t>(c) * KC + j];
          best_u = u;
          best_v = v;
        }
      }
    } else if constexpr (ANY) {
      split_anyhit<P>(c_rows, ray, want, occ);
    } else {
      split_closest<P>(c_rows, a.ids, c, ray, want, best_t, best_i, best_u,
                       best_v);
    }
    if (p < 0 || threadIdx.x % P) continue;
    if constexpr (ANY)
      a.occ_out[p] = occ;
    else
      write_closest(p, best_t, best_i, best_u, best_v, a.t_out, a.tri_out,
                    a.u_out, a.v_out);
  }
}

template <bool ANY, bool MMA, int P, int RUNS, bool RING>
int launch_split(const PairArgs& a, int smem, void* stream) {
  return launch_threads(pair_split_kernel<ANY, MMA, P, RUNS, RING>,
                        (a.n_runs + RUNS - 1) / RUNS, P * RUN,
                        static_cast<size_t>(smem), stream, a);
}

// A split launch in form (p, runs, ring): the production forms, PAIR_P for
// the _dot4 test and PAIR_MMA_P for the tensor-core one; RL_LAB_FORMS also
// builds the _dot4 test at P = 4, at 4 runs a block, and at 4 runs a block
// with the ring, and the tensor-core test at P = 8, 4, 2 and 1 (one warp a
// set: all 48 column blocks over the staged rows). cudaErrorInvalidValue
// for a form not built.
template <bool ANY>
int launch_split_form(const PairArgs& a, int mma, int p, int runs, int ring,
                      int smem, void* stream) {
  if (runs == 1 && !ring && p == (mma ? PAIR_MMA_P : PAIR_P))
    return mma ? launch_split<ANY, true, PAIR_MMA_P, 1, false>(a, smem, stream)
               : launch_split<ANY, false, PAIR_P, 1, false>(a, smem, stream);
#ifdef RL_LAB_FORMS
  if (!mma && p == 4 && runs == 1 && !ring)
    return launch_split<ANY, false, 4, 1, false>(a, smem, stream);
  if (!mma && p == PAIR_P && runs == 4)
    return ring ? launch_split<ANY, false, PAIR_P, 4, true>(a, smem, stream)
                : launch_split<ANY, false, PAIR_P, 4, false>(a, smem, stream);
  if (mma && runs == 1 && !ring) {
    if (p == 8) return launch_split<ANY, true, 8, 1, false>(a, smem, stream);
    if (p == 4) return launch_split<ANY, true, 4, 1, false>(a, smem, stream);
    if (p == 2) return launch_split<ANY, true, 2, 1, false>(a, smem, stream);
    if (p == 1) return launch_split<ANY, true, 1, 1, false>(a, smem, stream);
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The split form over the layout perm of n_slots slots (a multiple of 64;
// see pair_split_kernel); writes the live pairs only. any_hit picks the
// outputs: occ_out, or t/tri/u/v_out; mma the test; (p, runs, ring) the
// form and smem its dynamic shared memory (ops/pair_trace.py:
// launch_geometry). cudaErrorInvalidValue for a form not built.
extern "C" int rl_pair_split(int any_hit, int mma, int p, int runs, int ring,
                             int smem, const void* rows, const void* ids,
                             const void* o, const void* d, const void* tnear,
                             const void* tcap, const void* cid,
                             const void* perm, int n_slots, void* t_out,
                             void* tri_out, void* u_out, void* v_out,
                             void* occ_out, void* stream) {
  const PairArgs a{static_cast<const float4*>(rows),
                   static_cast<const int*>(ids),
                   static_cast<const float*>(o),
                   static_cast<const float*>(d),
                   static_cast<const float*>(tnear),
                   static_cast<const float*>(tcap),
                   static_cast<const int*>(cid),
                   static_cast<const int*>(perm),
                   n_slots / RUN,
                   static_cast<float*>(t_out),
                   static_cast<int*>(tri_out),
                   static_cast<float*>(u_out),
                   static_cast<float*>(v_out),
                   static_cast<bool*>(occ_out)};
  return any_hit ? launch_split_form<true>(a, mma, p, runs, ring, smem, stream)
                 : launch_split_form<false>(a, mma, p, runs, ring, smem,
                                            stream);
}

// The parent's forms, the wrappers' yardstick. m must be a multiple of 64
// (the caller pads with inert pairs).
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
