// Sub-tiled tile walk for Hopper (sm_90a): closest hit and any hit over
// clustered walk tables, each 64-ray tile walked as SUB independent groups.
//
// Replaces the TPU kernels
// rustlight_tpu/accel/pallas_walk.py:_closest_kernel_sub and
// :_anyhit_kernel_sub (K6). Tables and rays are those of walk_trace.cu; the
// tables have at most 640 clusters (the reference's resident tables).
//
// The schedule is the reference's: the tile's 64 rays split into SUB (2, 4
// or 8) contiguous groups of GS = 64 / SUB rays; the entry pass gives each
// group its own packed entries (the minimum over the group's rays only,
// heap s * Cp of SUB * Cp * 4 B of dynamic shared memory); each group pops
// front to back, visits two clusters per termination check, and stops when
// its popped entry reaches the largest best t among its own rays, or after
// Cp pairs. Nothing one group does changes another's result. The reference
// runs the groups one after another; here they run side by side in one
// block of NT = P x 64 threads a tile, P threads a ray (ray threadIdx.x / P),
// so a group is GT = GS x P adjacent threads.
//
// What bounds it: the ray-triangle tests, as in walk_trace.cu; the rows of
// a 131k-triangle scene (6.3 MB) stay in L2. With one thread a ray (P = 1,
// the first form) every lane scans a visit's 384 triangles alone, the
// latency walk_trace.cu's split form removed from K3. The split form gives a
// visit to the ray's P threads (walk_common.cuh: split_closest /
// split_anyhit, lane q scanning columns q, q + P, ..., a (t, column)
// butterfly keeping the serial winner), so its results are the one-thread
// form's bit for bit.
//
// A group's pop and threshold are reductions over its GT threads
// (`Group`): shuffles while GT <= 32 (several groups then share a warp,
// which runs them in lockstep: a group that has stopped keeps its state and
// skips its visits until the warp's last group stops); past 32, a warp's
// shuffle and then per-warp partials in shared memory behind a named
// barrier of the group alone (bar.sync 1 + s, GT; two sets of partials
// taken in turn, so one barrier a reduction), since the groups stop at
// different times and a group must never wait on another. A popped entry
// is cleared by the thread that scans it, so a pop needs no barrier after
// it. The rows of a visit are read through L1 from the table, or, with
// STAGE, copied into a slot of 48 x KC B (18,432 at K = 384) per group
// (behind the group's barrier) when one of its rays wants them.
//
// With MMA a visit takes the tensor-core form of the triangle test
// (tri_test_mma.cuh, not bit-identical to the _dot4 form). One thread a ray:
// mma.sync is warp-collective, so the whole warp scans whenever one of its
// groups has a ray that wants the visit, each group against its own
// cluster's rows read from the table (a group of 32 lanes is the warp; of
// 16, an m16 row block, which takes the B fragments of its own cluster; of
// 8, half a row block, which runs once per cluster of its two groups unless
// both visit the same one). The split form (GT >= 32, so a warp lies in one
// group) splits the group's column blocks over its GT / 32 warps
// (walk_common.cuh: split_mma), the caps and partials in shared memory
// behind the group's barrier: bit for bit the one-thread tensor-core form.
// Lanes of a stopped group, rays with tnear >= best t and occluded rays
// enter the scan with a cap of -inf, and a slot of 8 rays with no cap skips
// its products.
//
// Arithmetic is IEEE f32 without contraction and min/max propagate NaN as
// torch.minimum/maximum do (walk_common.cuh), so the _dot4 forms are
// bit-identical to the plain version in ops/walk_sub.py, which is the
// one-level walk at a tile of GS rays.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a form it was not built with.

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using namespace rl::walk;
using rl::Ray;
using rl::load_ray;

// The split forms this library builds, per hit kind and test, for SUB = 2,
// 4 and 8: P threads a ray and whether the rows are staged. The fastest on
// an H100 on grid122k's spread wavefront (tools/perf/sub_forms.py; PERF.md
// section 6), as ops/walk_sub.py:PRODUCTION_FORMS and MMA_FORMS name them.
// The one-thread form (P = 1, not staged) is built for every SUB and both
// tests.
struct SubForm {
  int p;
  bool stage;
};
constexpr SubForm CLOSEST_FORMS[3] = {{8, true}, {8, true}, {8, false}};
constexpr SubForm ANYHIT_FORMS[3] = {{8, true}, {8, true}, {8, false}};
constexpr SubForm CLOSEST_MMA_FORMS[3] = {{4, true}, {4, true}, {8, true}};
constexpr SubForm ANYHIT_MMA_FORMS[3] = {{4, true}, {4, true}, {8, true}};

constexpr int sub_index(int sub) { return sub == 2 ? 0 : sub == 4 ? 1 : 2; }

// Whether the library has form (P, STAGE) of the kernel (ANY, MMA) at SUB.
// RL_LAB_FORMS builds every candidate form instead (tools/perf/sub_forms.py
// times them).
template <bool ANY, int SUB, int P, bool STAGE, bool MMA>
constexpr bool built() {
  if (P == 1) return !STAGE;
  if (MMA && TILE / SUB * P < 32) return false;
#ifdef RL_LAB_FORMS
  return true;
#else
  const SubForm f = (MMA ? (ANY ? ANYHIT_MMA_FORMS : CLOSEST_MMA_FORMS)
                         : (ANY ? ANYHIT_FORMS : CLOSEST_FORMS))[sub_index(SUB)];
  return f.p == P && f.stage == STAGE;
#endif
}

struct SubArgs {
  const float* lo;
  const float* hi;
  int cp, n_real;
  const float4* rows;
  const int* ids;
  const float* o;
  const float* d;
  const float* tnear;
  const float* tfar;
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  bool* occ_out;
};

// One group's reductions over its GT threads (see the head of this file).
template <int SUB, int P>
struct Group {
  static constexpr int GS = TILE / SUB;   // rays
  static constexpr int GT = GS * P;       // threads
  static constexpr int RW = GT > 32 ? GT / 32 : 1;   // partials a group
  int id;        // 0 .. SUB - 1
  int gl;        // thread of the group
  int* red;      // the block's partials, [2][SUB][RW]
  int parity = 0;

  __device__ __forceinline__ void sync() const {
    if constexpr (GT <= 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "n"(GT) : "memory");
  }
  __device__ __forceinline__ int reduce_min(int v) {
#pragma unroll
    for (int off = (GT < 32 ? GT : 32) / 2; off > 0; off >>= 1)
      v = min(v, __shfl_xor_sync(FULL, v, off));
    if constexpr (GT > 32) {
      int* part = red + (parity * SUB + id) * RW;
      if ((threadIdx.x & 31) == 0) part[gl >> 5] = v;
      sync();
      v = part[0];
      for (int k = 1; k < RW; ++k) v = min(v, part[k]);
      parity ^= 1;
    }
    return v;
  }
  // v >= 0: the bits of non-negative floats
  __device__ __forceinline__ int reduce_max(int v) { return -reduce_min(-v); }
  __device__ __forceinline__ bool any(bool x) { return reduce_min(!x) == 0; }
  // Pops the smallest entry of the group's heap; a group that has stopped
  // (`active` false, uniform over the group) takes part in the reduction
  // only. The thread that scans the popped entry clears it, so its next
  // scan sees the clear.
  __device__ __forceinline__ int pop(int* heap, int cp, bool active) {
    int m = INF_BITS;
    if (active)
      for (int c = gl; c < cp; c += GT) m = min(m, heap[c]);
    m = reduce_min(m);
    if (active && m != INF_BITS && (m & ID_MASK) % GT == gl)
      heap[m & ID_MASK] = INF_BITS;
    return m;
  }
};

template <int SUB, int P>
struct SubShared {
  TileRays ray;
  int red[2 * SUB * Group<SUB, P>::RW];
};

// s_ent[s * cp + c] = packed entry of cluster c for group s: the minimum
// over rays s * GS .. s * GS + GS - 1 of the slab entry, capped by tfar.
template <int SUB, int NT>
__device__ inline void group_entries(const float* __restrict__ lo,
                                     const float* __restrict__ hi, int cp,
                                     int n_real, const TileRays& r,
                                     int* s_ent) {
  constexpr int GS = TILE / SUB;
  for (int c = threadIdx.x; c < cp; c += NT) {
    const bool real = c < n_real;
    float l[3] = {0.0f, 0.0f, 0.0f}, h[3] = {0.0f, 0.0f, 0.0f};
    if (real) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        l[ax] = lo[ax * cp + c];
        h[ax] = hi[ax * cp + c];
      }
    }
#pragma unroll 1
    for (int s = 0; s < SUB; ++s) {
      float e = CUDART_INF_F;
      for (int j = s * GS; real && j < (s + 1) * GS; ++j) {
        float entry;
        if (slab_entry(l, h, r, j, r.tfar[j], entry)) e = fminf(e, entry);
      }
      s_ent[s * cp + c] = pack_entry(e, c, ID_MASK);
    }
  }
}

// The walk of one tile by NT = P x TILE threads. Dynamic shared memory: with
// STAGE SUB slots of 3 x KC float4, with the split tensor-core visit its
// caps and partials (mma_scratch_f4<NT>() float4), then the SUB heaps of Cp
// entries.
template <bool ANY, int SUB, int P, bool STAGE, bool MMA>
__device__ __forceinline__ void sub_walk(const SubArgs& a) {
  using G = Group<SUB, P>;
  constexpr int NT = P * TILE;
  constexpr bool SPLIT_MMA = MMA && P > 1;
  extern __shared__ float4 s_dyn[];
  __shared__ SubShared<SUB, P> s;
  float4* s_mma = s_dyn + (STAGE ? SUB * 3 * KC : 0);
  const MmaScratch mx = mma_scratch(s_mma);
  int* s_ent =
      reinterpret_cast<int*>(s_mma + (SPLIT_MMA ? mma_scratch_f4<NT>() : 0));
  const int r = threadIdx.x / P;
  const int i = blockIdx.x * TILE + r;
  const Ray ray = load_ray(i, a.o, a.d, a.tnear, a.tfar);
  MmaRays m1{};
  if constexpr (MMA && P == 1) m1 = mma_rays(ray);
  load_tile<P>(ray, s.ray);
  __syncthreads();
  group_entries<SUB, NT>(a.lo, a.hi, a.cp, a.n_real, s.ray, s_ent);
  __syncthreads();

  G grp{r / G::GS, static_cast<int>(threadIdx.x % G::GT), s.red};
  int* heap = s_ent + grp.id * a.cp;
  float4* slot = s_dyn + grp.id * 3 * KC;
  // best_t starts at tfar and only decreases: it is the closest hit's cap
  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  bool occ = false;
  int emin = grp.pop(heap, a.cp, true);
  int thresh = grp.reduce_max(__float_as_int(ray.tfar));
  int nv = 0;
  bool active = (emin & ~ID_MASK) < thresh;
  while (__any_sync(FULL, active)) {
    for (int half = 0; half < 2; ++half) {
      const float cap = ANY ? ray.tfar : best_t;
      const bool want = active && !occ && ray.tnear < cap;
      const int csel = min(emin & ID_MASK, a.cp - 1);
      const float4* src = a.rows + static_cast<size_t>(csel) * (3 * KC);
      float t, u, v;
      int j = KC;
      if constexpr (P == 1) {
        if constexpr (MMA) {
          if (__any_sync(FULL, want))
            mma_scan<G::GS, ANY>(reinterpret_cast<const float*>(src), m1,
                                 want ? cap : -CUDART_INF_F, t, j, u, v);
        } else if (want) {
          if constexpr (ANY)
            occ = scan_anyhit(src, ray);
          else
            scan_closest(src, a.ids, csel, ray, best_t, best_i, best_u,
                         best_v);
        }
      } else {
        if constexpr (MMA) put_cap<P>(mx, want, cap);
        bool go = true;
        if constexpr (STAGE || MMA) {
          go = grp.any(want);
          // orders the caps before their reads and the last visit's reads
          // of the slot before the copy (the reduction is shuffles alone)
          if constexpr (G::GT <= 32) __syncwarp();
        }
        const float4* c_rows = src;
        if constexpr (STAGE) {
          if (go)
            for (int k = grp.gl; k < 3 * KC; k += G::GT) slot[k] = src[k];
          grp.sync();
          c_rows = slot;
        }
        if constexpr (MMA) {
          if (go)
            split_mma<P, G::GS, ANY>(
                reinterpret_cast<const float*>(c_rows),
                set_rays<P>(a.o, a.d, a.tnear), mx, [&grp] { grp.sync(); }, t,
                j, u, v);
        } else if constexpr (ANY) {
          split_anyhit<P>(c_rows, ray, want && go, occ);
        } else {
          split_closest<P>(c_rows, a.ids, csel, ray, want && go, best_t,
                           best_i, best_u, best_v);
        }
      }
      if constexpr (MMA) {
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
      const int m = grp.pop(heap, a.cp, active);
      if (active) emin = m;
    }
    const int th = grp.reduce_max(
        ANY ? (occ ? 0 : __float_as_int(ray.tfar)) : __float_as_int(best_t));
    if (active) {
      thresh = th;
      ++nv;
      active = nv < a.cp && (emin & ~ID_MASK) < thresh;
    }
  }
  if (threadIdx.x % P) return;
  if constexpr (ANY)
    a.occ_out[i] = occ;
  else
    write_closest(i, best_t, best_i, best_u, best_v, a.t_out, a.tri_out,
                  a.u_out, a.v_out);
}

template <int SUB, int P, bool STAGE, bool MMA>
__global__ void __launch_bounds__(P * TILE)
walk_sub_closest_kernel(const SubArgs a) {
  sub_walk<false, SUB, P, STAGE, MMA>(a);
}

template <int SUB, int P, bool STAGE, bool MMA>
__global__ void __launch_bounds__(P * TILE)
walk_sub_anyhit_kernel(const SubArgs a) {
  sub_walk<true, SUB, P, STAGE, MMA>(a);
}

template <bool ANY, int SUB, int P, bool STAGE, bool MMA>
int launch_form(const SubArgs& a, int n, int smem, void* stream) {
  if constexpr (!built<ANY, SUB, P, STAGE, MMA>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (ANY) {
    return launch_threads(walk_sub_anyhit_kernel<SUB, P, STAGE, MMA>,
                          n / TILE, P * TILE, static_cast<size_t>(smem),
                          stream, a);
  } else {
    return launch_threads(walk_sub_closest_kernel<SUB, P, STAGE, MMA>,
                          n / TILE, P * TILE, static_cast<size_t>(smem),
                          stream, a);
  }
}

template <bool ANY, int SUB, int P>
int launch_p(int stage, int mma, const SubArgs& a, int n, int smem,
             void* stream) {
  if (stage)
    return mma ? launch_form<ANY, SUB, P, true, true>(a, n, smem, stream)
               : launch_form<ANY, SUB, P, true, false>(a, n, smem, stream);
  return mma ? launch_form<ANY, SUB, P, false, true>(a, n, smem, stream)
             : launch_form<ANY, SUB, P, false, false>(a, n, smem, stream);
}

template <bool ANY, int SUB>
int launch_sub(int p, int stage, int mma, const SubArgs& a, int n, int smem,
               void* stream) {
  switch (p) {
    case 1: return launch_p<ANY, SUB, 1>(stage, mma, a, n, smem, stream);
    case 2: return launch_p<ANY, SUB, 2>(stage, mma, a, n, smem, stream);
    case 4: return launch_p<ANY, SUB, 4>(stage, mma, a, n, smem, stream);
    case 8: return launch_p<ANY, SUB, 8>(stage, mma, a, n, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool ANY>
int launch_walk(int sub, int p, int stage, int mma, const SubArgs& a, int n,
                int smem, void* stream) {
  switch (sub) {
    case 2: return launch_sub<ANY, 2>(p, stage, mma, a, n, smem, stream);
    case 4: return launch_sub<ANY, 4>(p, stage, mma, a, n, smem, stream);
    case 8: return launch_sub<ANY, 8>(p, stage, mma, a, n, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads); sub is 2, 4 or 8. mma != 0
// takes the tensor-core form of the triangle test. (p, stage) name the
// form: (1, 0) the one-thread-a-ray kernel, else a split form this library
// builds (CLOSEST_FORMS ... above); smem is the dynamic shared memory the
// wrapper computed for it (ops/walk_sub.py:launch_geometry).
extern "C" int rl_walk_sub_closest(int sub, const void* lo, const void* hi,
                                   int cp, int n_real, const void* rows,
                                   const void* ids, const void* o,
                                   const void* d, const void* tnear,
                                   const void* tfar, int n, int mma, int p,
                                   int stage, int smem, void* t_out,
                                   void* tri_out, void* u_out, void* v_out,
                                   void* stream) {
  const SubArgs a{static_cast<const float*>(lo),
                  static_cast<const float*>(hi),
                  cp,
                  n_real,
                  static_cast<const float4*>(rows),
                  static_cast<const int*>(ids),
                  static_cast<const float*>(o),
                  static_cast<const float*>(d),
                  static_cast<const float*>(tnear),
                  static_cast<const float*>(tfar),
                  static_cast<float*>(t_out),
                  static_cast<int*>(tri_out),
                  static_cast<float*>(u_out),
                  static_cast<float*>(v_out),
                  nullptr};
  return launch_walk<false>(sub, p, stage, mma, a, n, smem, stream);
}

extern "C" int rl_walk_sub_anyhit(int sub, const void* lo, const void* hi,
                                  int cp, int n_real, const void* rows,
                                  const void* o, const void* d,
                                  const void* tnear, const void* tfar, int n,
                                  int mma, int p, int stage, int smem,
                                  void* occ_out, void* stream) {
  const SubArgs a{static_cast<const float*>(lo),
                  static_cast<const float*>(hi),
                  cp,
                  n_real,
                  static_cast<const float4*>(rows),
                  nullptr,
                  static_cast<const float*>(o),
                  static_cast<const float*>(d),
                  static_cast<const float*>(tnear),
                  static_cast<const float*>(tfar),
                  nullptr,
                  nullptr,
                  nullptr,
                  nullptr,
                  static_cast<bool*>(occ_out)};
  return launch_walk<true>(sub, p, stage, mma, a, n, smem, stream);
}
