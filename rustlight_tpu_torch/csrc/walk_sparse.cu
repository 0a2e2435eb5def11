// Sparse-visit tile walk for Hopper (sm_90a): closest hit and any hit over
// clustered walk tables, a visit testing only the rays that enter the
// popped cluster.
//
// Replaces the TPU kernels
// rustlight_tpu/accel/pallas_walk.py:_closest_kernel_sparse and
// :_anyhit_kernel_sparse (K7), with :_compact_rays and :_test_rows_cols.
// Tables and rays are those of walk_trace.cu; the tables have at most 640
// clusters (the reference's resident tables).
//
// The schedule is the one-level walk's (walk_trace.cu): one block per
// tile, one heap of packed entries, the same pops, two visits per
// termination check, the same stop test. The entry pass, which computes
// every ray's slab test of every cluster anyway, also keeps which rays
// enter which real cluster (tmax >= entry and entry < tfar, with entry =
// max(tmin, tnear)). The reference stores each ray's entry in a [Cp, 64]
// f32 matrix and reads only whether it is finite; here that is one 64-bit
// mask per cluster, bit j for ray j (Cp * 8 B of dynamic shared memory
// beside the Cp * 4 B heap). A visit reads the popped cluster's mask: with
// at most `cap` (16) bits set only the flagged rays test the cluster, else
// every ray does, which is the reference's branch; which rays are tested
// can decide a hit that lies on a cluster's boundary, so the plain version
// (ops/walk_sparse.py) branches alike. A tested ray's cap is its current
// best t and only a strictly nearer hit is written back.
//
// The reference gathers the flagged rays into 16 slots and scatters their
// hits back with one-hot matrix products, guarded against 0 * inf; those
// are a TPU's means to a gather and are not carried over. On the card the
// point of compaction is latency. The one-thread form (walk_sparse_*_kernel:
// 64 threads, the form the smoke run times beside the split one) ran a
// dense visit as one thread a ray, 384 serial tests with an IEEE division,
// and a sparse one as 16 slots of 4 threads, 96 tests a thread; its entry
// pass strode over 64 threads; 90 registers. It took 1.87 / 1.34 ms on
// grid122k's sorted spread wavefront against a 0.036 ms bound (NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md section 6): the latency of those chains on
// the longest tiles, as in K3 before its split form.
//
// The split form (sparse_walk below) is K3's layout: P = 8 threads a ray,
// NT = 512 a block, the entry pass and the pops strided over all of them,
// the pop taken a visit ahead and cleared by the thread that scans it, the
// rows staged at the visit (closest) or in the ring filled a visit ahead
// (any hit; walk_common.cuh: RingFeed). A dense visit is K3's split visit
// (split_closest / split_anyhit: 48 tests a thread). A sparse visit takes
// the NT threads as 16 slots of NT / 16 lanes, a warp a flagged ray at P =
// 8: lane q scans the columns q, q + 32, ..., 12 tests instead of 96, and
// a shuffle butterfly keeps the least (t, column), t compared as a float,
// which is the serial scan's winner; the any hit is a ballot of the slot's
// lanes. The slot's result goes back through shared memory to the ray's P
// threads. The entry pass is K3w's split one (walk_common.cuh:
// slab_entry4). Every form is bit for bit the one-thread kernel of its
// test. 59 / 49 registers (closest / any hit), so two 512-thread blocks
// share an SM; on grid122k's spread wavefront 0.83 / 0.58 ms against the
// one-thread form's 1.89 / 1.36 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6), where 90% of its visits are sparse, 6.6 rays flagged a visit.
//
// Arithmetic is IEEE f32 without contraction and min/max propagate NaN as
// torch.minimum/maximum do (walk_common.cuh), so the results are
// bit-identical to the plain versions.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using namespace rl::walk;
using rl::Ray;
using rl::load_ray;
using rl::test_tri;

typedef unsigned long long Mask;

// s_ent[c] = packed tile entry of cluster c, s_mask[c] = the rays that enter
// it (none for pads).
__device__ inline void tile_entries_flags(const float* __restrict__ lo,
                                          const float* __restrict__ hi, int cp,
                                          int n_real, const TileRays& r,
                                          int* s_ent, Mask* s_mask) {
  for (int c = threadIdx.x; c < cp; c += TILE) {
    float e = CUDART_INF_F;
    Mask mk = 0;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      for (int j = 0; j < TILE; ++j) {
        float entry;
        if (slab_entry(l, h, r, j, r.tfar[j], entry)) {
          e = fminf(e, entry);
          mk |= Mask(1) << j;
        }
      }
    }
    s_ent[c] = pack_entry(e, c, ID_MASK);
    s_mask[c] = mk;
  }
}

// The same by the split kernel's NT threads (slab_entry4); thread c % NT
// writes entry c.
template <int NT>
__device__ inline void tile_entries_flags4(const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           int cp, int n_real,
                                           const TileRays4& r, int* s_ent,
                                           Mask* s_mask) {
  for (int c = threadIdx.x; c < cp; c += NT) {
    float e = CUDART_INF_F;
    Mask mk = 0;
    if (c < n_real) {
      const float l[3] = {lo[c], lo[cp + c], lo[2 * cp + c]};
      const float h[3] = {hi[c], hi[cp + c], hi[2 * cp + c]};
      for (int j = 0; j < TILE; ++j) {
        float entry;
        if (slab_entry4(l, h, r.o[j], r.inv[j], entry)) {
          e = fminf(e, entry);
          mk |= Mask(1) << j;
        }
      }
    }
    s_ent[c] = pack_entry(e, c, ID_MASK);
    s_mask[c] = mk;
  }
}

__device__ __forceinline__ int cluster_of(int bits, int cp) {
  return min(bits & ID_MASK, cp - 1);
}

constexpr int SLOTS = 16;            // the most rays a sparse visit tests
constexpr int PARTS = TILE / SLOTS;  // threads a slot
constexpr unsigned FULL = 0xffffffffu;

struct SparseShared {
  float4 rows[3 * KC];
  TileRays ray;
  float d[3][TILE];
  float cap[TILE];     // each ray's t cap in this visit
  float res_t[SLOTS];  // a sparse visit's result per slot; res_j < 0: none
  int res_j[SLOTS];
  float res_u[SLOTS];
  float res_v[SLOTS];
  int red[WARPS];
};

__device__ __forceinline__ void load_dir(const Ray& ray, SparseShared& s) {
  s.d[0][threadIdx.x] = ray.dx;
  s.d[1][threadIdx.x] = ray.dy;
  s.d[2][threadIdx.x] = ray.dz;
}

// The position of the n-th (from 0) set bit of mk, which has more than n.
__device__ __forceinline__ int nth_bit(Mask mk, int n) {
  const unsigned lo = static_cast<unsigned>(mk);
  const unsigned hi = static_cast<unsigned>(mk >> 32);
  const int nlo = __popc(lo);
  return n < nlo ? __fns(lo, 0, n + 1) : 32 + __fns(hi, 0, n - nlo + 1);
}

// The ray of this thread's slot in a sparse visit, capped by s.cap.
__device__ __forceinline__ Ray slot_ray(const SparseShared& s, Mask mk) {
  const int r = nth_bit(mk, threadIdx.x / PARTS);
  Ray ray;
  ray.ox = s.ray.o[0][r]; ray.oy = s.ray.o[1][r]; ray.oz = s.ray.o[2][r];
  ray.dx = s.d[0][r]; ray.dy = s.d[1][r]; ray.dz = s.d[2][r];
  ray.tnear = s.ray.tnear[r];
  ray.tfar = s.cap[r];
  return ray;
}

// The rank of ray r (this thread's by default) among the flagged rays of
// mk: its slot.
__device__ __forceinline__ int slot_of(Mask mk, int r = threadIdx.x) {
  return __popcll(mk & ((Mask(1) << r) - 1));
}

// One closest-hit visit of cluster csel: dense (one thread a ray) when more
// than cap rays are flagged, else sparse (four threads a flagged ray).
__device__ __forceinline__ void visit_closest_sparse(
    const float4* __restrict__ rows, const int* __restrict__ ids, int csel,
    int cap, const Ray& ray, SparseShared& s, const Mask* s_mask,
    float& best_t, int& best_i, float& best_u, float& best_v) {
  const Mask mk = s_mask[csel];
  const int cnt = __popcll(mk);
  if (cnt > cap) {
    const bool want = ray.tnear < best_t;
    if (stage(rows, csel, want, s.rows) && want)
      scan_closest(s.rows, ids, csel, ray, best_t, best_i, best_u, best_v);
    return;
  }
  const bool flagged = (mk >> threadIdx.x) & 1;
  s.cap[threadIdx.x] = best_t;  // published by stage's first barrier
  if (!stage(rows, csel, flagged && ray.tnear < best_t, s.rows)) return;
  const int slot = threadIdx.x / PARTS, part = threadIdx.x % PARTS;
  float lt = 0.0f, lu = 0.0f, lv = 0.0f;
  int lj = -1;
  if (slot < cnt) {
    const Ray rr = slot_ray(s, mk);
    if (rr.tnear < rr.tfar) {
      lt = rr.tfar;
      for (int j = part; j < KC; j += PARTS) {
        float t, u, v;
        if (test_tri(&s.rows[3 * j], rr, lt, t, u, v)) {
          lt = t; lj = j; lu = u; lv = v;
        }
      }
    }
  }
  unsigned long long key =
      lj >= 0 ? (static_cast<unsigned long long>(__float_as_uint(lt)) << 32) |
                    static_cast<unsigned>(lj)
              : ~0ull;
  for (int off = PARTS / 2; off > 0; off >>= 1)
    key = min(key, __shfl_xor_sync(FULL, key, off));
  // column j was scanned by part j % PARTS of the slot
  const int src = (threadIdx.x & 31 & ~(PARTS - 1)) |
                  (static_cast<int>(key) & (PARTS - 1));
  lu = __shfl_sync(FULL, lu, src);
  lv = __shfl_sync(FULL, lv, src);
  if (part == 0) {
    s.res_j[slot] = key == ~0ull ? -1 : static_cast<int>(key & 0xffffffffull);
    s.res_t[slot] = __uint_as_float(static_cast<unsigned>(key >> 32));
    s.res_u[slot] = lu;
    s.res_v[slot] = lv;
  }
  __syncthreads();
  if (flagged) {
    const int k = slot_of(mk);
    const int j = s.res_j[k];
    if (j >= 0) {  // found under the ray's cap: strictly nearer
      best_t = s.res_t[k];
      best_i = ids[static_cast<size_t>(csel) * KC + j];
      best_u = s.res_u[k];
      best_v = s.res_v[k];
    }
  }
}

// One any-hit visit of cluster csel, dense or sparse as above; a ray's cap
// is tfar, or 0 once occluded, so occluded rays skip the test.
__device__ __forceinline__ void visit_anyhit_sparse(
    const float4* __restrict__ rows, int csel, int cap, const Ray& ray,
    SparseShared& s, const Mask* s_mask, bool& occ) {
  const Mask mk = s_mask[csel];
  const int cnt = __popcll(mk);
  const bool open = !occ && ray.tnear < ray.tfar;
  if (cnt > cap) {
    if (stage(rows, csel, open, s.rows) && open && scan_anyhit(s.rows, ray))
      occ = true;
    return;
  }
  const bool flagged = (mk >> threadIdx.x) & 1;
  s.cap[threadIdx.x] = occ ? 0.0f : ray.tfar;
  if (!stage(rows, csel, flagged && open, s.rows)) return;
  const int slot = threadIdx.x / PARTS, part = threadIdx.x % PARTS;
  bool hit = false;
  if (slot < cnt) {
    const Ray rr = slot_ray(s, mk);
    if (rr.tnear < rr.tfar) {
      for (int j = part; j < KC && !hit; j += PARTS) {
        float t, u, v;
        hit = test_tri(&s.rows[3 * j], rr, rr.tfar, t, u, v);
      }
    }
  }
  const unsigned hits = __ballot_sync(FULL, hit);
  if (part == 0)
    s.res_j[slot] = (hits >> (threadIdx.x & 31)) & ((1u << PARTS) - 1);
  __syncthreads();
  if (flagged && s.res_j[slot_of(mk)]) occ = true;
}

__global__ void __launch_bounds__(TILE)
walk_sparse_closest_kernel(const float* __restrict__ lo,
                           const float* __restrict__ hi, int cp, int n_real,
                           const float4* __restrict__ rows,
                           const int* __restrict__ ids,
                           const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ tnear,
                           const float* __restrict__ tfar, int cap,
                           float* __restrict__ t_out,
                           int* __restrict__ tri_out,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out) {
  extern __shared__ Mask s_mask[];
  __shared__ SparseShared s;
  int* s_ent = reinterpret_cast<int*>(s_mask + cp);
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile(ray, s.ray);
  load_dir(ray, s);
  __syncthreads();
  tile_entries_flags(lo, hi, cp, n_real, s.ray, s_ent, s_mask);
  __syncthreads();

  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int emin = pop_min(s_ent, cp, ID_MASK, s.red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(best_t), s.red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      visit_closest_sparse(rows, ids, csel, cap, ray, s, s_mask, best_t,
                           best_i, best_u, best_v);
      emin = pop_min(s_ent, cp, ID_MASK, s.red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(__float_as_int(best_t), s.red);
  }
  write_closest(i, best_t, best_i, best_u, best_v, t_out, tri_out, u_out,
                v_out);
}

__global__ void __launch_bounds__(TILE)
walk_sparse_anyhit_kernel(const float* __restrict__ lo,
                          const float* __restrict__ hi, int cp, int n_real,
                          const float4* __restrict__ rows,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tnear,
                          const float* __restrict__ tfar, int cap,
                          bool* __restrict__ occ_out) {
  extern __shared__ Mask s_mask[];
  __shared__ SparseShared s;
  int* s_ent = reinterpret_cast<int*>(s_mask + cp);
  const int i = blockIdx.x * TILE + threadIdx.x;
  const Ray ray = load_ray(i, o, d, tnear, tfar);
  load_tile(ray, s.ray);
  load_dir(ray, s);
  __syncthreads();
  tile_entries_flags(lo, hi, cp, n_real, s.ray, s_ent, s_mask);
  __syncthreads();

  bool occ = false;
  int emin = pop_min(s_ent, cp, ID_MASK, s.red);
  int csel = cluster_of(emin, cp);
  int thresh = block_max(__float_as_int(ray.tfar), s.red);
  for (int nv = 0; nv < cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      visit_anyhit_sparse(rows, csel, cap, ray, s, s_mask, occ);
      emin = pop_min(s_ent, cp, ID_MASK, s.red);
      csel = cluster_of(emin, cp);
    }
    thresh = block_max(occ ? 0 : __float_as_int(ray.tfar), s.red);
  }
  occ_out[i] = occ;
}

// ------------------------------------------------------------- split form

// The split forms this library builds (P threads a ray, RING), as
// ops/walk_sparse.py:PRODUCTION_FORMS names them.
constexpr int SPARSE_CLOSEST_P = 8;
constexpr bool SPARSE_CLOSEST_RING = false;
constexpr int SPARSE_ANYHIT_P = 8;
constexpr bool SPARSE_ANYHIT_RING = true;

template <int NT>
struct SparseSplitShared {
  TileRays4 ray;
  float d[3][TILE];
  float cap[TILE];     // each ray's t cap in a sparse visit
  float res_t[SLOTS];  // a sparse visit's result per slot
  int res_j[SLOTS];    // its column, KC for none; any hit: whether it hit
  float res_u[SLOTS];
  float res_v[SLOTS];
  uint64_t bar[2];
  int red[NT / 32];
};

struct SparseArgs {
  const float* lo;
  const float* hi;
  int cp, n_real;
  const float4* rows;
  const int* ids;
  const float* o;
  const float* d;
  const float* tnear;
  const float* tfar;
  int cap;
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  bool* occ_out;
};

// One visit of cluster csel by the split form's NT = P x TILE threads
// (thread threadIdx.x of ray r = threadIdx.x / P). Dense when more than
// a.cap rays are flagged: K3's split visit, every ray's P threads testing
// every P-th column. Sparse otherwise: the NT threads as SLOTS slots of L =
// NT / SLOTS lanes (a warp at P = 8), slot k taking the k-th flagged ray
// (its origin, direction, tnear and cap from shared memory) and lane q the
// columns q, q + L, ... under the serial rule (a strict < against its
// running cap); then the slot's least (t, column), t compared as a float
// and the lower column on equal t, which is the serial scan's winner, or,
// for the any hit, the ballot of its lanes (each stops at its first hit).
// The slot's result goes back through shared memory to the ray's P
// threads, which take it: a hit found under the ray's cap is strictly
// nearer.
template <bool ANY, int P, typename FeedT>
__device__ __forceinline__ void sparse_visit(
    const SparseArgs& a, FeedT& feed, SparseSplitShared<P * TILE>& s,
    const Mask* s_mask, int csel, const Ray& ray, float& best_t, int& best_i,
    float& best_u, float& best_v, bool& occ) {
  constexpr int NT = P * TILE;
  constexpr int L = NT / SLOTS;
  static_assert(L >= P && L <= 32, "a slot lies in one warp");
  const Mask mk = s_mask[csel];
  const int cnt = __popcll(mk);
  const float cap = ANY ? (occ ? 0.0f : ray.tfar) : best_t;
  const int r = threadIdx.x / P;
  if (cnt > a.cap) {
    const bool want = ray.tnear < cap;
    if (const float4* c_rows = feed.take(a.rows, csel, want)) {
      if constexpr (ANY)
        split_anyhit<P>(c_rows, ray, want, occ);
      else
        split_closest<P>(c_rows, a.ids, csel, ray, want, best_t, best_i,
                         best_u, best_v);
    }
    return;
  }
  const bool flagged = (mk >> r) & 1;
  if (threadIdx.x % P == 0) s.cap[r] = cap;
  // its barrier publishes the caps; the last sparse visit's reads of them
  // and of res_* ended before the pops' barriers
  const float4* c_rows =
      feed.take_all(a.rows, csel, flagged && ray.tnear < cap);
  if (!c_rows) return;
  const int slot = threadIdx.x / L, lane = threadIdx.x % L;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bj = KC;
  bool hit = false;
  if (slot < cnt) {
    const int k = nth_bit(mk, slot);
    const float4 ro = s.ray.o[k];
    Ray q;
    q.ox = ro.x; q.oy = ro.y; q.oz = ro.z;
    q.dx = s.d[0][k]; q.dy = s.d[1][k]; q.dz = s.d[2][k];
    q.tnear = ro.w;
    q.tfar = s.cap[k];
    bt = q.tfar;
    if (q.tnear < q.tfar) {
      for (int j = lane; j < KC; j += L) {
        float t, u, v;
        if (test_tri(&c_rows[3 * j], q, bt, t, u, v)) {
          if constexpr (ANY) {
            hit = true;
            break;
          } else {
            bt = t; bj = j; bu = u; bv = v;
          }
        }
      }
    }
  }
  constexpr unsigned SLOT_MASK = L == 32 ? FULL : (1u << L) - 1;
  const int base = threadIdx.x & 31 & ~(L - 1);
  if constexpr (ANY) {
    const unsigned hits = __ballot_sync(FULL, hit);
    if (lane == 0) s.res_j[slot] = ((hits >> base) & SLOT_MASK) != 0;
  } else {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(FULL, bt, off);
      const int oj = __shfl_xor_sync(FULL, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    // column j was scanned by lane j % L of the slot
    const int src = base | (bj % L);
    bu = __shfl_sync(FULL, bu, src);
    bv = __shfl_sync(FULL, bv, src);
    if (lane == 0) {
      s.res_t[slot] = bt;
      s.res_j[slot] = bj;
      s.res_u[slot] = bu;
      s.res_v[slot] = bv;
    }
  }
  __syncthreads();
  if (!flagged) return;
  const int k = slot_of(mk, r);
  if constexpr (ANY) {
    if (s.res_j[k]) occ = true;
  } else if (s.res_j[k] < KC) {
    best_t = s.res_t[k];
    best_i = a.ids[static_cast<size_t>(csel) * KC + s.res_j[k]];
    best_u = s.res_u[k];
    best_v = s.res_v[k];
  }
}

// The split walk: walk_flat.cuh's walk_closest_split_kernel with the sparse
// visit. Dynamic shared memory: the feed's slots, then each cluster's ray
// mask (Cp x 8 B), then the heap (Cp x 4 B).
template <bool ANY, int P, bool RING>
__device__ __forceinline__ void sparse_walk(const SparseArgs& a) {
  constexpr int NT = P * TILE;
  extern __shared__ float4 s_dyn[];
  __shared__ SparseSplitShared<NT> s;
  Mask* s_mask = reinterpret_cast<Mask*>(s_dyn + feed_slots<RING>() * 3 * KC);
  int* s_ent = reinterpret_cast<int*>(s_mask + a.cp);
  auto feed = make_feed<NT, RING>(s_dyn, s.bar);
  feed.init();
  const int r = threadIdx.x / P;
  const int i = blockIdx.x * TILE + r;
  const Ray ray = load_ray(i, a.o, a.d, a.tnear, a.tfar);
  load_tile4<P>(ray, s.ray);
  if (threadIdx.x % P == 0) {
    s.d[0][r] = ray.dx;
    s.d[1][r] = ray.dy;
    s.d[2][r] = ray.dz;
  }
  __syncthreads();
  tile_entries_flags4<NT>(a.lo, a.hi, a.cp, a.n_real, s.ray, s_ent, s_mask);
  __syncthreads();  // every visit reads every mask

  float best_t = ray.tfar, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  bool occ = false;
  int emin = pop_min<NT, true>(s_ent, a.cp, ID_MASK, s.red);
  int csel = cluster_of(emin, a.cp);
  feed.prefetch(a.rows, csel);
  int enext = pop_min<NT, true>(s_ent, a.cp, ID_MASK, s.red);
  int cnext = cluster_of(enext, a.cp);
  int thresh = block_max<NT>(__float_as_int(ray.tfar), s.red);
  for (int nv = 0; nv < a.cp && (emin & ~ID_MASK) < thresh; ++nv) {
    for (int half = 0; half < 2; ++half) {
      feed.prefetch(a.rows, cnext);
      sparse_visit<ANY, P>(a, feed, s, s_mask, csel, ray, best_t, best_i,
                           best_u, best_v, occ);
      emin = enext;
      csel = cnext;
      enext = pop_min<NT, true>(s_ent, a.cp, ID_MASK, s.red);
      cnext = cluster_of(enext, a.cp);
    }
    thresh = block_max<NT>(
        ANY ? (occ ? 0 : __float_as_int(ray.tfar)) : __float_as_int(best_t),
        s.red);
  }
  feed.drain();
  if (threadIdx.x % P) return;
  if constexpr (ANY)
    a.occ_out[i] = occ;
  else
    write_closest(i, best_t, best_i, best_u, best_v, a.t_out, a.tri_out,
                  a.u_out, a.v_out);
}

template <int P, bool RING>
__global__ void __launch_bounds__(P * TILE)
walk_sparse_closest_split_kernel(const SparseArgs a) {
  sparse_walk<false, P, RING>(a);
}

template <int P, bool RING>
__global__ void __launch_bounds__(P * TILE)
walk_sparse_anyhit_split_kernel(const SparseArgs a) {
  sparse_walk<true, P, RING>(a);
}

// A split launch in form (P, RING) if the library builds it: the
// production form, and with RL_LAB_FORMS also P = 4 with the production
// feed and the production P with the other feed (tools/perf/split_forms.py).
template <bool ANY, int P, bool RING>
int launch_split(const SparseArgs& a, int n, int smem, void* stream) {
  constexpr int PP = ANY ? SPARSE_ANYHIT_P : SPARSE_CLOSEST_P;
  constexpr bool PR = ANY ? SPARSE_ANYHIT_RING : SPARSE_CLOSEST_RING;
#ifdef RL_LAB_FORMS
  constexpr bool BUILT = (P == PP) || (P == 4 && RING == PR);
#else
  constexpr bool BUILT = P == PP && RING == PR;
#endif
  if constexpr (!BUILT) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (ANY) {
    return launch_threads(walk_sparse_anyhit_split_kernel<P, RING>, n / TILE,
                          P * TILE, static_cast<size_t>(smem), stream, a);
  } else {
    return launch_threads(walk_sparse_closest_split_kernel<P, RING>, n / TILE,
                          P * TILE, static_cast<size_t>(smem), stream, a);
  }
}

template <bool ANY>
int launch_form(const SparseArgs& a, int n, int p, int ring, int smem,
                void* stream) {
  switch (p) {
    case 4:
      return ring ? launch_split<ANY, 4, true>(a, n, smem, stream)
                  : launch_split<ANY, 4, false>(a, n, smem, stream);
    case 8:
      return ring ? launch_split<ANY, 8, true>(a, n, smem, stream)
                  : launch_split<ANY, 8, false>(a, n, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads); cap is at most 16. (p,
// ring) name the form: (1, 0) the one-thread-a-ray kernel, else a split
// form this library builds (SPARSE_CLOSEST_P ... above); smem is the
// dynamic shared memory the wrapper computed for it (ops/walk_sparse.py:
// launch_geometry). cudaErrorInvalidValue for a form not built.
extern "C" int rl_walk_sparse_closest(const void* lo, const void* hi, int cp,
                                      int n_real, const void* rows,
                                      const void* ids, const void* o,
                                      const void* d, const void* tnear,
                                      const void* tfar, int n, int cap,
                                      int p, int ring, int smem, void* t_out,
                                      void* tri_out, void* u_out, void* v_out,
                                      void* stream) {
  if (cap > SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 1 && !ring)
    return launch(
        walk_sparse_closest_kernel, n / TILE, static_cast<size_t>(smem),
        stream, static_cast<const float*>(lo), static_cast<const float*>(hi),
        cp, n_real, static_cast<const float4*>(rows),
        static_cast<const int*>(ids), static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(tnear),
        static_cast<const float*>(tfar), cap, static_cast<float*>(t_out),
        static_cast<int*>(tri_out), static_cast<float*>(u_out),
        static_cast<float*>(v_out));
  const SparseArgs a{static_cast<const float*>(lo),
                     static_cast<const float*>(hi),
                     cp,
                     n_real,
                     static_cast<const float4*>(rows),
                     static_cast<const int*>(ids),
                     static_cast<const float*>(o),
                     static_cast<const float*>(d),
                     static_cast<const float*>(tnear),
                     static_cast<const float*>(tfar),
                     cap,
                     static_cast<float*>(t_out),
                     static_cast<int*>(tri_out),
                     static_cast<float*>(u_out),
                     static_cast<float*>(v_out),
                     nullptr};
  return launch_form<false>(a, n, p, ring, smem, stream);
}

extern "C" int rl_walk_sparse_anyhit(const void* lo, const void* hi, int cp,
                                     int n_real, const void* rows,
                                     const void* o, const void* d,
                                     const void* tnear, const void* tfar,
                                     int n, int cap, int p, int ring, int smem,
                                     void* occ_out, void* stream) {
  if (cap > SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 1 && !ring)
    return launch(
        walk_sparse_anyhit_kernel, n / TILE, static_cast<size_t>(smem), stream,
        static_cast<const float*>(lo), static_cast<const float*>(hi), cp,
        n_real, static_cast<const float4*>(rows),
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tnear), static_cast<const float*>(tfar), cap,
        static_cast<bool*>(occ_out));
  const SparseArgs a{static_cast<const float*>(lo),
                     static_cast<const float*>(hi),
                     cp,
                     n_real,
                     static_cast<const float4*>(rows),
                     nullptr,
                     static_cast<const float*>(o),
                     static_cast<const float*>(d),
                     static_cast<const float*>(tnear),
                     static_cast<const float*>(tfar),
                     cap,
                     nullptr,
                     nullptr,
                     nullptr,
                     nullptr,
                     static_cast<bool*>(occ_out)};
  return launch_form<true>(a, n, p, ring, smem, stream);
}
