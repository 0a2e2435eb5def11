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
// The schedule is the one-level walk's (walk_trace.cu): one block of 64
// threads per tile, one thread per ray, one heap of packed entries, the same
// pops, two visits per termination check, the same stop test. The entry
// pass, which computes every ray's slab test of every cluster anyway, also
// keeps which rays enter which real cluster (tmax >= entry and entry < tfar,
// with entry = max(tmin, tnear)). The reference stores each ray's entry in
// a [Cp, 64] f32 matrix and reads only whether it is finite; here that is
// one 64-bit mask per cluster, bit j for ray j (Cp * 8 B of dynamic shared
// memory beside the Cp * 4 B heap). A visit reads the popped cluster's mask:
// with at most `cap` (16) bits set only the flagged rays test the cluster,
// else every ray does, which is the reference's branch; which rays are
// tested can decide a hit that lies on a cluster's boundary, so the plain
// version (ops/walk_sparse.py) branches alike. A tested ray's cap is its
// current best t and only a strictly nearer hit is written back.
//
// The reference gathers the flagged rays into 16 slots and scatters their
// hits back with one-hot matrix products, guarded against 0 * inf; those
// are a TPU's means to a gather and are not carried over. On the card the
// point of compaction is latency: in a sparse visit at most SLOTS = 16 rays
// test, so the block's 64 threads regroup as 16 slots of PARTS = 4 threads,
// slot k taking the k-th flagged ray (its origin, direction, tnear and
// current cap are in shared memory) and each of its threads every fourth
// column of the staged cluster, 96 tests instead of 384. A shuffle
// reduction over (t bits, column) inside the slot keeps the least t and,
// among equals, the lowest column, which is the serial scan's winner (t >
// tnear >= 0, so t orders as its bits); the slot's result goes back through
// shared memory to the ray's own thread, which writes it only if strictly
// nearer. A dense visit is the one-level walk's: one thread a ray.
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

// This thread's rank among the flagged rays of mk: its slot.
__device__ __forceinline__ int slot_of(Mask mk) {
  return __popcll(mk & ((Mask(1) << threadIdx.x) - 1));
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

size_t dyn_bytes(int cp) {
  return static_cast<size_t>(cp) * (sizeof(Mask) + sizeof(int));
}

}  // namespace

// n must be a multiple of 64 (the wrapper pads); cap is at most 16.
extern "C" int rl_walk_sparse_closest(const void* lo, const void* hi, int cp,
                                      int n_real, const void* rows,
                                      const void* ids, const void* o,
                                      const void* d, const void* tnear,
                                      const void* tfar, int n, int cap,
                                      void* t_out, void* tri_out, void* u_out,
                                      void* v_out, void* stream) {
  if (cap > SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dyn_bytes(cp);
  if (const int err = set_smem(walk_sparse_closest_kernel, smem)) return err;
  walk_sparse_closest_kernel<<<n / TILE, TILE, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const int*>(ids),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar), cap,
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_walk_sparse_anyhit(const void* lo, const void* hi, int cp,
                                     int n_real, const void* rows,
                                     const void* o, const void* d,
                                     const void* tnear, const void* tfar,
                                     int n, int cap, void* occ_out,
                                     void* stream) {
  if (cap > SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dyn_bytes(cp);
  if (const int err = set_smem(walk_sparse_anyhit_kernel, smem)) return err;
  walk_sparse_anyhit_kernel<<<n / TILE, TILE, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi), cp, n_real,
      static_cast<const float4*>(rows), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tnear),
      static_cast<const float*>(tfar), cap, static_cast<bool*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}
