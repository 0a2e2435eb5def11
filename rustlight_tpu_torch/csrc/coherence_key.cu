// The walk's incidence coherence key for Hopper (sm_90a), in one launch.
//
// Replaces no Pallas kernel: the reference computes this key in XLA
// (rustlight_tpu/accel/pallas_walk.py:_incidence_key), and the port's plain
// version (ops/coherence_key.py:incidence_key_ref) is that code in torch,
// chunked over rays. For each lane, a slab test against every real cluster
// of the walk tables gives the clusters its ray overlaps within
// (max(tnear, 0), tfar]; the key is
//   major = direction octant << 18 | 6-bit/axis morton of the centroid of
//           the overlapped clusters' centres on the clusters' bounds,
//   minor = the overlap count, capped at 63,
// and the walk sorts its rays by (major, minor) (accel/walk.py:_prepare).
//
// Design: one thread a lane, 256 a block. The real clusters' lo, hi and
// centres are staged as structure-of-arrays float32 in dynamic shared
// memory, STAGE clusters (72 KB) at a time, so that tables of up to
// accel/walk.py:_INC_SORT_MAX_C clusters loop over stages; a table of at
// most STAGE clusters takes one stage of its own size. Every thread reads
// the same cluster at the same step (a broadcast, 16 bytes a load, four
// clusters an axis), and keeps its slab limits, its count and its centroid
// sum (in cluster order) in registers: nothing of shape [N, C] touches
// device memory. The clusters' bounding box (the morton grid) is reduced
// over the block while it stages. No atomics: the key is a function of the
// inputs.
//
// Arithmetic follows the plain version's order: __fsub_rn / __fmul_rn (no
// FMA contraction), IEEE division for the slab inverse and the centroid,
// min/max that propagate NaN as torch.minimum/maximum do, and _quantize's
// clamp and truncation. The overlap mask and the count are bit-equal to the
// plain version's; the centroid differs from its [N, C] @ [C, 3] product
// only in the order of the sum.
//
// What bounds it: FP32 issue. A lane-cluster pair is some 30 instructions
// (6 subtractions, 6 products, 11 min/max, 2 comparisons, the count and 3
// predicated adds) at 132 SMs x 128 lanes a clock; a warp pays for every
// lane, inert ones too, so every lane counts. The bytes (32 in, 8 out a
// lane) weigh far less.
//
// Plain C interface (loaded with ctypes): rl_incidence_key launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rl {
namespace key {

constexpr int BLOCK = 256;
constexpr int STAGE = 2048;   // clusters a stage: 9 floats each, 72 KB
constexpr int CELLS = 64;     // morton cells an axis (6 bits)
constexpr int MAX_COUNT = 63;

// min/max that propagate NaN, as torch.minimum/torch.maximum do (PTX's
// min.NaN / max.NaN: one instruction each)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ops/walk_trace.py:_slab_inv
__device__ __forceinline__ float slab_inv(float d) {
  const float dd = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return __fdiv_rn(1.0f, dd);
}

// ops/coherence_key.py:_quantize(x, CELLS) of one coordinate: clamp to
// [0, CELLS - 1], truncate
__device__ __forceinline__ int quantize(float x) {
  return static_cast<int>(fminf(fmaxf(x, 0.0f), CELLS - 1.0f));
}

// ops/coherence_key.py:_morton(q, 6): the low six bits of each axis
// interleaved, x lowest
__device__ __forceinline__ int morton6(int qx, int qy, int qz) {
  int m = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b)
    m |= (((qx >> b) & 1) << (3 * b)) | (((qy >> b) & 1) << (3 * b + 1)) |
         (((qz >> b) & 1) << (3 * b + 2));
  return m;
}

// The block's min over its threads of v (NaN-propagating); red holds
// BLOCK / 32 partials. Every thread gets the result.
__device__ __forceinline__ float block_min(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < BLOCK / 32; ++w) r = min_nan(r, red[w]);
  return r;
}

// The slab test of one lane against one cluster: the plain version's
// tmin / tmax over three axes, the first axis's t0, t1 taken as they are.
__device__ __forceinline__ bool overlaps(float lx, float ly, float lz,
                                         float hx, float hy, float hz,
                                         const float o[3], const float inv[3],
                                         float tn0, float tf) {
  float t0 = __fmul_rn(__fsub_rn(lx, o[0]), inv[0]);
  float t1 = __fmul_rn(__fsub_rn(hx, o[0]), inv[0]);
  float tmin = min_nan(t0, t1), tmax = max_nan(t0, t1);
  t0 = __fmul_rn(__fsub_rn(ly, o[1]), inv[1]);
  t1 = __fmul_rn(__fsub_rn(hy, o[1]), inv[1]);
  tmin = max_nan(tmin, min_nan(t0, t1));
  tmax = min_nan(tmax, max_nan(t0, t1));
  t0 = __fmul_rn(__fsub_rn(lz, o[2]), inv[2]);
  t1 = __fmul_rn(__fsub_rn(hz, o[2]), inv[2]);
  tmin = max_nan(tmin, min_nan(t0, t1));
  tmax = min_nan(tmax, max_nan(t0, t1));
  return (tmax >= max_nan(tmin, tn0)) & (tmin <= tf);
}

// lo, hi: [3, cp] f32 cluster bounds, the first c real; o, d [n, 3],
// tnear, tfar [n]; kmaj, kmin [n] int32. Dynamic shared memory: 9 x sp
// floats, sp = the stage's clusters rounded up to 4.
__global__ void __launch_bounds__(BLOCK)
incidence_key_kernel(const float* __restrict__ lo,
                     const float* __restrict__ hi, int c, int cp, int sp,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar, int n,
                     int* __restrict__ kmaj, int* __restrict__ kmin) {
  extern __shared__ float4 s_dyn[];
  __shared__ float red[BLOCK / 32];
  float* s_lo = reinterpret_cast<float*>(s_dyn);   // [3][sp]
  float* s_hi = s_lo + 3 * sp;                     // [3][sp]
  float* s_ct = s_hi + 3 * sp;                     // [3][sp]
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 0.0f};
  float tn0 = 0.0f, tf = 0.0f;
  if (i < n) {
    ro[0] = o[3 * i]; ro[1] = o[3 * i + 1]; ro[2] = o[3 * i + 2];
    rd[0] = d[3 * i]; rd[1] = d[3 * i + 1]; rd[2] = d[3 * i + 2];
    tn0 = max_nan(tnear[i], 0.0f);   // torch.clamp(tnear, min=0)
    tf = tfar[i];
  }
  const float inv[3] = {slab_inv(rd[0]), slab_inv(rd[1]), slab_inv(rd[2])};
  // a lane with !(tfar > 0) overlaps nothing: it skips the tests
  const bool live = tf > 0.0f;
  int cnt = 0;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float wlo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float nwhi[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};   // -max hi
  for (int base = 0; base < c; base += STAGE) {
    const int m = min(STAGE, c - base);
    __syncthreads();
    for (int k = threadIdx.x; k < sp; k += BLOCK) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float l = CUDART_NAN_F, h = CUDART_NAN_F, ct = 0.0f;  // pads: no hit
        if (k < m) {
          l = lo[ax * cp + base + k];
          h = hi[ax * cp + base + k];
          ct = __fmul_rn(0.5f, __fadd_rn(l, h));
          wlo[ax] = min_nan(wlo[ax], l);
          nwhi[ax] = min_nan(nwhi[ax], -h);
        }
        s_lo[ax * sp + k] = l;
        s_hi[ax * sp + k] = h;
        s_ct[ax * sp + k] = ct;
      }
    }
    __syncthreads();
    if (!live) continue;
    const float4* l4 = reinterpret_cast<const float4*>(s_lo);
    const float4* h4 = reinterpret_cast<const float4*>(s_hi);
    const float4* c4 = reinterpret_cast<const float4*>(s_ct);
    const int q = sp / 4;
    for (int j = 0; j < (m + 3) / 4; ++j) {
      const float4 lx = l4[j], ly = l4[q + j], lz = l4[2 * q + j];
      const float4 hx = h4[j], hy = h4[q + j], hz = h4[2 * q + j];
      const float4 cx = c4[j], cy = c4[q + j], cz = c4[2 * q + j];
#define RL_KEY_STEP(f)                                                      \
  if (overlaps(lx.f, ly.f, lz.f, hx.f, hy.f, hz.f, ro, inv, tn0, tf)) {     \
    ++cnt;                                                                  \
    sx = __fadd_rn(sx, cx.f);                                               \
    sy = __fadd_rn(sy, cy.f);                                               \
    sz = __fadd_rn(sz, cz.f);                                               \
  }
      RL_KEY_STEP(x)
      RL_KEY_STEP(y)
      RL_KEY_STEP(z)
      RL_KEY_STEP(w)
#undef RL_KEY_STEP
    }
  }
  // the clusters' bounds: wlo = min lo, span = max(max hi - wlo, 1e-9)
  float w[3], span[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    w[ax] = block_min(wlo[ax], red);
    const float whi = -block_min(nwhi[ax], red);
    span[ax] = fmaxf(__fsub_rn(whi, w[ax]), 1e-9f);
  }
  if (i >= n) return;
  const float den = static_cast<float>(max(cnt, 1));
  const float s[3] = {sx, sy, sz};
  int qc[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float cen = __fdiv_rn(s[ax], den);
    qc[ax] = quantize(__fmul_rn(__fdiv_rn(__fsub_rn(cen, w[ax]), span[ax]),
                                static_cast<float>(CELLS)));
  }
  const int octant = (rd[0] > 0.0f) * 4 + (rd[1] > 0.0f) * 2 + (rd[2] > 0.0f);
  kmaj[i] = (octant << 18) | morton6(qc[0], qc[1], qc[2]);
  kmin[i] = min(cnt, MAX_COUNT);
}

}  // namespace key
}  // namespace rl

extern "C" int rl_incidence_key(const void* lo, const void* hi, int c, int cp,
                                const void* o, const void* d,
                                const void* tnear, const void* tfar, int n,
                                void* kmaj, void* kmin, void* stream) {
  using rl::key::BLOCK;
  using rl::key::STAGE;
  const int sp = (min(c, STAGE) + 3) / 4 * 4;
  const size_t smem = 9 * sizeof(float) * static_cast<size_t>(sp);
  if (smem > 48 * 1024) {   // past 48 KB a kernel must opt in, per device
    const cudaError_t err = cudaFuncSetAttribute(
        rl::key::incidence_key_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n + BLOCK - 1) / BLOCK;
  rl::key::incidence_key_kernel<<<grid, BLOCK, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi), c, cp, sp,
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tnear), static_cast<const float*>(tfar), n,
      static_cast<int*>(kmaj), static_cast<int*>(kmin));
  return static_cast<int>(cudaGetLastError());
}
