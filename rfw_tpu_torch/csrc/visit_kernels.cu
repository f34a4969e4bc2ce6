// Visit-list intersector kernels for Hopper (sm_90a), plain C interface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false
// and bound with ctypes. Each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError().
//
// Rays are SoA rows of n floats (n a multiple of 256):
//   row 0-2 origin xyz, row 3 t_max (0 = dead lane), row 4-6 direction xyz.
// A "ray block" is 256 consecutive rays.
//
// --fmad=false: every multiply and add rounds on its own, exactly as the
// plain PyTorch versions in rfw_tpu_torch/ops/visit_intersect.py compute
// them, so both kernels are held to those versions bit for bit. Division
// is IEEE (no fast math). Tensor cores are no use here: the Woop transform
// is a 3x4 affine map whose separately rounded sums neither TF32 nor a
// split-TF32 product reproduces.

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

using rfw::cp_async_wait_all;
using rfw::safe_inv;

constexpr int kBlock = 256;      // rays per ray block
constexpr int kExitEvery = 4;    // visits between early-exit votes

// ---------------------------------------------------------------------------
// enum
// ---------------------------------------------------------------------------

constexpr int kEnumThreads = 128;
constexpr int kEnumCells = 4;                              // cells a thread
constexpr int kEnumSpan = kEnumThreads * kEnumCells;       // cells a block

// enum: per ray block, the minimum slab entry of every cell over the
// block's rays that cross it (1e30 when none does). The slab interval is
// closed (ent <= ext): a wall's box is padded by one ulp or less, which
// (lo - o) rounds away, so a ray can meet it with ent == ext exactly.
//
// Replaces rfw_tpu/ops/visit_intersect.py::_enum_kernel (:94), which
// computes (256, 1024) slab tiles per program in VMEM. Here one CUDA
// block owns (one ray block, 512 cells): the block stages its 256 rays in
// shared memory as two 16-byte values each, (o.xyz, t_max) and
// (1/d.xyz, pad), and each thread keeps 4 cells' boxes and minima in
// registers, so the two vector loads of a staged ray serve 4 slab tests
// (on an H100 one or two cells a thread ran 11-21 % slower:
// rfw_tpu_torch/tools/kernel_variant.py). No atomics and no cross-thread
// reduction: the result is deterministic.
// Bound: FP32 issue, ~28 operations per (live ray, cell). Two kinds of
// work are skipped, both exactly:
// - the cells past n_real are the build's padding, far boxes no ray
//   reaches: the kernel writes 1e30 for them without testing, and a
//   block that holds only padding cells returns before it stages
//   anything;
// - a dead ray (t_max <= 0) crosses nothing, since ent >= 0 never lies
//   below its t_max: every thread reads the same staged ray, so the
//   skip is uniform across the block. Compaction puts dead lanes last,
//   so on a bounce stream whole ray blocks cost only their staging.
__global__ void __launch_bounds__(kEnumThreads)
enum_kernel(const float* __restrict__ rays, int n,
            const float* __restrict__ bounds, int t_dim, int n_real,
            float* __restrict__ out) {
  __shared__ float4 s_ot[kBlock];    // origin xyz, t_max
  __shared__ float4 s_inv[kBlock];   // 1/d xyz, pad
  const int b = blockIdx.y;
  const int first = (int)blockIdx.x * kEnumSpan;   // the block's first cell
  const int base = first + (int)threadIdx.x;
  float* row = out + (size_t)b * t_dim;
  if (first >= n_real) {
#pragma unroll
    for (int j = 0; j < kEnumCells; ++j) {
      const int cell = base + j * kEnumThreads;
      if (cell < t_dim) row[cell] = 1e30f;
    }
    return;
  }
  for (int i = threadIdx.x; i < kBlock; i += kEnumThreads) {
    const int r = b * kBlock + i;
    s_ot[i] = make_float4(rays[r], rays[(size_t)n + r],
                          rays[(size_t)2 * n + r], rays[(size_t)3 * n + r]);
    s_inv[i] = make_float4(safe_inv(rays[(size_t)4 * n + r]),
                           safe_inv(rays[(size_t)5 * n + r]),
                           safe_inv(rays[(size_t)6 * n + r]), 0.0f);
  }
  float lo[kEnumCells][3], hi[kEnumCells][3], best[kEnumCells];
#pragma unroll
  for (int j = 0; j < kEnumCells; ++j) {
    const int cell = min(base + j * kEnumThreads, t_dim - 1);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[j][ax] = bounds[(size_t)ax * t_dim + cell];
      hi[j][ax] = bounds[(size_t)(3 + ax) * t_dim + cell];
    }
    best[j] = 1e30f;
  }
  __syncthreads();

  for (int i = 0; i < kBlock; ++i) {
    const float4 ot = s_ot[i];
    if (!(ot.w > 0.0f)) continue;    // dead lane (NaN t_max too)
    const float4 iv = s_inv[i];
    const float o[3] = {ot.x, ot.y, ot.z};
    const float inv[3] = {iv.x, iv.y, iv.z};
#pragma unroll
    for (int j = 0; j < kEnumCells; ++j) {
      float ent = 0.0f, ext = 3e38f;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float t1 = (lo[j][ax] - o[ax]) * inv[ax];
        const float t2 = (hi[j][ax] - o[ax]) * inv[ax];
        ent = fmaxf(ent, fminf(t1, t2));
        ext = fminf(ext, fmaxf(t1, t2));
      }
      best[j] = fminf(best[j], ent <= ext && ent < ot.w ? ent : 1e30f);
    }
  }
#pragma unroll
  for (int j = 0; j < kEnumCells; ++j) {
    const int cell = base + j * kEnumThreads;
    if (cell < t_dim) row[cell] = cell < n_real ? best[j] : 1e30f;
  }
}

// ---------------------------------------------------------------------------
// visit
// ---------------------------------------------------------------------------

constexpr int kRaysPerThread = 2;
constexpr int kVisitThreads = kBlock / kRaysPerThread;   // 128

// visit: per ray block, walk the entry-sorted granule list and Woop-test
// every ray against every triangle of each granule, keeping each ray's
// closest hit.
//
// Replaces rfw_tpu/ops/visit_intersect.py::_visit_kernel (:303), which
// DMAs each granule's (G*16, 128) Woop planes HBM->VMEM through an 8-deep
// ring and tests all 256 rays as a (256, 128) lane matrix, reducing per
// lane and taking a final argmin. Here a block of 128 threads owns one
// ray block, two rays a thread, each ray's best (t, lane, granule) in
// registers. Bound: FP32 issue, 39 operations per (ray, triangle) test
// (IEEE division included as one). Against that the design does three
// things:
// - triangle-major planes (planes[g][t][12], the scene's derived
//   wplanes_tm): a triangle's Woop rows are three 16-byte shared loads,
//   and each load serves both of a thread's rays, whose two independent
//   dependency chains (the separately rounded sums, the IEEE divide)
//   give the scheduler instruction-level parallelism;
// - double-buffered staging: a granule's 12*K*super_g floats are
//   contiguous, so while visit i computes, cp.async copies visit i+1's
//   granule into the other buffer. One barrier per visit, and the load's
//   latency leaves the walk;
// - the block's visit list is staged in shared memory once, so the next
//   granule's address needs no global load.
//
// Tie parity: the TPU kernel's per-lane running minimum plus final argmin
// picks the smallest t, then the lowest lane, then the earliest visit. A
// thread scanning visits in order reproduces that by also taking an equal
// t at a lower lane. The first hit must still lie strictly below t_max
// (best_lane starts at -1).
//
// Early exit every kExitEvery visits by a block-wide vote over all of a
// thread's rays: closest-hit stops once every ray's best t precedes the
// next granule's entry bound; any-hit once no live ray still lacks a hit.
// The vote is uniform across the block, so every thread leaves the loop
// (and its barriers) together. walked (optional) receives each block's
// count of walked visits.
__global__ void __launch_bounds__(kVisitThreads)
visit_kernel(const float* __restrict__ rays, int n,
             const int* __restrict__ ids, const int* __restrict__ counts,
             const float* __restrict__ tnears, int m_c,
             const float* __restrict__ planes, int n_gran, int super_g,
             int k_size, float t_epsilon, int any_hit,
             float* __restrict__ t_out, int* __restrict__ slot_out,
             int* __restrict__ walked) {
  extern __shared__ float4 s_mem[];  // 2 granule buffers, then the list
  const int K = k_size;
  const int gran_tris = super_g * K;        // triangles per granule
  const int stage4 = 3 * gran_tris;         // 16-byte chunks per granule
  int* s_ids = reinterpret_cast<int*>(s_mem + 2 * stage4);
  const int b = blockIdx.x;

  float ox[kRaysPerThread], oy[kRaysPerThread], oz[kRaysPerThread];
  float dx[kRaysPerThread], dy[kRaysPerThread], dz[kRaysPerThread];
  float tmax0[kRaysPerThread], best_t[kRaysPerThread];
  int best_lane[kRaysPerThread], best_gran[kRaysPerThread];
#pragma unroll
  for (int q = 0; q < kRaysPerThread; ++q) {
    const int r = b * kBlock + q * kVisitThreads + threadIdx.x;
    ox[q] = rays[r];
    oy[q] = rays[(size_t)n + r];
    oz[q] = rays[(size_t)2 * n + r];
    tmax0[q] = rays[(size_t)3 * n + r];
    dx[q] = rays[(size_t)4 * n + r];
    dy[q] = rays[(size_t)5 * n + r];
    dz[q] = rays[(size_t)6 * n + r];
    best_t[q] = tmax0[q];
    best_lane[q] = -1;
    best_gran[q] = 0;
  }
  const int n_step = counts[b];
  // same clamps as the TPU kernel: visit i reads list slot min(i, m_c-1)
  // (i < n_step, the live prefix), and an invalid id (an empty list's
  // slot) is clamped to the last granule
  for (int e = threadIdx.x; e < min(n_step, m_c); e += kVisitThreads)
    s_ids[e] = min(ids[(size_t)b * m_c + e], n_gran - 1);
  __syncthreads();
  if (n_step > 0)
    rfw::stage_granule<kVisitThreads>(
        s_mem, planes + (size_t)s_ids[0] * gran_tris * 12, stage4);

  int steps = 0;
  for (int i = 0; i < n_step; ++i) {
    ++steps;
    cp_async_wait_all();
    // visit i's granule is in place for every thread, and every thread
    // is done with visit i-1's buffer, which the next copy overwrites
    __syncthreads();
    if (i + 1 < n_step) {
      const int gn = s_ids[min(i + 1, m_c - 1)];
      rfw::stage_granule<kVisitThreads>(
          s_mem + ((i + 1) & 1) * stage4,
          planes + (size_t)gn * gran_tris * 12, stage4);
    }
    const int g = s_ids[min(i, m_c - 1)];
    const float4* w = s_mem + (i & 1) * stage4;

    for (int sub = 0; sub < super_g; ++sub) {
      const int gran = g * super_g + sub;
      const float4* ws = w + 3 * sub * K;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float4 pu = ws[3 * k];        // u: x, y, z weights, offset
        const float4 pv = ws[3 * k + 1];    // v
        const float4 pw = ws[3 * k + 2];    // w
#pragma unroll
        for (int q = 0; q < kRaysPerThread; ++q) {
          float ou = pu.w + ox[q] * pu.x;
          ou = ou + oy[q] * pu.y;
          ou = ou + oz[q] * pu.z;
          float du = dx[q] * pu.x;
          du = du + dy[q] * pu.y;
          du = du + dz[q] * pu.z;
          float ov = pv.w + ox[q] * pv.x;
          ov = ov + oy[q] * pv.y;
          ov = ov + oz[q] * pv.z;
          float dv = dx[q] * pv.x;
          dv = dv + dy[q] * pv.y;
          dv = dv + dz[q] * pv.z;
          float ow = pw.w + ox[q] * pw.x;
          ow = ow + oy[q] * pw.y;
          ow = ow + oz[q] * pw.z;
          float dw = dx[q] * pw.x;
          dw = dw + dy[q] * pw.y;
          dw = dw + dz[q] * pw.z;
          const bool valid = fabsf(dw) > 1e-12f;
          const float t = -ow / (valid ? dw : 1.0f);
          const float u = ou + t * du;
          const float v = ov + t * dv;
          const bool hit = valid && u >= 0.0f && v >= 0.0f &&
                           u + v <= 1.0f && t > t_epsilon;
          const float th = hit ? t : 1e30f;
          if (th < best_t[q] ||
              (th == best_t[q] && best_lane[q] >= 0 && k < best_lane[q])) {
            best_t[q] = th;
            best_lane[q] = k;
            best_gran[q] = gran;
          }
        }
      }
    }

    if (i % kExitEvery == kExitEvery - 1) {
      int done;
      if (any_hit) {
        bool open = false;
#pragma unroll
        for (int q = 0; q < kRaysPerThread; ++q)
          open = open || (best_t[q] >= tmax0[q] && tmax0[q] > 0.0f);
        done = !__syncthreads_or(open);
      } else {
        const float tn = tnears[(size_t)b * m_c + min(i + 1, m_c - 1)];
        bool ahead = true;
#pragma unroll
        for (int q = 0; q < kRaysPerThread; ++q)
          ahead = ahead && best_t[q] <= tn;
        done = __syncthreads_and(ahead);
      }
      if (done) break;
    }
  }
  cp_async_wait_all();  // an early exit leaves no copy in flight

#pragma unroll
  for (int q = 0; q < kRaysPerThread; ++q) {
    const int r = b * kBlock + q * kVisitThreads + threadIdx.x;
    const bool found = best_lane[q] >= 0;
    t_out[r] = found ? best_t[q] : tmax0[q];
    slot_out[r] = found ? best_gran[q] * K + best_lane[q] : -1;
  }
  if (walked != nullptr && threadIdx.x == 0) walked[b] = steps;
}

}  // namespace

extern "C" int rfw_enum_entries(const float* rays, int n, const float* bounds,
                                int t_dim, int n_real, float* out,
                                void* stream) {
  if (n <= 0 || n % kBlock || t_dim <= 0 || n_real < 0 || n_real > t_dim)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t_dim + kEnumSpan - 1) / kEnumSpan, n / kBlock);
  enum_kernel<<<grid, kEnumThreads, 0, (cudaStream_t)stream>>>(
      rays, n, bounds, t_dim, n_real, out);
  return (int)cudaGetLastError();
}

extern "C" int rfw_visit(const float* rays, int n, const int* ids,
                         const int* counts, const float* tnears, int m_c,
                         const float* planes, int n_gran, int super_g,
                         int k_size, float t_epsilon, int any_hit,
                         float* t_out, int* slot_out, int* walked,
                         void* stream) {
  if (n <= 0 || n % kBlock || m_c <= 0 || n_gran <= 0 || super_g <= 0 ||
      k_size <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)super_g * k_size * 12 * sizeof(float) +
                      (size_t)m_c * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        visit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  visit_kernel<<<n / kBlock, kVisitThreads, smem, (cudaStream_t)stream>>>(
      rays, n, ids, counts, tnears, m_c, planes, n_gran, super_g, k_size,
      t_epsilon, any_hit, t_out, slot_out, walked);
  return (int)cudaGetLastError();
}

extern "C" const char* rfw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
