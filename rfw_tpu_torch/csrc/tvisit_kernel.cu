// Transposed sub-cell visit kernel for Hopper (sm_90a), plain C interface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the flags of
// visit_kernels.cu (--fmad=false, IEEE division) and linked into the same
// library; bound with ctypes. The entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().
//
// Replaces rfw_tpu/ops/tvisit_intersect.py::_tvisit_kernel (:186). There
// one program holds two 128-ray sub-blocks that share a DMA ring and run
// in lockstep; each sub-block walks its own entry-sorted list of child
// cells (K/4 = 32 triangles each), DMAs the child's (16, 128) plane block
// and tests the block's K triangles on sublanes against its 128 rays on
// lanes. Each sub-block's walk depends only on its own list, its own rays
// and the step, so here every sub-block is an independent CUDA block.
//
// Bound: FP32 issue, 39 operations per (ray, triangle) test (the IEEE
// division counted as one) over the visits the exit rule walks: 3.7e8
// tests, 0.22 ms at 67 TFLOP/s (0.44 ms at the half rate that
// separately rounded multiplies and adds reach), on pass 0 of the 1080p
// bounce chunk. A visit is small, 32 triangles of 12 floats (1.5 KB), so
// latency around it decides the time: a barrier and a dependent load per
// visit, shared loads per triangle; and the tail of the grid: the median
// sub-block walks no visit and the longest about 250, so the time is the
// longest walks' dependent chains. The design does four things about
// that:
// - a triangle-major child table (the scene's derived wplanes32_tm,
//   (T32, K, 12)): a child's 12*K floats are contiguous and a triangle's
//   Woop rows are three 16-byte shared loads, each serving all of a
//   thread's kTvisitRays rays, whose independent dependency chains (the
//   separately rounded sums, the IEEE divide) give the scheduler
//   instruction-level parallelism;
// - double-buffered staging: while visit i computes, cp.async copies
//   visit i+1's child into the other buffer, one barrier per visit, so
//   the load's latency leaves the walk;
// - the sub-block's child list is staged in shared memory once, so the
//   next child's address needs no global load;
// - kTvisitSplit threads share each ray, each testing its own share of
//   a child's triangles (k in [k_lo, k_hi)), so a long walk spreads over
//   kTvisitSplit times as many warps. The shares meet only at the exit
//   votes (the least t per ray, through shared memory) and once at the
//   end. On an H100 two rays a thread and four shares (256 threads)
//   measured fastest: 0.66x the unsplit kernel's time on the bounce
//   chunk; one or four rays a thread, or two or eight shares, 0.69-0.85x
//   (rfw_tpu_torch/tools/kernel_variant.py).
//
// Tie rule, as the TPU kernel's: within a visit the argmin over the K
// triangles takes the lowest k, and a visit commits only a strictly
// smaller t, so the earliest visit wins. A thread scanning its share of
// k in order with a strict "<" against its running best reproduces both
// within the share (unlike visit_kernel, whose final cross-visit argmin
// prefers the lower lane); the shares merge in the walk's order: the
// least t, then the earliest visit, then the lower share.
//
// Early exit every kExitEvery visits by a block-wide vote over every
// ray's best t (the least over its shares): closest-hit stops once every
// ray's best t precedes the next child's entry bound, any-hit once no
// live ray still lacks a hit; the walk also ends with the list. The vote
// is uniform across the block, so every thread leaves the loop (and its
// barriers) together. walked (optional) receives each sub-block's count
// of walked visits.

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr int kLanes = 128;      // rays per sub-block
constexpr int kTvisitRays = 2;   // rays a thread
constexpr int kTvisitSplit = 4;  // threads sharing a ray, each a share of
                                 // a child's triangles
constexpr int kRayThreads = kLanes / kTvisitRays;      // threads a share
constexpr int kTvisitThreads = kRayThreads * kTvisitSplit;
constexpr int kExitEvery = 4;    // visits between early-exit votes
constexpr int kMaxK = 128;       // triangles per child, at most

static_assert(kLanes % kTvisitRays == 0, "rays must tile the sub-block");

__global__ void __launch_bounds__(kTvisitThreads)
tvisit_kernel(const float* __restrict__ rays, int n,
              const int* __restrict__ cids, const int* __restrict__ counts,
              const float* __restrict__ tnears, int cslots,
              const float* __restrict__ planes, int n_child, int k_size,
              float t_epsilon, int any_hit, float* __restrict__ t_out,
              int* __restrict__ slot_out, int* __restrict__ walked) {
  extern __shared__ float4 s_mem[];  // 2 child buffers, then the list
  // each share's best per ray, for the exit votes and the final merge
  __shared__ float s_part_t[kTvisitSplit * kLanes];
  __shared__ int s_part_slot[kTvisitSplit * kLanes];
  __shared__ int s_part_visit[kTvisitSplit * kLanes];
  const int K = k_size;
  const int stage4 = 3 * K;          // 16-byte chunks per child
  int* s_ids = reinterpret_cast<int*>(s_mem + 2 * stage4);
  const int row = blockIdx.x;
  // this thread's share of each child's triangles: k in [k_lo, k_hi)
  const int part = threadIdx.x / kRayThreads;
  const int lane = threadIdx.x % kRayThreads;
  const int k_lo = K * part / kTvisitSplit;
  const int k_hi = K * (part + 1) / kTvisitSplit;

  float ox[kTvisitRays], oy[kTvisitRays], oz[kTvisitRays];
  float dx[kTvisitRays], dy[kTvisitRays], dz[kTvisitRays];
  float tmax0[kTvisitRays], best_t[kTvisitRays];
  int best_slot[kTvisitRays], best_visit[kTvisitRays];
#pragma unroll
  for (int q = 0; q < kTvisitRays; ++q) {
    const int r = row * kLanes + q * kRayThreads + lane;
    ox[q] = rays[r];
    oy[q] = rays[(size_t)n + r];
    oz[q] = rays[(size_t)2 * n + r];
    tmax0[q] = rays[(size_t)3 * n + r];
    dx[q] = rays[(size_t)4 * n + r];
    dy[q] = rays[(size_t)5 * n + r];
    dz[q] = rays[(size_t)6 * n + r];
    best_t[q] = tmax0[q];
    best_slot[q] = -1;
    best_visit[q] = 0;
  }
  const int n_step = counts[row];
  // same clamps as the TPU kernel: visit i reads list slot
  // min(i, cslots-1) (i < n_step, the live prefix), and an invalid id is
  // clamped to a real child
  for (int e = threadIdx.x; e < min(n_step, cslots); e += kTvisitThreads)
    s_ids[e] = min(cids[(size_t)row * cslots + e], n_child - 1);
  __syncthreads();
  if (n_step > 0)
    rfw::stage_granule<kTvisitThreads>(
        s_mem, planes + (size_t)s_ids[0] * K * 12, stage4);

  int steps = 0;
  for (int i = 0; i < n_step; ++i) {
    ++steps;
    rfw::cp_async_wait_all();
    // visit i's child is in place for every thread, and every thread is
    // done with visit i-1's buffer, which the next copy overwrites
    __syncthreads();
    if (i + 1 < n_step) {
      const int gn = s_ids[min(i + 1, cslots - 1)];
      rfw::stage_granule<kTvisitThreads>(s_mem + ((i + 1) & 1) * stage4,
                                         planes + (size_t)gn * K * 12,
                                         stage4);
    }
    const int g = s_ids[min(i, cslots - 1)];
    const float4* w = s_mem + (i & 1) * stage4;

#pragma unroll 2
    for (int k = k_lo; k < k_hi; ++k) {
      const float4 pu = w[3 * k];        // u: x, y, z weights, offset
      const float4 pv = w[3 * k + 1];    // v
      const float4 pw = w[3 * k + 2];    // w
#pragma unroll
      for (int q = 0; q < kTvisitRays; ++q) {
        float ou = pu.w + pu.x * ox[q];
        ou = ou + pu.y * oy[q];
        ou = ou + pu.z * oz[q];
        float du = pu.x * dx[q];
        du = du + pu.y * dy[q];
        du = du + pu.z * dz[q];
        float ov = pv.w + pv.x * ox[q];
        ov = ov + pv.y * oy[q];
        ov = ov + pv.z * oz[q];
        float dv = pv.x * dx[q];
        dv = dv + pv.y * dy[q];
        dv = dv + pv.z * dz[q];
        float ow = pw.w + pw.x * ox[q];
        ow = ow + pw.y * oy[q];
        ow = ow + pw.z * oz[q];
        float dw = pw.x * dx[q];
        dw = dw + pw.y * dy[q];
        dw = dw + pw.z * dz[q];
        const bool valid = fabsf(dw) > 1e-12f;
        const float t = -ow / (valid ? dw : 1.0f);
        const float u = ou + t * du;
        const float v = ov + t * dv;
        const bool hit = valid && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                         t > t_epsilon;
        const float th = hit ? t : 1e30f;
        if (th < best_t[q]) {
          best_t[q] = th;
          best_slot[q] = g * K + k;
          best_visit[q] = i;
        }
      }
    }

    if (i % kExitEvery == kExitEvery - 1) {
      // each ray's best t so far: the least over the shares
      float ray_t[kTvisitRays];
#pragma unroll
      for (int q = 0; q < kTvisitRays; ++q)
        s_part_t[part * kLanes + q * kRayThreads + lane] = best_t[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kTvisitRays; ++q) {
        ray_t[q] = best_t[q];
        for (int p = 0; p < kTvisitSplit; ++p)
          ray_t[q] = fminf(ray_t[q],
                           s_part_t[p * kLanes + q * kRayThreads + lane]);
      }
      int done;
      if (any_hit) {
        bool open = false;
#pragma unroll
        for (int q = 0; q < kTvisitRays; ++q)
          open = open || (ray_t[q] >= tmax0[q] && tmax0[q] > 0.0f);
        done = !__syncthreads_or(open);
      } else {
        const float tn = tnears[(size_t)row * cslots + min(i + 1, cslots - 1)];
        bool ahead = true;
#pragma unroll
        for (int q = 0; q < kTvisitRays; ++q)
          ahead = ahead && ray_t[q] <= tn;
        done = __syncthreads_and(ahead);
      }
      if (done) break;
    }
  }
  rfw::cp_async_wait_all();  // an early exit leaves no copy in flight

  // merge the shares in the sequential order of the walk: the least t,
  // then the earliest visit, then the lower share (the lower k). A
  // share's t equals t_max only while it has no hit.
#pragma unroll
  for (int q = 0; q < kTvisitRays; ++q) {
    const int at = part * kLanes + q * kRayThreads + lane;
    s_part_t[at] = best_t[q];
    s_part_slot[at] = best_slot[q];
    s_part_visit[at] = best_visit[q];
  }
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int q = 0; q < kTvisitRays; ++q)
    for (int p = 1; p < kTvisitSplit; ++p) {
      const int at = p * kLanes + q * kRayThreads + lane;
      const float t = s_part_t[at];
      const int v = s_part_visit[at];
      if (t < best_t[q] ||
          (t == best_t[q] && t < tmax0[q] && v < best_visit[q])) {
        best_t[q] = t;
        best_slot[q] = s_part_slot[at];
        best_visit[q] = v;
      }
    }
#pragma unroll
  for (int q = 0; q < kTvisitRays; ++q) {
    const int r = row * kLanes + q * kRayThreads + lane;
    const bool found = best_t[q] < tmax0[q];
    t_out[r] = found ? best_t[q] : tmax0[q];
    slot_out[r] = found ? best_slot[q] : -1;
  }
  if (walked != nullptr && threadIdx.x == 0) walked[row] = steps;
}

}  // namespace

extern "C" int rfw_tvisit(const float* rays, int n, const int* cids,
                          const int* counts, const float* tnears, int cslots,
                          const float* planes, int n_child, int k_size,
                          float t_epsilon, int any_hit, float* t_out,
                          int* slot_out, int* walked, void* stream) {
  if (n <= 0 || n % kLanes || cslots <= 0 || n_child <= 0 || k_size <= 0 ||
      k_size > kMaxK)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)k_size * 12 * sizeof(float) +
                      (size_t)cslots * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tvisit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tvisit_kernel<<<n / kLanes, kTvisitThreads, smem, (cudaStream_t)stream>>>(
      rays, n, cids, counts, tnears, cslots, planes, n_child, k_size,
      t_epsilon, any_hit, t_out, slot_out, walked);
  return (int)cudaGetLastError();
}
