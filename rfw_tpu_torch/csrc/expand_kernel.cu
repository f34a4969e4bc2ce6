// Child-expansion kernel for Hopper (sm_90a), plain C interface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the flags of
// visit_kernels.cu (--fmad=false, IEEE division) and linked into the same
// library; bound with ctypes. The entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().
//
// Replaces rfw_tpu/ops/tvisit_intersect.py::expand_children (:89), which
// is XLA outside any Pallas kernel: a (256, 256, 4*M_C) broadcast slab
// test per chunk of 256 ray blocks, a minimum per 128-ray sub-block and a
// row sort of packed keys. It computes, bit for bit, what
// ops/tvisit_intersect.py::expand_children_ref computes: for each
// sub-block, the entry-sorted list of the 4*M_C child cells of its ray
// block's parent window (cids, counts, tnears).
//
// Design (the enum kernel's, whose work this nearly is): one CUDA block
// per 256-ray block, since both sub-blocks share the block's window of
// child slots. The rays are staged in shared memory as two 16-byte values
// each, (o.xyz, t_hi) and (1/d.xyz, far), and each thread keeps kSlots
// child boxes in registers (slot tid + kThreads*j), gathered from the
// child tables by the window's parent ids, and a running minimum per
// slot; the two sub-blocks are walked one after the other. No atomics and
// no cross-thread reduction per box: the result is deterministic. Then
// per sub-block the 512 keys (quantized entry | slot) are formed in
// shared memory and bitonic-sorted there; the keys are distinct exact
// integers apart from the "no entry" pad, so the sort gives torch.sort's
// values.
//
// Exactness. The slab test is expand_children_ref's, operation for
// operation: (lo - o) * inv per axis, min/max, the entry clamped at 0
// after the three axes, and the closed test ent <= ext, then ent < t_hi.
// A slot whose parent is invalid (id >= t_p) holds the far-point box
// (3e37 on every axis), not the clamped last child; its entry depends
// only on the ray, so staging computes it once per ray (the .w of the
// second value) and the slot loop reads it instead of testing a box.
// Under a 1e12 inverse the far box gives +-inf, never NaN, and the same
// comparisons decide. Two kinds of work are skipped, both exactly:
// - a dead ray (t_hi <= 0) crosses nothing, since ent >= 0 never lies
//   below its t_hi: every thread reads the same staged ray, so the skip is
//   uniform across the block;
// - a block without a live ray has no entry at all: it writes the empty
//   lists (count 0, id 4*t_p, bound big_t) and stops before the sort.
//
// Bound: FP32 issue, ~28 operations per (live ray, real child slot); the
// bytes (ids, boxes, rays, the lists written) are about a tenth of that
// time at 3.35 TB/s.

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr int kBlock = 256;                       // rays per ray block
constexpr int kSub = 2;                           // sub-blocks per ray block
constexpr int kSubLanes = kBlock / kSub;          // rays per sub-block
constexpr int kMaxSlots = 512;                    // child slots, sort width
constexpr int kExpandSlots = 4;                   // child slots a thread
constexpr int kExpandThreads = kMaxSlots / kExpandSlots;
constexpr float kBigKey = 33554432.0f;            // 2^25: "no entry"
constexpr float kFar = 3e37f;                     // the far-point box
constexpr float kNoEntry = 1e30f;

static_assert(kMaxSlots % kExpandSlots == 0, "slots must tile the window");

// The slab entry of one ray into one box, as expand_children_ref
// computes it: the clamped entry if the ray crosses the box before t_hi
// (ot.w), else 1e30.
__device__ __forceinline__ float slab_entry(const float lo[3],
                                            const float hi[3], float4 ot,
                                            float4 iv) {
  const float o[3] = {ot.x, ot.y, ot.z};
  const float inv[3] = {iv.x, iv.y, iv.z};
  float ent = 0.0f, ext = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t1 = (lo[ax] - o[ax]) * inv[ax];
    const float t2 = (hi[ax] - o[ax]) * inv[ax];
    const float a = fminf(t1, t2), b = fmaxf(t1, t2);
    ent = ax == 0 ? a : fmaxf(ent, a);
    ext = ax == 0 ? b : fminf(ext, b);
  }
  ent = fmaxf(ent, 0.0f);
  return ent <= ext && ent < ot.w ? ent : kNoEntry;
}

__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const float* __restrict__ rays, int n,
              const int* __restrict__ ids, int m_p, int t_p,
              const float* __restrict__ bmin, const float* __restrict__ bmax,
              const float* __restrict__ scale_p,
              const float* __restrict__ gran_p, int slot_bits, float qmax,
              float big_t, int* __restrict__ cids, int* __restrict__ counts,
              float* __restrict__ tnears) {
  __shared__ float4 s_ot[kBlock];              // origin xyz, t_hi
  __shared__ float4 s_inv[kBlock];             // 1/d xyz, far-box entry
  __shared__ float s_key[kSub][kMaxSlots];
  __shared__ int s_cid[kMaxSlots];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int cslots = 4 * m_p;
  const int t32 = 4 * t_p;

  // the window's global child ids; an invalid parent's children get t32
  for (int s = tid; s < cslots; s += kExpandThreads) {
    const int p = ids[(size_t)b * m_p + (s >> 2)];
    s_cid[s] = p < t_p ? p * 4 + (s & 3) : t32;
  }
  const float far[3] = {kFar, kFar, kFar};
  int live = 0;
  for (int i = tid; i < kBlock; i += kExpandThreads) {
    const int r = b * kBlock + i;
    const float4 ot =
        make_float4(rays[r], rays[(size_t)n + r], rays[(size_t)2 * n + r],
                    rays[(size_t)3 * n + r]);
    float4 iv = make_float4(rfw::safe_inv(rays[(size_t)4 * n + r]),
                            rfw::safe_inv(rays[(size_t)5 * n + r]),
                            rfw::safe_inv(rays[(size_t)6 * n + r]), 0.0f);
    iv.w = slab_entry(far, far, ot, iv);
    s_ot[i] = ot;
    s_inv[i] = iv;
    live |= ot.w > 0.0f;
  }
  if (!__syncthreads_or(live)) {     // no live ray: every list is empty
    for (int e = tid; e < kSub * cslots; e += kExpandThreads) {
      const size_t at = (size_t)b * kSub * cslots + e;
      cids[at] = t32;
      tnears[at] = big_t;
    }
    if (tid < kSub) counts[b * kSub + tid] = 0;
    return;
  }

  float lo[kExpandSlots][3], hi[kExpandSlots][3];
  bool real[kExpandSlots];
#pragma unroll
  for (int j = 0; j < kExpandSlots; ++j) {
    const int s = tid + j * kExpandThreads;
    const int c = s < cslots ? s_cid[s] : t32;
    real[j] = c < t32;
    const int cc = min(c, t32 - 1);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[j][ax] = bmin[(size_t)cc * 3 + ax];
      hi[j][ax] = bmax[(size_t)cc * 3 + ax];
    }
  }
  const float scale = *scale_p;
  const float slot_mul = (float)(1 << slot_bits);

  for (int sb = 0; sb < kSub; ++sb) {
    float best[kExpandSlots];
#pragma unroll
    for (int j = 0; j < kExpandSlots; ++j) best[j] = kNoEntry;
    for (int i = sb * kSubLanes; i < (sb + 1) * kSubLanes; ++i) {
      const float4 ot = s_ot[i];
      if (!(ot.w > 0.0f)) continue;    // dead lane (NaN t_hi too)
      const float4 iv = s_inv[i];
#pragma unroll
      for (int j = 0; j < kExpandSlots; ++j)
        best[j] = fminf(best[j], real[j] ? slab_entry(lo[j], hi[j], ot, iv)
                                         : iv.w);
    }
    // key = quantized entry | slot, as exact-integer floats (< 2^24)
#pragma unroll
    for (int j = 0; j < kExpandSlots; ++j) {
      const int s = tid + j * kExpandThreads;
      float key = kBigKey;             // slots past the window pad the sort
      if (s < cslots && best[j] < big_t) {
        const float q = fminf(fmaxf(floorf(best[j] * scale), 0.0f), qmax);
        key = q * slot_mul + (float)s;
      }
      s_key[sb][s] = key;
    }
  }
  __syncthreads();

  // bitonic sort of both sub-blocks' keys, ascending
  for (int k = 2; k <= kMaxSlots; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < kSub * kMaxSlots / 2; p += kExpandThreads) {
        const int sb = p / (kMaxSlots / 2);
        const int q = p % (kMaxSlots / 2);
        const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int c = a + j;
        const float ka = s_key[sb][a], kc = s_key[sb][c];
        if ((a & k) == 0 ? ka > kc : ka < kc) {
          s_key[sb][a] = kc;
          s_key[sb][c] = ka;
        }
      }
      __syncthreads();
    }
  }

  const float gran = *gran_p;
  const int mask = (1 << slot_bits) - 1;
  for (int sb = 0; sb < kSub; ++sb) {
    const size_t row = (size_t)b * kSub + sb;
    for (int i = tid; i < cslots; i += kExpandThreads) {
      const float key = s_key[sb][i];
      const bool valid = key < kBigKey;
      cids[row * cslots + i] = valid ? s_cid[(int)key & mask] : t32;
      tnears[row * cslots + i] =
          valid ? floorf(key / slot_mul) * gran : big_t;
      // the sorted valid keys come first: the last one writes the count
      const bool next = i + 1 < cslots && s_key[sb][i + 1] < kBigKey;
      if (valid && !next) counts[row] = i + 1;
      if (i == 0 && !valid) counts[row] = 0;
    }
  }
}

}  // namespace

extern "C" int rfw_expand(const float* rays, int n, const int* ids, int m_p,
                          int t_p, const float* bmin, const float* bmax,
                          const float* scale, const float* gran,
                          int slot_bits, float qmax, float big_t, int* cids,
                          int* counts, float* tnears, void* stream) {
  if (n <= 0 || n % kBlock || m_p <= 0 || 4 * m_p > kMaxSlots || t_p <= 0 ||
      slot_bits < 1 || slot_bits > 23 || (1 << slot_bits) < 4 * m_p)
    return (int)cudaErrorInvalidValue;
  expand_kernel<<<n / kBlock, kExpandThreads, 0, (cudaStream_t)stream>>>(
      rays, n, ids, m_p, t_p, bmin, bmax, scale, gran, slot_bits, qmax,
      big_t, cids, counts, tnears);
  return (int)cudaGetLastError();
}
