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
// block's parent window (cids, counts, tnears), padded past each count
// with the invalid child id 4*t_p and big_t.
//
// What bounds it on the H100: FP32 instruction issue. The work is one
// slab test (~28 operations) per (live ray, real child slot); the bytes
// (rays in, the full 512-wide lists out) take about half that time at
// 3.35 TB/s.
// A window of the 1080p bounce chunk holds ~155 real child slots a live
// ray of the 4*M_C = 512, and ~40 % of its lanes are dead, so a kernel
// that walks every slot over every lane does ~3.3x the work, and a
// 512-wide sort with a barrier a stage costs more than the tests. The
// work is also uneven: the few full bounce windows (512 real slots) hold
// most of its pairs (chip_smoke.py phase 3 prints the shares).
//
// Design: one block of 128 threads per 128-ray sub-block, its row of the
// lists (the two sub-blocks of a window are two blocks: a full window's
// work is split over two SMs, and small blocks keep 10 resident an SM).
// 1. Staging. Each thread loads one ray as two 16-byte values, (o.xyz,
//    t_hi) and (1/d.xyz, far), where far is the ray's entry into the
//    far-point box (3e37 on every axis) that the plain version gives an
//    invalid parent's slots: computed once per ray. Warp ballots compact
//    the live lanes (t_hi > 0; NaN is dead) into shared memory, and the
//    window's parents into a list whose valid ones (id < t_p) come
//    first, in any order the window has them. A dead ray crosses nothing
//    (ent >= 0 never lies below its t_hi), so dropping it is exact; a
//    sub-block with no live ray writes the empty list and stops.
// 2. Boxes. The valid parents' child boxes are staged in shared memory
//    by cooperative loads: a parent's four children are 12 contiguous
//    floats of bmin32 and 12 of bmax32.
// 3. Slab tests over real slots and live rays only. A work item is
//    kExpandSlots real slots (their boxes in registers); its live rays
//    are split into `shares` strided shares on adjacent lanes, and the
//    shares' minima are combined by fminf through warp shuffles (exact
//    and free of order, so bit-identical to the plain version's amin).
//    `shares` (a power of two up to 32) is chosen per block from its
//    item and live-ray counts, to keep the threads busy. Invalid slots
//    take the sub-block's least far entry, which lies below big_t only
//    for a ray whose three axes reach the far box at the same t.
// 4. Ranks instead of a sort. The valid keys (quantized entry | slot)
//    are distinct exact integers below 2^24, so each one's place in the
//    sorted row is the count of smaller keys. A block-wide prefix count
//    compacts them; then each is compared with the others (broadcast
//    reads of 16-byte values, no barrier between compares) and written
//    at its rank, and the rest of the row is padded.
//
// Exactness. The slab test is expand_children_ref's, operation for
// operation: (lo - o) * inv per axis, min/max, the entry clamped at 0
// after the three axes, and the closed test ent <= ext, then ent < t_hi.
// Under a 1e12 inverse the far box gives +-inf, never NaN, and the same
// comparisons decide.

#include <cuda_runtime.h>

#include <climits>

#include "kernel_common.cuh"

namespace {

constexpr int kBlock = 256;                       // rays per ray block
constexpr int kSub = 2;                           // sub-blocks per ray block
constexpr int kSubLanes = kBlock / kSub;          // rays per sub-block
constexpr int kMaxSlots = 512;                    // child slots, row width
constexpr int kMaxParents = kMaxSlots / 4;
constexpr int kExpandThreads = kSubLanes;        // a thread a ray
constexpr int kExpandSlots = 2;                   // real slots a work item
constexpr int kExpandMinBlocks = 10;              // launch bounds: 48 regs
constexpr int kWarps = kExpandThreads / 32;
constexpr int kKeysPerThread = kMaxSlots / kExpandThreads;
constexpr float kBigKey = 33554432.0f;            // 2^25: "no entry"
constexpr float kFar = 3e37f;                     // the far-point box
constexpr float kNoEntry = 1e30f;

static_assert(kExpandThreads % 32 == 0 && kMaxParents <= kExpandThreads &&
                  kMaxSlots % kExpandThreads == 0,
              "whole warps, a thread a parent, whole key rows");
static_assert(4 % kExpandSlots == 0, "a parent's 4 slots tile the items");

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

// key = quantized entry | slot, as an exact-integer float (< 2^24)
__device__ __forceinline__ float child_key(float best, int s, float scale,
                                           float qmax, float slot_mul,
                                           float big_t) {
  if (!(best < big_t)) return kBigKey;
  const float q = fminf(fmaxf(floorf(best * scale), 0.0f), qmax);
  return q * slot_mul + (float)s;
}

__device__ __forceinline__ int warp_prefix(unsigned ballot) {
  return __popc(ballot & ((1u << (threadIdx.x & 31)) - 1u));
}

// One block per 128-ray sub-block: its row of the lists.
__global__ void __launch_bounds__(kExpandThreads, kExpandMinBlocks)
expand_kernel(const float* __restrict__ rays, int n,
              const int* __restrict__ ids, int m_p, int t_p,
              const float* __restrict__ bmin, const float* __restrict__ bmax,
              const float* __restrict__ scale_p,
              const float* __restrict__ gran_p, int slot_bits, float qmax,
              float big_t, int* __restrict__ cids, int* __restrict__ counts,
              float* __restrict__ tnears) {
  __shared__ float4 s_ot[kSubLanes];           // live rays: o xyz, t_hi
  __shared__ float4 s_inv[kSubLanes];          // 1/d xyz, far-box entry
  __shared__ float s_key[kMaxSlots];           // a key per slot entry
  // the real slots' boxes, then (once tested) the valid keys and their
  // entries
  __shared__ union {
    struct {
      float lo[3][kMaxSlots], hi[3][kMaxSlots];
    } box;
    struct {
      float4 key4[kMaxSlots / 4 + 1];
      short ent[kMaxSlots];
    } valid;
  } s_u;
  float(&s_lo)[3][kMaxSlots] = s_u.box.lo;
  float(&s_hi)[3][kMaxSlots] = s_u.box.hi;
  float* const s_ckey = reinterpret_cast<float*>(s_u.valid.key4);
  short* const s_cent = s_u.valid.ent;
  __shared__ int s_par[kMaxParents];           // window position: valid
  __shared__ int s_pid[kMaxParents];           // parents first; parent id
  __shared__ int s_live[kWarps];               // live lanes a warp
  __shared__ float s_far[kWarps];              // min far entry a warp
  __shared__ int s_valid[kWarps];              // valid parents a warp
  __shared__ int s_scan[kWarps];               // valid keys a warp
  const int row = blockIdx.x;                  // sub-block
  const int b = row / kSub;                    // its ray block, window
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cslots = 4 * m_p;
  const int t32 = 4 * t_p;
  const unsigned full = 0xffffffffu;
  int* const row_cids = cids + (size_t)row * cslots;
  float* const row_tnears = tnears + (size_t)row * cslots;

  // 1. this thread's ray and parent; counts per warp
  const size_t r = (size_t)row * kSubLanes + tid;
  const float4 ot = make_float4(rays[r], rays[(size_t)n + r],
                                rays[(size_t)2 * n + r],
                                rays[(size_t)3 * n + r]);
  float4 iv = make_float4(rfw::safe_inv(rays[(size_t)4 * n + r]),
                          rfw::safe_inv(rays[(size_t)5 * n + r]),
                          rfw::safe_inv(rays[(size_t)6 * n + r]), 0.0f);
  const float far[3] = {kFar, kFar, kFar};
  iv.w = slab_entry(far, far, ot, iv);
  const bool live = ot.w > 0.0f;               // NaN t_hi is dead
  const unsigned live_bal = __ballot_sync(full, live);
  float wfar = live ? iv.w : kNoEntry;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wfar = fminf(wfar, __shfl_xor_sync(full, wfar, off));
  const int pid = tid < m_p ? ids[(size_t)b * m_p + tid] : t_p;
  const bool valid = pid < t_p;
  const unsigned valid_bal = __ballot_sync(full, valid);
  if (lane == 0) {
    s_live[warp] = __popc(live_bal);
    s_far[warp] = wfar;
    s_valid[warp] = __popc(valid_bal);
  }
  __syncthreads();

  int n_live = 0, live_before = 0;
  int n_valid = 0, valid_before = 0, invalid_before = 0;
  float far_min = kNoEntry;
  for (int w = 0; w < kWarps; ++w) {
    n_live += s_live[w];
    far_min = fminf(far_min, s_far[w]);
    n_valid += s_valid[w];
    if (w < warp) {
      live_before += s_live[w];
      valid_before += s_valid[w];
      invalid_before += 32 - s_valid[w];
    }
  }
  if (n_live == 0) {                 // no live ray: the list is empty
    for (int e = tid; e < cslots; e += kExpandThreads) {
      row_cids[e] = t32;
      row_tnears[e] = big_t;
    }
    if (tid == 0) counts[row] = 0;
    return;
  }
  // compact the live rays, and the parents with the valid ones first
  if (live) {
    const int at = live_before + warp_prefix(live_bal);
    s_ot[at] = ot;
    s_inv[at] = iv;
  }
  if (tid < m_p) {
    const int at = valid ? valid_before + warp_prefix(valid_bal)
                         : n_valid + invalid_before
                               + warp_prefix(~valid_bal);
    s_par[at] = tid;
    s_pid[at] = pid;
  }
  __syncthreads();

  // 2. the valid parents' child boxes: 12 floats of bmin32 and 12 of
  //    bmax32 a parent, read in contiguous runs
  const int n_real = 4 * n_valid;
  for (int i = tid; i < 24 * n_valid; i += kExpandThreads) {
    const int pi = i / 24, f = i % 24, g = f % 12;
    const float* src = f < 12 ? bmin : bmax;
    const float v = src[(size_t)s_pid[pi] * 12 + g];
    (f < 12 ? s_lo : s_hi)[g % 3][4 * pi + g / 3] = v;
  }

  // 3. work items of kExpandSlots real slots, each over the live rays in
  //    `shares` strided shares on adjacent lanes
  const int n_items = n_real / kExpandSlots;
  int shares = 1, log_shares = 0;
  {
    int best_cost = INT_MAX;
    for (int ls = 0; ls <= 5; ++ls) {
      const int rounds = ((n_items << ls) + kExpandThreads - 1)
                         / kExpandThreads;
      const int cost = rounds * (((n_live + (1 << ls) - 1) >> ls)
                                 * kExpandSlots + ls);
      if (cost < best_cost) {
        best_cost = cost;
        shares = 1 << ls;
        log_shares = ls;
      }
    }
  }
  const float scale = *scale_p;
  const float slot_mul = (float)(1 << slot_bits);
  __syncthreads();

  const int units = n_items << log_shares;
  for (int u0 = 0; u0 < units; u0 += kExpandThreads) {  // block-uniform
    const int u = u0 + tid;
    const bool on = u < units;
    const int item = on ? u >> log_shares : 0;
    const int share = u & (shares - 1);
    const int nl = on ? n_live : 0;
    float lo[kExpandSlots][3], hi[kExpandSlots][3], best[kExpandSlots];
#pragma unroll
    for (int j = 0; j < kExpandSlots; ++j) {
      const int rs = item * kExpandSlots + j;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        lo[j][ax] = s_lo[ax][rs];
        hi[j][ax] = s_hi[ax][rs];
      }
      best[j] = kNoEntry;
    }
    for (int k = share; k < nl; k += shares) {
      const float4 o4 = s_ot[k], i4 = s_inv[k];
#pragma unroll
      for (int j = 0; j < kExpandSlots; ++j)
        best[j] = fminf(best[j], slab_entry(lo[j], hi[j], o4, i4));
    }
    for (int off = 1; off < shares; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kExpandSlots; ++j)
        best[j] = fminf(best[j], __shfl_xor_sync(full, best[j], off));
    }
    if (on && share == 0) {
#pragma unroll
      for (int j = 0; j < kExpandSlots; ++j) {
        const int rs = item * kExpandSlots + j;
        const int s = 4 * s_par[rs >> 2] + (rs & 3);
        s_key[rs] = child_key(best[j], s, scale, qmax, slot_mul, big_t);
      }
    }
  }
  // an invalid parent's slots: the sub-block's least far-box entry
  const bool reach = far_min < big_t;
  const int n_keys = reach ? cslots : n_real;
  if (reach) {
    for (int rs = n_real + tid; rs < cslots; rs += kExpandThreads) {
      const int s = 4 * s_par[rs >> 2] + (rs & 3);
      s_key[rs] = child_key(far_min, s, scale, qmax, slot_mul, big_t);
    }
  }
  __syncthreads();

  // 4. compact the valid keys (a block-wide prefix count), then each
  //    one's rank: the count of smaller valid keys
  float key[kKeysPerThread];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int e = tid * kKeysPerThread + i;
    key[i] = e < n_keys ? s_key[e] : kBigKey;
    mine += key[i] < kBigKey;
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(full, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int at = incl - mine, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    count += s_scan[w];
    if (w < warp) at += s_scan[w];
  }
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    if (key[i] < kBigKey) {
      s_ckey[at] = key[i];
      s_cent[at] = (short)(tid * kKeysPerThread + i);
      ++at;
    }
  }
  if (tid < 4) s_ckey[count + tid] = kBigKey;  // pad to whole float4s
  __syncthreads();

  const float gran = *gran_p;
  const float4* keys4 = s_u.valid.key4;
  for (int i = tid; i < count; i += kExpandThreads) {
    const float kv = s_ckey[i];
    int rank = 0;
    for (int j = 0; j < (count + 3) / 4; ++j) {
      const float4 k4 = keys4[j];
      rank += (k4.x < kv) + (k4.y < kv) + (k4.z < kv) + (k4.w < kv);
    }
    const int e = s_cent[i];
    row_cids[rank] = e < n_real ? 4 * s_pid[e >> 2] + (e & 3) : t32;
    row_tnears[rank] = floorf(kv / slot_mul) * gran;
  }
  // the rest of the row is padding
  for (int i = count + tid; i < cslots; i += kExpandThreads) {
    row_cids[i] = t32;
    row_tnears[i] = big_t;
  }
  if (tid == 0) counts[row] = count;
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
  expand_kernel<<<n / kSubLanes, kExpandThreads, 0, (cudaStream_t)stream>>>(
      rays, n, ids, m_p, t_p, bmin, bmax, scale, gran, slot_bits, qmax,
      big_t, cids, counts, tnears);
  return (int)cudaGetLastError();
}

// Resident blocks of the expansion kernel per SM of the current device,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int rfw_expand_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, expand_kernel, kExpandThreads, 0);
}
