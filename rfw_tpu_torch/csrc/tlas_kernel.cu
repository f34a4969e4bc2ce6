// The two-level (TLAS) walk for Hopper (sm_90a), plain C interface: the
// tlas intersector's premask and its walk over the touched instances of
// one BLAS, two kernels a BLAS and intersector call.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the other kernels
// (--fmad=false, IEEE division) and bound with ctypes. Each entry point
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces rfw_tpu/render/intersectors.py::make_tlas_intersector._loop
// (:201), an XLA program (a batched premask, an argsort of the touched
// instances, a while_loop over them with a cond each) rather than a
// Pallas kernel. Their plain PyTorch versions are premask_ref and
// walk_group_ref in rfw_tpu_torch/bvh/tlas.py; between the two kernels
// the order of the touched instances is a torch argsort on the device,
// so no step reads anything to the host.
//
// tlas_premask_kernel: one thread a ray slab-tests every instance box of
// the BLAS (bvh/tlas.py::box_hit: the world direction's 1e-12-clamped
// reciprocal safe_inv_box_dir, NaN carried through min.NaN/max.NaN, the
// closed test tf >= max(tn, 0) && tn < best_t). Per instance it reduces
// "does any ray cross" and "the least max(tn, 0) over the crossing rays":
// within the warp (ballot, __reduce_min_sync on the bits of a
// non-negative float, which order as the floats do; + 0.0f turns -0.0
// into +0.0 first), then in shared memory, then one atomicOr and one
// atomicMin a block and instance. An OR and a minimum are free of order,
// so the result is exact. It also writes the walk's list of lanes: the
// rays that cross at least one box below their best t, have best t >
// eps and, for any hit, no hit yet, first (one atomicAdd a block after a
// ballot and a prefix count over the block's warps), then every other
// ray from the far end, so the list is a permutation of the n lanes and
// n_lanes[0] counts the first part. A dead lane (best t 0) whose origin
// lies inside a box passes box_hit with tn < 0 < tf and still sets that
// instance's cross and tn_min to 0, as premask_ref does; it is not on
// the list.
// Bound: FP32 issue, 25 FLOP a (ray, instance) pair (bytes: a ray's 28
// B in and its list entry out). Against that the design keeps the loop
// body to the test itself and skips tests no lane needs: the boxes are
// staged once a block and 256-instance slice in shared memory as
// 16-byte rows (two broadcast LDS.128 a box instead of six LDG), with a
// cluster box around each kPremaskCluster consecutive boxes (both
// corners of each; with finite bounds (x - o) * inv is monotone in x,
// so a ray that crosses a box crosses its cluster box, and a warp none
// of whose lanes crosses the cluster box skips its boxes; a cluster
// holding an infinite bound is never skipped); kPremaskBoxes tests run
// side by side before their ballots, and only a non-zero ballot pays
// for the warp minimum and the two shared-memory atomics.
//
// tlas_walk_kernel: thread j takes lane lanes[j]. A thread below
// n_lanes[0] walks its ray over the first `count` entries of `order`
// (both read on the device): per instance the box test against the
// ray's running best t (any hit: none once the ray has a hit), the ray
// into object space by the instance's world -> object matrix in
// bvh/tlas.py::to_object's fixed order of sums (the direction left
// unnormalised, so object t is world t), then bvh_walk.cuh's walk of the
// BLAS with t_max = best t, and on a hit best t, orig = inst_base +
// prim_order[prim], u and v. A thread at or past n_lanes[0] copies its
// lane's state: that lane crosses no box or is dead, so the walk would
// leave it as it is. Each lane is written once, in one launch, and a
// ray's result depends only on its own pass over `order`, so the
// outputs equal walk_group_ref's (which walks all rays instance by
// instance) whatever order the list has.
// Bound: instruction issue and latency, as traverse_kernel's. On a
// bounce chunk about 5 % of the lanes cross a sphere's box, scattered
// over four warps in five; one thread a lane made each of those warps
// pay the walk for one or two lanes, and every lane box-test every
// touched instance. On the list the walking lanes fill whole warps and
// the rest only copy. The lanes of a warp cross different instances at
// different places of `order`, so a warp that walked each instance to
// its end before the next would walk one lane's instance after another;
// instead each pass of a lane's loop either tests the next
// kTlasWalkBatch boxes at its current best t (side by side; the first
// hit starts a walk, the scan goes on after it) or takes one step of its
// walk (bvh_walk.cuh's walk_step, one node), and the lanes of a warp walk
// their different instances in the same passes.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using rfw::Hit;
using rfw::kMaxLeaf;
using rfw::tmax;
using rfw::tmin;

constexpr int kPremaskThreads = 256;
constexpr int kPremaskSlice = 256;  // instances a pass over shared memory
constexpr int kPremaskBoxes = 4;    // box tests a thread runs side by side
// boxes under one cluster box, which a warp tests first and whose boxes
// it skips when no lane crosses it
constexpr int kPremaskCluster = 8;
constexpr int kTlasWalkThreads = 128;
constexpr int kTlasWalkBatch = 4;   // boxes a scan step tests side by side
constexpr int kPremaskWarps = kPremaskThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPremaskThreads % 32 == 0 && kTlasWalkThreads % 32 == 0,
              "whole warps");
static_assert(kPremaskCluster > 0 &&
                  kPremaskCluster % kPremaskBoxes == 0 &&
                  kPremaskSlice % kPremaskCluster == 0,
              "whole steps a cluster, whole clusters a slice");
static_assert(kTlasWalkBatch >= 1 && kTlasWalkBatch <= 32, "a 32-bit mask");

// bvh/tlas.py::safe_inv_box_dir: 1 / d with |d| < 1e-12 replaced by
// +1e-12 (not sign-preserving, unlike kernel_common.cuh's safe_inv).
__device__ __forceinline__ float inv_box(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

// bvh/tlas.py::box_hit of one ray against the box (lo, hi); tn is the
// entry distance, NaN where a slab is.
__device__ __forceinline__ bool box_hit(float3 lo, float3 hi, float3 o,
                                        float3 inv, float cap, float& tn) {
  const float t1x = (lo.x - o.x) * inv.x;
  const float t2x = (hi.x - o.x) * inv.x;
  const float t1y = (lo.y - o.y) * inv.y;
  const float t2y = (hi.y - o.y) * inv.y;
  const float t1z = (lo.z - o.z) * inv.z;
  const float t2z = (hi.z - o.z) * inv.z;
  tn = tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
  const float tf = tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)),
                        tmax(t1z, t2z));
  return tf >= tmax(tn, 0.0f) && tn < cap;
}

// box_hit against row i of the (k, 3) global tables.
__device__ __forceinline__ bool box_hit(const float* __restrict__ bmin,
                                        const float* __restrict__ bmax,
                                        int i, float3 o, float3 inv,
                                        float cap, float& tn) {
  const float* lo = bmin + 3 * i;
  const float* hi = bmax + 3 * i;
  return box_hit(make_float3(__ldg(lo), __ldg(lo + 1), __ldg(lo + 2)),
                 make_float3(__ldg(hi), __ldg(hi + 1), __ldg(hi + 2)), o,
                 inv, cap, tn);
}

__device__ __forceinline__ float3 xyz(float4 v) {
  return make_float3(v.x, v.y, v.z);
}

__global__ void __launch_bounds__(kPremaskThreads)
tlas_premask_kernel(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const float* __restrict__ best_t,
                    const int* __restrict__ orig, int n, float eps,
                    const float* __restrict__ bmin,
                    const float* __restrict__ bmax, int k,
                    unsigned* __restrict__ cross,
                    unsigned* __restrict__ tn_min, int* __restrict__ lanes,
                    int* __restrict__ ends) {
  __shared__ float4 s_lo[kPremaskSlice];
  __shared__ float4 s_hi[kPremaskSlice];
  // cluster c's box; w is 1 where a box of it has an infinite bound,
  // which the cluster box cannot be trusted to enclose for every ray
  __shared__ float4 s_clo[kPremaskSlice / kPremaskCluster];
  __shared__ float4 s_chi[kPremaskSlice / kPremaskCluster];
  __shared__ unsigned s_cross[kPremaskSlice];
  __shared__ unsigned s_min[kPremaskSlice];
  __shared__ int s_warp[2][kPremaskWarps];
  __shared__ int s_base[2];
  const int r = blockIdx.x * kPremaskThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = r < n;
  float3 o = make_float3(0.0f, 0.0f, 0.0f);
  float3 inv = o;
  float cap = 0.0f;
  if (live) {
    o = make_float3(origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]);
    inv = make_float3(inv_box(directions[3 * r]),
                      inv_box(directions[3 * r + 1]),
                      inv_box(directions[3 * r + 2]));
    cap = best_t[r];
  }
  bool crossed = false;
  for (int base = 0; base < k; base += kPremaskSlice) {
    const int m = min(kPremaskSlice, k - base);
    // whole clusters; the rows past m are NaN boxes, which no ray hits,
    // and only the steps that hold a row of the slice are taken
    const int runs = (m + kPremaskCluster - 1) / kPremaskCluster;
    const int steps = (m + kPremaskBoxes - 1) / kPremaskBoxes;
    const float nan = __int_as_float(0x7fffffff);
    for (int j = threadIdx.x; j < runs * kPremaskCluster;
         j += kPremaskThreads) {
      if (j < m) {
        const float* lo = bmin + 3 * (base + j);
        const float* hi = bmax + 3 * (base + j);
        s_lo[j] = make_float4(lo[0], lo[1], lo[2], 0.0f);
        s_hi[j] = make_float4(hi[0], hi[1], hi[2], 0.0f);
      } else {
        s_lo[j] = s_hi[j] = make_float4(nan, nan, nan, nan);
      }
      s_cross[j] = 0u;
      s_min[j] = 0xffffffffu;
    }
    // a slice of one cluster tests its boxes without the cluster box
    const bool clusters = m > kPremaskCluster;
    if (clusters) {
      __syncthreads();
      // the least box around each cluster's boxes, both corners of each
      // (a NaN bound is left out: its box is never hit); with finite
      // bounds a ray that crosses a box crosses its cluster box, as
      // (x - o) * inv is monotone in x
      for (int c = threadIdx.x; c < runs; c += kPremaskThreads) {
        float3 lo = make_float3(nan, nan, nan), hi = lo;
        bool infinite = false;
        for (int b = 0; b < 2 * kPremaskCluster; ++b) {
          const int j = c * kPremaskCluster + (b >> 1);
          const float4 v = b & 1 ? s_hi[j] : s_lo[j];
          lo = make_float3(fminf(lo.x, v.x), fminf(lo.y, v.y),
                           fminf(lo.z, v.z));
          hi = make_float3(fmaxf(hi.x, v.x), fmaxf(hi.y, v.y),
                           fmaxf(hi.z, v.z));
          infinite |= isinf(v.x) || isinf(v.y) || isinf(v.z);
        }
        s_clo[c] = make_float4(lo.x, lo.y, lo.z, 0.0f);
        s_chi[c] = make_float4(hi.x, hi.y, hi.z, infinite ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
    for (int c = 0; c < runs; ++c) {
      if (clusters && s_chi[c].w == 0.0f) {
        float tn;
        const bool near =
            live && box_hit(xyz(s_clo[c]), xyz(s_chi[c]), o, inv, cap, tn);
        if (!__ballot_sync(kFull, near)) continue;
      }
      constexpr int kSteps = kPremaskCluster / kPremaskBoxes;
      for (int s = c * kSteps; s < min((c + 1) * kSteps, steps); ++s) {
        bool hit[kPremaskBoxes];
        float tn[kPremaskBoxes];
#pragma unroll
        for (int b = 0; b < kPremaskBoxes; ++b) {
          const int j = s * kPremaskBoxes + b;
          hit[b] = live && box_hit(xyz(s_lo[j]), xyz(s_hi[j]), o, inv, cap,
                                   tn[b]);
        }
#pragma unroll
        for (int b = 0; b < kPremaskBoxes; ++b) {
          crossed |= hit[b];
          if (__ballot_sync(kFull, hit[b])) {
            // a hit's tn is not NaN; max(tn, 0) + 0.0f is never -0.0
            const unsigned bits =
                hit[b] ? __float_as_uint(tmax(tn[b], 0.0f) + 0.0f)
                       : 0xffffffffu;
            const unsigned least = __reduce_min_sync(kFull, bits);
            if (lane == 0) {
              atomicOr(s_cross + s * kPremaskBoxes + b, 1u);
              atomicMin(s_min + s * kPremaskBoxes + b, least);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kPremaskThreads) {
      if (s_cross[j]) {
        atomicOr(cross + base + j, 1u);
        atomicMin(tn_min + base + j, s_min[j]);
      }
    }
    __syncthreads();
  }
  // the walk's list: walking lanes from the front, the others from the
  // back; ends[0] and ends[1] count each part over the grid
  const bool walks = live && crossed && cap > eps &&
                     (orig == nullptr || orig[r] < 0);
  const unsigned front = __ballot_sync(kFull, walks);
  const unsigned back = __ballot_sync(kFull, live && !walks);
  if (lane == 0) {
    s_warp[0][warp] = __popc(front);
    s_warp[1][warp] = __popc(back);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int total = 0;
    for (int w = 0; w < kPremaskWarps; ++w) {
      const int c = s_warp[threadIdx.x][w];
      s_warp[threadIdx.x][w] = total;
      total += c;
    }
    s_base[threadIdx.x] = total ? atomicAdd(ends + threadIdx.x, total) : 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  if (walks)
    lanes[s_base[0] + s_warp[0][warp] + __popc(front & below)] = r;
  else if (live)
    lanes[n - 1 - (s_base[1] + s_warp[1][warp] + __popc(back & below))] = r;
}

__global__ void __launch_bounds__(kTlasWalkThreads)
tlas_walk_kernel(const float* __restrict__ origins,
                 const float* __restrict__ directions, int n,
                 const float* __restrict__ t_in,
                 const int* __restrict__ orig_in,
                 const float* __restrict__ u_in,
                 const float* __restrict__ v_in,
                 const int* __restrict__ lanes,
                 const int* __restrict__ n_lanes,
                 const int* __restrict__ order,
                 const int* __restrict__ count,
                 const float* __restrict__ bmin,
                 const float* __restrict__ bmax,
                 const float* __restrict__ inst_inv,
                 const int* __restrict__ inst_base,
                 const float4* __restrict__ nodes,
                 const float4* __restrict__ tris,
                 const int* __restrict__ prim_order, int leaf_size,
                 float eps, int any_hit, float* __restrict__ t_out,
                 int* __restrict__ orig_out, float* __restrict__ u_out,
                 float* __restrict__ v_out) {
  const int j = blockIdx.x * kTlasWalkThreads + threadIdx.x;
  if (j >= n) return;
  const int r = __ldg(lanes + j);
  float best_t = t_in[r], best_u = u_in[r], best_v = v_in[r];
  int best_orig = orig_in[r];
  if (j < __ldg(n_lanes)) {
    const float3 o = make_float3(origins[3 * r], origins[3 * r + 1],
                                 origins[3 * r + 2]);
    const float3 d = make_float3(directions[3 * r], directions[3 * r + 1],
                                 directions[3 * r + 2]);
    const float3 inv = make_float3(inv_box(d.x), inv_box(d.y),
                                   inv_box(d.z));
    const int touched = __ldg(count);
    int q = 0;      // the next entry of order to test
    int i = -1;     // the instance being walked, -1 between walks
    // the walk: the ray in object space, its reciprocal, the stack
    float3 oo, dd, oinv;
    int stack[rfw::kStack];
    int ptr = 0;
    Hit h;
    // each pass either tests boxes or takes one step of a walk, so the
    // lanes of a warp walk their instances side by side
    while (true) {
      if (i < 0) {
        // a ray with a hit (any hit), or whose bound is a dead lane's
        // (!(t > eps)), walks nothing more
        if (q >= touched || (any_hit && best_orig >= 0) || !(best_t > eps))
          break;
        // the next kTlasWalkBatch boxes at the current best t, side by
        // side; the first hit starts a walk, the rest are tested again
        unsigned hits = 0;
#pragma unroll
        for (int b = 0; b < kTlasWalkBatch; ++b) {
          float tn;
          if (q + b < touched &&
              box_hit(bmin, bmax, __ldg(order + q + b), o, inv, best_t, tn))
            hits |= 1u << b;
        }
        if (!hits) {
          q += kTlasWalkBatch;
          continue;
        }
        q += __ffs(hits);
        i = __ldg(order + q - 1);
        const float* m = inst_inv + 16 * (size_t)i;
        oo = make_float3(
            o.x * __ldg(m) + o.y * __ldg(m + 1) + o.z * __ldg(m + 2) +
                __ldg(m + 3),
            o.x * __ldg(m + 4) + o.y * __ldg(m + 5) + o.z * __ldg(m + 6) +
                __ldg(m + 7),
            o.x * __ldg(m + 8) + o.y * __ldg(m + 9) + o.z * __ldg(m + 10) +
                __ldg(m + 11));
        dd = make_float3(
            d.x * __ldg(m) + d.y * __ldg(m + 1) + d.z * __ldg(m + 2),
            d.x * __ldg(m + 4) + d.y * __ldg(m + 5) + d.z * __ldg(m + 6),
            d.x * __ldg(m + 8) + d.y * __ldg(m + 9) + d.z * __ldg(m + 10));
        oinv = make_float3(rfw::safe_inv(dd.x), rfw::safe_inv(dd.y),
                           rfw::safe_inv(dd.z));
        stack[0] = 0;
        ptr = 1;
        h = Hit{best_t, 0.0f, 0.0f, -1};
      } else if (!rfw::walk_step(oo, dd, oinv, stack, ptr, nodes, tris,
                                 leaf_size, eps, any_hit != 0, h)) {
        if (h.prim >= 0) {  // the walk takes only t < best_t
          best_t = h.t;
          best_orig = __ldg(inst_base + i) + __ldg(prim_order + h.prim);
          best_u = h.u;
          best_v = h.v;
        }
        i = -1;
      }
    }
  }
  t_out[r] = best_t;
  orig_out[r] = best_orig;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace

// ends: two int32 the caller zeroes; ends[0] ends as the count of the
// walking lanes at the front of lanes (n int32). orig is the state's
// orig for any hit, null for closest hit.
extern "C" int rfw_tlas_premask(const float* origins, const float* directions,
                                const float* best_t, const int* orig, int n,
                                float eps, const float* bmin,
                                const float* bmax, int k, int* cross,
                                float* tn_min, int* lanes, int* ends,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kPremaskThreads - 1) / kPremaskThreads;
  tlas_premask_kernel<<<grid, kPremaskThreads, 0, stream>>>(
      origins, directions, best_t, orig, n, eps, bmin, bmax, k,
      reinterpret_cast<unsigned*>(cross), reinterpret_cast<unsigned*>(tn_min),
      lanes, ends);
  return (int)cudaGetLastError();
}

extern "C" int rfw_tlas_walk(const float* origins, const float* directions,
                             int n, const float* t_in, const int* orig_in,
                             const float* u_in, const float* v_in,
                             const int* lanes, const int* n_lanes,
                             const int* order, const int* count,
                             const float* bmin, const float* bmax,
                             const float* inst_inv, const int* inst_base,
                             const float* nodes, const float* tris,
                             const int* prim_order, int leaf_size, float eps,
                             int any_hit, float* t_out, int* orig_out,
                             float* u_out, float* v_out,
                             cudaStream_t stream) {
  if (leaf_size < 1 || leaf_size > kMaxLeaf)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + kTlasWalkThreads - 1) / kTlasWalkThreads;
  tlas_walk_kernel<<<grid, kTlasWalkThreads, 0, stream>>>(
      origins, directions, n, t_in, orig_in, u_in, v_in, lanes, n_lanes,
      order, count, bmin, bmax, inst_inv, inst_base,
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), prim_order, leaf_size, eps,
      any_hit, t_out, orig_out, u_out, v_out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the current device of each kernel, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int rfw_tlas_occupancy(int* premask_blocks, int* walk_blocks) {
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      premask_blocks, tlas_premask_kernel, kPremaskThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      walk_blocks, tlas_walk_kernel, kTlasWalkThreads, 0);
}
