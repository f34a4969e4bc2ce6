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
// so the result is exact. Bound: FP32 issue, 25 FLOP a (ray, instance)
// pair, and the rays' 28 B.
//
// tlas_walk_kernel: one thread a ray walks the first `count` entries of
// `order` (both read on the device): per instance the box test against
// the ray's running best t (any hit: none once the ray has a hit), the
// ray into object space by the instance's world -> object matrix in
// bvh/tlas.py::to_object's fixed order of sums (the direction left
// unnormalised, so object t is world t), then bvh_walk.cuh's walk of the
// BLAS with t_max = best t, and on a hit best t, orig = inst_base +
// prim_order[prim], u and v. A ray's result depends only on its own pass
// over `order`, so it equals walk_group_ref's, which walks all rays
// instance by instance. Bound: instruction issue and latency, as
// traverse_kernel's; the rays of a warp touch different instances and
// walk paths of different length, and one thread a ray leaves that
// divergence in place.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using rfw::Hit;
using rfw::kMaxLeaf;
using rfw::tmax;
using rfw::tmin;

constexpr int kPremaskThreads = 256;
constexpr int kPremaskSlice = 256;  // instances a pass over shared memory
constexpr int kTlasWalkThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPremaskThreads % 32 == 0 && kTlasWalkThreads % 32 == 0,
              "whole warps");

// bvh/tlas.py::safe_inv_box_dir: 1 / d with |d| < 1e-12 replaced by
// +1e-12 (not sign-preserving, unlike kernel_common.cuh's safe_inv).
__device__ __forceinline__ float inv_box(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

// bvh/tlas.py::box_hit of one ray against the box at row i of the
// (k, 3) tables; tn is the entry distance, NaN where a slab is.
__device__ __forceinline__ bool box_hit(const float* __restrict__ bmin,
                                        const float* __restrict__ bmax,
                                        int i, float3 o, float3 inv,
                                        float cap, float& tn) {
  const float* lo = bmin + 3 * i;
  const float* hi = bmax + 3 * i;
  const float t1x = (__ldg(lo) - o.x) * inv.x;
  const float t2x = (__ldg(hi) - o.x) * inv.x;
  const float t1y = (__ldg(lo + 1) - o.y) * inv.y;
  const float t2y = (__ldg(hi + 1) - o.y) * inv.y;
  const float t1z = (__ldg(lo + 2) - o.z) * inv.z;
  const float t2z = (__ldg(hi + 2) - o.z) * inv.z;
  tn = tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
  const float tf = tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)),
                        tmax(t1z, t2z));
  return tf >= tmax(tn, 0.0f) && tn < cap;
}

__global__ void __launch_bounds__(kPremaskThreads)
tlas_premask_kernel(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const float* __restrict__ best_t, int n,
                    const float* __restrict__ bmin,
                    const float* __restrict__ bmax, int k,
                    unsigned* __restrict__ cross,
                    unsigned* __restrict__ tn_min) {
  __shared__ unsigned s_cross[kPremaskSlice];
  __shared__ unsigned s_min[kPremaskSlice];
  const int r = blockIdx.x * kPremaskThreads + threadIdx.x;
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
  for (int base = 0; base < k; base += kPremaskSlice) {
    const int m = min(kPremaskSlice, k - base);
    for (int j = threadIdx.x; j < m; j += kPremaskThreads) {
      s_cross[j] = 0u;
      s_min[j] = 0xffffffffu;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float tn;
      const bool hit = live && box_hit(bmin, bmax, base + j, o, inv, cap, tn);
      if (__ballot_sync(kFull, hit)) {
        // a hit's tn is not NaN; max(tn, 0) + 0.0f is never -0.0
        const unsigned bits =
            hit ? __float_as_uint(tmax(tn, 0.0f) + 0.0f) : 0xffffffffu;
        const unsigned least = __reduce_min_sync(kFull, bits);
        if ((threadIdx.x & 31) == 0) {
          atomicOr(s_cross + j, 1u);
          atomicMin(s_min + j, least);
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
}

__global__ void __launch_bounds__(kTlasWalkThreads)
tlas_walk_kernel(const float* __restrict__ origins,
                 const float* __restrict__ directions, int n,
                 const float* __restrict__ t_in,
                 const int* __restrict__ orig_in,
                 const float* __restrict__ u_in,
                 const float* __restrict__ v_in,
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
  const int r = blockIdx.x * kTlasWalkThreads + threadIdx.x;
  if (r >= n) return;
  float best_t = t_in[r], best_u = u_in[r], best_v = v_in[r];
  int best_orig = orig_in[r];
  const float3 o = make_float3(origins[3 * r], origins[3 * r + 1],
                               origins[3 * r + 2]);
  const float3 d = make_float3(directions[3 * r], directions[3 * r + 1],
                               directions[3 * r + 2]);
  const float3 inv = make_float3(inv_box(d.x), inv_box(d.y), inv_box(d.z));
  const int touched = __ldg(count);
  for (int q = 0; q < touched; ++q) {
    if (any_hit && best_orig >= 0) break;
    const int i = __ldg(order + q);
    float tn;
    // a culled lane, or one whose bound is a dead lane's (!(t > eps)),
    // walks nothing and keeps its result
    if (!box_hit(bmin, bmax, i, o, inv, best_t, tn) || !(best_t > eps))
      continue;
    const float* m = inst_inv + 16 * (size_t)i;
    const float3 oo = make_float3(
        o.x * __ldg(m) + o.y * __ldg(m + 1) + o.z * __ldg(m + 2) +
            __ldg(m + 3),
        o.x * __ldg(m + 4) + o.y * __ldg(m + 5) + o.z * __ldg(m + 6) +
            __ldg(m + 7),
        o.x * __ldg(m + 8) + o.y * __ldg(m + 9) + o.z * __ldg(m + 10) +
            __ldg(m + 11));
    const float3 dd = make_float3(
        d.x * __ldg(m) + d.y * __ldg(m + 1) + d.z * __ldg(m + 2),
        d.x * __ldg(m + 4) + d.y * __ldg(m + 5) + d.z * __ldg(m + 6),
        d.x * __ldg(m + 8) + d.y * __ldg(m + 9) + d.z * __ldg(m + 10));
    Hit h{best_t, 0.0f, 0.0f, -1};
    rfw::walk_bvh(oo, dd, nodes, tris, leaf_size, eps, any_hit != 0, h);
    if (h.prim >= 0) {      // the walk takes only t < best_t
      best_t = h.t;
      best_orig = __ldg(inst_base + i) + __ldg(prim_order + h.prim);
      best_u = h.u;
      best_v = h.v;
    }
  }
  t_out[r] = best_t;
  orig_out[r] = best_orig;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace

extern "C" int rfw_tlas_premask(const float* origins, const float* directions,
                                const float* best_t, int n, const float* bmin,
                                const float* bmax, int k, int* cross,
                                float* tn_min, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return 0;
  const int grid = (n + kPremaskThreads - 1) / kPremaskThreads;
  tlas_premask_kernel<<<grid, kPremaskThreads, 0, stream>>>(
      origins, directions, best_t, n, bmin, bmax, k,
      reinterpret_cast<unsigned*>(cross), reinterpret_cast<unsigned*>(tn_min));
  return (int)cudaGetLastError();
}

extern "C" int rfw_tlas_walk(const float* origins, const float* directions,
                             int n, const float* t_in, const int* orig_in,
                             const float* u_in, const float* v_in,
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
      origins, directions, n, t_in, orig_in, u_in, v_in, order, count, bmin,
      bmax, inst_inv, inst_base, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), prim_order, leaf_size, eps,
      any_hit, t_out, orig_out, u_out, v_out);
  return (int)cudaGetLastError();
}
