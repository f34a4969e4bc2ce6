// Wide-BVH traversal kernel for Hopper (sm_90a), plain C interface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the other kernels
// (--fmad=false, IEEE division) and bound with ctypes. The entry point
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces rfw_tpu/ops/traverse.py::traverse_wide (:58), an XLA step (a
// vmapped while_loop with a gather per node) rather than a Pallas kernel;
// its plain PyTorch version is traverse_wide_ref in
// rfw_tpu_torch/ops/traverse.py.
//
// Bound: neither bytes nor FP32 issue but instruction issue and
// latency. A ray pops a few nodes, each a chain of dependent loads
// (stack, node, triangles) and a few hundred instructions, and the rays
// of a warp walk paths of very different length. The design:
// - one thread a ray over ceil(n / kTraverseThreads) blocks. Persistent
//   warps that refill finished lanes from a global counter (Aila and
//   Laine, HPG 2009) were measured slower on the 1080p streams (PERF.md)
//   and cost a counter reset and an occupancy query a launch;
// - an exact exit for dead lanes: a ray with !(t_max > eps) is written as
//   (t_max, -1, 0, 0) at thread start and never walks (the TLAS path
//   launches one walk an instance with its culled rays dead). A triangle
//   is taken only for eps < t < best.t, and best.t starts at t_max, so
//   nothing such a ray could walk changes its result;
// - triangles from the triangle-major table traverse.tri_table, rows
//   (v0, .), (e1, .), (e2, .): three 16-byte loads a triangle, and a
//   leaf's triangles are contiguous;
// - the leaf tests of a node as one mask of (slot, triangle) bits taken
//   in order, so the warp runs as many tests as its busiest lane, not the
//   sum over slots of each slot's busiest lane;
// - a box's slab test by the NaN-propagating min.NaN/max.NaN of sm_80+,
//   one instruction each, where a select-based min and max that carries
//   NaN as torch.minimum/maximum do takes several (measured 1.1-1.4x
//   slower, PERF.md).
// Measured and dropped (PERF.md): the stack's first entries in shared
// memory, the top of a breadth-first node table in shared memory, and L1
// prefetches of the next node, of a node's leaf rows and of a batch's
// rays; each was slower.
// The block size kTraverseThreads is a constexpr below, which
// rfw_tpu_torch/tools/kernel_variant.py switches and times.
//
// The walk itself, its order and its stack, is bvh_walk.cuh's walk_bvh,
// which tlas_kernel.cu's walk over instances shares.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using rfw::Hit;
using rfw::kMaxLeaf;

constexpr int kTraverseThreads = 128;

static_assert(kTraverseThreads % 32 == 0, "whole warps");

__global__ void __launch_bounds__(kTraverseThreads)
traverse_kernel(const float* __restrict__ origins,
                const float* __restrict__ directions,
                const float* __restrict__ t_max, int n,
                const float4* __restrict__ nodes,
                const float4* __restrict__ tris, int leaf_size, float eps,
                int any_hit, float* __restrict__ t_out,
                int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out) {
  const int r = blockIdx.x * kTraverseThreads + threadIdx.x;
  if (r >= n) return;
  Hit best{t_max[r], 0.0f, 0.0f, -1};
  if (!(best.t > eps)) {
    t_out[r] = best.t;
    prim_out[r] = -1;
    u_out[r] = 0.0f;
    v_out[r] = 0.0f;
    return;
  }
  const float3 o = make_float3(origins[3 * r], origins[3 * r + 1],
                               origins[3 * r + 2]);
  const float3 d = make_float3(directions[3 * r], directions[3 * r + 1],
                               directions[3 * r + 2]);
  rfw::walk_bvh(o, d, nodes, tris, leaf_size, eps, any_hit != 0, best);
  t_out[r] = best.t;
  prim_out[r] = best.prim;
  u_out[r] = best.u;
  v_out[r] = best.v;
}

}  // namespace

extern "C" int rfw_traverse(const float* origins, const float* directions,
                            const float* t_max, int n, const float* nodes,
                            const float* tris, int leaf_size, float eps,
                            int any_hit, float* t_out, int* prim_out,
                            float* u_out, float* v_out,
                            cudaStream_t stream) {
  if (leaf_size < 1 || leaf_size > kMaxLeaf)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + kTraverseThreads - 1) / kTraverseThreads;
  traverse_kernel<<<grid, kTraverseThreads, 0, stream>>>(
      origins, directions, t_max, n, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), leaf_size, eps, any_hit, t_out,
      prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}
