// One ray's walk of a 4-wide BVH, shared by traverse_kernel.cu (a ray a
// thread over the scene's BVH, walk_bvh) and tlas_kernel.cu (a ray a
// thread over each touched instance's BLAS, one walk_step at a time).
// Header-only; every function is inline, so each translation unit keeps
// its own copy.
//
// Order, exactly as ops/traverse.py::traverse_wide_ref (and rfw_tpu)
// takes it:
// - the 4 child boxes are tested against the best t at node entry,
//   tfar >= max(tnear, 0) && tnear < t_best && child >= 0, with NaN
//   carried through every min and max as torch.minimum/maximum do (so a
//   NaN anywhere in a box's slabs leaves it unhit);
// - hit leaf slots in slot order, each leaf's first min(count, leaf_size)
//   triangles in order, each against the running best with a strict <;
// - hit internal children pushed farthest first, ties the higher slot
//   first, so the nearest (on a tie the lower slot) pops first; a push
//   past the stack writes slot 63 while ptr keeps counting, and a pop past
//   it reads slot 63;
// - any hit stops after the node in which a hit was recorded.
// The leaf tests of a node run as one mask of (slot, triangle) bits taken
// in order, so a warp runs as many tests as its busiest lane, not the sum
// over slots of each slot's busiest lane.

#pragma once

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace rfw {

constexpr int kStack = 64;
constexpr int kWidth = 4;
constexpr int kMaxLeaf = 8;  // triangles a leaf slot: 8 bits of the mask

// torch.minimum / torch.maximum: NaN in, NaN out, one instruction each
// (sm_80+). The sign of a zero result may differ from torch's; no
// comparison sees it.
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Hit {
  float t, u, v;
  int prim;
};

// ops/intersect.py::intersect_tri, operation for operation, on row idx
// of the triangle-major table (traverse.tri_table).
__device__ __forceinline__ void test_tri(float3 o, float3 d,
                                         const float4* __restrict__ tris,
                                         int idx, float eps, Hit& best) {
  const float4* row = tris + 3 * (size_t)idx;
  const float4 a = __ldg(row), e1 = __ldg(row + 1), e2 = __ldg(row + 2);
  const float px = d.y * e2.z - d.z * e2.y;
  const float py = d.z * e2.x - d.x * e2.z;
  const float pz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const bool valid = fabsf(det) > 1e-12f;
  const float inv_det = valid ? 1.0f / det : 0.0f;
  const float tx = o.x - a.x, ty = o.y - a.y, tz = o.z - a.z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  if (valid && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
      t > eps && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.prim = idx;
  }
}

// One pop of the walk of the live ray (o, d), whose reciprocal inv is
// safe_inv of d (the sign-preserving clamp), from the nodes left on
// stack (ptr of them pushed; stack[0] = 0, the root, and ptr = 1 to
// start) of the node-major table (traverse.node_table), against best.t,
// which it lowers at each hit; best.prim is the hit row of the triangle
// table, untouched on a miss. Returns whether the walk goes on: nodes
// are left and, for any hit, no hit was recorded. The ray stays in the
// caller's registers; only the stack is in local memory.
__device__ __forceinline__ bool walk_step(float3 o, float3 d, float3 inv,
                                          int* stack, int& ptr,
                                          const float4* __restrict__ nodes,
                                          const float4* __restrict__ tris,
                                          int leaf_size, float eps,
                                          bool any_hit, Hit& best) {
  const int node = stack[min(ptr - 1, kStack - 1)];
  ptr -= 1;
  const float4* nd = nodes + (size_t)node * (2 * kWidth);
  float tnear[kWidth];
  int child[kWidth];
  bool push[kWidth];
  unsigned todo = 0;      // leaf tests, bit 8 j + i: slot j, triangle i
  const float t_entry = best.t;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const float4 lo = __ldg(nd + j);
    const float4 hi = __ldg(nd + kWidth + j);
    child[j] = __float_as_int(lo.w);
    const int count = __float_as_int(hi.w);
    const float t1x = (lo.x - o.x) * inv.x, t2x = (hi.x - o.x) * inv.x;
    const float t1y = (lo.y - o.y) * inv.y, t2y = (hi.y - o.y) * inv.y;
    const float t1z = (lo.z - o.z) * inv.z, t2z = (hi.z - o.z) * inv.z;
    const float tn =
        tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
    const float tf =
        tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)), tmax(t1z, t2z));
    tnear[j] = tn;
    const bool hit = tf >= tmax(tn, 0.0f) && tn < t_entry && child[j] >= 0;
    push[j] = hit && count < 0;
    if (hit && count > 0) {
      const int cnt = min(count & 0x7FFFFFFF, leaf_size);
      todo |= ((1u << cnt) - 1u) << (8 * j);
    }
  }
  while (todo) {
    const int b = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int s = b >> 3;
    const int first = s == 0 ? child[0] : s == 1 ? child[1]
                                        : s == 2 ? child[2] : child[3];
    test_tri(o, d, tris, first + (b & 7), eps, best);
  }
  // slot j's place in the push sequence: after every pushed slot with
  // a larger tnear, or an equal one in a higher slot
  int pos[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    int p = 0;
#pragma unroll
    for (int k = 0; k < kWidth; ++k)
      p += push[k] && (tnear[k] > tnear[j] ||
                       (tnear[k] == tnear[j] && k > j));
    pos[j] = p;
  }
  int pushed = 0;
#pragma unroll
  for (int q = 0; q < kWidth; ++q) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      if (push[j] && pos[j] == q) {
        stack[min(ptr + q, kStack - 1)] = child[j];
        ++pushed;
      }
    }
  }
  ptr += pushed;
  return ptr > 0 && !(any_hit && best.prim >= 0);
}

// The whole walk of one live ray (o, d) from the root against best.
__device__ __forceinline__ void walk_bvh(float3 o, float3 d,
                                         const float4* __restrict__ nodes,
                                         const float4* __restrict__ tris,
                                         int leaf_size, float eps,
                                         bool any_hit, Hit& best) {
  const float3 inv =
      make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int stack[kStack];
  stack[0] = 0;
  int ptr = 1;
  while (walk_step(o, d, inv, stack, ptr, nodes, tris, leaf_size, eps,
                   any_hit, best)) {
  }
}

}  // namespace rfw
