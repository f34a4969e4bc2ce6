// Wide-BVH traversal kernel for Hopper (sm_90a), plain C interface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the other kernels
// (--fmad=false, IEEE division) and bound with ctypes. The entry point
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces rfw_tpu/ops/traverse.py::traverse_wide (:58), an XLA step (a
// vmapped while_loop with a gather per node) rather than a Pallas kernel;
// its plain PyTorch version, traverse_wide_ref in
// rfw_tpu_torch/ops/traverse.py, is a host loop of some 60 small ops and
// a host sync per step. Here one thread walks one ray: the ray and its
// best hit live in registers, the 64-entry stack in local memory (a stack
// frame, not a spill). A node is 128 contiguous bytes of the node-major
// table (traverse.node_table): for slot j, (bmin xyz, child) and
// (bmax xyz, count), each one 16-byte __ldg. Triangles are read as the
// (T, 3) rows v0, e1, e2.
//
// Bound: neither bytes nor FP32 issue. Threads of a warp walk different
// nodes (divergence) and each node's loads depend on the pop before them
// (latency), so most issue slots wait. A treelet-cached or packet design
// is a later change; this kernel is the simple one, held to the plain
// version bit for bit.
//
// Order, exactly as traverse_wide_ref (and rfw_tpu) takes it:
// - the 4 child boxes are tested against the best t at node entry,
//   tfar >= max(tnear, 0) && tnear < t_best && child >= 0, with NaN
//   carried through every min and max as torch.minimum/maximum do
//   (fminf/fmaxf would drop it);
// - hit leaf slots in slot order, each leaf's first min(count, leaf_size)
//   triangles in order, each against the running best with a strict <;
// - hit internal children pushed farthest first, ties the higher slot
//   first, so the nearest (on a tie the lower slot) pops first; a push
//   past the stack writes slot 63 while ptr keeps counting, and a pop past
//   it reads slot 63;
// - any hit stops after the node in which a hit was recorded.

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

using rfw::safe_inv;

constexpr int kStack = 64;
constexpr int kWidth = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum: NaN in, NaN out.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : (b < a ? b : a);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : (b > a ? b : a);
}

struct Hit {
  float t, u, v;
  int prim;
};

// ops/intersect.py::intersect_tri, operation for operation.
__device__ __forceinline__ void test_tri(float3 o, float3 d,
                                         const float* __restrict__ v0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2,
                                         int idx, float eps, Hit& best) {
  const float ax = __ldg(v0 + 3 * idx), ay = __ldg(v0 + 3 * idx + 1),
              az = __ldg(v0 + 3 * idx + 2);
  const float e1x = __ldg(e1 + 3 * idx), e1y = __ldg(e1 + 3 * idx + 1),
              e1z = __ldg(e1 + 3 * idx + 2);
  const float e2x = __ldg(e2 + 3 * idx), e2y = __ldg(e2 + 3 * idx + 1),
              e2z = __ldg(e2 + 3 * idx + 2);
  const float px = d.y * e2z - d.z * e2y;
  const float py = d.z * e2x - d.x * e2z;
  const float pz = d.x * e2y - d.y * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool valid = fabsf(det) > 1e-12f;
  const float inv_det = valid ? 1.0f / det : 0.0f;
  const float tx = o.x - ax, ty = o.y - ay, tz = o.z - az;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (valid && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
      t > eps && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.prim = idx;
  }
}

__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ origins,
                const float* __restrict__ directions,
                const float* __restrict__ t_max, int n,
                const float4* __restrict__ nodes,
                const float* __restrict__ v0, const float* __restrict__ e1,
                const float* __restrict__ e2, int leaf_size, float eps,
                int any_hit, float* __restrict__ t_out,
                int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float3 o = make_float3(origins[3 * r], origins[3 * r + 1],
                               origins[3 * r + 2]);
  const float3 d = make_float3(directions[3 * r], directions[3 * r + 1],
                               directions[3 * r + 2]);
  const float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Hit best{t_max[r], 0.0f, 0.0f, -1};
  int stack[kStack];
  stack[0] = 0;
  int ptr = 1;
  while (ptr > 0 && !(any_hit && best.prim >= 0)) {
    const int node = stack[min(ptr - 1, kStack - 1)];
    ptr -= 1;
    const float4* nd = nodes + (size_t)node * (2 * kWidth);
    float tnear[kWidth];
    int child[kWidth], count[kWidth];
    bool hit[kWidth];
    const float t_entry = best.t;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const float4 lo = __ldg(nd + j);
      const float4 hi = __ldg(nd + kWidth + j);
      child[j] = __float_as_int(lo.w);
      count[j] = __float_as_int(hi.w);
      const float t1x = (lo.x - o.x) * inv.x, t2x = (hi.x - o.x) * inv.x;
      const float t1y = (lo.y - o.y) * inv.y, t2y = (hi.y - o.y) * inv.y;
      const float t1z = (lo.z - o.z) * inv.z, t2z = (hi.z - o.z) * inv.z;
      const float tn =
          tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
      const float tf =
          tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)), tmax(t1z, t2z));
      tnear[j] = tn;
      hit[j] = tf >= tmax(tn, 0.0f) && tn < t_entry && child[j] >= 0;
    }
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      if (!hit[j] || count[j] <= 0) continue;
      const int cnt = min(count[j] & 0x7FFFFFFF, leaf_size);
      for (int i = 0; i < cnt; ++i)
        test_tri(o, d, v0, e1, e2, child[j] + i, eps, best);
    }
    // slot j's place in the push sequence: after every pushed slot with
    // a larger tnear, or an equal one in a higher slot
    bool push[kWidth];
    int pos[kWidth];
#pragma unroll
    for (int j = 0; j < kWidth; ++j) push[j] = hit[j] && count[j] < 0;
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
  }
  t_out[r] = best.t;
  prim_out[r] = best.prim;
  u_out[r] = best.u;
  v_out[r] = best.v;
}

}  // namespace

extern "C" int rfw_traverse(const float* origins, const float* directions,
                            const float* t_max, int n, const float* nodes,
                            const float* v0, const float* e1,
                            const float* e2, int leaf_size, float eps,
                            int any_hit, float* t_out, int* prim_out,
                            float* u_out, float* v_out, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  traverse_kernel<<<grid, kThreads, 0, stream>>>(
      origins, directions, t_max, n, reinterpret_cast<const float4*>(nodes),
      v0, e1, e2, leaf_size, eps, any_hit, t_out, prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}
