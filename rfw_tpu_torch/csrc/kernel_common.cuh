// Device helpers shared by the port's kernels (visit_kernels.cu,
// expand_kernel.cu, tvisit_kernel.cu). Header-only; every function is
// inline, so each translation unit keeps its own copy.

#pragma once

#include <cuda_runtime.h>

namespace rfw {

// 1/d with the sign-preserving clamp of ops/intersect.py::safe_inv_dir.
__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / s;
}

// 16-byte global -> shared copy that bypasses the registers (and L1).
__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread of a block of kThreads issues its share of one contiguous
// granule's copy (n4 16-byte chunks, 16-byte aligned) as one cp.async
// group.
template <int kThreads>
__device__ __forceinline__ void stage_granule(float4* dst, const float* src,
                                              int n4) {
  for (int c = threadIdx.x; c < n4; c += kThreads)
    cp_async16(dst + c, src + 4 * c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace rfw
