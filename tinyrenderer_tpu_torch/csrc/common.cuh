// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace tr {

// Affine plane a * px + b * py + c with the rounding of the JAX
// reference's CPU execution (ops/fp.py plane): XLA's LLVM backend fuses
// the first product into an FMA for broadcast multiply-adds, and the
// second for the 3-term matrix product of large tiles (mxu_order).
// Intrinsics keep nvcc from contracting anything else.
__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py, bool mxu_order) {
  const float t = mxu_order ? __fmaf_rn(b, py, __fmul_rn(a, px))
                            : __fmaf_rn(a, px, __fmul_rn(b, py));
  return __fadd_rn(t, c);
}

}  // namespace tr
