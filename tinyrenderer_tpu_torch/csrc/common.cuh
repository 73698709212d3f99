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

// Largest value tr::plane takes over the pixel centres of the rectangle
// [xlo, xhi] x [ylo, yhi] (centres, 0 < xlo <= xhi, 0 < ylo <= yhi): plane
// composes correctly rounded operations, each monotone, so it rises with
// px where a >= 0 and falls where a < 0 (py and b alike), in both
// mxu_order forms; its maximum is its own value at the corner those signs
// pick. NaN where the plane is NaN there.
__device__ __forceinline__ float plane_max(float a, float b, float c,
                                           float xlo, float xhi, float ylo,
                                           float yhi, bool mxu_order) {
  return plane(a, b, c, a >= 0.0f ? xhi : xlo, b >= 0.0f ? yhi : ylo,
               mxu_order);
}

// Whether a setup row (floats 0..11 in r0, r1, r2: three edge planes, then
// the depth plane) covers no pixel centre of the rectangle: some edge is
// negative even at its best corner. A NaN never rejects. Exact: it rejects
// no row that the per-pixel test edge >= 0 accepts anywhere inside.
__device__ __forceinline__ bool edges_reject(const float4& r0,
                                             const float4& r1,
                                             const float4& r2, float xlo,
                                             float xhi, float ylo, float yhi,
                                             bool mxu_order) {
  return plane_max(r0.x, r0.y, r0.z, xlo, xhi, ylo, yhi, mxu_order) < 0.0f ||
         plane_max(r0.w, r1.x, r1.y, xlo, xhi, ylo, yhi, mxu_order) < 0.0f ||
         plane_max(r1.z, r1.w, r2.x, xlo, xhi, ylo, yhi, mxu_order) < 0.0f;
}

// End of tile t's walked window of a CSR stream: the reference walks nb
// blocks of kb rows from the block holding the segment's first row, so the
// window is [starts[t], min(starts[t + 1], (starts[t] / kb + nb) * kb)).
__device__ __forceinline__ int walk_stop(const int* starts, int t, int kb,
                                         int nb) {
  return min(starts[t + 1], (starts[t] / kb + nb) * kb);
}

}  // namespace tr
