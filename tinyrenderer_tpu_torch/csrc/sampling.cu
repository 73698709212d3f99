// K7: the windowed u8 bilinear texture tap.
//
// Replaces the TPU kernel tinyrenderer_tpu/ops/sampling.py::
// _windowed_blend_kernel (launcher _windowed_blend_u8). A windowed pool
// row holds a texel and its +x, +y and +x+y neighbours as 4C u8 values, so
// one row is one whole bilinear footprint. The TPU kernel receives the
// rows already gathered (XLA's gather), transposes them with an identity
// matrix product so that pixels fill the vector lanes, decodes and blends.
// Here the gather is the kernel's own first step: per pixel, read row
// idx[n] of the pool, decode q * (1/255) and blend
// lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy).
//
// What bounds it on the H100: memory latency of the row gather. Per pixel
// it reads one 4C-byte row (36 bytes at C = 9; the pool is a few MB and
// stays in L2), 12 bytes of index and fractions, and writes 4C bytes, for
// ~3C fused multiply-adds. Design: one thread per pixel, the row read as
// bytes through the read-only cache (rows start at any multiple of 4C), the
// output written channel-first (one coalesced plane per channel) or
// channel-last (C consecutive floats a thread). Rounding is the jitted
// reference's: lerp(a, b, f) = fma(a, 1 - f, b * f) everywhere (ops/fp.py
// lerp), with every other operation rounded on its own (-fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(a, 1.0f - f, __fmul_rn(b, f));
}

__global__ void __launch_bounds__(kThreads)
windowed_blend_kernel(const uint8_t* __restrict__ texels,
                      const int* __restrict__ idx,
                      const float* __restrict__ fx_in,
                      const float* __restrict__ fy_in,
                      float* __restrict__ out, int R, int C, int N,
                      int channel_first) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int r = min(max(idx[n], 0), R - 1);
  const uint8_t* row = texels + (size_t)r * 4 * C;
  const float fx = fx_in[n], fy = fy_in[n];
  const float k = 1.0f / 255.0f;
  for (int c = 0; c < C; ++c) {
    const float c00 = __fmul_rn((float)__ldg(row + c), k);
    const float c10 = __fmul_rn((float)__ldg(row + C + c), k);
    const float c01 = __fmul_rn((float)__ldg(row + 2 * C + c), k);
    const float c11 = __fmul_rn((float)__ldg(row + 3 * C + c), k);
    const float v = lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy);
    if (channel_first)
      out[(size_t)c * N + n] = v;
    else
      out[(size_t)n * C + c] = v;
  }
}

}  // namespace

extern "C" int tr_windowed_blend(const void* texels, const void* idx,
                                 const void* fx, const void* fy, void* out,
                                 int R, int C, int N, int channel_first,
                                 void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  windowed_blend_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)texels, (const int*)idx, (const float*)fx,
      (const float*)fy, (float*)out, R, C, N, channel_first);
  return (int)cudaGetLastError();
}
