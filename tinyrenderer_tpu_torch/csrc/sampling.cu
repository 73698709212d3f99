// K7: the windowed u8 bilinear texture tap.
//
// Replaces the TPU kernel tinyrenderer_tpu/ops/sampling.py::
// _windowed_blend_kernel (launcher _windowed_blend_u8). A windowed pool
// row holds a texel and its +x, +y and +x+y neighbours as 4C u8 values, so
// one row is one whole bilinear footprint. The TPU kernel receives the
// rows already gathered (XLA's gather), transposes them with an identity
// matrix product so that pixels fill the vector lanes, decodes and blends.
// Here the gather is the kernel's own first step: per tap, read row
// idx[n] of the pool, decode q * (1/255) and blend
// lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy).
//
// What bounds it on the H100: with the row read a byte at a time (36 loads
// a tap at C = 9, each with its own address arithmetic and conversion) the
// number of load instructions, and in channel-last layout the stores, a
// thread's C floats lying 4C bytes from its neighbour's. With both repaired
// it is close to its bytes: a tap reads one 4C-byte row (the pool is a few
// MB and stays in L2) and 12 bytes of index and fractions and writes 4C
// bytes, for ~3C fused multiply-adds. The design:
//   - a row starts at r * 4C bytes, a multiple of 4, so it is read as C
//     32-bit words through the read-only cache and the corner bytes are
//     shifted out of registers (C is a template parameter, so every shift
//     is a constant);
//   - channel-first output is one coalesced plane a channel; channel-last
//     output is composed a warp at a time in shared memory (32 taps, one
//     contiguous 16-byte aligned span of 32 * C floats) and written as
//     16-byte stores;
//   - a thread takes one tap, so the index and fraction reads are
//     coalesced; the warps of a multiprocessor cover the latency of L2.
//     Several taps a thread, their row loads started before the first
//     blend, were slower the more there were (four need 80 registers at
//     C = 9).
// Times a launch on an H100 80GB HBM3 at 700 W, the byte kernel it replaced
// in the same call (tools/tune_raster.py --k7): 524288 taps of the material
// sample, channel-last, 0.0094 against 0.0481 ms (channel-first 0.0086
// against 0.0173 ms); 32768 taps of the sprite 0.0028 against 0.0049 ms.
// C = 9 (the composite material record, also the overlay sprite's pool) is
// instantiated; any other C takes the byte loop, one thread a tap. Rounding
// is the jitted reference's in both: lerp(a, b, f) = fma(a, 1 - f, b * f)
// everywhere (ops/fp.py lerp), with every other operation rounded on its
// own (-fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(a, 1.0f - f, __fmul_rn(b, f));
}

__device__ __forceinline__ float blend(float c00, float c10, float c01,
                                       float c11, float fx, float fy) {
  return lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy);
}

// Byte b of a row held as C words, decoded.
template <int C>
__device__ __forceinline__ float texel(const uint32_t (&w)[C], int b) {
  return __fmul_rn((float)((w[b >> 2] >> (8 * (b & 3))) & 0xffu),
                   1.0f / 255.0f);
}

// texels: the pool as words, C a row (4-byte aligned).
template <int C>
__global__ void __launch_bounds__(kThreads)
windowed_blend_kernel(const uint32_t* __restrict__ texels,
                      const int* __restrict__ idx,
                      const float* __restrict__ fx_in,
                      const float* __restrict__ fy_in,
                      float* __restrict__ out, int R, int N,
                      int channel_first) {
  // channel-last staging: 32 * C floats a warp
  __shared__ __align__(16) float stage[kThreads * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const int r = live ? min(max(idx[n], 0), R - 1) : 0;
  const float fx = live ? fx_in[n] : 0.0f, fy = live ? fy_in[n] : 0.0f;
  const uint32_t* row = texels + (size_t)r * C;
  uint32_t w[C];
#pragma unroll
  for (int j = 0; j < C; ++j) w[j] = __ldg(row + j);
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    v[c] = blend(texel<C>(w, c), texel<C>(w, C + c), texel<C>(w, 2 * C + c),
                 texel<C>(w, 3 * C + c), fx, fy);
  if (channel_first) {
    if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[(size_t)c * N + n] = v[c];
    }
    return;
  }
  // this warp's 32 taps start at tap n0, a multiple of 32: their floats are
  // one span that starts on a 16-byte boundary of out
  const int n0 = blockIdx.x * kThreads + warp * 32;
  const int floats = min(32, N - n0) * C;      // <= 0 past the end
  float* st = stage + warp * 32 * C;
#pragma unroll
  for (int c = 0; c < C; ++c) st[lane * C + c] = v[c];
  __syncwarp();
  float* dst = out + (size_t)n0 * C;
  const int quads = floats > 0 ? floats / 4 : 0;
  for (int q = lane; q < quads; q += 32)
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(st)[q];
  for (int j = quads * 4 + lane; j < floats; j += 32) dst[j] = st[j];
}

// Any C: one thread a tap, the row read a byte at a time.
__global__ void __launch_bounds__(kThreads)
windowed_blend_bytes_kernel(const uint8_t* __restrict__ texels,
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
    const float v = blend(__fmul_rn((float)__ldg(row + c), k),
                          __fmul_rn((float)__ldg(row + C + c), k),
                          __fmul_rn((float)__ldg(row + 2 * C + c), k),
                          __fmul_rn((float)__ldg(row + 3 * C + c), k), fx, fy);
    if (channel_first)
      out[(size_t)c * N + n] = v;
    else
      out[(size_t)n * C + c] = v;
  }
}

}  // namespace

// texels and out must be 4- and 16-byte aligned (the wrapper checks the
// first and allocates the second).
extern "C" int tr_windowed_blend(const void* texels, const void* idx,
                                 const void* fx, const void* fy, void* out,
                                 int R, int C, int N, int channel_first,
                                 void* stream) {
  if (((uintptr_t)texels & 3) || ((uintptr_t)out & 15))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (N + kThreads - 1) / kThreads;
  if (C == 9) {
    windowed_blend_kernel<9><<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)texels, (const int*)idx, (const float*)fx,
        (const float*)fy, (float*)out, R, N, channel_first);
  } else {
    windowed_blend_bytes_kernel<<<blocks, kThreads, 0, s>>>(
        (const uint8_t*)texels, (const int*)idx, (const float*)fx,
        (const float*)fy, (float*)out, R, C, N, channel_first);
  }
  return (int)cudaGetLastError();
}
