// K3: fused deferred shading.
//
// Replaces the TPU kernel tinyrenderer_tpu/ops/shading.py::_shade_kernel
// (launcher shade_deferred_fused). Per pixel: normalize the geometric
// normal, take the flat material (albedo, roughness, metalness), evaluate
// Cook-Torrance per point light (1/d^2 falloff) and per directional light,
// each gated on shadow > 0, add SH-9 ambient with roughness Fresnel,
// composite the sky over the background, and write (3, H, W) HDR.
//
// What bounds it on the H100: memory. It reads 13-22 attribute planes,
// the gates and the sky (~70-90 bytes a pixel) and writes 12, against
// ~100-200 flops a pixel with one or two lights — far below the card's
// flop/byte balance. Design: one thread per pixel, channel planes read
// with coalesced loads (neighbouring threads, neighbouring x), the
// constants row (camera, lights, SH) read through the read-only cache,
// light counts as runtime ints. The arithmetic follows _shade_kernel line
// by line: normalization divides by the length (no reciprocal), x^5 is
// x * (x^2 * x^2) as the reference's integer power, no fast-math, and
// the 3-term dot products and the GGX denominator (whose cancellation at
// low roughness amplifies any rounding difference) fuse exactly where the
// reference's CPU build fuses them; everything else rounds per operation.
// The textured material plane of the reference (has_rec) is not ported:
// the frame refuses textured scenes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265359f;
constexpr float kF0 = 0.04f;
// ops/env.py _SH_C
constexpr float kSh0 = 0.282095f, kSh1 = 0.488603f, kSh2 = 1.092548f,
                kSh3 = 0.315392f, kSh4 = 0.546274f;

// a . b rounded as the reference's CPU build does (ops/shading.py _dot3);
// every other product and sum rounds on its own (-fmad=false)
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, ay * by));
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float d = fmaxf(sqrtf(dot3(x, y, z, x, y, z)), 1e-12f);
  x = x / d;
  y = y / d;
  z = z / d;
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

struct Surface {
  float nx, ny, nz, vx, vy, vz, alb[3], rough, metal, one_m, f0[3], n_dot_v,
      kg, gv, r4;
};

__device__ __forceinline__ void add_light(const Surface& s, float lx, float ly,
                                          float lz, const float radiance[3],
                                          float gate, float hdr[3]) {
  float hx = s.vx + lx, hy = s.vy + ly, hz = s.vz + lz;
  norm3(hx, hy, hz);
  const float h_dot_v = fmaxf(dot3(hx, hy, hz, s.vx, s.vy, s.vz), 0.0f);
  const float fres5 = pow5(fminf(fmaxf(1.0f - h_dot_v, 0.0f), 1.0f));
  const float n_dot_h = fmaxf(dot3(s.nx, s.ny, s.nz, hx, hy, hz), 0.0f);
  const float n_dot_l = fmaxf(dot3(s.nx, s.ny, s.nz, lx, ly, lz), 0.0f);
  const float denom = __fmaf_rn(n_dot_h * n_dot_h, s.r4 - 1.0f, 1.0f);
  const float ndf = s.r4 / (kPi * denom * denom);
  const float gl = n_dot_l / (n_dot_l * (1.0f - s.kg) + s.kg);
  const float spec_s = ndf * (s.gv * gl) / (4.0f * s.n_dot_v * n_dot_l + 1e-4f);
  const float w = n_dot_l * gate;
  for (int ch = 0; ch < 3; ++ch) {
    const float f = s.f0[ch] + (1.0f - s.f0[ch]) * fres5;
    const float kd = (1.0f - f) * s.one_m;
    hdr[ch] = hdr[ch] + (kd * s.alb[ch] / kPi + f * spec_s) * radiance[ch] * w;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ c, const int* __restrict__ tri_id,
             const float* __restrict__ outf, const void* __restrict__ outh_raw,
             const float* __restrict__ gates, const float* __restrict__ sky,
             float* __restrict__ hdr_out, int H, int W, int cf, int ch,
             int num_point, int num_dir, int has_ibl) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)y * W + x;
  auto hv = [&](int k) -> float {
    if (kBf16)
      return __bfloat162float(((const __nv_bfloat16*)outh_raw)[k * HW + o]);
    return ((const float*)outh_raw)[k * HW + o];
  };
  float out[3];
  if (tri_id[o] < 0) {
    for (int k = 0; k < 3; ++k) out[k] = sky ? sky[k * HW + o] : 0.0f;
  } else {
    Surface s;
    s.nx = hv(0);
    s.ny = hv(1);
    s.nz = hv(2);
    norm3(s.nx, s.ny, s.nz);
    const int a0 = (cf == 4) ? 3 : 9;   // slim [normal3 flat6] / full
    for (int k = 0; k < 3; ++k) s.alb[k] = hv(a0 + k);
    s.rough = hv(a0 + 3);
    s.metal = hv(a0 + 4);
    const float px = outf[o], py = outf[HW + o], pz = outf[2 * HW + o];
    s.vx = c[0] - px;
    s.vy = c[1] - py;
    s.vz = c[2] - pz;
    norm3(s.vx, s.vy, s.vz);
    s.one_m = 1.0f - s.metal;
    for (int k = 0; k < 3; ++k)
      s.f0[k] = kF0 * s.one_m + s.alb[k] * s.metal;
    s.n_dot_v = fmaxf(dot3(s.nx, s.ny, s.nz, s.vx, s.vy, s.vz), 0.0f);
    s.kg = (s.rough + 1.0f) * (s.rough + 1.0f) / 8.0f;
    s.gv = s.n_dot_v / (s.n_dot_v * (1.0f - s.kg) + s.kg);
    const float r2 = s.rough * s.rough;
    s.r4 = r2 * r2;
    float hdr[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < num_point; ++i) {
      const float* L = c + 3 + 6 * i;
      const float tlx = L[0] - px, tly = L[1] - py, tlz = L[2] - pz;
      const float d2 = fmaxf(dot3(tlx, tly, tlz, tlx, tly, tlz), 1e-8f);
      const float dist = sqrtf(d2);
      const float atten = 1.0f / d2;
      const float gate = gates[i * HW + o] > 0.0f ? 1.0f : 0.0f;
      const float radiance[3] = {L[3] * atten, L[4] * atten, L[5] * atten};
      add_light(s, tlx / dist, tly / dist, tlz / dist, radiance, gate, hdr);
    }
    for (int i = 0; i < num_dir; ++i) {
      const float* L = c + 3 + 6 * num_point + 6 * i;
      const float gate = gates[(num_point + i) * HW + o] > 0.0f ? 1.0f : 0.0f;
      const float radiance[3] = {L[3], L[4], L[5]};
      add_light(s, -L[0], -L[1], -L[2], radiance, gate, hdr);
    }
    if (has_ibl) {
      const float* sh = c + 3 + 6 * (num_point + num_dir);
      const float nx = s.nx, ny = s.ny, nz = s.nz;
      const float basis[9] = {0.0f,
                              kSh1 * ny,
                              kSh1 * nz,
                              kSh1 * nx,
                              kSh2 * nx * ny,
                              kSh2 * ny * nz,
                              kSh3 * (3.0f * nz * nz - 1.0f),
                              kSh2 * nx * nz,
                              kSh4 * (nx * nx - ny * ny)};
      const float fres5 = pow5(fminf(fmaxf(1.0f - s.n_dot_v, 0.0f), 1.0f));
      for (int k = 0; k < 3; ++k) {
        float irr = sh[k] * kSh0;
        for (int b = 1; b < 9; ++b) irr = irr + sh[3 * b + k] * basis[b];
        irr = fmaxf(irr, 0.0f);
        const float ks =
            s.f0[k] + (fmaxf(1.0f - s.rough, s.f0[k]) - s.f0[k]) * fres5;
        hdr[k] = hdr[k] + (1.0f - ks) * irr * s.alb[k];
      }
    }
    for (int k = 0; k < 3; ++k) out[k] = hdr[k];
  }
  for (int k = 0; k < 3; ++k) hdr_out[k * HW + o] = out[k];
}

}  // namespace

extern "C" int tr_shade(const void* consts, const void* tri_id,
                        const void* outf, const void* outh, const void* gates,
                        const void* sky, void* hdr, int H, int W, int cf,
                        int ch, int h_bf16, int num_point, int num_dir,
                        int has_ibl, void* stream) {
  dim3 grid((W + kThreads - 1) / kThreads, H);
  if (h_bf16)
    shade_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)consts, (const int*)tri_id, (const float*)outf, outh,
        (const float*)gates, (const float*)sky, (float*)hdr, H, W, cf, ch,
        num_point, num_dir, has_ibl);
  else
    shade_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)consts, (const int*)tri_id, (const float*)outf, outh,
        (const float*)gates, (const float*)sky, (float*)hdr, H, W, cf, ch,
        num_point, num_dir, has_ibl);
  return (int)cudaGetLastError();
}
