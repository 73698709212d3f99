// K2: select + eval of the per-triangle resolve table.
//
// Replaces the TPU kernel tinyrenderer_tpu/ops/resolve.py::
// _select_eval_kernel (launcher select_eval_pallas, finish step
// _write_eval). On the TPU each tile picks its pixels' winning table rows
// with a one-hot matrix product over the tile's bin, because the TPU
// gathers badly; it then evaluates the numerator and 1/w planes at the
// pixel centres and writes the channels channel-first.
//
// What bounds it on the H100: memory. Per pixel it reads one id and one
// table row (28 or 53 floats, mostly served by L2: the table is a few
// hundred KB) and writes 13 or 22 channels; the arithmetic is ~2 FMAs per
// channel. Design: one thread per pixel gathers table[tri_id] directly —
// the winner is always in its tile's bin, so this is the row the one-hot
// product copies exactly — and writes each channel plane with coalesced
// stores (neighbouring threads, neighbouring x). Background pixels
// (tri_id < 0) write zeros, as the reference's empty one-hot sum does.
//
// Channel order (resolve.py _write_eval): slim (n_attr 6) f32 [world3
// oid], h [normal3 flat6]; full (n_attr 14) f32 [world3 uv2 record oid],
// h [normal3 tangent3 bitangent3 flat6]. The h plane is bf16 (round to
// nearest even, as JAX's astype) or f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
select_eval_kernel(const int* __restrict__ tri_id,
                   const float* __restrict__ table, float* __restrict__ outf,
                   void* __restrict__ outh_raw, int H, int W, int T, int D,
                   int n_attr) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)y * W + x;
  const int n_const = (n_attr == 14) ? 8 : 7;
  const int n_vec = (n_attr == 14) ? 5 : 3;
  const int planes = 3 * (n_attr + 1);
  const int tid = tri_id[o];
  // ids past the table clamp to its last row, as the plain version does
  const float* row = table + (size_t)(tid < 0 ? 0 : min(tid, T - 1)) * D;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;

  float denom = 1.0f;
  if (tid >= 0) {
    denom = tr::plane(row[0], row[1], row[2], px, py, false);
    if (!(fabsf(denom) > 1e-20f)) denom = 1.0f;
  }
  auto store_h = [&](int c, float v) {
    if (kBf16)
      ((__nv_bfloat16*)outh_raw)[c * HW + o] = __float2bfloat16_rn(v);
    else
      ((float*)outh_raw)[c * HW + o] = v;
  };
  for (int c = 0; c < n_attr; ++c) {
    float v = 0.0f;
    if (tid >= 0)
      v = __fdiv_rn(tr::plane(row[3 + c], row[3 + n_attr + c],
                              row[3 + 2 * n_attr + c], px, py, false),
                    denom);
    if (c < n_vec)
      outf[c * HW + o] = v;
    else
      store_h(c - n_vec, v);
  }
  const int h_off = n_attr - n_vec;
  for (int k = 0; k < n_const; ++k) {
    const float v = tid >= 0 ? row[planes + k] : 0.0f;
    if (k < 6)
      store_h(h_off + k, v);
    else
      outf[(n_vec + k - 6) * HW + o] = v;
  }
}

}  // namespace

extern "C" int tr_select_eval(const void* tri_id, const void* table,
                              void* outf, void* outh, int H, int W, int T,
                              int D, int n_attr, int h_bf16, void* stream) {
  dim3 grid((W + kThreads - 1) / kThreads, H);
  if (h_bf16)
    select_eval_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)tri_id, (const float*)table, (float*)outf, outh, H, W, T,
        D, n_attr);
  else
    select_eval_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)tri_id, (const float*)table, (float*)outf, outh, H, W, T,
        D, n_attr);
  return (int)cudaGetLastError();
}
