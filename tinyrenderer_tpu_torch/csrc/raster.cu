// K1: tiled visibility raster.
//
// Replaces the TPU kernel tinyrenderer_tpu/ops/raster.py::_raster_kernel
// (launcher rasterize_binned). Per screen tile it evaluates the three edge
// planes and the depth plane of every binned 16-float setup row at the
// pixel centres, keeps a pixel where all edges are >= 0 and the id is > 0,
// and runs a reverse-Z max-depth race with ties broken by the larger id.
//
// What bounds it on the H100: arithmetic. Each pixel evaluates 4 planes
// per binned row (K = 256 rows x 2 M pixels at 1080p is ~2 G plane
// evaluations), while the bins are a few MB read once per block. Design:
// one thread per pixel keeps best_z / best_id in registers; a block covers
// kThreads pixels of one tile (a 128 x 128 shadow tile has 16384 pixels,
// more than a block may hold) and stages the tile's rows through shared
// memory kChunk rows at a time, looping to counts[tile], so every row is
// read from device memory once per block and broadcast from shared memory.
// Results go straight into the untiled (H', W') image.
//
// Semantics follow the Pallas kernel, not the jnp reference: the race
// starts from best_z = 0, so a covered pixel whose depth is exactly 0
// still wins on its id. The plane rounding matches the reference through
// tr::plane (no --use_fast_math, no other contraction).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;
constexpr int kCols = 16;

__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ counts, const float* __restrict__ rows,
              int* __restrict__ tri_id, float* __restrict__ depth,
              int tiles_x, int tile_h, int tile_w, int K, int width,
              int mxu_order) {
  __shared__ float srow[kChunk * kCols];
  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int lx = p % tile_w;
  const int ly = p / tile_w;
  const float px = (float)(tx * tile_w + lx) + 0.5f;
  const float py = (float)(ty * tile_h + ly) + 0.5f;
  const bool mxu = mxu_order != 0;
  const float* trow = rows + (size_t)t * K * kCols;
  const int count = min(max(counts[t], 0), K);

  float best_z = 0.0f, best_id = 0.0f;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kCols; i += kThreads)
      srow[i] = trow[(size_t)base * kCols + i];
    __syncthreads();
    if (p < P) {
      for (int r = 0; r < n; ++r) {
        const float* s = srow + r * kCols;
        const float idf = s[12];
        const float l0 = tr::plane(s[0], s[1], s[2], px, py, mxu);
        const float l1 = tr::plane(s[3], s[4], s[5], px, py, mxu);
        const float l2 = tr::plane(s[6], s[7], s[8], px, py, mxu);
        const float z = tr::plane(s[9], s[10], s[11], px, py, mxu);
        const bool covered = l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f &&
                             idf > 0.0f;
        if (covered && (z > best_z || (z == best_z && idf > best_id))) {
          best_z = z;
          best_id = idf;
        }
      }
    }
  }
  if (p < P) {
    const size_t o = (size_t)(ty * tile_h + ly) * width + (tx * tile_w + lx);
    tri_id[o] = (int)best_id - 1;
    depth[o] = best_z;
  }
}

}  // namespace

extern "C" int tr_raster(const void* counts, const void* rows, void* tri_id,
                         void* depth, int n_tiles, int tiles_x, int tile_h,
                         int tile_w, int K, int width, int mxu_order,
                         void* stream) {
  const int P = tile_h * tile_w;
  dim3 grid(n_tiles, (P + kThreads - 1) / kThreads);
  raster_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)rows, (int*)tri_id, (float*)depth,
      tiles_x, tile_h, tile_w, K, width, mxu_order);
  return (int)cudaGetLastError();
}
