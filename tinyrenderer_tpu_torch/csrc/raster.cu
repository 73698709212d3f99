// K1, K4 and K6: tiled visibility raster.
//
// K1 replaces the TPU kernel tinyrenderer_tpu/ops/raster.py::_raster_kernel
// (launcher rasterize_binned): the bin of a tile is its first counts[t]
// rows of a dense (tiles, K, 16) array. K4 replaces
// tinyrenderer_tpu/ops/raster.py::_raster_stream_kernel (launcher
// rasterize_stream): the bin is the tile's walked window of one CSR stream
// of rows, [start, min(end, (start / kb + nb) * kb)) with start, end =
// starts[t], starts[t + 1] -- exactly the rows the reference's nb grid
// steps of kb-row blocks reach, so a segment longer than the walk loses
// the same tail. K6 replaces tinyrenderer_tpu/ops/raster.py::
// _raster_resolve_kernel (launcher rasterize_resolve_binned, the
// fused_resolve configuration): K1's race over dense bins, then the
// winner's row of the (T, D) resolve table. All three evaluate the three
// edge planes and the depth plane of every 16-float setup row at the pixel
// centres, keep a pixel where all edges are >= 0 and the id is > 0, and
// run a reverse-Z max-depth race with ties broken by the larger id.
//
// What bounds K1 and K4 on the H100: arithmetic. Each pixel evaluates 4 planes
// per row of its tile's bin (K = 256 rows x 2 M pixels at 1080p is ~2 G
// plane evaluations), while the rows are a few MB. Design: one thread per
// pixel keeps best_z / best_id in registers; a block covers kThreads
// pixels of one tile (a 128 x 128 shadow tile has 16384 pixels, more than
// a block may hold) and stages the tile's rows through shared memory
// kChunk rows at a time (race_rows, shared by all three), so every row
// is read from device memory once per block and broadcast from shared
// memory. A tile of P pixels spans P / kThreads blocks that each stage the
// same rows: at the high-poly main view's 8 x 128 tiles every segment is
// read from L2 four times, which is what bounds K4 beside the plane
// arithmetic. Results go straight into the untiled (H', W') image.
//
// K6 is bound by bytes instead: at 1088 x 1920 it writes a D = 53 float
// row a pixel (443 MB), against a few MB of bins. The TPU kernel carries
// the winner's row through the race with a one-hot matrix product over the
// tile's pre-gathered table rows; here the race is K1's (race_rows) and
// only its result picks the row: table[best_id - 1], read through the
// read-only cache (the table is small and stays in L2). The block writes
// its pixels' rows together, thread k of the block writing float k of the
// block's rows, so that the stores of a warp are contiguous (a tile row of
// pixels is contiguous in the (H', W', D) output). Background pixels get
// zeros, as the reference's empty one-hot sum.
//
// Semantics follow the Pallas kernels, not the jnp reference: the race
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

// Depth race of one pixel (px, py) over rows[0, n), staged through srow by
// the whole block; every thread of the block must call it (the syncs), and
// only threads with active set evaluate.
__device__ __forceinline__ void race_rows(const float* __restrict__ rows,
                                          int n, bool active, float px,
                                          float py, bool mxu, float* srow,
                                          float& best_z, float& best_id) {
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < m * kCols; i += kThreads)
      srow[i] = rows[(size_t)base * kCols + i];
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < m; ++r) {
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

// Pixel of this thread in tile t, and the race's result written out.
struct Pixel {
  int ty, tx, lx, ly;
  bool active;
  float px, py;
  __device__ Pixel(int t, int tiles_x, int tile_h, int tile_w) {
    const int p = blockIdx.y * kThreads + threadIdx.x;
    ty = t / tiles_x;
    tx = t - ty * tiles_x;
    lx = p % tile_w;
    ly = p / tile_w;
    active = p < tile_h * tile_w;
    px = (float)(tx * tile_w + lx) + 0.5f;
    py = (float)(ty * tile_h + ly) + 0.5f;
  }
  __device__ void store(int* tri_id, float* depth, int tile_h, int tile_w,
                        int width, float best_z, float best_id) const {
    if (!active) return;
    const size_t o = (size_t)(ty * tile_h + ly) * width + (tx * tile_w + lx);
    tri_id[o] = (int)best_id - 1;
    depth[o] = best_z;
  }
};

__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ counts, const float* __restrict__ rows,
              int* __restrict__ tri_id, float* __restrict__ depth,
              int tiles_x, int tile_h, int tile_w, int K, int width,
              int mxu_order) {
  __shared__ float srow[kChunk * kCols];
  const int t = blockIdx.x;
  const Pixel pix(t, tiles_x, tile_h, tile_w);
  const int count = min(max(counts[t], 0), K);
  float best_z = 0.0f, best_id = 0.0f;
  race_rows(rows + (size_t)t * K * kCols, count, pix.active, pix.px, pix.py,
            mxu_order != 0, srow, best_z, best_id);
  pix.store(tri_id, depth, tile_h, tile_w, width, best_z, best_id);
}

__global__ void __launch_bounds__(kThreads)
raster_stream_kernel(const int* __restrict__ starts,
                     const float* __restrict__ rows, int* __restrict__ tri_id,
                     float* __restrict__ depth, int tiles_x, int tile_h,
                     int tile_w, int kb, int nb, int width, int mxu_order) {
  __shared__ float srow[kChunk * kCols];
  const int t = blockIdx.x;
  const Pixel pix(t, tiles_x, tile_h, tile_w);
  const int start = starts[t];
  const int stop = tr::walk_stop(starts, t, kb, nb);
  float best_z = 0.0f, best_id = 0.0f;
  race_rows(rows + (size_t)start * kCols, max(stop - start, 0), pix.active,
            pix.px, pix.py, mxu_order != 0, srow, best_z, best_id);
  pix.store(tri_id, depth, tile_h, tile_w, width, best_z, best_id);
}

__global__ void __launch_bounds__(kThreads)
raster_resolve_kernel(const int* __restrict__ counts,
                      const float* __restrict__ rows,
                      const float* __restrict__ table, int* __restrict__ tri_id,
                      float* __restrict__ depth, float* __restrict__ sel,
                      int tiles_x, int tile_h, int tile_w, int K, int width,
                      int T, int D, int mxu_order) {
  __shared__ float srow[kChunk * kCols];
  __shared__ int swin[kThreads];
  const int t = blockIdx.x;
  const Pixel pix(t, tiles_x, tile_h, tile_w);
  const int count = min(max(counts[t], 0), K);
  float best_z = 0.0f, best_id = 0.0f;
  race_rows(rows + (size_t)t * K * kCols, count, pix.active, pix.px, pix.py,
            mxu_order != 0, srow, best_z, best_id);
  pix.store(tri_id, depth, tile_h, tile_w, width, best_z, best_id);
  swin[threadIdx.x] = (int)best_id - 1;
  __syncthreads();
  const int p0 = blockIdx.y * kThreads;
  const int n = min(kThreads, tile_h * tile_w - p0);   // pixels of the block
  for (int k = threadIdx.x; k < n * D; k += kThreads) {
    const int q = k / D;
    const int j = k - q * D;
    const int p = p0 + q;
    const int ly = p / tile_w;
    const int lx = p - ly * tile_w;
    const int id = swin[q];
    const float v = (id >= 0 && id < T) ? __ldg(table + (size_t)id * D + j)
                                        : 0.0f;
    sel[((size_t)(pix.ty * tile_h + ly) * width + pix.tx * tile_w + lx) * D +
        j] = v;
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

extern "C" int tr_raster_stream(const void* starts, const void* rows,
                                void* tri_id, void* depth, int n_tiles,
                                int tiles_x, int tile_h, int tile_w, int kb,
                                int nb, int width, int mxu_order,
                                void* stream) {
  const int P = tile_h * tile_w;
  dim3 grid(n_tiles, (P + kThreads - 1) / kThreads);
  raster_stream_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)rows, (int*)tri_id, (float*)depth,
      tiles_x, tile_h, tile_w, kb, nb, width, mxu_order);
  return (int)cudaGetLastError();
}

extern "C" int tr_raster_resolve(const void* counts, const void* rows,
                                 const void* table, void* tri_id, void* depth,
                                 void* sel, int n_tiles, int tiles_x,
                                 int tile_h, int tile_w, int K, int width,
                                 int T, int D, int mxu_order, void* stream) {
  const int P = tile_h * tile_w;
  dim3 grid(n_tiles, (P + kThreads - 1) / kThreads);
  raster_resolve_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)rows, (const float*)table,
      (int*)tri_id, (float*)depth, (float*)sel, tiles_x, tile_h, tile_w, K,
      width, T, D, mxu_order);
  return (int)cudaGetLastError();
}
