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
// winner's row of the (T, D) resolve table. All three keep a pixel for a
// 16-float setup row where its three edge planes are >= 0 at the pixel
// centre and its id is > 0, and run a reverse-Z max-depth race over the
// kept rows with ties broken by the larger id. The result is the maximum
// of (depth, id), so it does not depend on the order of the rows.
//
// The race of K1 and K6 (race_rows; K4's is further down) tests no pixel
// a row cannot cover. A block is a 32 x 8 rectangle of its tile's pixels, a warp one
// 32-pixel row of it, a thread one pixel with best_z / best_id in
// registers; a tile of any shape is ceil(w / 32) x ceil(h / 8) blocks, the
// ragged ones clipped and masked. Level 1: each thread reads one row of
// the bin straight from device memory (three 16-byte loads and its id) and
// tests it against the block's rectangle; the survivors are compacted
// (ballot + prefix over the warps' counts, one sync a 256 rows) into a
// ring of 48-byte slots in shared memory. Level 2, when the ring fills or
// the bin ends: each lane of a warp takes one survivor and tests it
// against the warp's pixel row; for each one that passed, the warp reads
// its slot once (broadcast 16-byte loads) and every lane evaluates the
// four planes at its own pixel with tr::plane. Two departures, chosen by
// the bin's length, which is uniform over the block:
//   - a bin of at most kDirectRows rows (the main and shadow views of
//     ordinary scenes hold a few rows a tile) skips level 1, the ring and
//     every sync: each warp tests the rows against its own pixel row
//     straight from device memory (race_direct);
//   - a bin of more than kFineRows rows is taken for small triangles:
//     level 2 tests a survivor against four 8-pixel segments of the row
//     and each quarter of the warp walks the survivors of its own segment.
//
// Why the rejection is exact (tr::edges_reject, common.cuh): tr::plane is
// a composition of correctly rounded operations, each monotone, so for a
// fixed py it rises or falls with px as the sign of a says, and likewise
// in py with b. Its maximum over the pixel centres of a rectangle is thus
// its own value at the corner those signs pick, and a row is dropped only
// if some edge is < 0 even there (a NaN drops nothing). Nothing is stepped
// incrementally: every pixel's value is the plain tr::plane formula.
//
// Balance: K1 splits a bin of more than kSplitRows rows over several
// blocks (raster_kernel). The high-poly shadow view needs it: all of its
// 54055 rows fall into one 128 x 128 tile of 64, sub-texel triangles in a
// few clusters, so 64 blocks did all the work (1.31 ms on an H100 80GB
// HBM3 at 700 W; 0.40 ms split by 4096 rows, 0.25 ms by 2048, 0.24 ms by
// 1024; 4.73 ms before the cull). What bounds it now is level 2 in the
// rectangles that hold a cluster: 73% of a block's survivors also pass its
// pixel rows, 16% an 8-pixel segment, and 1940 (row, pixel) pairs are
// covered at all. Staging: requesting a thread's next row before testing
// the current one changed no time (0.259 against 0.260 ms) and cost 20
// registers, so there is none; the block count a multiprocessor holds
// matters more (kMinBlocks). What bounds the short bins is the chain of
// dependent loads a block starts with (count, rows), over 8160 blocks at
// 1088 x 1920: the direct path brought the main view from 0.0268 to
// 0.0210 ms, beside 0.0207 ms for the exhaustive race it replaces (which
// took 6.22 ms on the high-poly shadow view); sending a bin of at most 8
// rows to the pixels untested was slower (0.0237 against 0.0211 ms).
// tools/tune_raster.py times such variants side by side.
//
// K4 is bound by neither bytes nor operations but by how unevenly its work
// lies: on the 108k-triangle frame (1080 x 1920 in 2025 tiles of 8 x 128,
// 79483 walked rows) 1781 tiles are empty, 37 hold more than 512 rows (the
// spheres' silhouettes, up to 1380), and a row covers 2.2 pixels: 176555
// (row, pixel) pairs in all. Racing rows on pixels wastes the pixels, and a
// block a tile leaves most multiprocessors idle behind the long windows.
// The design:
//   - a one-block kernel (stream_parts_kernel) cuts every window into
//     parts of at most kStreamSplit rows with a prefix sum over the tiles;
//     the raster's grid is that list, so every block has at most
//     kStreamSplit rows and the hardware spreads the long windows;
//   - a block owns a sub-tile (8 rows of at most 128 pixels, so the whole
//     8 x 128 tile: a row is read by one block, not four) as 64-bit keys
//     bits(depth) << 32 | id in shared memory, which order as the race;
//   - the race is row-parallel. Four lanes take a row, each a group of 32
//     columns and then its 8-column cells, with the exact rejection; the
//     (row, cell) units left go to a queue in shared memory. Eight lanes
//     take a unit, a lane a pixel column: the plane of an edge is monotone
//     along the column under the rounded arithmetic, so a binary search
//     with the plane's own values finds the rows the edge admits, three
//     searches the rows the row covers (none, for most columns), and only
//     those pixels get the depth plane and an atomicMax of their key;
//   - the parts of a long window each write their keys to their own
//     buffer, and the last to finish (a counter a window) takes the
//     maxima and writes the pixels out; nothing has to be zeroed.
// Times a launch on an H100 80GB HBM3 at 700 W, the kernel it replaced
// (blocks of 32 x 8 pixels, four a tile, each racing the tile's whole
// window) in the same call (tools/tune_raster.py --k4 --baseline):
// 0.0398 against 0.0920 ms; with parts of 64 rows 0.0402, of 256 rows
// 0.0504 ms, with whole windows 0.1137 ms. The searches take the largest
// share of it, then the list kernel and the launch of the ~3000 blocks of
// the list that find no work; the 135632 units keep 4.1 of their 8
// columns, 562798 in all (tools/tune_raster.py --counts). Tried and dropped,
// each bit-equal: per-pixel tests in place of the searches, a lane a
// pixel of each column left (0.0499 ms); the same parts with the ring and
// per-pixel registers of K1 over four 32-column groups (0.0845-0.0917
// ms); whole windows raced by their own block, with idle blocks taking
// parts of published windows (0.0815-0.1385 ms: a block that finishes
// before a window is published helps nobody); the rows left in at most
// two cells descended by their own thread to the pixel (slower: the lanes
// of a warp diverge); the parts meeting in zeroed keys through global
// atomics (the zeroing by one block cost 0.02 ms); eight units in flight a
// warp (spills at 40 registers).
//
// K6 is bound by bytes: at 1088 x 1920 it writes a D = 53 float row a
// pixel (443 MB), against a few MB of bins. The race is K1's and only its
// result picks the row, table[best_id - 1], read through the read-only
// cache (the table is small and stays in L2). The pixels of one image row
// of a block are one contiguous, 16-byte aligned span of 32 * D floats
// whatever D is: each warp composes its span in shared memory (the ring's,
// free once the race is over; one pixel at a time, the lanes across the D
// floats, so neither the table reads nor the shared writes need a
// division) and writes it out with 16-byte streaming stores. A tile width
// that is no multiple of 32, or a D too large for shared memory, takes the
// scalar store loop of the same kernel. Background pixels and ids >= T get
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

// These four can be set from the command line of nvcc, as
// tools/tune_raster.py does to time variants side by side.
#ifndef TR_SPLIT_ROWS
#define TR_SPLIT_ROWS 2048
#endif
#ifndef TR_FINE_ROWS
#define TR_FINE_ROWS 512
#endif
#ifndef TR_DIRECT_ROWS
#define TR_DIRECT_ROWS 64
#endif
#ifndef TR_MIN_BLOCKS
#define TR_MIN_BLOCKS 6
#endif

constexpr int kThreads = 256;
constexpr int kRectW = 32;    // block rectangle: a warp is one row of it
constexpr int kRectH = kThreads / kRectW;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;
// survivor ring: floats 0..11 of a row in a 48-byte slot (the 16-byte reads
// of eight consecutive slots fall into distinct banks), its id beside it
constexpr int kRing = 512;    // slots, a power of two, >= 2 * kThreads
constexpr int kRingBytes = kRing * (3 * 16 + 4);
constexpr unsigned kFull = 0xffffffffu;
// K1 splits a bin of more rows than this over several blocks
constexpr int kSplitRows = TR_SPLIT_ROWS;
// a bin of more rows than this is taken for small triangles: level 2 then
// tests a survivor against four 8-pixel segments of the warp's row
constexpr int kFineRows = TR_FINE_ROWS;
// a bin of at most this many rows skips level 1 and the ring: every warp
// tests the rows against its own pixel row straight from device memory
constexpr int kDirectRows = TR_DIRECT_ROWS;
// blocks of K1 and K4 a multiprocessor should hold (caps their registers)
constexpr int kMinBlocks = TR_MIN_BLOCKS;

struct Ring {
  float4* planes;   // kRing * 3
  float* ids;       // kRing
  __device__ explicit Ring(void* base)
      : planes(reinterpret_cast<float4*>(base)),
        ids(reinterpret_cast<float*>(planes + kRing * 3)) {}
  __device__ const float4* slot(int j) const {
    return planes + (j & (kRing - 1)) * 3;
  }
};

// The block's rectangle of tile t and this thread's pixel in it.
struct Rect {
  int ox, oy;        // image coordinates of the rectangle's first pixel
  int w, h;          // its extent, clipped to the tile
  int lane, warp;
  bool row_active;   // this warp's pixel row lies in the tile
  bool active;       // and this thread's pixel too
  float px, py;      // this thread's pixel centre
  float xlo, xhi, ylo, yhi;   // corner centres of the rectangle
  __device__ Rect(int t, int tiles_x, int tile_h, int tile_w) {
    const int nbx = (tile_w + kRectW - 1) / kRectW;
    const int by = blockIdx.y / nbx, bx = blockIdx.y - by * nbx;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    w = min(kRectW, tile_w - bx * kRectW);
    h = min(kRectH, tile_h - by * kRectH);
    ox = tx * tile_w + bx * kRectW;
    oy = ty * tile_h + by * kRectH;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    row_active = warp < h;
    active = row_active && lane < w;
    px = (float)(ox + lane) + 0.5f;
    py = (float)(oy + warp) + 0.5f;
    xlo = (float)ox + 0.5f;
    xhi = (float)(ox + w - 1) + 0.5f;
    ylo = (float)oy + 0.5f;
    yhi = (float)(oy + h - 1) + 0.5f;
  }
  __device__ void store(int* tri_id, float* depth, int width, float best_z,
                        float best_id) const {
    if (!active) return;
    const size_t o = (size_t)(oy + warp) * width + (ox + lane);
    tri_id[o] = (int)best_id - 1;
    depth[o] = best_z;
  }
};

// One survivor at this lane's pixel.
__device__ __forceinline__ void race_pixel(const Ring& ring, int j, float px,
                                           float py, bool mxu, float& best_z,
                                           float& best_id) {
  const float4* p = ring.slot(j);
  const float4 r0 = p[0], r1 = p[1], r2 = p[2];
  const float idf = ring.ids[j & (kRing - 1)];
  const float l0 = tr::plane(r0.x, r0.y, r0.z, px, py, mxu);
  const float l1 = tr::plane(r0.w, r1.x, r1.y, px, py, mxu);
  const float l2 = tr::plane(r1.z, r1.w, r2.x, px, py, mxu);
  const float z = tr::plane(r2.y, r2.z, r2.w, px, py, mxu);
  const bool covered = l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && idf > 0.0f;
  if (covered && (z > best_z || (z == best_z && idf > best_id))) {
    best_z = z;
    best_id = idf;
  }
}

// Level 2: the survivors [done, total) of the ring against this warp's
// pixel row, 32 at a time, a lane a survivor; then each survivor that
// passed against the lanes' pixels. kFine: the row is tested as four
// segments of 8 pixels, and each quarter of the warp walks the survivors
// of its own segment; it pays where most survivors miss most segments.
template <bool kFine>
__device__ __forceinline__ void drain(const Ring& ring, int done, int total,
                                      const Rect& rc, bool mxu,
                                      float& best_z, float& best_id) {
  for (int s = done; s < total; s += 32) {
    const int j = s + rc.lane;
    if (kFine) {
      unsigned seg = 0;
      if (j < total) {
        const float4* p = ring.slot(j);
        const float4 r0 = p[0], r1 = p[1], r2 = p[2];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int x0 = 8 * g, x1 = min(8 * g + 7, rc.w - 1);
          if (x0 <= x1 &&
              !tr::edges_reject(r0, r1, r2, rc.xlo + (float)x0,
                                rc.xlo + (float)x1, rc.py, rc.py, mxu))
            seg |= 1u << g;
        }
      }
      const unsigned m0 = __ballot_sync(kFull, seg & 1u);
      const unsigned m1 = __ballot_sync(kFull, seg & 2u);
      const unsigned m2 = __ballot_sync(kFull, seg & 4u);
      const unsigned m3 = __ballot_sync(kFull, seg & 8u);
      const int g = rc.lane >> 3;
      unsigned m = g == 0 ? m0 : g == 1 ? m1 : g == 2 ? m2 : m3;
      while (__any_sync(kFull, m != 0)) {
        if (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          race_pixel(ring, s + b, rc.px, rc.py, mxu, best_z, best_id);
        }
      }
    } else {
      bool hit = false;
      if (j < total) {
        const float4* p = ring.slot(j);
        hit = !tr::edges_reject(p[0], p[1], p[2], rc.xlo, rc.xhi, rc.py,
                                rc.py, mxu);
      }
      unsigned m = __ballot_sync(kFull, hit);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        race_pixel(ring, s + b, rc.px, rc.py, mxu, best_z, best_id);
      }
    }
  }
}

// Depth race of the block's pixels over rows[0, n) (64-byte aligned).
// Every thread of the block must call it (the syncs). wcount holds
// 2 * kWarps ints.
template <bool kFine>
__device__ __forceinline__ void race_rows_as(const float* __restrict__ rows,
                                             int n, const Rect& rc, bool mxu,
                                             const Ring& ring, int* wcount,
                                             float& best_z, float& best_id) {
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  int total = 0, done = 0;    // survivors found and raced, block-uniform
  for (int base = 0, it = 0; base < n; base += kThreads, ++it) {
    const int i = base + threadIdx.x;
    float4 r0, r1, r2;
    float idf = 0.0f;
    r0 = r1 = r2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < n) {
      const float4* p = rows4 + (size_t)i * 4;
      r0 = __ldg(p), r1 = __ldg(p + 1), r2 = __ldg(p + 2);
      idf = __ldg(rows + (size_t)i * kCols + 12);
    }
    // level 1: this thread's row against the block's rectangle
    const bool keep = i < n && idf > 0.0f &&
                      !tr::edges_reject(r0, r1, r2, rc.xlo, rc.xhi, rc.ylo,
                                        rc.yhi, mxu);
    const unsigned m = __ballot_sync(kFull, keep);
    int* cnt = wcount + (it & 1) * kWarps;
    if (rc.lane == 0) cnt[rc.warp] = __popc(m);
    __syncthreads();
    int pos = total;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w];
      if (w < rc.warp) pos += c;
      total += c;
    }
    if (keep) {
      const int slot = (pos + __popc(m & ((1u << rc.lane) - 1))) & (kRing - 1);
      float4* d = ring.planes + slot * 3;
      d[0] = r0, d[1] = r1, d[2] = r2;
      ring.ids[slot] = idf;
    }
    if (total - done > kRing - kThreads || base + kThreads >= n) {
      __syncthreads();
      if (rc.row_active)
        drain<kFine>(ring, done, total, rc, mxu, best_z, best_id);
      done = total;
      // the next writes to the ring follow the next iteration's sync
    }
  }
}

// A short bin: no block-level cull, no shared memory, no sync. A lane a
// row against the warp's pixel row, then each row that passed, read again
// through L1 by all lanes, against the lanes' pixels.
__device__ __forceinline__ void race_direct(const float* __restrict__ rows,
                                            int n, const Rect& rc, bool mxu,
                                            float& best_z, float& best_id) {
  if (!rc.row_active) return;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  for (int s = 0; s < n; s += 32) {
    const int j = s + rc.lane;
    bool hit = false;
    if (j < n && __ldg(rows + (size_t)j * kCols + 12) > 0.0f) {
      const float4* p = rows4 + (size_t)j * 4;
      hit = !tr::edges_reject(__ldg(p), __ldg(p + 1), __ldg(p + 2), rc.xlo,
                              rc.xhi, rc.py, rc.py, mxu);
    }
    unsigned m = __ballot_sync(kFull, hit);
    while (m) {
      const int b = s + __ffs(m) - 1;
      m &= m - 1;
      const float4* p = rows4 + (size_t)b * 4;
      const float4 r0 = __ldg(p), r1 = __ldg(p + 1), r2 = __ldg(p + 2);
      const float idf = __ldg(rows + (size_t)b * kCols + 12);
      const float l0 = tr::plane(r0.x, r0.y, r0.z, rc.px, rc.py, mxu);
      const float l1 = tr::plane(r0.w, r1.x, r1.y, rc.px, rc.py, mxu);
      const float l2 = tr::plane(r1.z, r1.w, r2.x, rc.px, rc.py, mxu);
      const float z = tr::plane(r2.y, r2.z, r2.w, rc.px, rc.py, mxu);
      if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f &&
          (z > best_z || (z == best_z && idf > best_id))) {
        best_z = z;
        best_id = idf;
      }
    }
  }
}

__device__ __forceinline__ void race_rows(const float* __restrict__ rows,
                                          int n, const Rect& rc, bool mxu,
                                          const Ring& ring, int* wcount,
                                          float& best_z, float& best_id) {
  if (n <= kDirectRows)
    race_direct(rows, n, rc, mxu, best_z, best_id);
  else if (n > kFineRows)
    race_rows_as<true>(rows, n, rc, mxu, ring, wcount, best_z, best_id);
  else
    race_rows_as<false>(rows, n, rc, mxu, ring, wcount, best_z, best_id);
}

// kSplit, for a capacity K above kSplitRows (the kernel without it is the
// leaner one, and serves every K below): a bin of more than kSplitRows
// rows is raced by several blocks (blockIdx.z),
// kSplitRows rows each; every pixel's partial winners meet in a 64-bit
// atomicMax on bits(depth) << 32 | id, which orders as the race does (a
// winner's depth is never negative; -0.0 is written as +0.0), and the block
// that arrives last writes the pixel out. keys: a zeroed 64-bit word a
// thread of every (tile, rectangle); arrived: a zeroed counter each.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_kernel(const int* __restrict__ counts, const float* __restrict__ rows,
              int* __restrict__ tri_id, float* __restrict__ depth,
              unsigned long long* __restrict__ keys,
              unsigned* __restrict__ arrived, int tiles_x, int tile_h,
              int tile_w, int K, int width, int mxu_order) {
  __shared__ __align__(16) unsigned char ring_mem[kRingBytes];
  __shared__ int wcount[2 * kWarps];
  __shared__ bool last;
  const int t = blockIdx.x;
  const int count = min(max(counts[t], 0), K);
  const int parts = kSplit ? max(1, (count + kSplitRows - 1) / kSplitRows) : 1;
  if ((int)blockIdx.z >= parts) return;
  const Rect rc(t, tiles_x, tile_h, tile_w);
  const Ring ring(ring_mem);
  const int first = kSplit ? blockIdx.z * kSplitRows : 0;
  float best_z = 0.0f, best_id = 0.0f;
  race_rows(rows + ((size_t)t * K + first) * kCols,
            kSplit ? min(count - first, kSplitRows) : count, rc,
            mxu_order != 0, ring, wcount, best_z, best_id);
  if (kSplit && parts > 1) {
    const size_t rect = (size_t)t * gridDim.y + blockIdx.y;
    unsigned long long* key = keys + rect * kThreads + threadIdx.x;
    const unsigned long long mine =
        ((unsigned long long)__float_as_uint(best_z + 0.0f) << 32) |
        (unsigned)(int)best_id;
    if (mine) atomicMax(key, mine);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(arrived + rect, 1u) == (unsigned)parts - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const unsigned long long won = __ldcg(key);
    best_z = __uint_as_float((unsigned)(won >> 32));
    best_id = (float)(unsigned)(won & 0xffffffffull);
  }
  rc.store(tri_id, depth, width, best_z, best_id);
}

// ---- K4: the stream raster -------------------------------------------------

// These can be set from the command line of nvcc too.
#ifndef TR_STREAM_SPLIT_ROWS
#define TR_STREAM_SPLIT_ROWS 128
#endif
#ifndef TR_STREAM_MIN_BLOCKS
#define TR_STREAM_MIN_BLOCKS 6
#endif

// A block of K4 owns a sub-tile: kSubH rows of at most kSubW pixels, four
// pixels a thread; an 8 x 128 tile is one sub-tile.
constexpr int kSubW = 128;
constexpr int kSubH = 8;
constexpr int kSubPixels = kSubW * kSubH;
static_assert(kSubPixels == 4 * kThreads, "four pixels a thread");
// a sub-tile is cut into cells of kCell columns, all its rows high
constexpr int kCell = 8;
constexpr int kCells = kSubW / kCell;
static_assert(kSubH == 8 && kCell == 8, "eight lanes a column, a cell");
// rows a block takes at a step: four lanes a row
constexpr int kRowsAtOnce = kThreads / 4;
static_assert(kSubW == 4 * 32, "a lane a group of 32 columns");
// a window of more rows than this is cut into parts of this many rows, a
// block each
constexpr int kStreamSplit = TR_STREAM_SPLIT_ROWS;
constexpr int kStreamMinBlocks = TR_STREAM_MIN_BLOCKS;

typedef unsigned long long Key;   // bits(depth) << 32 | id, 0 = background

__device__ __forceinline__ Key make_key(float z, float idf) {
  return ((Key)__float_as_uint(z + 0.0f) << 32) | (unsigned)(int)idf;
}

struct Sub {
  int ox, oy;   // image coordinates of the sub-tile's first pixel
  int w, h;     // its extent, clipped to the tile
  __device__ Sub(int t, int sub, int tiles_x, int tile_h, int tile_w) {
    const int nsx = (tile_w + kSubW - 1) / kSubW;
    const int sy = sub / nsx, sx = sub - sy * nsx;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    ox = tx * tile_w + sx * kSubW;
    oy = ty * tile_h + sy * kSubH;
    w = min(kSubW, tile_w - sx * kSubW);
    h = min(kSubH, tile_h - sy * kSubH);
  }
  // whether a row misses every pixel centre of columns [x0, x1] of the
  // sub-tile (clipped to it), all its rows high
  __device__ bool rejects(const float4& r0, const float4& r1, const float4& r2,
                          int x0, int x1, bool mxu) const {
    const float xlo = (float)(ox + x0) + 0.5f;
    const float xhi = (float)(ox + min(x1, w - 1)) + 0.5f;
    const float ylo = (float)oy + 0.5f, yhi = (float)(oy + h - 1) + 0.5f;
    // tr::edges_reject without its short circuit: the three planes are
    // independent work for the pipeline, not three branches
    const float m0 = tr::plane_max(r0.x, r0.y, r0.z, xlo, xhi, ylo, yhi, mxu);
    const float m1 = tr::plane_max(r0.w, r1.x, r1.y, xlo, xhi, ylo, yhi, mxu);
    const float m2 = tr::plane_max(r1.z, r1.w, r2.x, xlo, xhi, ylo, yhi, mxu);
    return (m0 < 0.0f) | (m1 < 0.0f) | (m2 < 0.0f);
  }
};

// Narrow the rows [lo, hi) of one pixel column (centre px; row 0's centre
// ylo) to those where the plane a * px + b * py + c is >= 0. tr::plane
// rises with py where b >= 0 and falls where b < 0, under the rounded
// arithmetic too (see tr::plane_max), and a NaN, which only inf - inf
// gives, stays a NaN for every py further on: so the rows where it is >= 0
// are a suffix or a prefix of the column, and a binary search with the
// plane's own value at the row centres finds them exactly.
__device__ __forceinline__ void narrow_rows(float a, float b, float c, float px,
                                            float ylo, bool mxu, int& lo,
                                            int& hi) {
  const bool rising = b >= 0.0f;
  int first = lo, last = hi;
  while (first < last) {
    const int mid = (first + last) >> 1;
    const bool in = tr::plane(a, b, c, px, ylo + (float)mid, mxu) >= 0.0f;
    if (in == rising)
      last = mid;
    else
      first = mid + 1;
  }
  if (rising)
    lo = first;    // rows [first, hi) are in
  else
    hi = first;    // rows [lo, first) are in
}

// K4's work list (global memory, written by stream_parts_kernel): entry b
// is the part of a window that block b races. A window of at most
// kStreamSplit rows is one part; a longer one is cut into `count` parts of
// kStreamSplit rows, neighbours in the list, that share a counter.
struct __align__(16) Part {
  int tile;    // < 0: no work (the list is as long as it could get)
  int first;   // its first row in the stream
  int rows;
  int count;   // parts of its window
  int index;   // which of them this is
  int slot;    // the window's counter, when count > 1
  int pad[2];
};
static_assert(sizeof(Part) == 32, "scratch layout");

struct StreamShared {
  Key keys[kSubPixels];
  unsigned short queue[kRowsAtOnce * kCells];   // (row << 4 | cell) units
  int qcount[2];
  int last;
};

// Race rows[0, n) over the sub-tile into sh.keys. Row-parallel: four lanes
// take a row, each a group of 32 columns and then its cells, with the exact
// rejection; every (row, cell) pair left is a work unit in a queue, and
// eight lanes take a unit, a lane a column of the cell: a binary search an
// edge finds the column's covered rows, and a covered pixel's key goes into
// shared memory with atomicMax. Every thread of the block must call it; it
// returns after a sync.
__device__ __forceinline__ void race_window(const float* __restrict__ rows,
                                            int n, const Sub& s, bool mxu,
                                            StreamShared& sh) {
  for (int p = threadIdx.x; p < kSubPixels; p += kThreads) sh.keys[p] = 0;
  if (threadIdx.x < 2) sh.qcount[threadIdx.x] = 0;
  __syncthreads();
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const int lane = threadIdx.x & 31;
  for (int base = 0, it = 0; base < n; base += kRowsAtOnce, ++it) {
    int* count = sh.qcount + (it & 1);
    // four lanes a row, a lane a group of 32 columns and its four cells
    const int i = base + (threadIdx.x >> 2), g = threadIdx.x & 3;
    unsigned cells = 0;
    if (i < n && g * 32 < s.w) {
      const float4* p = rows4 + (size_t)i * 4;
      const float4 r0 = __ldg(p), r1 = __ldg(p + 1), r2 = __ldg(p + 2);
      if (__ldg(rows + (size_t)i * kCols + 12) > 0.0f &&
          !s.rejects(r0, r1, r2, g * 32, g * 32 + 31, mxu))
        for (int c = g * 4; c < g * 4 + 4 && c * kCell < s.w; ++c)
          if (!s.rejects(r0, r1, r2, c * kCell, c * kCell + kCell - 1, mxu))
            cells |= 1u << c;
    }
    // every (row, cell) left is a work unit; queue positions: a prefix sum
    // over the warp, one atomicAdd a warp
    const int mine = __popc(cells);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int wbase = 0;
    if (lane == 31 && total) wbase = atomicAdd(count, total);
    int pos = __shfl_sync(kFull, wbase, 31) + incl - mine;
    while (cells) {
      const int c = __ffs(cells) - 1;
      cells &= cells - 1;
      sh.queue[pos++] = (unsigned short)((threadIdx.x >> 2 << 4) | c);
    }
    __syncthreads();
    const int units = *count;
    if (threadIdx.x == 0) sh.qcount[(it + 1) & 1] = 0;
    // eight lanes take a unit, a lane a column of the cell: the rows of the
    // column that the three edges cover (none, for most columns), then the
    // depth plane at those pixels and each one's key into shared memory.
    // The race starts from depth 0: a negative or NaN depth never wins.
    for (int u = threadIdx.x >> 3; u < units; u += kThreads / 8) {
      const unsigned e = sh.queue[u];
      const int x = (int)(e & 15u) * kCell + (threadIdx.x & 7);
      if (x >= s.w) continue;
      const size_t row = (size_t)base + (e >> 4);
      const float4* p = rows4 + row * 4;
      const float4 r0 = __ldg(p), r1 = __ldg(p + 1), r2 = __ldg(p + 2);
      const float px = (float)(s.ox + x) + 0.5f, ylo = (float)s.oy + 0.5f;
      int lo = 0, hi = s.h;
      narrow_rows(r0.x, r0.y, r0.z, px, ylo, mxu, lo, hi);
      narrow_rows(r0.w, r1.x, r1.y, px, ylo, mxu, lo, hi);
      narrow_rows(r1.z, r1.w, r2.x, px, ylo, mxu, lo, hi);
      if (lo >= hi) continue;
      const float idf = __ldg(rows + row * kCols + 12);
      for (int y = lo; y < hi; ++y) {
        const float z = tr::plane(r2.y, r2.z, r2.w, px, ylo + (float)y, mxu);
        if (z >= 0.0f) atomicMax(sh.keys + y * kSubW + x, make_key(z, idf));
      }
    }
    __syncthreads();
  }
}

// Write the sub-tile's keys (shared memory; nullptr: background) out as
// tri_id and depth. vec: 16-byte stores (tile_w and width multiples of 4).
__device__ __forceinline__ void store_sub(const Key* keys, const Sub& s,
                                          int* __restrict__ tri_id,
                                          float* __restrict__ depth, int width,
                                          bool vec) {
  if (vec) {
    const int p = threadIdx.x * 4;
    const int y = p / kSubW, x = p % kSubW;
    if (x >= s.w || y >= s.h) return;
    Key k[4] = {0, 0, 0, 0};
    if (keys != nullptr)
      for (int j = 0; j < 4; ++j) k[j] = keys[p + j];
    const size_t o = (size_t)(s.oy + y) * width + s.ox + x;
    *reinterpret_cast<int4*>(tri_id + o) =
        make_int4((int)(unsigned)k[0] - 1, (int)(unsigned)k[1] - 1,
                  (int)(unsigned)k[2] - 1, (int)(unsigned)k[3] - 1);
    *reinterpret_cast<float4*>(depth + o) = make_float4(
        __uint_as_float((unsigned)(k[0] >> 32)),
        __uint_as_float((unsigned)(k[1] >> 32)),
        __uint_as_float((unsigned)(k[2] >> 32)),
        __uint_as_float((unsigned)(k[3] >> 32)));
    return;
  }
  for (int p = threadIdx.x; p < kSubPixels; p += kThreads) {
    const int y = p / kSubW, x = p % kSubW;
    if (x >= s.w || y >= s.h) continue;
    const Key k = keys != nullptr ? keys[p] : 0;
    const size_t o = (size_t)(s.oy + y) * width + s.ox + x;
    tri_id[o] = (int)(unsigned)k - 1;
    depth[o] = __uint_as_float((unsigned)(k >> 32));
  }
}

// Scratch of K4 for a stream of Ls rows over n_tiles tiles: at most
// max_slots = Ls / kStreamSplit windows are long (they are disjoint), so the
// list has at most n_parts = n_tiles + max_slots parts. Nothing of it has
// to be zero: a part of a long window writes its keys to its own buffer.
struct StreamScratch {
  unsigned* arrived;   // max_slots * subs counters of finished parts
  Part* parts;         // n_parts
  Key* keys;           // n_parts * subs buffers of kSubPixels
  __host__ __device__ static size_t counters(int max_slots, int subs) {
    return ((size_t)max_slots * subs + 7) / 8 * 8;
  }
  __host__ __device__ StreamScratch(void* base, int n_parts, int max_slots,
                                    int subs) {
    arrived = static_cast<unsigned*>(base);
    parts = reinterpret_cast<Part*>(arrived + counters(max_slots, subs));
    keys = reinterpret_cast<Key*>(parts + n_parts);
  }
  __host__ __device__ static size_t bytes(int n_parts, int max_slots,
                                          int subs) {
    return counters(max_slots, subs) * sizeof(unsigned) +
           (size_t)n_parts * sizeof(Part) +
           (size_t)n_parts * subs * kSubPixels * sizeof(Key);
  }
};

// One block: cut every tile's walked window into parts (a prefix sum over
// the tiles, 1024 at a time) and give each long window a zeroed counter.
// Every tile gets at least one entry whatever the starts are, so every
// pixel is written: the windows of monotone starts <= Ls are disjoint and
// their parts fit the list; were they not, the window whose parts no longer
// fit, and every long one after it, is raced whole by one block.
__global__ void __launch_bounds__(1024)
stream_parts_kernel(const int* __restrict__ starts, void* scratch, int n_tiles,
                    int max_slots, int subs, int kb, int nb) {
  __shared__ int warp_sum[32];
  __shared__ int running, slots;
  const int n_parts = n_tiles + max_slots;
  const StreamScratch sc(scratch, n_parts, max_slots, subs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) running = slots = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += 1024) {
    const int t = t0 + threadIdx.x;
    int start = 0, n = 0, want = 0;   // entries of the list the tile takes
    if (t < n_tiles) {
      start = starts[t];
      n = max(tr::walk_stop(starts, t, kb, nb) - start, 0);
      want = max(1, (n + kStreamSplit - 1) / kStreamSplit);
    }
    int incl = want;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = running;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (t < n_tiles) {
      // entries [at, at + room): the tile's own and its share of the
      // max_slots further ones, room == want while those last
      const int extra = before + incl - want - t;   // of the tiles before
      const int at = t + min(extra, max_slots);
      const int room = 1 + min(extra + want - 1, max_slots) - (at - t);
      int slot = 0;
      const bool cut = want > 1 && room == want;
      if (cut) slot = atomicAdd(&slots, 1);   // < max_slots: each took a part
      for (int sub = 0; cut && sub < subs; ++sub)
        sc.arrived[slot * subs + sub] = 0;
      for (int k = 0; k < room; ++k) {
        if (cut)
          sc.parts[at + k] = Part{t, start + k * kStreamSplit,
                                  min(kStreamSplit, n - k * kStreamSplit),
                                  want, k, slot};
        else
          sc.parts[at + k] = k == 0 ? Part{t, start, n, 1, 0, 0}
                                    : Part{-1, 0, 0, 0, 0, 0};
      }
    }
    __syncthreads();
    if (threadIdx.x == 1023) running = before + incl;
    __syncthreads();
  }
  const int used = n_tiles + min(running - n_tiles, max_slots);
  for (int b = used + threadIdx.x; b < n_parts; b += 1024)
    sc.parts[b] = Part{-1, 0, 0, 0, 0, 0};
}

// kMxu: the plane order of large tiles (tr::plane's mxu_order), a template
// parameter so that the planes of the race carry no select.
template <bool kMxu>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
raster_stream_kernel(const float* __restrict__ rows, int* __restrict__ tri_id,
                     float* __restrict__ depth, void* scratch, int max_slots,
                     int tiles_x, int tile_h, int tile_w, int width, int vec) {
  __shared__ StreamShared sh;
  const int subs = gridDim.y, sub = blockIdx.y;
  const StreamScratch sc(scratch, gridDim.x, max_slots, subs);
  const Part part = sc.parts[blockIdx.x];
  if (part.tile < 0) return;
  const Sub s(part.tile, sub, tiles_x, tile_h, tile_w);
  if (part.rows == 0) {
    store_sub(nullptr, s, tri_id, depth, width, vec != 0);
    return;
  }
  race_window(rows + (size_t)part.first * kCols, part.rows, s, kMxu, sh);
  if (part.count > 1) {
    // the parts of a long window each leave their keys in their own buffer;
    // the last to finish takes every pixel's maximum over them (a key
    // orders as the race does) and writes the pixels out
    Key* mine = sc.keys + ((size_t)blockIdx.x * subs + sub) * kSubPixels;
    for (int p = threadIdx.x; p < kSubPixels; p += kThreads)
      mine[p] = sh.keys[p];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      sh.last = atomicAdd(sc.arrived + part.slot * subs + sub, 1u) ==
                (unsigned)part.count - 1u;
    __syncthreads();
    if (!sh.last) return;
    __threadfence();
    const Key* first = mine - (ptrdiff_t)part.index * subs * kSubPixels;
    Key best[kSubPixels / kThreads] = {0, 0, 0, 0};
#pragma unroll 4
    for (int k = 0; k < part.count; ++k)
#pragma unroll
      for (int j = 0; j < kSubPixels / kThreads; ++j)
        best[j] = max(best[j], __ldcg(first + (size_t)k * subs * kSubPixels +
                                      j * kThreads + threadIdx.x));
#pragma unroll
    for (int j = 0; j < kSubPixels / kThreads; ++j)
      sh.keys[j * kThreads + threadIdx.x] = best[j];
    __syncthreads();
  }
  store_sub(sh.keys, s, tri_id, depth, width, vec != 0);
}

// group > 0: the vector store, each warp composing `group` pixels of its
// row at a time (a multiple of 4, so a group is a whole number of 16-byte
// words); needs tile_w % 32 == 0 and kWarps * group * D floats of dynamic
// shared memory. group == 0: the scalar store.
__global__ void __launch_bounds__(kThreads)
raster_resolve_kernel(const int* __restrict__ counts,
                      const float* __restrict__ rows,
                      const float* __restrict__ table, int* __restrict__ tri_id,
                      float* __restrict__ depth, float* __restrict__ sel,
                      int tiles_x, int tile_h, int tile_w, int K, int width,
                      int T, int D, int mxu_order, int group) {
  extern __shared__ float4 dyn[];    // the ring, then the row staging
  __shared__ int wcount[2 * kWarps];
  __shared__ int swin[kThreads];
  const Ring ring(dyn);
  const int t = blockIdx.x;
  const Rect rc(t, tiles_x, tile_h, tile_w);
  const int count = min(max(counts[t], 0), K);
  float best_z = 0.0f, best_id = 0.0f;
  race_rows(rows + (size_t)t * K * kCols, count, rc, mxu_order != 0, ring,
            wcount, best_z, best_id);
  rc.store(tri_id, depth, width, best_z, best_id);
  int win = (int)best_id - 1;
  if (win >= T) win = -1;
  if (group == 0) {
    swin[threadIdx.x] = win;
    __syncthreads();
    for (int k = threadIdx.x; k < kThreads * D; k += kThreads) {
      const int q = k / D;
      const int j = k - q * D;
      const int ly = q >> 5, lx = q & 31;
      if (lx >= rc.w || ly >= rc.h) continue;
      const int id = swin[q];
      const float v = id >= 0 ? __ldg(table + (size_t)id * D + j) : 0.0f;
      sel[((size_t)(rc.oy + ly) * width + rc.ox + lx) * D + j] = v;
    }
    return;
  }
  __syncthreads();                   // every warp is done with the ring
  if (!rc.row_active) return;
  float* stage = reinterpret_cast<float*>(dyn) + (size_t)rc.warp * group * D;
  for (int p0 = 0; p0 < kRectW; p0 += group) {
    const int pixels = min(group, kRectW - p0);
    const int words = pixels * D / 4;
#pragma unroll 4
    for (int p = 0; p < pixels; ++p) {
      const int id = __shfl_sync(kFull, win, p0 + p);
      const float* src = table + (size_t)max(id, 0) * D;
      for (int j = rc.lane; j < D; j += 32)
        stage[p * D + j] = id >= 0 ? __ldg(src + j) : 0.0f;
    }
    __syncwarp();
    float4* out = reinterpret_cast<float4*>(
        sel + ((size_t)(rc.oy + rc.warp) * width + rc.ox + p0) * D);
    const float4* in = reinterpret_cast<const float4*>(stage);
    for (int q = rc.lane; q < words; q += 32) __stcs(out + q, in[q]);
    __syncwarp();
  }
}

dim3 raster_grid(int n_tiles, int tile_h, int tile_w) {
  return dim3(n_tiles, ((tile_w + kRectW - 1) / kRectW) *
                           ((tile_h + kRectH - 1) / kRectH));
}

}  // namespace

// Bytes of zeroed scratch tr_raster needs for these shapes: 0 unless K
// allows a bin of more than kSplitRows rows.
extern "C" long long tr_raster_scratch_bytes(int n_tiles, int tile_h,
                                             int tile_w, int K) {
  if (K <= kSplitRows) return 0;
  const long long rects = (long long)n_tiles * raster_grid(1, tile_h, tile_w).y;
  return rects * kThreads * 8 + rects * 4;
}

extern "C" int tr_raster(const void* counts, const void* rows, void* tri_id,
                         void* depth, void* scratch, int n_tiles, int tiles_x,
                         int tile_h, int tile_w, int K, int width,
                         int mxu_order, void* stream) {
  dim3 grid = raster_grid(n_tiles, tile_h, tile_w);
  grid.z = (K + kSplitRows - 1) / kSplitRows;
  if (grid.z > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  unsigned long long* keys = (unsigned long long*)scratch;
  unsigned* arrived =
      (unsigned*)(keys + (size_t)n_tiles * grid.y * kThreads);
  auto kernel = grid.z > 1 ? raster_kernel<true> : raster_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)rows, (int*)tri_id, (float*)depth,
      keys, arrived, tiles_x, tile_h, tile_w, K, width, mxu_order);
  return (int)cudaGetLastError();
}

static int stream_subs(int tile_h, int tile_w) {
  return ((tile_w + kSubW - 1) / kSubW) * ((tile_h + kSubH - 1) / kSubH);
}

// Bytes of scratch tr_raster_stream needs for a stream of Ls rows over
// n_tiles tiles (nothing of it has to be zeroed).
extern "C" long long tr_raster_stream_scratch_bytes(int n_tiles, int tile_h,
                                                    int tile_w, int Ls) {
  const int max_slots = Ls / kStreamSplit;
  return (long long)StreamScratch::bytes(n_tiles + max_slots, max_slots,
                                         stream_subs(tile_h, tile_w));
}

extern "C" int tr_raster_stream(const void* starts, const void* rows,
                                void* tri_id, void* depth, void* scratch,
                                int n_tiles, int tiles_x, int tile_h,
                                int tile_w, int kb, int nb, int Ls, int width,
                                int mxu_order, void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int max_slots = Ls / kStreamSplit, subs = stream_subs(tile_h, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  stream_parts_kernel<<<1, 1024, 0, st>>>((const int*)starts, scratch, n_tiles,
                                          max_slots, subs, kb, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = tile_w % 4 == 0 && width % 4 == 0 &&
                  ((uintptr_t)tri_id & 15) == 0 && ((uintptr_t)depth & 15) == 0;
  auto kernel = mxu_order ? raster_stream_kernel<true>
                          : raster_stream_kernel<false>;
  kernel<<<dim3(n_tiles + max_slots, subs), kThreads, 0, st>>>(
      (const float*)rows, (int*)tri_id, (float*)depth, scratch, max_slots,
      tiles_x, tile_h, tile_w, width, vec);
  return (int)cudaGetLastError();
}

extern "C" int tr_raster_resolve(const void* counts, const void* rows,
                                 const void* table, void* tri_id, void* depth,
                                 void* sel, int n_tiles, int tiles_x,
                                 int tile_h, int tile_w, int K, int width,
                                 int T, int D, int mxu_order, void* stream) {
  // pixels a warp composes at a time: all 32 while the block's staging
  // stays within 64 KB, else the largest multiple of 4 that does
  constexpr int kStageBytes = 64 * 1024;
  int group = 0;
  if (tile_w % kRectW == 0 && D > 0)
    group = min(kRectW, kStageBytes / (kWarps * D * 4) / 4 * 4);
  const int stage = kWarps * group * D * 4;
  const int smem = stage > kRingBytes ? stage : kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      raster_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (err != cudaSuccess) return (int)err;
  raster_resolve_kernel<<<raster_grid(n_tiles, tile_h, tile_w), kThreads,
                          smem, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)rows, (const float*)table,
      (int*)tri_id, (float*)depth, (float*)sel, tiles_x, tile_h, tile_w, K,
      width, T, D, mxu_order, group);
  return (int)cudaGetLastError();
}
