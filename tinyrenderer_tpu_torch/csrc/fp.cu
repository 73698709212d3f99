// The glue's fused multiply-adds: ops/fp.py fma, lerp, plane, sqrt and
// fma_chain on CUDA tensors.
//
// Replaces no Pallas kernel: XLA's contraction of a * b + c into one fused
// multiply-add (rounded once), which its LLVM backend applies inside every
// compiled elementwise loop of the JAX package's frame (the triangle setup,
// the vertex transform, the G-buffer's dot products, SSR's ray projection,
// the blends). The port's plain versions spell each contraction out in
// float64 (fp.py fma_ref: three casts up, a float64 product and sum, a cast
// down; six launches and ~96 bytes an element); here it is one __fmaf_rn.
//
// What bounds it on the H100: memory. An element reads each of its operands
// once (4 bytes for float32, 2 for bfloat16 / float16; a broadcast operand
// or a by-value scalar nothing) and writes 4 bytes, for one to four
// floating-point operations. Design:
//   - one chained form covers every entry point: r = c, or a0 * b0 when no
//     addend is given; r = fma(a_k, b_k, r) for the remaining pairs (at most
//     three); r + d when a tail is given; sqrt(r) when asked. lerp(a, b, f)
//     is fma(a, 1 - f, b * f). Each step is rounded once (-fmad=false and
//     the _rn intrinsics: nothing else is contracted);
//   - every operand is a pointer with one element stride a dimension (0
//     along a broadcast dimension) or a by-value float, so column slices,
//     0-dim views and expanded tensors are read in place. The wrapper merges
//     the dimensions that are contiguous in every operand (ops/fp.py pack),
//     so most calls reach the kernel as one dimension;
//   - the descriptor (FpArgs) is a kernel parameter, passed by value from
//     the host: a launch uploads nothing, so it can be captured into a CUDA
//     graph and never synchronizes;
//   - paths: one dimension of float32 operands with unit or zero stride,
//     16-byte aligned, reads and writes 16 bytes a thread (float4); one
//     dimension otherwise, offset = i * stride; several dimensions with
//     32-bit index arithmetic while the output has fewer than 2^31
//     elements (each division by a dimension a multiply-high and a shift,
//     its magic number from the host, as PyTorch's IntDivider), else
//     64-bit division. Offsets are 64-bit throughout. A grid-stride loop
//     over at most 8 blocks of 256 threads an SM;
//   - the five entry points launch five __global__ templates of one body,
//     so a profiler names each entry point's launches apart; each is
//     instantiated once a path, so a path's kernel holds only the
//     registers that path needs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TR_FP_DIMS 6
#define TR_FP_SLOTS 8   // a0 b0 a1 b1 a2 b2 c d; lerp: a b f in 0 1 2

// Mirrored by tinyrenderer_tpu_torch/kernels.py FpOperand / FpArgs
// (ops/fp.py checks the size through tr_fp_args_bytes before a library's
// first launch).
struct FpOperand {
  const void* ptr;                  // nullptr: the operand is `value`
  long long stride[TR_FP_DIMS];     // elements; 0 along a broadcast dim
  float value;
  int dtype;                        // 0 float32, 1 bfloat16, 2 float16
};

struct FpArgs {
  FpOperand op[TR_FP_SLOTS];
  long long shape[TR_FP_DIMS];      // the merged output dimensions
  long long n;                      // output elements
  int ndim;                         // 1..TR_FP_DIMS
  int n_pairs;                      // 0..3 products
  int has_c, has_d, lerp, root;
  int used;                         // bit s: slot s is read
  int path;                         // set by launch()
  int vec;                          // kVec4: bit s, slot s read as float4
  unsigned magic[TR_FP_DIMS];       // kNd32: n / shape[d] as
  int shift[TR_FP_DIMS];            //   (umulhi(n, magic) + n) >> shift
};

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
enum Path { kVec4 = 0, kLinear = 1, kNd32 = 2, kNd64 = 3 };

__device__ __forceinline__ float load(const FpOperand& o, long long off) {
  if (o.ptr == nullptr) return o.value;
  switch (o.dtype) {
    case 1:
      return __bfloat162float(
          __ldg(static_cast<const __nv_bfloat16*>(o.ptr) + off));
    case 2:
      return __half2float(__ldg(static_cast<const __half*>(o.ptr) + off));
    default:
      return __ldg(static_cast<const float*>(o.ptr) + off);
  }
}

// sqrtf rounded once; a NaN comes back with its payload, quieted, as the
// float64 root and the reference's CPU sqrt return it (sqrt.rn.f32 alone
// returns the canonical NaN).
__device__ __forceinline__ float root(float r) {
  return r != r ? __int_as_float(__float_as_int(r) | 0x00400000)
                : __fsqrt_rn(r);
}

// The chain on one element's slot values.
__device__ __forceinline__ float combine(const FpArgs& p,
                                         const float (&v)[TR_FP_SLOTS]) {
  float r;
  if (p.lerp) {
    r = __fmaf_rn(v[0], __fsub_rn(1.0f, v[2]), __fmul_rn(v[1], v[2]));
  } else {
    const int k0 = p.has_c ? 0 : 1;
    r = p.has_c ? v[6] : __fmul_rn(v[0], v[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k >= k0 && k < p.n_pairs) r = __fmaf_rn(v[2 * k], v[2 * k + 1], r);
    if (p.has_d) r = __fadd_rn(r, v[7]);
  }
  return p.root ? root(r) : r;
}

// i / shape[d] (kNd32 with the host's magic number, else a division).
__device__ __forceinline__ unsigned quotient(const FpArgs& p, int d,
                                            unsigned i) {
  return (__umulhi(i, p.magic[d]) + i) >> p.shift[d];
}
__device__ __forceinline__ long long quotient(const FpArgs& p, int d,
                                             long long i) {
  return i / p.shape[d];
}

// Element i's slot values into v; I is the type of the coordinate
// arithmetic.
template <typename I>
__device__ __forceinline__ void gather_nd(const FpArgs& p, I i,
                                          float (&v)[TR_FP_SLOTS]) {
  long long off[TR_FP_SLOTS];
#pragma unroll
  for (int s = 0; s < TR_FP_SLOTS; ++s) off[s] = 0;
#pragma unroll
  for (int d = TR_FP_DIMS - 1; d >= 0; --d) {
    if (d < p.ndim) {
      const I q = quotient(p, d, i);
      const I c = i - q * static_cast<I>(p.shape[d]);
      i = q;
#pragma unroll
      for (int s = 0; s < TR_FP_SLOTS; ++s)
        if (p.used >> s & 1)
          off[s] += static_cast<long long>(c) * p.op[s].stride[d];
    }
  }
#pragma unroll
  for (int s = 0; s < TR_FP_SLOTS; ++s)
    v[s] = (p.used >> s & 1) ? load(p.op[s], off[s]) : 0.0f;
}

template <int P>
__device__ __forceinline__ void gather(const FpArgs& p, long long i,
                                       float (&v)[TR_FP_SLOTS]) {
  if constexpr (P == kNd32) {
    gather_nd<unsigned>(p, static_cast<unsigned>(i), v);
  } else if constexpr (P == kNd64) {
    gather_nd<long long>(p, i, v);
  } else {          // one dimension
#pragma unroll
    for (int s = 0; s < TR_FP_SLOTS; ++s)
      v[s] = (p.used >> s & 1) ? load(p.op[s], i * p.op[s].stride[0]) : 0.0f;
  }
}

__device__ __forceinline__ float lane(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// 16 bytes through the read-only path. Volatile, so that it is never
// speculated out of its branch: an operand that is not read as float4 (a
// by-value scalar, a slot not in use) has no address to read there.
__device__ __forceinline__ float4 load4(const void* base, long long q) {
  const float4* a = static_cast<const float4*>(base) + q;
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(a));
  return v;
}

// One path's grid-stride loop (P: a Path, fixed at compile time so that a
// path's kernel holds only its own registers).
template <int P>
__device__ __forceinline__ void run(const FpArgs& p, float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (P == kVec4) {
    // the operands read once: by value, or a broadcast element
    float one[TR_FP_SLOTS];
#pragma unroll
    for (int s = 0; s < TR_FP_SLOTS; ++s)
      one[s] = ((p.used & ~p.vec) >> s & 1) ? load(p.op[s], 0) : 0.0f;
    const long long n4 = p.n >> 2;
    for (long long q = first; q < n4; q += step) {
      float4 w[TR_FP_SLOTS];
#pragma unroll
      for (int s = 0; s < TR_FP_SLOTS; ++s)
        w[s] = (p.vec >> s & 1)
                   ? load4(p.op[s].ptr, q)
                   : make_float4(one[s], one[s], one[s], one[s]);
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[TR_FP_SLOTS];
#pragma unroll
        for (int s = 0; s < TR_FP_SLOTS; ++s) v[s] = lane(w[s], j);
        r[j] = combine(p, v);
      }
      reinterpret_cast<float4*>(out)[q] = make_float4(r[0], r[1], r[2], r[3]);
    }
    for (long long i = n4 * 4 + first; i < p.n; i += step) {
      float v[TR_FP_SLOTS];
      gather<kLinear>(p, i, v);
      out[i] = combine(p, v);
    }
  } else {
    for (long long i = first; i < p.n; i += step) {
      float v[TR_FP_SLOTS];
      gather<P>(p, i, v);
      out[i] = combine(p, v);
    }
  }
}

}  // namespace

#define TR_FP_KERNEL(name)                                                  \
  template <int P>                                                          \
  __global__ void __launch_bounds__(kThreads)                               \
      name(const FpArgs p, float* __restrict__ out) {                       \
    run<P>(p, out);                                                         \
  }

TR_FP_KERNEL(fp_fma_kernel)
TR_FP_KERNEL(fp_lerp_kernel)
TR_FP_KERNEL(fp_plane_kernel)
TR_FP_KERNEL(fp_sqrt_kernel)
TR_FP_KERNEL(fp_chain_kernel)

namespace {

// The path of a launch; for kVec4 also p.vec, the slots read as float4;
// for kNd32 the magic numbers (PyTorch's IntDivider: exact for dividends
// and divisors below 2^31).
int choose_path(FpArgs& p, const void* out) {
  p.vec = 0;
  if (p.ndim > 1 && p.n >= (1LL << 31)) return kNd64;
  if (p.ndim > 1) {
    for (int d = 0; d < p.ndim; ++d) {
      const unsigned long long div = (unsigned long long)p.shape[d];
      int sh = 0;
      while (sh < 32 && (1ULL << sh) < div) ++sh;
      p.shift[d] = sh;
      p.magic[d] = (unsigned)(((1ULL << 32) * ((1ULL << sh) - div)) / div + 1);
    }
    return kNd32;
  }
  bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int s = 0; s < TR_FP_SLOTS && vec; ++s) {
    const FpOperand& o = p.op[s];
    if (!(p.used >> s & 1) || o.ptr == nullptr || o.stride[0] == 0) continue;
    vec = o.stride[0] == 1 && o.dtype == 0 &&
          (reinterpret_cast<uintptr_t>(o.ptr) & 15) == 0;
    p.vec |= 1 << s;
  }
  if (!vec) p.vec = 0;
  return vec ? kVec4 : kLinear;
}

int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

using Kernel = void (*)(const FpArgs, float*);

// kernel[path]: an entry point's kernel for each Path.
int launch(const Kernel* kernel, FpArgs p, void* out, void* stream) {
  if (p.n <= 0) return 0;
  if (p.ndim < 1 || p.ndim > TR_FP_DIMS || p.n_pairs < 0 || p.n_pairs > 3)
    return (int)cudaErrorInvalidValue;
  p.path = choose_path(p, out);
  const long long work = p.path == kVec4 ? (p.n + 3) / 4 : p.n;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  kernel[p.path]<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tr_fp_args_bytes() { return (int)sizeof(FpArgs); }

// args by value; out: contiguous float32, args.n elements.
#define TR_FP_ENTRY(entry, kernel)                                          \
  extern "C" int entry(FpArgs args, void* out, void* stream) {              \
    static const Kernel k[4] = {kernel<kVec4>, kernel<kLinear>,             \
                                kernel<kNd32>, kernel<kNd64>};              \
    return launch(k, args, out, stream);                                    \
  }

TR_FP_ENTRY(tr_fp_fma, fp_fma_kernel)
TR_FP_ENTRY(tr_fp_lerp, fp_lerp_kernel)
TR_FP_ENTRY(tr_fp_plane, fp_plane_kernel)
TR_FP_ENTRY(tr_fp_sqrt, fp_sqrt_kernel)
TR_FP_ENTRY(tr_fp_chain, fp_chain_kernel)
