// AdamW's step and its gradient norm over a whole list of leaves, for Hopper
// (sm_90a).  No TPU kernel: the reference leaves the update and the norm to
// XLA (repro/optim/adamw.py), and the port ran them as about 21 PyTorch
// elementwise ops a leaf, each a full pass over an f32 copy of the leaf.
//
// Bound: bytes.  A step reads each weight's bf16 gradient for the norm
// (2 B), then the gradient, the bf16 weight and the f32 moments m and v for
// the update (12 B), and writes the weight, m and v (10 B): 24 B a weight,
// 11.46 ms at 3.35 TB/s for rwkv6-1.6b's 1.60 B weights, 20.04 ms for the
// MoE cell's 2.80 B, 3.54 ms for internvl2-1b's 0.49 B.  The arithmetic
// (a division, a square root and ~15 other f32 operations a weight) is far
// under the card's rate.
//
// Design: the leaves are cut into chunks of kChunk elements, one block a
// chunk, so a 311 M-element head and a 2,048-element norm scale share one
// launch and every SM streams.  A launch's leaves travel by value in the
// kernel's parameter space (a __grid_constant__ Table of up to kMaxLeaves
// leaves: pointers, element counts, each leaf's first chunk, its kind), so
// there is no host-to-device copy and nothing to reuse between steps; a
// longer list takes several launches.  A block finds its leaf by a binary
// search of the first chunks (uniform across the block).  Where all of a
// leaf's pointers are 16-byte aligned a thread moves 8 elements at a time
// (16-byte loads and stores); a chunk's ragged tail, and every element of a
// leaf that is not aligned, goes element by element.
//
// sumsq: each block sums its chunk's squares in f64 (each square exact),
// reduces across the block in a fixed order and writes one partial; a
// one-block finalize sums the partials in a fixed order and writes
// sqrt(sum) as f32.  The result does not depend on the schedule.
//
// update: each element reads g, p, m and v once and writes p, m and v
// once, in place.  The arithmetic is the plain loop's
// (kernels/adamw/ref.py), op for op in f32 with no contraction, so for the
// same norm the bits are those PyTorch's elementwise kernels give:
//   g     = float(g) * scale                     (0 for a None gradient)
//   m     = m*b1 + (1-b1)*g
//   v     = v*b2 + ((1-b2)*g)*g
//   delta = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p
//   p     = round(p - lr*delta)                  (bf16 or f32)
// lr, the clip scale, bc1 and bc2 are 0-d f32 device tensors read through
// pointers, so the step needs no host sync.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 1 << 16;    // elements a block
constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a thread moves at a time
constexpr int kMaxLeaves = 640;    // leaves a launch (the table's ~28 KB)
constexpr int kFinalThreads = 1024;

// a leaf's kind: its gradient's type, its weight's, and whether every
// pointer is 16-byte aligned
enum : unsigned {
  kGradNone = 0, kGradF32 = 1, kGradBf16 = 2, kGradMask = 3,
  kParamBf16 = 4, kAligned = 8,
};

struct Table {
  const void* g[kMaxLeaves];
  void* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];       // leaf i's chunks: first[i] .. first[i+1]-1
  unsigned char kind[kMaxLeaves];
  int count;
};

// the f32 hyper-parameters, rounded from the host's doubles as PyTorch
// rounds a Python scalar into an f32 kernel
struct Hyper {
  float b1, c1, b2, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// 8 elements to f32, and back
struct NoGrad {};
__device__ __forceinline__ void load8(const NoGrad*, float* x) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) x[k] = 0.f;
}
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  union { uint4 raw; __nv_bfloat16 h[kVec]; } u;
  u.raw = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < kVec; ++k) x[k] = __bfloat162float(u.h[k]);
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  union { uint4 raw; __nv_bfloat16 h[kVec]; } u;
#pragma unroll
  for (int k = 0; k < kVec; ++k) u.h[k] = __float2bfloat16_rn(x[k]);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

__device__ __forceinline__ float load1(const NoGrad*, long long) {
  return 0.f;
}
__device__ __forceinline__ float load1(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                       float x) {
  p[i] = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- update

struct Scalars {
  float lr, scale, bc1, bc2;
};

// one element, in the plain loop's order; g is float(g) (0 for None)
__device__ __forceinline__ void adamw1(float g, float& p, float& m, float& v,
                                       const Scalars& s, const Hyper& h) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float q = __fdiv_rn(
      __fdiv_rn(m, s.bc1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  const float delta = __fadd_rn(q, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename G, typename P>
__device__ __forceinline__ void update_chunk(const G* g, P* p, float* m,
                                             float* v, long long len,
                                             bool aligned, const Scalars& s,
                                             const Hyper& h) {
  const long long n_vec = aligned ? len / kVec : 0;
  for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
    const long long e = i * kVec;
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    load8(g + e, gx);
    load8(p + e, px);
    load8(m + e, mx);
    load8(v + e, vx);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adamw1(gx[k], px[k], mx[k], vx[k], s, h);
    store8(p + e, px);
    store8(m + e, mx);
    store8(v + e, vx);
  }
  for (long long e = n_vec * kVec + threadIdx.x; e < len; e += kThreads) {
    float px = load1(p, e), mx = m[e], vx = v[e];
    adamw1(load1(g, e), px, mx, vx, s, h);
    store1(p, e, px);
    m[e] = mx;
    v[e] = vx;
  }
}

template <typename G>
__device__ __forceinline__ void update_param(const Table& t, int i,
                                             long long at, long long len,
                                             const Scalars& s,
                                             const Hyper& h) {
  const unsigned kind = t.kind[i];
  const G* g = static_cast<const G*>(t.g[i]) + at;
  const bool aligned = kind & kAligned;
  if (kind & kParamBf16)
    update_chunk(g, static_cast<__nv_bfloat16*>(t.p[i]) + at, t.m[i] + at,
                 t.v[i] + at, len, aligned, s, h);
  else
    update_chunk(g, static_cast<float*>(t.p[i]) + at, t.m[i] + at,
                 t.v[i] + at, len, aligned, s, h);
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table t,
                    const float* __restrict__ lr,
                    const float* __restrict__ scale,
                    const float* __restrict__ bc1,
                    const float* __restrict__ bc2, Hyper h) {
  const int b = blockIdx.x;
  const int i = leaf_of(t, b);
  const long long at = static_cast<long long>(b - t.first[i]) * kChunk;
  const long long len = min(static_cast<long long>(kChunk), t.n[i] - at);
  const Scalars s{*lr, *scale, *bc1, *bc2};
  switch (t.kind[i] & kGradMask) {
    case kGradNone: update_param<NoGrad>(t, i, at, len, s, h); break;
    case kGradF32: update_param<float>(t, i, at, len, s, h); break;
    default: update_param<__nv_bfloat16>(t, i, at, len, s, h); break;
  }
}

// ----------------------------------------------------------------- sumsq

// the block's sum in a fixed order: warps by shuffles, then warp 0 over
// the warps' sums; the total in thread 0
template <int kN>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double part[kN / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < kN / 32 ? part[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename G>
__device__ __forceinline__ double sumsq_chunk(const G* g, long long len,
                                              bool aligned) {
  double acc = 0.0;
  const long long n_vec = aligned ? len / kVec : 0;
  for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
    float x[kVec];
    load8(g + i * kVec, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      acc = fma(static_cast<double>(x[k]), static_cast<double>(x[k]), acc);
  }
  for (long long e = n_vec * kVec + threadIdx.x; e < len; e += kThreads) {
    const double x = load1(g, e);
    acc = fma(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const __grid_constant__ Table t,
                   double* __restrict__ partial) {
  const int b = blockIdx.x;
  const int i = leaf_of(t, b);
  const long long at = static_cast<long long>(b - t.first[i]) * kChunk;
  const long long len = min(static_cast<long long>(kChunk), t.n[i] - at);
  const unsigned kind = t.kind[i];
  const bool aligned = kind & kAligned;
  const double acc =
      (kind & kGradMask) == kGradF32
          ? sumsq_chunk(static_cast<const float*>(t.g[i]) + at, len, aligned)
          : sumsq_chunk(static_cast<const __nv_bfloat16*>(t.g[i]) + at, len,
                        aligned);
  const double total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partial[b] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
adamw_sumsq_finalize_kernel(const double* __restrict__ partial, int n,
                            float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinalThreads) acc += partial[i];
  const double total = block_sum<kFinalThreads>(acc);
  if (threadIdx.x == 0) *out = static_cast<float>(sqrt(total));
}

int fill(Table& t, int count, const void* const* g, void* const* p,
         float* const* m, float* const* v, const long long* n,
         const int* first, const unsigned char* kind) {
  if (count <= 0 || count > kMaxLeaves) return cudaErrorInvalidValue;
  t.count = count;
  memcpy(t.g, g, count * sizeof(void*));
  if (p != nullptr) {
    memcpy(t.p, p, count * sizeof(void*));
    memcpy(t.m, m, count * sizeof(float*));
    memcpy(t.v, v, count * sizeof(float*));
  }
  memcpy(t.n, n, count * sizeof(long long));
  memcpy(t.first, first, (count + 1) * sizeof(int));
  memcpy(t.kind, kind, count);
  return 0;
}

}  // namespace

// The table's capacity and chunk, for the wrapper to check its own against.
extern "C" int adamw_max_leaves() { return kMaxLeaves; }
extern "C" int adamw_chunk() { return kChunk; }

// One launch of the update over `count` leaves: g[i] (null: a None
// gradient), p[i], m[i], v[i], n[i] elements, first[0..count] their first
// chunks (first[count] the blocks), kind[i].
extern "C" int adamw_update_launch(int count, const void* const* g,
                                   void* const* p, float* const* m,
                                   float* const* v, const long long* n,
                                   const int* first, const unsigned char* kind,
                                   const void* lr, const void* scale,
                                   const void* bc1, const void* bc2, float b1,
                                   float c1, float b2, float c2, float eps,
                                   float wd, void* stream) {
  Table t;
  const int rc = fill(t, count, g, p, m, v, n, first, kind);
  if (rc != 0) return rc;
  if (first[count] == 0) return 0;
  adamw_update_kernel<<<first[count], kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(lr), static_cast<const float*>(scale),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      Hyper{b1, c1, b2, c2, eps, wd});
  return static_cast<int>(cudaGetLastError());
}

// One launch of the sums of squares over `count` gradients: partial[b] for
// each of the launch's first[count] chunks.
extern "C" int adamw_sumsq_launch(int count, const void* const* g,
                                  const long long* n, const int* first,
                                  const unsigned char* kind, void* partial,
                                  void* stream) {
  Table t;
  const int rc = fill(t, count, g, nullptr, nullptr, nullptr, n, first, kind);
  if (rc != 0) return rc;
  if (first[count] == 0) return 0;
  adamw_sumsq_kernel<<<first[count], kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<double*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// sqrt of the sum of partial[0..n) into the f32 at out (0 when n is 0).
extern "C" int adamw_sumsq_finalize_launch(const void* partial, int n,
                                           void* out, void* stream) {
  adamw_sumsq_finalize_kernel<<<1, kFinalThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
