// Causal or full grouped-query attention with an online softmax, for
// Hopper (sm_90a), optionally over a sliding window.  Replaces the Pallas
// TPU kernel repro/kernels/flash_attention/kernel.py::flash_attention and
// the window of the reference's _sdpa_naive/_sdpa_chunked
// (repro/models/attention.py), which that kernel lacks.  Two kernels
// share the entry point flash_attention_launch, and the caller names the
// route: "wgmma" (bf16 at head dims 64 and 128 without a window, on the
// tensor cores; see flash_attention_wgmma.cuh) and "fma" (below: every
// other call, f32 and bf16 at head dims 16 to 256).
//
// The FMA kernel:
// For each (b, h, query row i), with g = h / (H / KV) the shared KV head:
//   s_j = (q_i . k_j) * hd^-0.5,   masked to NEG_INF where causal && j > i
//                                  or window && i - j >= window
//   o_i = sum_j softmax(s)_j v_j
// with the running max m, the running sum l and the accumulator acc in f32
// (P is never rounded to the input type), and o written in q's dtype.
//
// Design (simple and right first):
//   * one block of 256 threads per (query tile, h, b);
//   * each query row belongs to kTPR neighbouring threads (4, or 8 at hd
//     256, so a thread holds at most 32 query values and 32 accumulators
//     in registers: the tile is 64 rows, 32 at hd 256); thread t of the
//     group owns the float4 chunks t, t+kTPR, t+2*kTPR, ... of the head
//     dim, and the partial dot products are summed with __shfl_xor_sync;
//   * K and V tiles of kBK rows (32, 16 at hd 256, so both fit the 48 KB
//     of static shared memory) are staged in shared memory as f32, read
//     back as float4 (one 16-byte load feeds four FMAs);
//   * with causal masking the loop stops after the tile that holds the
//     block's last query row, so tiles above the diagonal are skipped;
//   * the window is a template flag, so calls without one run the loop
//     and mask above unchanged; with one, the loop also starts at the
//     tile holding the first row's first windowed key, and masked keys
//     in the tiles visited get probability 0 once a row has seen a key
//     (a row that sees no key at all, i >= Sk + window - 1, averages
//     every key as the reference's softmax over NEG_INF does, so a block
//     holding one visits every tile);
//   * the ragged edges (Sq and Sk not multiples of the tiles) are masked:
//     keys past Sk get probability 0, rows past Sq are not stored.
// Every tensor is addressed through (batch, seq, head) strides in elements
// with the head dim contiguous, so the model's [B,S,H,hd] layout and the
// kernel layout [B,H,S,hd] both run without a copy.
//
// Bound: at the models' shapes the function needs 4*B*H*pairs*hd flops
// (pairs = the unmasked (i, j) pairs), which at the H100's bf16
// tensor-core rate take longer than moving q, k, v and o once; this kernel
// runs on the f32 FMA units (f32 must stay exact to 2e-5, which TF32
// tensor cores cannot give) and is far from that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf
constexpr int kThreads = 256;       // threads per block

// The tile shapes at head dim HD: threads per query row, query rows per
// block, key rows per shared-memory tile.
template <int HD>
struct FmaTile {
  static constexpr int kTPR = HD >= 256 ? 8 : 4;
  static constexpr int kBQ = kThreads / kTPR;
  static constexpr int kBK = HD >= 256 ? 16 : 32;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

using fa_wgmma::Strides;

template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int group, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window) {
  constexpr int kTPR = FmaTile<HD>::kTPR;
  constexpr int kBQ = FmaTile<HD>::kBQ;
  constexpr int kBK = FmaTile<HD>::kBK;
  constexpr int kChunks = HD / 4;            // float4 chunks per row
  constexpr int kMine = kChunks / kTPR;      // chunks per thread
  __shared__ float4 k_tile[kBK][kChunks];
  __shared__ float4 v_tile[kBK][kChunks];

  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + row;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / group;

  float4 qr[kMine], acc[kMine];
  const T* qrow = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d = 4 * (t + kTPR * c);
    if (qi < sq) {
      qr[c] = make_float4(to_f32(qrow[d]), to_f32(qrow[d + 1]),
                          to_f32(qrow[d + 2]), to_f32(qrow[d + 3]));
    } else {
      qr[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  const T* kbase = k + b * ks.b + g * ks.h;
  const T* vbase = v + b * vs.b + g * vs.h;
  // with a window the block's first row sees keys from q0 - window + 1;
  // a block holding a row that sees no key (its last stored row,
  // min(q0 + kBQ, sq) - 1, is window or more past Sk - 1) visits every key
  int kbegin = 0;
  if (kWindow && min(q0 + kBQ, sq) - window < sk)
    kbegin = (max(0, q0 - window + 1) / kBK) * kBK;
  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = kbegin; k0 < kend; k0 += kBK) {
    __syncthreads();                          // the last tile is consumed
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int j = e / kChunks, d = 4 * (e % kChunks), kj = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kj < sk) {
        const T* kp = kbase + (int64_t)kj * ks.s + d;
        const T* vp = vbase + (int64_t)kj * vs.s + d;
        kk = make_float4(to_f32(kp[0]), to_f32(kp[1]), to_f32(kp[2]),
                         to_f32(kp[3]));
        vv = make_float4(to_f32(vp[0]), to_f32(vp[1]), to_f32(vp[2]),
                         to_f32(vp[3]));
      }
      k_tile[j][d / 4] = kk;
      v_tile[j][d / 4] = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const float4 kk = k_tile[j][t + kTPR * c];
        dot = fmaf(qr[c].x, kk.x, dot);
        dot = fmaf(qr[c].y, kk.y, dot);
        dot = fmaf(qr[c].z, kk.z, dot);
        dot = fmaf(qr[c].w, kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < kTPR; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kj = k0 + j;
      const bool masked =
          (causal && kj > qi) || (kWindow && qi - kj >= window);
      s[j] = masked ? kNegInf : dot * scale;
      if (kj < sk) m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = (k0 + j < sk) ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const float4 vv = v_tile[j][t + kTPR * c];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (qi >= sq) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + b * os.b + (int64_t)qi * os.s + h * os.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d = 4 * (t + kTPR * c);
    store(orow + d, acc[c].x * inv);
    store(orow + d + 1, acc[c].y * inv);
    store(orow + d + 2, acc[c].z * inv);
    store(orow + d + 3, acc[c].w * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int sq, int sk, int group, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int kBQ = FmaTile<HD>::kBQ;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  if (window > 0)
    flash_fwd_kernel<T, HD, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, qs, ks,
        vs, os, scale, causal, window);
  else
    flash_fwd_kernel<T, HD, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, qs, ks,
        vs, os, scale, causal, 0);
  return cudaGetLastError();
}

// Both dtypes at every head dim: bf16 at 64 and 128 comes here too when
// the call has a window.
template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int b, int h, int sq, int sk, int group,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
#define FA_CASE(HD)                                                          \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, o, b, h, sq, sk, group, qs, ks, vs, os,   \
                         scale, causal, window, stream);
  switch (hd) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q [B,H,Sq,hd], k/v [B,KV,Sk,hd], o [B,H,Sq,hd] given as element strides
// (batch, seq, head) with the head dim contiguous; window 0 = none, else
// row i sees keys j with i - j < window; dtype 0 = f32, 1 = bf16 (q, k, v
// and o alike); route 0 = the FMA kernel (hd 16, 32, 64, 128 or 256),
// 1 = the wgmma kernel (bf16, hd 64 or 128, no window, every stride of a
// dim longer than 1 and every base 16-byte aligned).  Returns the launch's cudaError_t; a route that does
// not take the arguments is cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int kvh, int sq, int sk, int hd, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int64_t osb, int64_t oss, int64_t osh, float scale,
    int causal, int window, int dtype, int route, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const int group = h / kvh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (window < 0) return cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || window != 0) return cudaErrorInvalidValue;
    if (hd == 64)
      return fa_wgmma::launch<64>(q, k, v, o, b, h, kvh, sq, sk, qs, ks, vs,
                                  os, scale, causal, st);
    if (hd == 128)
      return fa_wgmma::launch<128>(q, k, v, o, b, h, kvh, sq, sk, qs, ks,
                                   vs, os, scale, causal, st);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, b, h, sq, sk, group, qs, ks, vs,
                           os, scale, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, b, h, sq, sk, group, qs,
                                   ks, vs, os, scale, causal, window, st);
  return cudaErrorInvalidValue;
}
