// The RWKV6 WKV recurrence, for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel repro/kernels/rwkv_scan/kernel.py::wkv6.
//
// Per (b, h), with an [N, N] f32 state S starting at zero, for t = 0..T-1:
//   o_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//   S[n][m] = w_t[n] * S[n][m] + k_t[n] * v_t[m]
// Inputs r/k/v/w in f32 or bf16, u [H, N] in the same dtype; o is f32.
//
// Design (simple and right first): one block of N threads per (b, h)
// steps over T.  Thread m owns column m of the state in registers (N
// floats), so the state never leaves the SM.  Each step, thread m stages
// r_t[m], k_t[m] and w_t[m] in shared memory (double-buffered, so one
// __syncthreads per step suffices) and keeps v_t[m] in a register; the
// next step's four values are loaded before this step's arithmetic, so
// their latency overlaps it.  Any T runs; N is 16, 32 or 64.
// Every tensor is addressed through (batch, head, time) strides in
// elements with N contiguous, so the model's [B,T,H,N] layout and the
// kernel layout [B,H,T,N] both run without a copy.
//
// Bound: bytes.  The function reads r, k, v, w once and writes o once
// (5 * B*H*T*N * 4 B in f32) and does about 4*N^2 flops per token and
// head; at N = 64 that is 12.8 flops per byte, below the H100's f32 FMA
// rate per byte of HBM bandwidth (67e12 / 3.35e12 = 20).  This design has
// only B*H blocks of N threads (128 blocks of 64 threads at RWKV6-1.6B's
// B=4, H=32) stepping T times in sequence, so it is latency-bound, far
// from that bound.  A chunked formulation is a later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {
  int64_t b, h, t;
};

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, float* __restrict__ o, int n_heads,
            int t_len, Strides is, Strides os) {
  __shared__ float r_s[2][N], k_s[2][N], w_s[2][N], u_s[N];
  const int m = threadIdx.x;
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int64_t in0 = b * is.b + h * is.h + m;
  float* out = o + b * os.b + h * os.h + m;

  u_s[m] = to_f32(u[h * N + m]);
  float state[N];
#pragma unroll
  for (int n = 0; n < N; ++n) state[n] = 0.f;

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (t_len > 0) {
    rn = to_f32(r[in0]);
    kn = to_f32(k[in0]);
    vn = to_f32(v[in0]);
    wn = to_f32(w[in0]);
  }
  for (int i = 0; i < t_len; ++i) {
    const int buf = i & 1;
    r_s[buf][m] = rn;
    k_s[buf][m] = kn;
    w_s[buf][m] = wn;
    const float vm = vn;
    __syncthreads();
    if (i + 1 < t_len) {                     // prefetch the next step
      const int64_t at = in0 + (int64_t)(i + 1) * is.t;
      rn = to_f32(r[at]);
      kn = to_f32(k[at]);
      vn = to_f32(v[at]);
      wn = to_f32(w[at]);
    }
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float kv = k_s[buf][n] * vm;
      acc = fmaf(r_s[buf][n], state[n] + u_s[n] * kv, acc);
      state[n] = fmaf(w_s[buf][n], state[n], kv);
    }
    out[(int64_t)i * os.t] = acc;
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, float* o, int b, int h,
                   int t, Strides is, Strides os, cudaStream_t stream) {
  wkv6_kernel<T, N><<<b * h, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), o, h, t, is, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int n, const void* r, const void* k, const void* v,
                     const void* w, const void* u, float* o, int b, int h,
                     int t, Strides is, Strides os, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, o, b, h, t, is, os, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, o, b, h, t, is, os, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, o, b, h, t, is, os, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v/w [B,H,T,N] sharing (batch, head, time) element strides with N
// contiguous; u [H,N] contiguous; o [B,H,T,N] f32 with its own strides.
// dtype 0 = f32, 1 = bf16 (inputs).  Returns the launch's cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* o, int b,
                           int h, int t, int n, int64_t isb, int64_t ish,
                           int64_t ist, int64_t osb, int64_t osh,
                           int64_t ost, int dtype, void* stream) {
  const Strides is{isb, ish, ist}, os{osb, osh, ost};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  if (dtype == 0)
    return dispatch<float>(n, r, k, v, w, u, out, b, h, t, is, os, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(n, r, k, v, w, u, out, b, h, t, is, os,
                                   st);
  return cudaErrorInvalidValue;
}
