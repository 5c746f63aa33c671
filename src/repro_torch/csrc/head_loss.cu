// The f32 next-token loss over a buffer of logits, with the logits'
// gradient written over them in place, for Hopper (sm_90a).  No TPU kernel:
// it replaces repro/models/common.py::cross_entropy (the f32 cast,
// logsumexp, the gather, the mean) and, in the backward, their autograd,
// on the port's training path (repro_torch/kernels/head_loss/ops.py runs
// the head's product before it and the two gradient products after).
//
// For each row i of buf [N, ld] (its first v columns the logits, the rest
// pad up to v_pad, a multiple of 64), with label y = labels[i] and the
// row's gradient weight c = scale[i] (mask_i / count, 1 / N without a
// mask):
//   logz_i  = log sum_{j < v} exp(x_ij)                    (in f32)
//   nll[i]  = logz_i - x_iy
//   x_ij   <- bf16(exp(x_ij - logz_i) * c - [j == y] * c)   for j < v
//   x_ij   <- 0                                             for j >= v
// The gradient is the one autograd gives the f32 composition for an
// incoming gradient of 1, rounded to the buffer's type once (the
// composition's .float() backward); the caller scales the products by the
// incoming gradient.  With write_grad 0 the row is only read.
//
// Bound: bytes.  The buffer is read once and written once at the least:
// 2 * N * v_pad * 2 B, 9.94 GB for internvl2-1b's 16,380 loss rows of
// 151,680 (151,655 padded), 2.97 ms at 3.35 TB/s; 4.29 GB and 1.28 ms for
// rwkv6-1.6b's 65,536.  The exps (two a column) are ~2.5e9 a call there,
// far under the SFU's rate.
//
// Design: one block of 512 threads a row.  Pass 1 streams the row in
// 16-byte vectors and keeps, per thread, an online max and a sum of
// exponentials rescaled to it (one rescale a vector); the block combines
// the threads' pairs in a fixed order (warp shuffles, then one warp over
// the warps' pairs), so a row's result does not depend on the schedule.
// Thread 0 reads the gold logit before the block's first barrier, so pass
// 2, which overwrites the row, cannot overwrite it first.  Pass 2 streams
// the row again and stores the gradient as 16-byte vectors.  A row of
// 303 KB does not fit in shared memory, so the second read comes from L2
// where the row is still there and from HBM otherwise: at most two reads
// and one write a row.  No f32 copy of the logits exists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (m, s) <- the pair of the union: the larger max, both sums rescaled to it
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float nm = fmaxf(m, m2);
  if (nm == -INFINITY) return;  // both empty
  s = s * expf(m - nm) + s2 * expf(m2 - nm);
  m = nm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_loss_kernel(T* __restrict__ buf, const int64_t* __restrict__ labels,
                 const float* __restrict__ scale, float* __restrict__ nll,
                 int v, int v_pad, int64_t ld, int write_grad) {
  constexpr int kVec = 16 / sizeof(T);
  union Vec {
    uint4 raw;
    T x[kVec];
  };
  __shared__ float sm_m[kWarps], sm_s[kWarps];
  __shared__ float sm_logz;

  const int64_t row = blockIdx.x;
  T* x = buf + row * ld;
  uint4* xv = reinterpret_cast<uint4*>(x);
  const int n_vec = v_pad / kVec;
  const int64_t y = labels[row];
  float gold = 0.f;
  if (threadIdx.x == 0) gold = to_f32(x[y]);

  // pass 1: the row's max and sum of exponentials over the v logits
  float m = -INFINITY, s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    Vec a;
    a.raw = xv[i];
    const int j0 = i * kVec;
    float lm = -INFINITY;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (j0 + k < v) lm = fmaxf(lm, to_f32(a.x[k]));
    if (lm == -INFINITY) continue;  // pad columns only
    const float nm = fmaxf(m, lm);
    float add = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (j0 + k < v) add += expf(to_f32(a.x[k]) - nm);
    s = s * expf(m - nm) + add;
    m = nm;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sm_m[lane] : -INFINITY;
    s = lane < kWarps ? sm_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      combine(m, s, m2, s2);
    }
    if (lane == 0) {
      const float logz = m + logf(s);
      sm_logz = logz;
      nll[row] = logz - gold;
    }
  }
  if (!write_grad) return;
  __syncthreads();

  // pass 2: the gradient over the row, pad columns 0
  const float logz = sm_logz;
  const float c = scale[row];
#pragma unroll 4
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    Vec a;
    a.raw = xv[i];
    const int j0 = i * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int j = j0 + k;
      float g = 0.f;
      if (j < v) {
        g = c * expf(to_f32(a.x[k]) - logz);
        if (j == y) g = g + -c;
      }
      a.x[k] = from_f32<T>(g);
    }
    xv[i] = a.raw;
  }
}

}  // namespace

extern "C" int head_loss_launch(void* buf, const void* labels,
                                const void* scale, void* nll, int n_rows,
                                int v, int v_pad, long long ld, int dtype,
                                int write_grad, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_rows), block(kThreads);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(nll);
  if (dtype == 0)
    head_loss_kernel<float><<<grid, block, 0, st>>>(
        static_cast<float*>(buf), lab, sc, out, v, v_pad, ld, write_grad);
  else
    head_loss_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<__nv_bfloat16*>(buf), lab, sc, out, v, v_pad, ld,
        write_grad);
  return static_cast<int>(cudaGetLastError());
}
