// The gradient of the RWKV6 WKV recurrence, for Hopper (sm_90a).  The TPU
// kernel it stands beside, repro/kernels/rwkv_scan/kernel.py::wkv6, has
// no backward: the reference differentiates its lax.scan WKV
// (repro/models/rwkv6.py) with jax.grad.  Per (b, h), with an [N, N] f32
// state S_t starting at zero (row i a key channel, column j a value one):
//   o_t[j]   = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j]),
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j].
// Given dO, with G_t = dL/dS_t (G_{T-1} = 0, the last state is not an
// output), G_{t-1} = diag(w_t) G_t + r_t^T dO_t, and
// X_t[i][j] = G_t[i][j] + r_t[i] u[i] dO_t[j] (the gradient of k_t^T v_t):
//   dr_t[i] = sum_j dO_t[j] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j]),
//   dk_t[i] = sum_j X_t[i][j] v_t[j],    dv_t[j] = sum_i X_t[i][j] k_t[i],
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j],
//   du[i]   = sum_t r_t[i] k_t[i] (dO_t . v_t).
// Everything in f32 (the model passes f32 r, k, v, w and u).
//
// Design (simple and right first).  A row of the state evolves on its own
// (w scales rows), so one block of 4N threads owns 16 rows of one (b, h)'s
// state, a thread one row by 4 columns, for every time step: N/16 blocks a
// (b, h), 512 at rwkv6-1.6b's B 4, H 32, N 64.
//   * Sweep 1, forward in time: the state at the start of every chunk of
//     kChunk steps into f32 checkpoints [B, H, ceil(T/kChunk), N, N] that
//     the wrapper allocates (268 MB at that shape and T 2048).
//   * Sweep 2, the chunks from the last to the first: each chunk's r, k, w
//     (the block's rows), v and dO are staged in shared memory; the
//     chunk's states S_{t-1} are recomputed from its checkpoint into
//     shared memory (each thread keeps its own 4 values of each), then the
//     steps run backwards with G in registers.  The row sums (dr, dk, dw,
//     dO . v) are __shfl_xor_sync sums over a row's N/4 threads, and one
//     lane a row stores dr, dk and dw; dv's sum over the block's rows goes
//     through a shuffle within the warp and a per-warp buffer in shared
//     memory, into f32 partials [N/16, B, H, T, N] that a second kernel
//     adds in row-block order into dv; du is a per-(b, h) partial
//     [B, H, N] that the wrapper sums over b in order.
// Nothing is summed with atomics or in an order that depends on timing, so
// a rerun gives the same bits.  Every [B, H, T, N] tensor is addressed
// through (batch, head, time) strides with N contiguous, so the model's
// [B, T, H, N] layout runs without a copy.
//
// Bound: bytes.  r, k, v, w and dO in and dr, dk, dv, dw out once (9 f32
// tensors: 604 MB at B 4, H 32, T 2048, N 64, 0.180 ms at 3.35 TB/s)
// against about 12 N^2 flops a token and head (1.29e10, 0.19 ms at 67
// TFLOP/s: the two bounds are close).  This kernel also moves the
// checkpoints and the dv partials and runs the recurrence three times.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // time steps a checkpoint and a staged chunk
constexpr int kRowsBlk = 16; // state rows a block owns

struct Strides {
  int64_t b, h, t;   // element strides along batch, head and time
};

template <int N>
struct Shape {
  static constexpr int kThreads = 4 * N;        // a thread: 1 row, 4 cols
  static constexpr int kLanes = N / 4;          // threads a row
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsWarp = 32 / kLanes; // rows a warp
};

// Dynamic shared memory: r, k, w [kChunk][16]; v, dO [kChunk][N]; the
// chunk's states, [kChunk][threads] float4; dv's per-warp sums
// [kChunk][warps][N].
template <int N>
struct Smem {
  static constexpr int kRows = kChunk * kRowsBlk;
  static constexpr int kCols = kChunk * N;
  static constexpr int kStates = kChunk * Shape<N>::kThreads * 4;
  static constexpr int kDv = kChunk * Shape<N>::kWarps * N;
  static constexpr size_t kBytes =
      sizeof(float) * (3 * kRows + 2 * kCols + kStates + kDv);
};

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

template <int kLanes>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage steps [t0, t0 + kChunk) (zero past T): rows [i0, i0 + 16) of the
// row tensors and all N columns of the column tensors (nullptr: skipped).
template <int N>
__device__ __forceinline__ void stage(float* rs, float* ks, float* ws,
                                      float* vs, float* dos, const float* r,
                                      const float* k, const float* w,
                                      const float* v, const float* dout,
                                      Strides st, Strides dst, int t0,
                                      int T, int i0) {
  constexpr int kThreads = Shape<N>::kThreads;
  for (int e = threadIdx.x; e < kChunk * kRowsBlk; e += kThreads) {
    const int s = e / kRowsBlk, i = i0 + e % kRowsBlk, t = t0 + s;
    const bool in = t < T;
    const int64_t at = (int64_t)t * st.t + i;
    if (r) rs[e] = in ? r[at] : 0.f;
    ks[e] = in ? k[at] : 0.f;
    ws[e] = in ? w[at] : 0.f;
  }
  for (int e = threadIdx.x; e < kChunk * N; e += kThreads) {
    const int s = e / N, j = e % N, t = t0 + s;
    const bool in = t < T;
    vs[e] = in ? v[(int64_t)t * st.t + j] : 0.f;
    if (dout) dos[e] = in ? dout[(int64_t)t * dst.t + j] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(4 * N)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dout,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dw, float* __restrict__ dv_part,
                float* __restrict__ du_part, float* __restrict__ ckpt,
                int B, int H, int T, Strides st, Strides dst, Strides drs,
                Strides dks, Strides dws) {
  using S = Shape<N>;
  using M = Smem<N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* sbuf = smem4;                          // [kChunk][threads]
  float* dvbuf = smem + M::kStates;              // [kChunk][warps][N]
  float* rs = dvbuf + M::kDv;
  float* ks = rs + M::kRows;
  float* ws = ks + M::kRows;
  float* vs = ws + M::kRows;
  float* dos = vs + M::kCols;

  const int tid = threadIdx.x;
  const int ri = tid / S::kLanes, jg = tid % S::kLanes, j0 = 4 * jg;
  const int rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = rb * kRowsBlk, i = i0 + ri;
  const int warp = tid / 32, lane = tid % 32;
  const int n_ck = (T + kChunk - 1) / kChunk;

  const int64_t in_off = b * st.b + h * st.h;
  const float* rb_ = r + in_off;
  const float* kb = k + in_off;
  const float* vb = v + in_off;
  const float* wb = w + in_off;
  const float* db = dout + b * dst.b + h * dst.h;
  float4* ck = reinterpret_cast<float4*>(
      ckpt + ((int64_t)b * H + h) * n_ck * N * N) + (i * N + j0) / 4;
  constexpr int kCkStride = N * N / 4;           // float4s a checkpoint

  // sweep 1: the state at the start of every chunk
  float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < n_ck; ++c) {
    ck[c * kCkStride] = s4;
    __syncthreads();
    stage<N>(nullptr, ks, ws, vs, nullptr, nullptr, kb, wb, vb, nullptr, st,
             dst, c * kChunk, T, i0);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + s * N + j0);
      s4 = fma4(ks[s * kRowsBlk + ri], v4, scale4(ws[s * kRowsBlk + ri], s4));
    }
  }

  // sweep 2: the chunks backwards
  const float uu = u[h * N + i];
  float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);   // G_t, this thread's part
  float du = 0.f;
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncthreads();
    stage<N>(rs, ks, ws, vs, dos, rb_, kb, wb, vb, db, st, dst, t0, T, i0);
    __syncthreads();
    // the chunk's states S_{t-1}, recomputed from its checkpoint
    s4 = ck[c * kCkStride];
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      sbuf[s * S::kThreads + tid] = s4;
      const float4 v4 = *reinterpret_cast<const float4*>(vs + s * N + j0);
      s4 = fma4(ks[s * kRowsBlk + ri], v4, scale4(ws[s * kRowsBlk + ri], s4));
    }
    const int steps = min(kChunk, T - t0);
    for (int s = steps - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float4 sp = sbuf[s * S::kThreads + tid];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + s * N + j0);
      const float4 do4 = *reinterpret_cast<const float4*>(dos + s * N + j0);
      const float rr = rs[s * kRowsBlk + ri], kk = ks[s * kRowsBlk + ri];
      const float ww = ws[s * kRowsBlk + ri];
      const float4 x4 = fma4(rr * uu, do4, g4);
      float dr_p = dot4(do4, fma4(uu * kk, v4, sp));
      float dk_p = dot4(x4, v4);
      float dw_p = dot4(g4, sp);
      float c_p = dot4(do4, v4);
      dr_p = row_sum<S::kLanes>(dr_p);
      dk_p = row_sum<S::kLanes>(dk_p);
      dw_p = row_sum<S::kLanes>(dw_p);
      c_p = row_sum<S::kLanes>(c_p);
      if (jg == 0) {
        dr[b * drs.b + h * drs.h + (int64_t)t * drs.t + i] = dr_p;
        dk[b * dks.b + h * dks.h + (int64_t)t * dks.t + i] = dk_p;
        dw[b * dws.b + h * dws.h + (int64_t)t * dws.t + i] = dw_p;
        du = fmaf(rr * kk, c_p, du);
      }
      // dv over the warp's rows, then into the warp's slot
      float4 dv4 = scale4(kk, x4);
#pragma unroll
      for (int off = S::kLanes; off < 32; off <<= 1) {
        dv4.x += __shfl_xor_sync(0xffffffffu, dv4.x, off);
        dv4.y += __shfl_xor_sync(0xffffffffu, dv4.y, off);
        dv4.z += __shfl_xor_sync(0xffffffffu, dv4.z, off);
        dv4.w += __shfl_xor_sync(0xffffffffu, dv4.w, off);
      }
      if (lane < S::kLanes)
        *reinterpret_cast<float4*>(dvbuf + (s * S::kWarps + warp) * N + j0) =
            dv4;
      g4 = fma4(rr, do4, scale4(ww, g4));
    }
    __syncthreads();
    // dv's partial over the block's rows, the warps summed in order
    for (int e = tid; e < steps * N; e += S::kThreads) {
      const int s = e / N, j = e % N;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < S::kWarps; ++q)
        acc += dvbuf[(s * S::kWarps + q) * N + j];
      dv_part[((((int64_t)rb * B + b) * H + h) * T + t0 + s) * N + j] = acc;
    }
  }
  if (jg == 0) du_part[((int64_t)b * H + h) * N + i] = du;
}

// dv = the sum of the row blocks' partials, in row-block order.
template <int N>
__global__ void wkv6_bwd_dv(const float* __restrict__ dv_part,
                            float* __restrict__ dv, int B, int H, int T,
                            Strides dvs) {
  const int64_t n = (int64_t)B * H * T * N;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int j = e % N;
    const int64_t bht = e / N;
    const int t = bht % T;
    const int64_t bh = bht / T;
    const int h = bh % H, b = bh / H;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < N / kRowsBlk; ++q) acc += dv_part[q * n + e];
    dv[b * dvs.b + h * dvs.h + (int64_t)t * dvs.t + j] = acc;
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* dout,
                   float* dr, float* dk, float* dv, float* dw,
                   float* dv_part, float* du_part, float* ckpt, int B, int H,
                   int T, Strides st, Strides dst, Strides drs, Strides dks,
                   Strides dvs, Strides dws, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kRowsBlk, H, B);
  wkv6_bwd_kernel<N><<<grid, Shape<N>::kThreads, kBytes, stream>>>(
      r, k, v, w, u, dout, dr, dk, dw, dv_part, du_part, ckpt, B, H, T, st,
      dst, drs, dks, dws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_dv<N><<<1024, 256, 0, stream>>>(dv_part, dv, B, H, T, dvs);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dout and dr, dk, dv, dw: [B, H, T, N] f32 given as element
// strides (batch, head, time), N contiguous; r, k, v and w share theirs
// (strides[0..2]), then dout's, dr's, dk's, dv's and dw's (strides[3..17]);
// u [H, N] contiguous; du_part [B, H, N], dv_part [N/16, B, H, T, N] and
// ckpt [B, H, ceil(T/16), N, N] contiguous f32 (scratch).  Returns the
// first launch's error (cudaErrorInvalidValue for N other than 16, 32, 64).
extern "C" int wkv6_bwd_launch(const float* r, const float* k,
                               const float* v, const float* w,
                               const float* u, const float* dout, float* dr,
                               float* dk, float* dv, float* dw,
                               float* du_part, float* dv_part, float* ckpt,
                               int B, int H, int T, int N,
                               const int64_t* strides, void* stream) {
  Strides s[6];
  for (int q = 0; q < 6; ++q)
    s[q] = Strides{strides[3 * q], strides[3 * q + 1], strides[3 * q + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch<16>(r, k, v, w, u, dout, dr, dk, dv, dw, dv_part,
                        du_part, ckpt, B, H, T, s[0], s[1], s[2], s[3], s[4],
                        s[5], st);
    case 32:
      return launch<32>(r, k, v, w, u, dout, dr, dk, dv, dw, dv_part,
                        du_part, ckpt, B, H, T, s[0], s[1], s[2], s[3], s[4],
                        s[5], st);
    case 64:
      return launch<64>(r, k, v, w, u, dout, dr, dk, dv, dw, dv_part,
                        du_part, ckpt, B, H, T, s[0], s[1], s[2], s[3], s[4],
                        s[5], st);
  }
  return cudaErrorInvalidValue;
}
