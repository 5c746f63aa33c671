// The gradient of the RWKV6 WKV recurrence, for Hopper (sm_90a).  The TPU
// kernel it stands beside, repro/kernels/rwkv_scan/kernel.py::wkv6, has
// no backward: the reference differentiates its lax.scan WKV
// (repro/models/rwkv6.py) with jax.grad.  Per (b, h), with an [N, N] f32
// state S_t starting at zero (row i a key channel, column j a value one):
//   o_t[j]   = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j]),
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j].
// Given dO, with G_t = dL/dS_t (G_{T-1} = 0, the last state is not an
// output), G_{t-1} = diag(w_t) G_t + r_t^T dO_t, and, with the two
// per-step scalars a_t = dO_t . v_t and c_t = sum_i r_t[i] u[i] k_t[i]
// (u's terms folded as the forward folds them, csrc/wkv6.cu):
//   dr_t[i] = sum_j dO_t[j] S_{t-1}[i][j] + u[i] k_t[i] a_t,
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] a_t,
//   dv_t[j] = sum_i G_t[i][j] k_t[i]      + dO_t[j] c_t,
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j],
//   du[i]   = sum_t r_t[i] k_t[i] a_t.
// Everything in f32 (the model passes f32 r, k, v, w and u).
//
// Bound: r, k, v, w and dO in and dr, dk, dv, dw out once (9 f32 tensors:
// 604 MB at rwkv6-1.6b's training shape B 4, H 32, T 2048, N 64, 0.180 ms
// at 3.35 TB/s) against about 12 N^2 flops a token and head (1.29e10,
// 0.192 ms at 67 TFLOP/s): the two are close.  This kernel also writes and
// reads the state checkpoints (266 MB each way at that shape: about 1.1 GB
// moved in all) and runs the forward recurrence 2.375 times a step (a
// forward sweep, then 22 recomputed steps for every 16): about 11 f32
// instructions a state element a step, and 1.06 shuffles.
//
// Design.  One CTA owns a (b, h) (128 CTAs at that shape on 132 SMs, one
// wave); a thread owns a tile of kRT rows by 4 columns of the [N, N]
// state (4 x 4 at N 64: 256 threads, 8 warps).
//   * Time runs in chunks of kChunk steps.  Thread 0 brings each chunk's
//     r, k, w, v and dO into a ring of kStages shared-memory stages with
//     TMA (4-d tensor maps over (N, T, H, B) from the caller's strides,
//     zero fill past T), completing on the stage's full mbarrier, and
//     refills a stage once every thread has arrived on its empty mbarrier.
//     The step loops read only shared memory and registers.
//   * Sweep 1, forward in time: each thread stores its tile of the state at
//     the start of every chunk but the last into f32 checkpoints [B, H,
//     ceil(T/kChunk) - 1, N, N] (call-lived scratch the wrapper allocates:
//     266 MB at that shape).  The forward kernel does not write them: kept
//     from each layer's forward to its backward they would add 3.2 GB to
//     train-rwkv6-1.6b's 72.5 GB peak.
//   * Sweep 2, the chunks from the last to the first.  A chunk's prologue
//     computes a_t and c_t for its steps (one CTA-wide barrier a chunk)
//     while the next chunk's checkpoint comes into shared memory with
//     cp.async.  The chunk then runs as two sub-chunks of kSub steps, the
//     later first: each thread recomputes a sub-chunk's states S_{t-1}
//     from its first state into registers (fully unrolled, kSub x 16
//     floats), then steps them backwards with G in registers.  No state
//     goes through shared memory on the step loop.
//   * The row sums dr, dk, dw over a row's N/4 lanes are a reduce-scatter:
//     the thread's 3 kRT partial sums are halved across lane bits until
//     each lane holds one row's three, then summed over the kG lanes left
//     (15 shuffles a step for 16 state elements at N 64), and the lanes of
//     a row store its dr, dk and dw.  dv's column sums over the thread's
//     rows are reduce-scattered over the warp's row groups (2 shuffles),
//     the first warp adds dO_t c_t, and each warp stores its partial in a
//     [2][kChunk][warps][N] buffer, which the CTA sums in warp order after
//     the chunk and stores as dv.  The buffer is double-buffered on the
//     chunk's parity, so the chunk's prologue barrier is the only one that
//     orders its reuse.
// Measured layouts the code no longer has (scripts/wkv6_variant_timing.py
// --bwd, PERF.md): a cluster of 4 CTAs of 16 rows a (b, h), dv summed over
// distributed shared memory, ran 2.4x slower (the card holds 124 of the
// 128 clusters at once), clusters of 2 and 4-step sub-chunks 5-6% slower.
// Nothing is summed with atomics or in an order that depends on timing, so
// a rerun gives the same bits.  Every [B, H, T, N] tensor is addressed
// through (batch, head, time) strides with N contiguous, so the model's
// [B, T, H, N] layout runs without a copy; TMA needs the strides of the
// inputs and dO, and the bases, 16-byte aligned, and dv's 16-byte stores
// its own (the wrapper checks all nine).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int kChunk = 16;     // steps a stage holds and a checkpoint spans
constexpr int kSub = kChunk / 2;   // steps whose states live in registers
constexpr int kStages = 4;

struct Strides {
  int64_t b, h, t;   // element strides along batch, head and time
};

template <int N>
struct Cfg {
  static constexpr int kRT = N == 16 ? 2 : 4;    // rows a thread
  static constexpr int kL = N / 4;               // lanes a row group (4 columns each)
  static constexpr int kRG = 32 / kL;            // row groups a warp
  static constexpr int kThreads = N / kRT * kL;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kG = kL / kRT;            // lanes that end with a row's sums
  static constexpr int kPer = kThreads / kChunk; // prologue threads a step
  static_assert(kThreads % 32 == 0 && kRG * kWarps * kRT == N,
                "the tiles must fill whole warps and the state's rows");
  static_assert(kG >= 2 && kPer >= 1, "tile too wide");
};

template <int N>
struct Stage {
  float r[kChunk][N], k[kChunk][N], w[kChunk][N], v[kChunk][N],
      dout[kChunk][N];
};

template <int N>
struct Smem {
  Stage<N> in[kStages];
  // a chunk's first state (two: the next one's copy is in flight)
  float4 ck[2][Cfg<N>::kRT][Cfg<N>::kThreads];
  float part[2][kChunk][Cfg<N>::kWarps][N];     // dv's partials
  float a[kStages][kChunk], c[kStages][kChunk];
  uint64_t full[kStages], empty[kStages];
};

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(Smem<N>) + 128;   // room to align the base to 128
}

// kR consecutive floats of shared memory (4 or 2, aligned to their size).
template <int kR>
__device__ __forceinline__ void load_f(const float* p, float (&x)[kR]) {
  if constexpr (kR == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    static_assert(kR == 2, "2 or 4 values");
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x;
    x[1] = q.y;
  }
}

// One reduce-scatter level: the lanes that differ in bit kOff swap halves
// of x[0 .. 2 kHalf); the lane with the bit set keeps the upper half.
template <int kHalf, int kOff>
__device__ __forceinline__ void halve(float* x, int lane) {
  const bool up = lane & kOff;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const float send = up ? x[q] : x[q + kHalf];
    const float keep = up ? x[q + kHalf] : x[q];
    x[q] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// Halve at lane bits kOff, kOff / 2, ..., kLast.
template <int kHalf, int kOff, int kLast>
__device__ __forceinline__ void scatter_down(float* x, int lane) {
  halve<kHalf, kOff>(x, lane);
  if constexpr (kOff > kLast) scatter_down<kHalf / 2, kOff / 2, kLast>(x, lane);
}

// Sum x[0 .. kV) over lane bits kOff, kOff / 2, ..., 1.
template <int kV, int kOff>
__device__ __forceinline__ void allreduce_down(float* x) {
  if constexpr (kOff >= 1) {
#pragma unroll
    for (int q = 0; q < kV; ++q) x[q] += __shfl_xor_sync(0xffffffffu, x[q], kOff);
    allreduce_down<kV, kOff / 2>(x);
  }
}

// dv's 4 values over the warp's row groups, lane bits kOff, 2 kOff, ...,
// 16: halved while more than one is left, then summed.
template <int kV, int kOff>
__device__ __forceinline__ void dv_up(float* x, int lane) {
  if constexpr (kOff < 32) {
    if constexpr (kV > 1) {
      halve<kV / 2, kOff>(x, lane);
      dv_up<kV / 2, kOff * 2>(x, lane);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], kOff);
      dv_up<1, kOff * 2>(x, lane);
    }
  }
}

// 16 bytes from global to shared memory, in the background of the
// thread's work until cp_async_wait (the thread reads them itself).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::kThreads)
wkv6_bwd_kernel(const __grid_constant__ CUtensorMap r_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ u, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ckpt, int n_heads, int t_len,
                Strides drs, Strides dks, Strides dvs, Strides dws) {
  using C = Cfg<N>;
  constexpr int RT = C::kRT;
  extern __shared__ unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cl = lane % C::kL;
  const int i0 = (warp * C::kRG + lane / C::kL) * RT;   // first row
  const int j0 = 4 * cl;                                // first column
  const int g = cl / C::kG, m = cl % C::kG;   // ends with row i0 + g's sums
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_ck = (t_len + kChunk - 1) / kChunk;
  const int n1 = n_ck - 1;                    // sweep 1's chunks
  const int n_items = n1 + n_ck;              // chunks staged, both sweeps

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], C::kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // staged item `it`: sweep 1's chunk it (k, w, v), then sweep 2's chunks
  // from the last (r, k, w, v, dO)
  auto load = [&](int it) {
    const int s = it % kStages;
    Stage<N>& st = sm.in[s];
    constexpr uint32_t kBox = kChunk * N * sizeof(float);
    if (it < n1) {
      const int t0 = it * kChunk;
      mbar_expect_tx(&sm.full[s], 3 * kBox);
      tma_load(st.k, &k_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.w, &w_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.v, &v_map, &sm.full[s], 0, t0, h, b);
    } else {
      const int t0 = (n_items - 1 - it) * kChunk;
      mbar_expect_tx(&sm.full[s], 5 * kBox);
      tma_load(st.r, &r_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.k, &k_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.w, &w_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.v, &v_map, &sm.full[s], 0, t0, h, b);
      tma_load(st.dout, &do_map, &sm.full[s], 0, t0, h, b);
    }
  };
  auto acquire = [&](int it) -> const Stage<N>& {
    mbar_wait(&sm.full[it % kStages], (it / kStages) & 1);
    return sm.in[it % kStages];
  };
  // every thread is done with item it's stage: thread 0 refills it
  auto release = [&](int it) {
    const int s = it % kStages;
    mbar_arrive(&sm.empty[s]);
    if (tid == 0 && it + kStages < n_items) {
      mbar_wait(&sm.empty[s], (it / kStages) & 1);
      load(it + kStages);
    }
  };
  if (tid == 0)
    for (int it = 0; it < kStages && it < n_items; ++it) load(it);

  // one step forward on this thread's tile: dst = w_t src + k_t^T v_t
  auto advance = [&](const Stage<N>& st, int t, const float (&src)[RT][4],
                     float (&dst)[RT][4]) {
    float kk[RT], ww[RT], vv[4];
    load_f(&st.k[t][i0], kk);
    load_f(&st.w[t][i0], ww);
    load_f(&st.v[t][j0], vv);
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[q][j] = fmaf(ww[q], src[q][j], kk[q] * vv[j]);
  };

  float4* ck = reinterpret_cast<float4*>(
      ckpt + ((int64_t)b * n_heads + h) * n1 * N * N +
      (int64_t)i0 * N + j0);
  constexpr int kCkStride = N * N / 4;   // float4s a checkpoint
  auto put_ckpt = [&](int c, const float (&x)[RT][4]) {
#pragma unroll
    for (int q = 0; q < RT; ++q)
      ck[c * kCkStride + q * N / 4] = make_float4(x[q][0], x[q][1], x[q][2],
                                                  x[q][3]);
  };

  // this thread's tile to and from a thread-major buffer of shared memory
  auto to_smem = [&](const float (&x)[RT][4], float4 (&d)[RT][C::kThreads]) {
#pragma unroll
    for (int q = 0; q < RT; ++q)
      d[q][tid] = make_float4(x[q][0], x[q][1], x[q][2], x[q][3]);
  };
  auto from_smem = [&](const float4 (&d)[RT][C::kThreads], float (&x)[RT][4]) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const float4 v4 = d[q][tid];
      x[q][0] = v4.x;
      x[q][1] = v4.y;
      x[q][2] = v4.z;
      x[q][3] = v4.w;
    }
  };

  // sweep 1: the state at the start of every chunk
  float S[RT][4];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[q][j] = 0.f;
  for (int it = 0; it < n1; ++it) {
    put_ckpt(it, S);
    const Stage<N>& st = acquire(it);
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) advance(st, t, S, S);
    release(it);
  }
  to_smem(S, sm.ck[0]);                // the last chunk's first state

  // sweep 2
  const float u_row = u[h * N + i0 + g];
  constexpr int kPreRows = N / C::kPer, kPreCols = N / C::kPer;
  const int pre_t = tid / C::kPer, pre_p = tid % C::kPer;
  float u_pre[kPreRows];
#pragma unroll
  for (int q = 0; q < kPreRows; ++q)
    u_pre[q] = u[h * N + pre_p * kPreRows + q];
  // where this lane's dv values land after dv_up, and whether it stores
  constexpr int kKeep = 4 / C::kRG > 0 ? 4 / C::kRG : 1;
  int dv_col = j0;
  bool dv_writer = true;
  {
    int nv = 4;
    for (int off = C::kL; off < 32; off <<= 1) {
      if (nv > 1) {
        nv /= 2;
        if (lane & off) dv_col += nv;
      } else if (lane & off) {
        dv_writer = false;
      }
    }
  }
  float* outp[3] = {dr + b * drs.b + h * drs.h + i0 + g,
                    dk + b * dks.b + h * dks.h + i0 + g,
                    dw + b * dws.b + h * dws.h + i0 + g};
  const int64_t outt[3] = {drs.t, dks.t, dws.t};

  // dv for chunk j's steps: the warps' partials summed in order
  auto sum_dv = [&](int j) {
    const int t0 = (n_ck - 1 - j) * kChunk;
    for (int e = tid; e < kChunk * N / 4; e += C::kThreads) {
      const int t = e / (N / 4), col = 4 * (e % (N / 4));
      const float* p = &sm.part[j & 1][t][0][col];
      float4 acc = *reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int wp = 1; wp < C::kWarps; ++wp) {
        const float4 x = *reinterpret_cast<const float4*>(p + wp * N);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      if (t0 + t < t_len)
        *reinterpret_cast<float4*>(dv + b * dvs.b + h * dvs.h +
                                   (int64_t)(t0 + t) * dvs.t + col) = acc;
    }
  };

  float G[RT][4];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) G[q][j] = 0.f;
  float du = 0.f;
  float st_[kSub][RT][4];   // a sub-chunk's states S_{t-1}

  // step t's partial sums over the thread's tile (x: its rows' dr, dk, dw;
  // y: dv's over its rows), then G_t -> G_{t-1}
  auto partials = [&](const Stage<N>& st, int t, const float (&sp)[RT][4],
                      float (&x)[3 * RT], float (&y)[4]) {
    float rr[RT], kk[RT], ww[RT], vv[4], dd[4];
    load_f(&st.r[t][i0], rr);
    load_f(&st.k[t][i0], kk);
    load_f(&st.w[t][i0], ww);
    load_f(&st.v[t][j0], vv);
    load_f(&st.dout[t][j0], dd);
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      float xr = dd[0] * sp[q][0], xk = G[q][0] * vv[0];
      float xw = G[q][0] * sp[q][0];
#pragma unroll
      for (int jj = 1; jj < 4; ++jj) {
        xr = fmaf(dd[jj], sp[q][jj], xr);
        xk = fmaf(G[q][jj], vv[jj], xk);
        xw = fmaf(G[q][jj], sp[q][jj], xw);
      }
      x[3 * q] = xr;
      x[3 * q + 1] = xk;
      x[3 * q + 2] = xw;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float acc = G[0][jj] * kk[0];
#pragma unroll
      for (int q = 1; q < RT; ++q) acc = fmaf(G[q][jj], kk[q], acc);
      y[jj] = acc;
    }
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        G[q][jj] = fmaf(ww[q], G[q][jj], rr[q] * dd[jj]);
  };

  // step t's sums across the lanes, u's terms, and its stores: dr, dk, dw
  // to device memory, the warp's dv partial to shared memory
  auto finish = [&](const Stage<N>& st, int s, int j, int t,
                    float (&x)[3 * RT], float (&y)[4]) {
    scatter_down<3 * RT / 2, C::kL / 2, C::kG>(x, lane);
    allreduce_down<3, C::kG / 2>(x);
    dv_up<4, C::kL>(y, lane);

    const float ri = st.r[t][i0 + g], ki = st.k[t][i0 + g];
    const float at = sm.a[s][t];
    const int tt = (n_ck - 1 - j) * kChunk + t;
    if (tt < t_len) {
      const float val[3] = {fmaf(u_row * ki, at, x[0]),
                            fmaf(ri * u_row, at, x[1]), x[2]};
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (q % C::kG == m) outp[q][tt * outt[q]] = val[q];
    }
    du = fmaf(ri * ki, at, du);
    float* pp = &sm.part[j & 1][t][warp][dv_col];
    if (warp == 0) {
      const float ct = sm.c[s][t];
#pragma unroll
      for (int e = 0; e < kKeep; ++e)
        y[e] = fmaf(st.dout[t][dv_col + e], ct, y[e]);
    }
    if (dv_writer) {
      if constexpr (kKeep == 2)
        *reinterpret_cast<float2*>(pp) = make_float2(y[0], y[1]);
      else
        *pp = y[0];
    }
  };

  // the steps base + kSub - 1 .. base of chunk j (stage s), backwards
  auto backward = [&](const Stage<N>& st, int s, int j, int base) {
#pragma unroll
    for (int sub = kSub - 1; sub >= 0; --sub) {
      float x[3 * RT], y[4];
      partials(st, base + sub, st_[sub], x, y);
      finish(st, s, j, base + sub, x, y);
    }
  };

  for (int j = 0; j < n_ck; ++j) {
    const int it = n1 + j, s = it % kStages, c = n_ck - 1 - j;
    const Stage<N>& st = acquire(it);
    // prologue: a_t = dO_t . v_t and c_t = sum_i r_t[i] u[i] k_t[i]
    {
      float a = 0.f, cc = 0.f;
#pragma unroll
      for (int q = 0; q < kPreCols; ++q)
        a = fmaf(st.dout[pre_t][pre_p * kPreCols + q],
                 st.v[pre_t][pre_p * kPreCols + q], a);
#pragma unroll
      for (int q = 0; q < kPreRows; ++q) {
        const int i = pre_p * kPreRows + q;
        cc = fmaf(st.r[pre_t][i] * u_pre[q], st.k[pre_t][i], cc);
      }
#pragma unroll
      for (int off = 1; off < C::kPer; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        cc += __shfl_xor_sync(0xffffffffu, cc, off);
      }
      if (pre_p == 0) {
        sm.a[s][pre_t] = a;
        sm.c[s][pre_t] = cc;
      }
    }
    __syncthreads();

    // the chunk's first state (sweep 1's last, or prefetched a chunk ago);
    // the next chunk's comes in meanwhile
    float4 (&first)[RT][C::kThreads] = sm.ck[j & 1];
    if (j > 0) cp_async_wait();
    if (c > 0) {                       // the next chunk's, in flight
#pragma unroll
      for (int q = 0; q < RT; ++q)
        cp_async16(&sm.ck[(j + 1) & 1][q][tid],
                   &ck[(c - 1) * kCkStride + q * N / 4]);
      cp_async_commit();
    }
    // the later sub-chunk: its first state, then its states
    from_smem(first, st_[0]);
#pragma unroll
    for (int t = 0; t < kSub; ++t) advance(st, t, st_[0], st_[0]);
#pragma unroll
    for (int sub = 1; sub < kSub; ++sub)
      advance(st, kSub + sub - 1, st_[sub - 1], st_[sub]);
    // the last chunk's dv, its partials all stored before the prologue's
    // barrier
    if (j > 0) sum_dv(j - 1);
    backward(st, s, j, kSub);
    // the earlier sub-chunk
    from_smem(first, st_[0]);
#pragma unroll
    for (int sub = 1; sub < kSub; ++sub)
      advance(st, sub - 1, st_[sub - 1], st_[sub]);
    backward(st, s, j, 0);
    release(it);
  }
  __syncthreads();
  sum_dv(n_ck - 1);
  if (m == 0) du_part[((int64_t)b * n_heads + h) * N + i0 + g] = du;
}

// A 4-d map over (N, T, H, B) of an f32 tensor given by element strides,
// read in boxes of [kChunk][N] (out of bounds, past T: zero).  False if the
// encoder refuses it (a stride that is not a multiple of 16 bytes, an
// unaligned base).
bool make_map(CUtensorMap* map, const float* ptr, int b, int h, int t, int n,
              Strides st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(t),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 4,
                                 static_cast<cuuint64_t>(st.h) * 4,
                                 static_cast<cuuint64_t>(st.b) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(n), kChunk, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's shared-memory limit (once per device: `configured`).
template <int N>
cudaError_t configure() {
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<N>()));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// Encode the maps (passed by value, so a captured CUDA graph keeps them),
// launch one CTA a (b, h).
template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* dout,
                   float* dr, float* dk, float* dv, float* dw,
                   float* du_part, float* ckpt, int B, int H, int T,
                   Strides st, Strides dst, Strides drs, Strides dks,
                   Strides dvs, Strides dws, cudaStream_t stream) {
  CUtensorMap rm, km, wm, vm, dm;
  if (!make_map(&rm, r, B, H, T, N, st) || !make_map(&km, k, B, H, T, N, st) ||
      !make_map(&wm, w, B, H, T, N, st) || !make_map(&vm, v, B, H, T, N, st) ||
      !make_map(&dm, dout, B, H, T, N, dst))
    return cudaErrorInvalidValue;
  const cudaError_t err = configure<N>();
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<N><<<dim3(H, B), Cfg<N>::kThreads, smem_bytes<N>(),
                       stream>>>(rm, km, wm, vm, dm, u, dr, dk, dv, dw,
                                 du_part, ckpt, H, T, drs, dks, dvs, dws);
  return cudaGetLastError();
}

// The dynamic shared memory a CTA asks for and the CTAs an SM holds.
template <int N>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = static_cast<int>(smem_bytes<N>());
  const cudaError_t err = configure<N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wkv6_bwd_kernel<N>, Cfg<N>::kThreads, smem_bytes<N>());
}

}  // namespace

// r, k, v, w, dout and dr, dk, dv, dw: [B, H, T, N] f32 given as element
// strides (batch, head, time), N contiguous; r, k, v and w share theirs
// (strides[0..2]), then dout's, dr's, dk's, dv's and dw's (strides[3..17]);
// the strides of r and dout and every base 16-byte aligned (TMA), and dv's
// too (16-byte stores).  u [H, N] contiguous; du_part [B, H, N] and ckpt
// [B, H, ceil(T/16) - 1, N, N] contiguous f32 (scratch).  One kernel, one
// CTA a (b, h).  Returns its launch's cudaError_t (cudaErrorInvalidValue
// for N other than 16, 32, 64, or strides or bases TMA refuses).
extern "C" int wkv6_bwd_launch(const float* r, const float* k,
                               const float* v, const float* w,
                               const float* u, const float* dout, float* dr,
                               float* dk, float* dv, float* dw,
                               float* du_part, float* ckpt, int B, int H,
                               int T, int N, const int64_t* strides,
                               void* stream) {
  Strides s[6];
  for (int q = 0; q < 6; ++q)
    s[q] = Strides{strides[3 * q], strides[3 * q + 1], strides[3 * q + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch<16>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                        B, H, T, s[0], s[1], s[2], s[3], s[4], s[5], st);
    case 32:
      return launch<32>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                        B, H, T, s[0], s[1], s[2], s[3], s[4], s[5], st);
    case 64:
      return launch<64>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                        B, H, T, s[0], s[1], s[2], s[3], s[4], s[5], st);
  }
  return cudaErrorInvalidValue;
}

// At head size N: the dynamic shared memory a CTA asks for and the CTAs an
// SM holds (CUDA's occupancy calculator).  Returns a cudaError_t
// (cudaErrorInvalidValue for N other than 16, 32, 64).
extern "C" int wkv6_bwd_occupancy(int N, int* smem, int* blocks) {
  switch (N) {
    case 16:
      return occupancy<16>(smem, blocks);
    case 32:
      return occupancy<32>(smem, blocks);
    case 64:
      return occupancy<64>(smem, blocks);
  }
  return cudaErrorInvalidValue;
}
