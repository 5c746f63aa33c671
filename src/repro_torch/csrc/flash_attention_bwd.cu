// The gradient of causal or full grouped-query attention, optionally over a
// sliding window, for Hopper (sm_90a): dQ, dK and dV of
//   s_ij = (q_i . k_j) * scale,  masked to NEG_INF where causal && j > i
//                                or window && i - j >= window,
//   P = softmax(s) over j,  o_i = sum_j P_ij v_j
// given dO, with query head h reading KV head h / (H / KV).  The TPU
// kernel it stands beside, repro/kernels/flash_attention/kernel.py::
// flash_attention, has no backward: the reference differentiates the jnp
// attention (repro/models/attention.py::_sdpa_naive) with jax.grad.  So
// the function is that gradient, with jnp.where's: a masked logit gets no
// gradient, and a row that sees no key (i - (Sk - 1) >= window) spreads
// P = 1/Sk over every key, so its dV share is dO_i / Sk and its dQ is 0.
//
// With D_i = dO_i . o_i and dP_ij = dO_i . v_j:
//   dS_ij = P_ij (dP_ij - D_i)   (0 where masked),
//   dQ_i  = scale * sum_j dS_ij k_j,
//   dK_j  = scale * sum_i dS_ij q_i   (over the group's query heads too),
//   dV_j  = sum_i P_ij dO_i.
//
// Two routes share the entry point flash_attention_bwd_launch, and the
// caller names the route: "wgmma" (bf16 at head dims 64, 128 and 256, with
// or without a window: three kernels on the tensor cores that read the
// forward's log-sum-exp; see flash_attention_bwd_wgmma.cuh) and "fma"
// (below: f32 at every head dim, bf16 at 16 and 32).
//
// The FMA route's design (simple and right first; every product on the f32
// FMA units, f32 accumulation whatever the input type, outputs in the
// input type):
//   * the row pass, one 256-thread block per (query tile, h, b): each
//     query row recomputes its softmax's max m_i and sum l_i over the keys
//     it sees (a row that sees no key gets m = NEG_INF and l = Sk, the
//     plain version's uniform row) and D_i, into f32 scratch [3, B, H, Sq]
//     that the wrapper allocates (this route takes no log-sum-exp from the
//     forward);
//   * the dK/dV kernel, one block per (key tile, KV head, b): each key row
//     keeps k_j, v_j, dK_j and dV_j in registers and loops over the
//     group's query heads and over the query tiles that see the key tile
//     (staged in shared memory with their m, 1/l and D), so GQA's sums
//     need no atomics;
//   * the dQ kernel, one block per (query tile, h, b): each query row keeps
//     q_i, dO_i and dQ_i in registers and loops over the key tiles it sees
//     (K and V staged in shared memory).
//   A row belongs to kTPR neighbouring threads, each holding kMine float4
//   chunks of the head dim (16 values at hd >= 64, so a thread holds 64
//   values in the dK/dV kernel); the partial dot products are summed with
//   __shfl_xor_sync.  Nothing is summed with atomics or in an order that
//   depends on timing, so a rerun gives the same bits.
// Every tensor is addressed through (batch, seq, head) strides with the
// head dim contiguous, as the forward's.
//
// Bound: operations.  Five products of hd per unmasked (query, key) pair
// and head (S, dP, dV, dK, dQ; 10*hd flops), at the bf16 tensor rate in
// bf16; at smollm-135m's training shape (B 4, H 9, KV 3, S 4096, hd 64,
// causal) 1.93e11 flops, 0.195 ms at 989 TFLOP/s.  The FMA route
// recomputes S three times and dP twice (16*hd flops a pair) on the FMA
// units, far from that bound; the wgmma route runs 7 products of hd a
// pair on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf
constexpr int kThreads = 256;       // threads per block

// element strides along batch, sequence and head
using fa_wgmma::Strides;

// Tile shapes at head dim HD: threads per row, rows a block owns (query
// rows in the row pass and dQ, key rows in dK/dV), rows of the streamed
// tile staged in shared memory (kTile * HD * 8 bytes: at most 32 KB).
template <int HD>
struct Tile {
  static constexpr int kTPR = HD >= 128 ? HD / 16 : 4;
  static constexpr int kRows = kThreads / kTPR;
  static constexpr int kTile = HD >= 128 ? 4096 / HD : 64;
  static constexpr int kChunks = HD / 4;          // float4 chunks a row
  static constexpr int kMine = kChunks / kTPR;    // chunks a thread
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                     to_f32(p[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x, float c) {
  store(p, x.x * c);
  store(p + 1, x.y * c);
  store(p + 2, x.z * c);
  store(p + 3, x.w * c);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

template <int kTPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kTPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Whether query row i sees key j (j < sk is the caller's to check).
template <bool kWindow>
__device__ __forceinline__ bool sees(int i, int j, int causal, int window) {
  return !((causal && j > i) || (kWindow && i - j >= window));
}

// A row that sees no key: only with a window, when even key sk - 1 (the
// nearest one it could see) is window or more behind it.
template <bool kWindow>
__device__ __forceinline__ bool blind(int i, int sk, int window) {
  return kWindow && i - (sk - 1) >= window;
}

// The first key a query tile starting at q0 can see, rounded down to the
// staged tile (0 without a window).
template <bool kWindow, int kTile>
__device__ __forceinline__ int first_key(int q0, int window) {
  return kWindow ? (max(0, q0 - window + 1) / kTile) * kTile : 0;
}

// Stage rows [r0, r0 + kTile) of two [*, HD] tensors into shared memory
// as f32 (zero past n).
template <typename T, int HD, int kTile>
__device__ __forceinline__ void stage2(float4 (*a)[HD / 4],
                                       float4 (*b)[HD / 4], const T* abase,
                                       const T* bbase, int64_t as, int64_t bs,
                                       int r0, int n) {
  constexpr int kChunks = HD / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int j = e / kChunks, d = 4 * (e % kChunks), r = r0 + j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < n) {
      x = load4(abase + r * as + d);
      y = load4(bbase + r * bs + d);
    }
    a[j][d / 4] = x;
    b[j][d / 4] = y;
  }
}

// The row pass: m_i, l_i and D_i of every query row into
// stats[0..2][b][h][i].
template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ stats, int nh, int sq, int sk, int group,
            Strides qs, Strides ks, Strides os, Strides dos, float scale,
            int causal, int window) {
  using TT = Tile<HD>;
  constexpr int kTPR = TT::kTPR, kRows = TT::kRows, kTile = TT::kTile;
  constexpr int kMine = TT::kMine;
  __shared__ float4 k_tile[kTile][HD / 4];

  const int tid = threadIdx.x, t = tid % kTPR;
  const int q0 = blockIdx.x * kRows, qi = q0 + tid / kTPR;
  const int h = blockIdx.y, b = blockIdx.z, g = h / group;
  const bool live = qi < sq;

  float4 qr[kMine];
  float dsum = 0.f;
  const T* qrow = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
  const T* orow = o + b * os.b + (int64_t)qi * os.s + h * os.h;
  const T* drow = dout + b * dos.b + (int64_t)qi * dos.s + h * dos.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d = 4 * (t + kTPR * c);
    qr[c] = live ? load4(qrow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) dsum = dot4(load4(drow + d), load4(orow + d), dsum);
  }
  dsum = row_sum<kTPR>(dsum);

  float m = kNegInf, l = 0.f;
  const T* kbase = k + b * ks.b + g * ks.h;
  const int kend = causal ? min(sk, q0 + kRows) : sk;
  for (int k0 = first_key<kWindow, kTile>(q0, window); k0 < kend;
       k0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * (HD / 4); e += kThreads) {
      const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
      k_tile[j][d / 4] = k0 + j < sk ? load4(kbase + (k0 + j) * ks.s + d)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kMine; ++c)
        dot = dot4(qr[c], k_tile[j][t + kTPR * c], dot);
      dot = row_sum<kTPR>(dot);
      const int kj = k0 + j;
      if (kj < sk && sees<kWindow>(qi, kj, causal, window)) {
        // the online max and sum, one key at a time
        const float sj = dot * scale;
        if (sj > m) {
          l = fmaf(l, expf(m - sj), 1.f);
          m = sj;
        } else {
          l += expf(sj - m);
        }
      }
    }
  }
  if (!live || t != 0) return;
  if (blind<kWindow>(qi, sk, window)) {
    m = kNegInf;
    l = (float)sk;
  }
  const int64_t at = ((int64_t)b * nh + h) * sq + qi;
  const int64_t plane = (int64_t)gridDim.z * nh * sq;
  stats[at] = m;
  stats[plane + at] = l;
  stats[2 * plane + at] = dsum;
}

// dQ: one block per (query tile, h, b), the key tiles the tile sees.
template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ stats, T* __restrict__ dq, int nh,
          int sq, int sk, int group, Strides qs, Strides ks, Strides vs,
          Strides dos, Strides dqs, float scale, int causal, int window) {
  using TT = Tile<HD>;
  constexpr int kTPR = TT::kTPR, kRows = TT::kRows, kTile = TT::kTile;
  constexpr int kMine = TT::kMine;
  __shared__ float4 k_tile[kTile][HD / 4];
  __shared__ float4 v_tile[kTile][HD / 4];

  const int tid = threadIdx.x, t = tid % kTPR;
  const int q0 = blockIdx.x * kRows, qi = q0 + tid / kTPR;
  const int h = blockIdx.y, b = blockIdx.z, g = h / group;
  const bool live = qi < sq;

  float4 qr[kMine], dor[kMine], acc[kMine];
  const T* qrow = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
  const T* drow = dout + b * dos.b + (int64_t)qi * dos.s + h * dos.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d = 4 * (t + kTPR * c);
    qr[c] = live ? load4(qrow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dor[c] = live ? load4(drow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int64_t at = ((int64_t)b * nh + h) * sq + qi;
  const int64_t plane = (int64_t)gridDim.z * nh * sq;
  const float m = live ? stats[at] : 0.f;
  const float inv_l = live ? 1.f / stats[plane + at] : 0.f;
  const float dsum = live ? stats[2 * plane + at] : 0.f;

  const T* kbase = k + b * ks.b + g * ks.h;
  const T* vbase = v + b * vs.b + g * vs.h;
  const int kend = causal ? min(sk, q0 + kRows) : sk;
  for (int k0 = first_key<kWindow, kTile>(q0, window); k0 < kend;
       k0 += kTile) {
    __syncthreads();
    stage2<T, HD, kTile>(k_tile, v_tile, kbase, vbase, ks.s, vs.s, k0, sk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        sdot = dot4(qr[c], k_tile[j][t + kTPR * c], sdot);
        pdot = dot4(dor[c], v_tile[j][t + kTPR * c], pdot);
      }
      sdot = row_sum<kTPR>(sdot);
      pdot = row_sum<kTPR>(pdot);
      const int kj = k0 + j;
      const bool vis = kj < sk && sees<kWindow>(qi, kj, causal, window);
      const float p = vis ? expf(sdot * scale - m) * inv_l : 0.f;
      const float ds = p * (pdot - dsum);
#pragma unroll
      for (int c = 0; c < kMine; ++c) axpy4(ds, k_tile[j][t + kTPR * c],
                                            acc[c]);
    }
  }
  if (!live) return;
  T* out = dq + b * dqs.b + (int64_t)qi * dqs.s + h * dqs.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) store4(out + 4 * (t + kTPR * c), acc[c],
                                         scale);
}

// dK and dV: one block per (key tile, KV head, b), over the group's query
// heads and the query tiles that see the key tile.
template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int nh, int sq, int sk, int group,
            Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
            Strides dvs, float scale, int causal, int window) {
  using TT = Tile<HD>;
  constexpr int kTPR = TT::kTPR, kRows = TT::kRows, kTile = TT::kTile;
  constexpr int kMine = TT::kMine;
  __shared__ float4 q_tile[kTile][HD / 4];
  __shared__ float4 do_tile[kTile][HD / 4];
  __shared__ float m_tile[kTile], il_tile[kTile], d_tile[kTile];

  const int tid = threadIdx.x, t = tid % kTPR;
  const int j0 = blockIdx.x * kRows, kj = j0 + tid / kTPR;
  const int g = blockIdx.y, b = blockIdx.z;
  const int j_last = min(j0 + kRows, sk) - 1;
  const bool live = kj < sk;

  float4 kr[kMine], vr[kMine], dka[kMine], dva[kMine];
  const T* krow = k + b * ks.b + (int64_t)kj * ks.s + g * ks.h;
  const T* vrow = v + b * vs.b + (int64_t)kj * vs.s + g * vs.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d = 4 * (t + kTPR * c);
    kr[c] = live ? load4(krow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    vr[c] = live ? load4(vrow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }
  const int64_t plane = (int64_t)gridDim.z * nh * sq;
  // with causal masking no row before the key tile sees it
  const int qbegin = causal ? (j0 / kTile) * kTile : 0;
  for (int h = g * group; h < (g + 1) * group; ++h) {
    const T* qbase = q + b * qs.b + h * qs.h;
    const T* dbase = dout + b * dos.b + h * dos.h;
    const float* st = stats + ((int64_t)b * nh + h) * sq;
    for (int i0 = qbegin; i0 < sq; i0 += kTile) {
      const int i_last = min(i0 + kTile, sq) - 1;
      // skip a tile that sees none of the key tile, unless it holds a row
      // that sees no key (which spreads over every key)
      if (kWindow && i0 - j_last >= window && !blind<kWindow>(i_last, sk,
                                                              window))
        continue;
      __syncthreads();
      stage2<T, HD, kTile>(q_tile, do_tile, qbase, dbase, qs.s, dos.s, i0,
                           sq);
      for (int e = tid; e < kTile; e += kThreads) {
        const bool in = i0 + e < sq;
        m_tile[e] = in ? st[i0 + e] : 0.f;
        il_tile[e] = in ? 1.f / st[plane + i0 + e] : 0.f;
        d_tile[e] = in ? st[2 * plane + i0 + e] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int ii = 0; ii < kTile; ++ii) {
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int c = 0; c < kMine; ++c) {
          sdot = dot4(q_tile[ii][t + kTPR * c], kr[c], sdot);
          pdot = dot4(do_tile[ii][t + kTPR * c], vr[c], pdot);
        }
        sdot = row_sum<kTPR>(sdot);
        pdot = row_sum<kTPR>(pdot);
        const int qi = i0 + ii;
        const bool vis = sees<kWindow>(qi, kj, causal, window);
        // a masked logit is NEG_INF: P is 0 in a row that sees a key and
        // 1/Sk in one that sees none (m = NEG_INF, l = Sk); il is 0 past Sq
        const float p = expf((vis ? sdot * scale : kNegInf) - m_tile[ii])
                        * il_tile[ii];
        const float ds = vis ? p * (pdot - d_tile[ii]) : 0.f;
#pragma unroll
        for (int c = 0; c < kMine; ++c) {
          axpy4(p, do_tile[ii][t + kTPR * c], dva[c]);
          axpy4(ds, q_tile[ii][t + kTPR * c], dka[c]);
        }
      }
    }
  }
  if (!live) return;
  T* kout = dk + b * dks.b + (int64_t)kj * dks.s + g * dks.h;
  T* vout = dv + b * dvs.b + (int64_t)kj * dvs.s + g * dvs.h;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    store4(kout + 4 * (t + kTPR * c), dka[c], scale);
    store4(vout + 4 * (t + kTPR * c), dva[c], 1.f);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;
  int b, h, kvh, sq, sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal, window;
};

template <typename T, int HD, bool kWindow>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using TT = Tile<HD>;
  const int group = a.h / a.kvh;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 qgrid((a.sq + TT::kRows - 1) / TT::kRows, a.h, a.b);
  fa_bwd_rows<T, HD, kWindow><<<qgrid, kThreads, 0, stream>>>(
      q, k, o, dout, a.stats, a.h, a.sq, a.sk, group, a.qs, a.ks, a.os,
      a.dos, a.scale, a.causal, a.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((a.sk + TT::kRows - 1) / TT::kRows, a.kvh, a.b);
  fa_bwd_dkdv<T, HD, kWindow><<<kgrid, kThreads, 0, stream>>>(
      q, k, v, dout, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.h, a.sq, a.sk, group, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.scale, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, HD, kWindow><<<qgrid, kThreads, 0, stream>>>(
      q, k, v, dout, a.stats, static_cast<T*>(a.dq), a.h, a.sq, a.sk, group,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_window(const Args& a, cudaStream_t stream) {
  return a.window > 0 ? launch<T, HD, true>(a, stream)
                      : launch<T, HD, false>(a, stream);
}

// f32 at every head dim, bf16 at 16 and 32 (bf16 at 64, 128 and 256 is
// the wgmma route's).
template <typename T>
cudaError_t dispatch(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_window<T, 16>(a, stream);
    case 32: return launch_window<T, 32>(a, stream);
  }
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) {
      case 64: return launch_window<T, 64>(a, stream);
      case 128: return launch_window<T, 128>(a, stream);
      case 256: return launch_window<T, 256>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

// The wgmma route at head dim HD, with the window compiled in or out.
template <int HD, bool kWindow>
cudaError_t run_wgmma(const Args& a, const float* lse, cudaStream_t stream) {
  return fa_bwd_wgmma::launch<HD, kWindow>(
      a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv, a.stats, lse, a.b, a.h,
      a.kvh, a.sq, a.sk, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs,
      a.scale, a.causal, a.window, stream);
}

template <int HD>
cudaError_t launch_wgmma(const Args& a, const float* lse,
                         cudaStream_t stream) {
  return a.window > 0 ? run_wgmma<HD, true>(a, lse, stream)
                      : run_wgmma<HD, false>(a, lse, stream);
}

}  // namespace

// q [B,H,Sq,hd], k/v [B,KV,Sk,hd], o and dout [B,H,Sq,hd] (the forward's
// output and its gradient), dq [B,H,Sq,hd], dk/dv [B,KV,Sk,hd], each given
// as element strides (batch, seq, head) with the head dim contiguous;
// window 0 = none; dtype 0 = f32, 1 = bf16 (every tensor but stats and lse
// alike); route 0 = the FMA kernels (f32 at hd 16, 32, 64, 128 or 256,
// bf16 at 16 or 32; stats f32 scratch of 3*B*H*Sq; lse null), 1 = the
// wgmma kernels (bf16 at hd 64, 128 or 256; lse the forward's f32 [B,H,Sq]
// contiguous; stats f32 scratch of 2*B*H*Sq_pad, Sq_pad = Sq rounded up to
// 128; every stride of a dim longer than 1 and every base 16-byte aligned).
// Launches the route's kernels on the stream; returns the first launch's
// error (cudaErrorInvalidValue for arguments the route does not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats,
    const void* lse, int b, int h, int kvh, int sq, int sk, int hd,
    const int64_t* strides, float scale, int causal, int window, int dtype,
    int route, void* stream) {
  if (window < 0 || kvh <= 0 || h % kvh) return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.b = b; a.h = h; a.kvh = kvh; a.sq = sq; a.sk = sk;
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks,
                     &a.dvs};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const float* lse_f = static_cast<const float*>(lse);
    if (dtype != 1 || lse_f == nullptr) return cudaErrorInvalidValue;
    if (hd == 64) return launch_wgmma<64>(a, lse_f, st);
    if (hd == 128) return launch_wgmma<128>(a, lse_f, st);
    if (hd == 256) return launch_wgmma<256>(a, lse_f, st);
    return cudaErrorInvalidValue;
  }
  if (route != 0 || lse != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(hd, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, a, st);
  return cudaErrorInvalidValue;
}
