// The gradient of bf16 attention on Hopper's tensor cores (sm_90a): the
// "wgmma" route of flash_attention_bwd.cu, for bf16 at head dims 64, 128
// and 256, causal or full, with or without a sliding window.  It computes
// what that file's FMA kernels compute (see its header for the function
// and the reference it stands beside), from the forward's log-sum-exp
// instead of a recomputed max and sum: with lse_i the forward's
// log-sum-exp of row i's scaled logits (flash_attention_wgmma.cuh, kLse)
// and D_i = dO_i . o_i,
//   P_ij  = exp(scale s_ij - lse_i)   (0 where masked),
//   dS_ij = P_ij (dO_i . v_j - D_i)   (0 where masked),
//   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,
//   dQ_i = scale sum_j dS_ij k_j,
// and a row that sees no key (only with a window: i - (Sk - 1) >= window)
// has P = 1/Sk on every key and dS = 0, as jnp.where over the reference's
// NEG_INF logits gives.  Its lse is NEG_INF, which cannot carry its sum
// (log Sk is far below one ulp of the forward's 2^100 mask), so both
// kernels recognise such a row from its index.
//
// Bound: operations, as the FMA route's: 10 hd flops an unmasked pair and
// head at the bf16 tensor rate; this design runs 7 products of hd a pair
// (S and dP twice, once in each kernel) in exchange for no atomics.
//
// Design (three kernels on the stream, none with atomics, so a rerun gives
// the same bits):
//   * the row pass (fa_bwd_dot): D_i from the forward's bf16 o and dO, and
//     lse_i log2(e), into f32 stats [2][B][H][Sq_pad] with Sq_pad a
//     multiple of 128, +inf and 0 past Sq (P = 0 and dS = 0 there); HD/8
//     threads a row read 16 bytes each;
//   * dK/dV (fa_bwd_dkdv_wgmma): one block per (key tile, KV head, b), the
//     first key tiles first (under causal masking they see the most rows);
//     two consumer warpgroups and a producer warpgroup whose one thread
//     loads the K and V tiles once, then, for each query head of the group
//     and each 64-row query tile that sees the key tile (and the tiles that
//     hold a row that sees no key), the Q and dO tiles by TMA and their lse
//     and D by bulk copy, into a ring of mbarrier stages (4 at hd 64, 3 at
//     hd 128, 2 at hd 256); the group's query heads are summed in the
//     block, so each key row is written once, dK scaled at the end.
//     At hd 64 and 128 (consume_kv) the tile holds 128 keys, 64 a consumer
//     warpgroup, and each warpgroup runs S^T = K Q^T and dP^T = V dO^T as
//     wgmma with both operands in shared memory, P^T and dS^T on the
//     accumulator fragments (lse and D a column), then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T packed to bf16 as the A operand from
//     registers and dO and Q read through the transposed (N-major)
//     descriptor.  A consumer thread holds dK and dV (hd/2 f32 each), S^T
//     and dP^T (32 each) and their bf16 pairs: 192 registers at hd 128 of
//     the 240 that setmaxnreg gives it, and 320 at hd 256.  So at hd 256
//     (consume_kv_split) the tile holds 64 keys and the two warpgroups
//     split the products on them: warpgroup 0 runs S^T, P^T and
//     dV += P^T dO, warpgroup 1 dP^T, dS^T and dK += dS^T Q, and P^T passes
//     from 0 to 1 in f32 through shared memory, each thread's fragment in
//     one column of a [32][128] buffer (named barriers 1, full, and 2,
//     empty), so dS = P (dP - D) is the narrower tiles' product of the
//     same f32 values; a thread holds one accumulator of 128 f32, a
//     64 x 64 fragment and its bf16 pairs;
//   * dQ (fa_bwd_dq_wgmma): one block per (128-row query tile, h, b), the
//     forward's shape with one more product: the producer loads Q and dO
//     once and the key tiles (128 keys at hd 64, 64 at hd 128, 32 at
//     hd 256, where Q and dO take 128 KB) of K and V into a ring of 3
//     stages; S = Q K^T and dP = dO V^T with both operands in shared
//     memory, dS on the fragments (lse and D a row, in registers),
//     dQ += dS K with the K tile read as the forward reads V; the key tiles
//     are visited in order.
// Masks run only on the tiles that need them (the diagonal, Sq's and Sk's
// ends, the window's edges, a tile holding a row that sees no key); TMA
// zero-fills past Sq and Sk.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace fa_bwd_wgmma {

using namespace tma;
using bf16 = __nv_bfloat16;
using fa_wgmma::desc_sw128;
using fa_wgmma::exp2_ftz;
using fa_wgmma::fence_regs;
using fa_wgmma::kBox;
using fa_wgmma::kConsumerRegs;
using fa_wgmma::kConsumerWarps;
using fa_wgmma::kLog2e;
using fa_wgmma::kProducerRegs;
using fa_wgmma::kThreads;
using fa_wgmma::make_map;
using fa_wgmma::pack_bf16;
using fa_wgmma::pack_p;
using fa_wgmma::release;
using fa_wgmma::Strides;
using fa_wgmma::wgmma_commit;
using fa_wgmma::wgmma_fence;
using fa_wgmma::wgmma_rs;
using fa_wgmma::wgmma_ss;
using fa_wgmma::wgmma_wait;

constexpr int kPad = 128;   // the stats' rows: Sq rounded up to this

// D[64x32] (+)= A[64x16] . B[16x32]; A and B from shared memory, both
// K-major (no transpose): S and dP over dQ's 32-key tiles at hd 256.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The P^T hand-off between dK/dV's warpgroups at hd 256 (named barriers
// of both consumer warpgroups' 256 threads; 0 is __syncthreads').
constexpr int kPFull = 1, kPEmpty = 2;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------------------
// the row pass
// ---------------------------------------------------------------------------

// stats[0][b][h][i] = lse_i log2(e) (+inf past Sq), stats[1][b][h][i] = D_i
// (0 past Sq), for the rows < Sq_pad; HD/8 threads a row.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_dot(const bf16* __restrict__ o, const bf16* __restrict__ dout,
           const float* __restrict__ lse, float* __restrict__ stats,
           int heads, int sq, int sq_pad, int64_t rows, Strides os,
           Strides dos) {
  constexpr int kTPR = HD / 8;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kTPR;
  const int t = threadIdx.x % kTPR;
  const int i = static_cast<int>(row % sq_pad);
  const int64_t bh = row / sq_pad;
  const int b = static_cast<int>(bh / heads), h = static_cast<int>(bh % heads);
  float d = 0.f;
  if (row < rows && i < sq) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * os.b + static_cast<int64_t>(i) * os.s + h * os.h + 8 * t);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h +
        8 * t);
    const bf16* xs = reinterpret_cast<const bf16*>(&x);
    const bf16* ys = reinterpret_cast<const bf16*>(&y);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d = fmaf(__bfloat162float(xs[e]), __bfloat162float(ys[e]), d);
  }
#pragma unroll
  for (int off = 1; off < kTPR; off <<= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (row < rows && t == 0) {
    stats[row] = i < sq ? lse[bh * sq + i] * kLog2e : INFINITY;
    stats[rows + row] = d;
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

// A block's 128 keys (64 a consumer warpgroup) and V rows, then a ring of
// steps of 64 query rows: Q, dO (each hd/64 boxes of [64][64] bf16, 128-byte
// swizzle) and their lse and D.
template <int HD>
struct KvSmem {
  static constexpr int kBK = 128;
  static constexpr int kBQ = 64;
  static constexpr int kStages = HD == 64 ? 4 : 3;
  bf16 k[kBK * HD];
  bf16 v[kBK * HD];
  bf16 q[kStages][kBQ * HD];
  bf16 dout[kStages][kBQ * HD];
  float lse[kStages][kBQ];
  float dd[kStages][kBQ];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// At hd 256 a block's 64 keys, shared by both consumer warpgroups, two
// stages (Q and dO take 64 KB a stage) and the P^T hand-off from
// warpgroup 0 to 1: p[i][t] is fragment register i of thread t.
template <>
struct KvSmem<256> {
  static constexpr int kBK = 64;
  static constexpr int kBQ = 64;
  static constexpr int kStages = 2;
  bf16 k[kBK * 256];
  bf16 v[kBK * 256];
  bf16 q[kStages][kBQ * 256];
  bf16 dout[kStages][kBQ * 256];
  float lse[kStages][kBQ];
  float dd[kStages][kBQ];
  float p[kBQ / 2][128];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// The query tiles (of kBQ rows) that visit a key tile [k0, k0 + kBK), for
// each query head of its group: [a0, a1), the tiles holding a row that may
// see one of its keys, then [b0, n_qt), those holding a row that sees no
// key (only with a window; such a row spreads 1/Sk over every key).
struct Span {
  int a0, a1, b0, n_qt;
  __device__ __forceinline__ int count() const {
    return a1 - a0 + n_qt - b0;
  }
  __device__ __forceinline__ int at(int n) const {
    return n < a1 - a0 ? a0 + n : b0 + n - (a1 - a0);
  }
};

template <int kBQ, int kBK, bool kWindow>
__device__ __forceinline__ Span span_of(int k0, int sq, int sk, int causal,
                                        int window) {
  Span sp;
  sp.n_qt = (sq + kBQ - 1) / kBQ;
  const int k_last = min(k0 + kBK, sk) - 1;
  // rows before the tile's first key see none of it (causal); with a
  // window, rows from k_last + window on see none either
  const int lo = causal ? k0 : 0;
  const int hi = kWindow ? min(sq, k_last + window) : sq;
  sp.a0 = lo < hi ? lo / kBQ : 0;
  sp.a1 = lo < hi ? (hi + kBQ - 1) / kBQ : 0;
  sp.b0 = sp.n_qt;
  if (kWindow && sk + window - 1 < sq)
    sp.b0 = min(sp.n_qt, max((sk + window - 1) / kBQ, sp.a1));
  return sp;
}

// The producer: one thread loads K and V once, then each step's Q, dO,
// lse and D, waiting for the consumers to release a stage first.  Step n
// is query head g group + n / count, tile at(n % count).
template <int HD>
__device__ __forceinline__ void produce_kv(
    KvSmem<HD>& sm, const CUtensorMap* q_map, const CUtensorMap* do_map,
    const CUtensorMap* k_map, const CUtensorMap* v_map,
    const float* __restrict__ stats, int64_t plane, int heads, int group,
    int sq_pad, int k0, int g, int b, Span sp) {
  using S = KvSmem<HD>;
  constexpr int kBoxes = HD / kBox;
  const int n_tiles = sp.count();
  if (n_tiles == 0) return;
  mbar_expect_tx(&sm.kv_full, 2 * S::kBK * HD * 2);
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    tma_load(sm.k + c * S::kBK * kBox, k_map, &sm.kv_full, c * kBox, k0, g,
             b);
    tma_load(sm.v + c * S::kBK * kBox, v_map, &sm.kv_full, c * kBox, k0, g,
             b);
  }
  for (int n = 0; n < group * n_tiles; ++n) {
    const int s = n % S::kStages;
    const int h = g * group + n / n_tiles;
    const int i0 = sp.at(n % n_tiles) * S::kBQ;
    mbar_wait(&sm.empty[s], ((n / S::kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * S::kBQ * HD * 2 + 2 * S::kBQ * 4);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_load(sm.q[s] + c * S::kBQ * kBox, q_map, &sm.full[s], c * kBox, i0,
               h, b);
      tma_load(sm.dout[s] + c * S::kBQ * kBox, do_map, &sm.full[s],
               c * kBox, i0, h, b);
    }
    const float* row = stats + (static_cast<int64_t>(b) * heads + h) * sq_pad
                       + i0;
    bulk_load(sm.lse[s], row, S::kBQ * 4, &sm.full[s]);
    bulk_load(sm.dd[s], row + plane, S::kBQ * 4, &sm.full[s]);
  }
}

// A consumer warpgroup: keys [k0 + 64 wg, k0 + 64 wg + 64).  A thread holds
// keys kw0 + r0 and kw0 + r0 + 8, and in S^T the query columns
// 8 j + c0 + {0, 1}.
template <int HD, bool kWindow>
__device__ __forceinline__ void consume_kv(
    KvSmem<HD>& sm, bf16* __restrict__ dk, bf16* __restrict__ dv,
    Strides dks, Strides dvs, int sq, int sk, float scale, float scale_log2,
    int causal, int window, int group, int k0, int g, int b, Span sp,
    int warp, int lane) {
  using S = KvSmem<HD>;
  constexpr int kBQ = S::kBQ;
  const int wg = warp / 4;
  const int kw0 = k0 + wg * 64;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int kj[2] = {kw0 + r0, kw0 + r0 + 8};
  const bf16* k_wg = sm.k + wg * 64 * kBox;
  const bf16* v_wg = sm.v + wg * 64 * kBox;
  const float inv_sk = 1.f / static_cast<float>(sk);
  const int blind0 = sk + window - 1;   // rows from here on see no key

  float dka[HD / 2], dva[HD / 2];   // dK, dV: [64 keys x HD]
  float st[kBQ / 2], dpt[kBQ / 2];  // S^T then P^T, dP^T then dS^T
  uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];   // P^T, dS^T as A operands
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) st[i] = dpt[i] = 0.f;

  const int n_tiles = sp.count();
  if (n_tiles > 0) mbar_wait(&sm.kv_full, 0);
  for (int n = 0; n < group * n_tiles; ++n) {
    const int s = n % S::kStages;
    const int i0 = sp.at(n % n_tiles) * kBQ;
    mbar_wait(&sm.full[s], (n / S::kStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T, each hd/16 wgmma (both K-major)
    wgmma_fence();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 16;
      wgmma_ss(st, desc_sw128(k_wg + box * S::kBK * kBox + col, 16),
               desc_sw128(sm.q[s] + box * kBQ * kBox + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 16;
      wgmma_ss(dpt, desc_sw128(v_wg + box * S::kBK * kBox + col, 16),
               desc_sw128(sm.dout[s] + box * kBQ * kBox + col, 16), kk > 0);
    }
    wgmma_commit();
    // the mask runs on the diagonal, Sq's end, the window's lower edge and
    // the tiles holding a row that sees no key
    const bool edge = (causal && i0 < kw0 + 63) || i0 + kBQ > sq ||
                      (kWindow && (i0 + kBQ - 1 - kw0 >= window ||
                                   i0 + kBQ - 1 >= blind0));
    wgmma_wait<1>();   // S^T is done; dP^T may still run
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][j * 8 + c0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(st[j * 4 + e], scale_log2,
                                -((e & 1) ? l2.y : l2.x)));
        if (edge) {
          const int qi = i0 + j * 8 + c0 + (e & 1), key = kj[e >> 1];
          const bool vis = qi < sq && !(causal && key > qi) &&
                           !(kWindow && qi - key >= window);
          const bool blind = kWindow && qi >= blind0 && qi < sq;
          p = vis ? p : (blind ? inv_sk : 0.f);
        }
        st[j * 4 + e] = p;
      }
    }
    wgmma_wait<0>();   // dP^T is done
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(&sm.dd[s][j * 8 + c0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ds = st[j * 4 + e] * (dpt[j * 4 + e] - ((e & 1) ? d2.y : d2.x));
        if (edge) {
          const int qi = i0 + j * 8 + c0 + (e & 1), key = kj[e >> 1];
          const bool vis = qi < sq && !(causal && key > qi) &&
                           !(kWindow && qi - key >= window);
          ds = vis ? ds : 0.f;
        }
        dpt[j * 4 + e] = ds;
      }
    }
    pack_p<kBQ>(pa, st);
    pack_p<kBQ>(da, dpt);
    // dV += P^T dO and dK += dS^T Q: kBQ/16 wgmma each, A from registers,
    // dO and Q N-major (transposed) from shared memory
    wgmma_fence();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs(dva, pa[kk], desc_sw128(sm.dout[s] + kk * 16 * kBox,
                                       kBQ * kBox * 2), 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs(dka, da[kk], desc_sw128(sm.q[s] + kk * 16 * kBox,
                                       kBQ * kBox * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    release(&sm.empty[s], lane);
  }

  // each key row once: dK scaled, dV, bf16 pairs through the strides
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= sk) continue;
    bf16* krow = dk + b * dks.b + static_cast<int64_t>(kj[r]) * dks.s +
                 g * dks.h + c0;
    bf16* vrow = dv + b * dvs.b + static_cast<int64_t>(kj[r]) * dvs.s +
                 g * dvs.h + c0;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(krow + jj * 8) = pack_bf16(
          dka[jj * 4 + 2 * r] * scale, dka[jj * 4 + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + jj * 8) =
          pack_bf16(dva[jj * 4 + 2 * r], dva[jj * 4 + 2 * r + 1]);
    }
  }
}

// At hd 256: both consumer warpgroups on keys [k0, k0 + 64), a thread
// holding keys k0 + r0 and k0 + r0 + 8 and query columns 8 j + c0 + {0, 1}.
// Warpgroup 0 runs S^T = K Q^T, P^T and dV += P^T dO and hands P^T over;
// warpgroup 1 runs dP^T = V dO^T, takes P^T, forms dS^T and dK += dS^T Q.
// Each writes its accumulator's key rows in bf16 at the end.
template <bool kWindow>
__device__ __forceinline__ void consume_kv_split(
    KvSmem<256>& sm, bf16* __restrict__ dk, bf16* __restrict__ dv,
    Strides dks, Strides dvs, int sq, int sk, float scale, float scale_log2,
    int causal, int window, int group, int k0, int g, int b, Span sp,
    int warp, int lane) {
  constexpr int HD = 256;
  using S = KvSmem<HD>;
  constexpr int kBQ = S::kBQ;
  const int wg = warp / 4;
  const int t = (warp % 4) * 32 + lane;   // the thread in its warpgroup
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int kj[2] = {k0 + r0, k0 + r0 + 8};
  const float inv_sk = 1.f / static_cast<float>(sk);
  const int blind0 = sk + window - 1;   // rows from here on see no key
  // the first product's A operand: K (warpgroup 0) or V (1)
  const bf16* a_tile = wg == 0 ? sm.k : sm.v;

  float acc[HD / 2];            // dV (0) or dK (1): [64 keys x HD]
  float f[kBQ / 2];             // S^T then P^T (0); dP^T then dS^T (1)
  uint32_t fa[kBQ / 16][4];     // P^T or dS^T as the A operand
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) f[i] = 0.f;

  const int n_tiles = sp.count();
  const int n_steps = group * n_tiles;
  if (n_steps > 0) mbar_wait(&sm.kv_full, 0);
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % S::kStages;
    const int i0 = sp.at(n % n_tiles) * kBQ;
    mbar_wait(&sm.full[s], (n / S::kStages) & 1);
    // the second product's B operand: dO (0) or Q (1), N-major
    const bf16* b1 = wg == 0 ? sm.q[s] : sm.dout[s];
    const bf16* b2 = wg == 0 ? sm.dout[s] : sm.q[s];
    // S^T = K Q^T (0) or dP^T = V dO^T (1): hd/16 wgmma (both K-major)
    wgmma_fence();
    fence_regs(f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 16;
      wgmma_ss(f, desc_sw128(a_tile + box * S::kBK * kBox + col, 16),
               desc_sw128(b1 + box * kBQ * kBox + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f);
    // the mask runs on the diagonal, Sq's end, the window's lower edge and
    // the tiles holding a row that sees no key
    const bool edge = (causal && i0 < k0 + 63) || i0 + kBQ > sq ||
                      (kWindow && (i0 + kBQ - 1 - k0 >= window ||
                                   i0 + kBQ - 1 >= blind0));
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(&sm.lse[s][j * 8 + c0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(f[j * 4 + e], scale_log2,
                                  -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int qi = i0 + j * 8 + c0 + (e & 1), key = kj[e >> 1];
            const bool vis = qi < sq && !(causal && key > qi) &&
                             !(kWindow && qi - key >= window);
            const bool blind = kWindow && qi >= blind0 && qi < sq;
            p = vis ? p : (blind ? inv_sk : 0.f);
          }
          f[j * 4 + e] = p;
        }
      }
      // warpgroup 1 has read the last step's P^T
      if (n > 0) named_sync(kPEmpty);
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) sm.p[i][t] = f[i];
      named_arrive(kPFull);
    } else {
      named_sync(kPFull);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(&sm.dd[s][j * 8 + c0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds = sm.p[j * 4 + e][t] *
                     (f[j * 4 + e] - ((e & 1) ? d2.y : d2.x));
          if (edge) {
            const int qi = i0 + j * 8 + c0 + (e & 1), key = kj[e >> 1];
            const bool vis = qi < sq && !(causal && key > qi) &&
                             !(kWindow && qi - key >= window);
            ds = vis ? ds : 0.f;
          }
          f[j * 4 + e] = ds;
        }
      }
      // (the last step's is never waited for)
      if (n + 1 < n_steps) named_arrive(kPEmpty);
    }
    pack_p<kBQ>(fa, f);
    // dV += P^T dO (0) or dK += dS^T Q (1): kBQ/16 wgmma, A from
    // registers, B N-major (transposed) from shared memory
    wgmma_fence();
    fence_regs(acc);
    fence_regs(fa);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs(acc, fa[kk], desc_sw128(b2 + kk * 16 * kBox,
                                       kBQ * kBox * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fa);
    release(&sm.empty[s], lane);
  }

  // each key row once: dV (0), dK scaled (1), bf16 pairs through the
  // strides
  const float mul = wg == 0 ? 1.f : scale;
  bf16* out = wg == 0 ? dv : dk;
  const Strides os = wg == 0 ? dvs : dks;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= sk) continue;
    bf16* row = out + b * os.b + static_cast<int64_t>(kj[r]) * os.s +
                g * os.h + c0;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(row + jj * 8) =
          pack_bf16(acc[jj * 4 + 2 * r] * mul, acc[jj * 4 + 2 * r + 1] * mul);
  }
}

template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const float* __restrict__ stats, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int sq, int sk, int heads,
                  int kv_heads, int batch, int sq_pad, Strides dks,
                  Strides dvs, float scale, float scale_log2, int causal,
                  int window) {
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "head dim 64, 128 or 256");
  using S = KvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // block w: KV head fastest, then batch, then the key tile (the first
  // tiles, which more rows see under causal masking, first)
  const int w = blockIdx.x;
  const int g = w % kv_heads;
  const int b = (w / kv_heads) % batch;
  const int k0 = (w / (kv_heads * batch)) * S::kBK;
  const int group = heads / kv_heads;
  const Span sp = span_of<S::kBQ, S::kBK, kWindow>(k0, sq, sk, causal, window);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the roles, never rejoined, so setmaxnreg holds
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0)
      produce_kv<HD>(sm, &q_map, &do_map, &k_map, &v_map, stats,
                     static_cast<int64_t>(batch) * heads * sq_pad, heads,
                     group, sq_pad, k0, g, b, sp);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    if constexpr (HD == 256)
      consume_kv_split<kWindow>(sm, dk, dv, dks, dvs, sq, sk, scale,
                                scale_log2, causal, window, group, k0, g, b,
                                sp, warp, lane);
    else
      consume_kv<HD, kWindow>(sm, dk, dv, dks, dvs, sq, sk, scale,
                              scale_log2, causal, window, group, k0, g, b,
                              sp, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// A block's 128 query rows of Q and dO (64 a consumer warpgroup), then a
// ring of key tiles of K and V: 128 keys at hd 64, 64 at hd 128 (so a
// consumer thread's S and dP take 64 registers together, beside dQ's 64),
// 32 at hd 256 (S and dP 32 beside dQ's 128; three stages and Q and dO
// take 224 KB).
template <int HD>
struct QSmem {
  static constexpr int kBQ = 128;
  static constexpr int kBK = HD == 64 ? 128 : HD == 128 ? 64 : 32;
  static constexpr int kStages = 3;
  bf16 q[kBQ * HD];
  bf16 dout[kBQ * HD];
  bf16 k[kStages][kBK * HD];
  bf16 v[kStages][kBK * HD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// The key tiles a query tile [q0, q0 + kBQ) visits: from the tile holding
// its first row's first windowed key to its last row's last key.  A row
// that sees no key has dQ = 0 and needs none.
template <int kBQ, int kBK, bool kWindow>
__device__ __forceinline__ int key_tiles(int q0, int sk, int causal,
                                         int window, int& k0) {
  k0 = kWindow ? (max(0, q0 - window + 1) / kBK) * kBK : 0;
  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  return kend > k0 ? (kend - k0 + kBK - 1) / kBK : 0;
}

template <int HD>
__device__ __forceinline__ void produce_q(
    QSmem<HD>& sm, const CUtensorMap* q_map, const CUtensorMap* do_map,
    const CUtensorMap* k_map, const CUtensorMap* v_map, int q0, int h, int g,
    int b, int k0, int n_tiles) {
  using S = QSmem<HD>;
  constexpr int kBoxes = HD / kBox;
  if (n_tiles == 0) return;
  mbar_expect_tx(&sm.q_full, 2 * S::kBQ * HD * 2);
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    tma_load(sm.q + c * S::kBQ * kBox, q_map, &sm.q_full, c * kBox, q0, h, b);
    tma_load(sm.dout + c * S::kBQ * kBox, do_map, &sm.q_full, c * kBox, q0,
             h, b);
  }
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % S::kStages;
    const int key = k0 + n * S::kBK;
    mbar_wait(&sm.empty[s], ((n / S::kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * S::kBK * HD * 2);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_load(sm.k[s] + c * S::kBK * kBox, k_map, &sm.full[s], c * kBox,
               key, g, b);
      tma_load(sm.v[s] + c * S::kBK * kBox, v_map, &sm.full[s], c * kBox,
               key, g, b);
    }
  }
}

// A consumer warpgroup: query rows [q0 + 64 wg, q0 + 64 wg + 64); a thread
// holds rows qi[0], qi[1] and in S the key columns 8 j + c0 + {0, 1}.
template <int HD, bool kWindow>
__device__ __forceinline__ void consume_q(
    QSmem<HD>& sm, const float* __restrict__ stats, int64_t plane,
    bf16* __restrict__ dq, Strides dqs, int sq, int sk, int heads,
    int sq_pad, float scale, float scale_log2, int causal, int window,
    int q0, int h, int b, int k0, int n_tiles, int warp, int lane) {
  using S = QSmem<HD>;
  constexpr int kBK = S::kBK;
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const int qi[2] = {qw0 + r0, qw0 + r0 + 8};
  const bf16* q_wg = sm.q + wg * 64 * kBox;
  const bf16* do_wg = sm.dout + wg * 64 * kBox;
  // the rows' lse log2(e) and D (rows < Sq_pad: the stats are padded)
  const float* st_row = stats + (static_cast<int64_t>(b) * heads + h) * sq_pad;
  const float lse2[2] = {st_row[qi[0]], st_row[qi[1]]};
  const float dsum[2] = {st_row[plane + qi[0]], st_row[plane + qi[1]]};

  float acc[HD / 2];          // dQ: [64 x HD]
  float sc[kBK / 2];          // S, then P: [64 x kBK]
  float dp[kBK / 2];          // dP, then dS
  uint32_t da[kBK / 16][4];   // dS as the A operand
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;

  if (n_tiles > 0) mbar_wait(&sm.q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % S::kStages;
    const int kb = k0 + n * kBK;
    mbar_wait(&sm.full[s], (n / S::kStages) & 1);
    // S = Q K^T and dP = dO V^T, hd/16 wgmma each (both K-major)
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 16;
      wgmma_ss(sc, desc_sw128(q_wg + box * S::kBQ * kBox + col, 16),
               desc_sw128(sm.k[s] + box * kBK * kBox + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 16;
      wgmma_ss(dp, desc_sw128(do_wg + box * S::kBQ * kBox + col, 16),
               desc_sw128(sm.v[s] + box * kBK * kBox + col, 16), kk > 0);
    }
    wgmma_commit();
    // the mask runs on the diagonal, Sk's end and the window's lower edge
    // (which also holds every row that sees no key)
    const bool edge = (causal && kb + kBK - 1 > qw0) || kb + kBK > sk ||
                      (kWindow && qw0 + 63 - kb >= window);
    wgmma_wait<1>();   // S is done; dP may still run
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
    wgmma_wait<0>();   // dP is done
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ds = sc[j * 4 + e] * (dp[j * 4 + e] - dsum[e >> 1]);
        if (edge) {
          const int key = kb + j * 8 + c0 + (e & 1), row = qi[e >> 1];
          const bool vis = key < sk && !(causal && key > row) &&
                           !(kWindow && row - key >= window);
          ds = vis ? ds : 0.f;
        }
        dp[j * 4 + e] = ds;
      }
    pack_p<kBK>(da, dp);
    // dQ += dS K: kBK/16 wgmma, dS from registers, K N-major (transposed)
    wgmma_fence();
    fence_regs(acc);
    fence_regs(da);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(acc, da[kk], desc_sw128(sm.k[s] + kk * 16 * kBox,
                                       kBK * kBox * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    release(&sm.empty[s], lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= sq) continue;
    bf16* qrow = dq + b * dqs.b + static_cast<int64_t>(qi[r]) * dqs.s +
                 h * dqs.h + c0;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(qrow + jj * 8) = pack_bf16(
          acc[jj * 4 + 2 * r] * scale, acc[jj * 4 + 2 * r + 1] * scale);
  }
}

template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const float* __restrict__ stats, bf16* __restrict__ dq,
                int sq, int sk, int heads, int kv_heads, int batch,
                int sq_pad, Strides dqs, float scale, float scale_log2,
                int causal, int window) {
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "head dim 64, 128 or 256");
  using S = QSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // block w: head fastest, then batch, then the query tile (under causal
  // masking the last tiles, which see the most keys, first)
  const int w = blockIdx.x;
  const int h = w % heads;
  const int b = (w / heads) % batch;
  const int z = w / (heads * batch);
  const int n_qt = (sq + S::kBQ - 1) / S::kBQ;
  const int q0 = (causal ? n_qt - 1 - z : z) * S::kBQ;
  const int g = h / (heads / kv_heads);
  int k0;
  const int n_tiles =
      key_tiles<S::kBQ, S::kBK, kWindow>(q0, sk, causal, window, k0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0)
      produce_q<HD>(sm, &q_map, &do_map, &k_map, &v_map, q0, h, g, b, k0,
                    n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    consume_q<HD, kWindow>(sm, stats,
                           static_cast<int64_t>(batch) * heads * sq_pad, dq,
                           dqs, sq, sk, heads, sq_pad, scale, scale_log2,
                           causal, window, q0, h, b, k0, n_tiles, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// Raise a kernel's shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

// The row pass, then dK/dV, then dQ, on the stream.  q, o, dout, dq
// [B,H,Sq,hd] and k, v, dk, dv [B,KV,Sk,hd] by element strides (TMA's
// alignment: every stride of a dim longer than 1 and every base 16-byte
// aligned); lse f32 [B,H,Sq] contiguous; stats f32 scratch of
// 2 B H Sq_pad.  Returns the first failure's cudaError_t (a map the
// encoder refuses is cudaErrorInvalidValue).
template <int HD, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* stats, const float* lse, int b, int h,
                   int kvh, int sq, int sk, Strides qs, Strides ks,
                   Strides vs, Strides os, Strides dos, Strides dqs,
                   Strides dks, Strides dvs, float scale, int causal,
                   int window, cudaStream_t stream) {
  using KS = KvSmem<HD>;
  using QS = QSmem<HD>;
  const int sq_pad = (sq + kPad - 1) / kPad * kPad;
  const int64_t rows = static_cast<int64_t>(b) * h * sq_pad;
  const int64_t dot_blocks = rows * (HD / 8) / 256;
  const int64_t kv_blocks =
      static_cast<int64_t>((sk + KS::kBK - 1) / KS::kBK) * kvh * b;
  const int64_t q_blocks =
      static_cast<int64_t>((sq + QS::kBQ - 1) / QS::kBQ) * h * b;
  if (dot_blocks > INT32_MAX || kv_blocks > INT32_MAX ||
      q_blocks > INT32_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!make_map(&kv_q, q, b, h, sq, HD, qs, KS::kBQ) ||
      !make_map(&kv_do, dout, b, h, sq, HD, dos, KS::kBQ) ||
      !make_map(&kv_k, k, b, kvh, sk, HD, ks, KS::kBK) ||
      !make_map(&kv_v, v, b, kvh, sk, HD, vs, KS::kBK) ||
      !make_map(&q_q, q, b, h, sq, HD, qs, QS::kBQ) ||
      !make_map(&q_do, dout, b, h, sq, HD, dos, QS::kBQ) ||
      !make_map(&q_k, k, b, kvh, sk, HD, ks, QS::kBK) ||
      !make_map(&q_v, v, b, kvh, sk, HD, vs, QS::kBK))
    return cudaErrorInvalidValue;
  constexpr size_t kv_smem = sizeof(KS) + 1024;   // room to align to 1024
  constexpr size_t q_smem = sizeof(QS) + 1024;
  constexpr int kMaxDevices = 64;
  static bool kv_ready[kMaxDevices] = {}, q_ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = allow_smem(fa_bwd_dkdv_wgmma<HD, kWindow>, kv_smem, &kv_ready[dev]);
  if (err == cudaSuccess)
    err = allow_smem(fa_bwd_dq_wgmma<HD, kWindow>, q_smem, &q_ready[dev]);
  if (err != cudaSuccess) return err;

  const float scale_log2 = scale * kLog2e;
  fa_bwd_dot<HD><<<static_cast<int>(dot_blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      stats, h, sq, sq_pad, rows, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_wgmma<HD, kWindow>
      <<<static_cast<int>(kv_blocks), kThreads, kv_smem, stream>>>(
          kv_q, kv_do, kv_k, kv_v, stats, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), sq, sk, h, kvh, b, sq_pad, dks, dvs, scale,
          scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_wgmma<HD, kWindow>
      <<<static_cast<int>(q_blocks), kThreads, q_smem, stream>>>(
          q_q, q_do, q_k, q_v, stats, static_cast<bf16*>(dq), sq, sk, h, kvh,
          b, sq_pad, dqs, scale, scale_log2, causal, window);
  return cudaGetLastError();
}

}  // namespace fa_bwd_wgmma
