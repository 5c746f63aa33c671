// bf16 flash attention on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
// The route of repro_torch's flash_attention for bf16 at head dims 64, 128
// and 256, with or without a sliding window; f32 and bf16 at head dims 16
// and 32 keep the FMA kernel of flash_attention.cu.  Replaces, with it,
// the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention, and the window of the reference's _sdpa_naive/
// _sdpa_chunked (repro/models/attention.py), which that kernel lacks.
//
// For each (b, h, query row i), with g = h / (H / KV) the shared KV head:
//   s_j = q_i . k_j (f32),  masked to NEG_INF where causal && j > i
//                           or window && i - j >= window
//   o_i = sum_j p_j v_j / max(l, 1e-30),  p_j = exp(scale (s_j - m)),
// with the running max m, the running sum l and the accumulator in f32.
// P is rounded to bf16 for the P.V product (the tensor cores' A operand);
// l sums the f32 p.
//
// Bound: at the dense prefill's shapes and recurrentgemma's local
// attention, the tensor cores' bf16 rate (4 hd flops an unmasked
// query-key pair); see kernels/flash_attention/kernel.py.
//
// Design (FlashAttention-3's shape):
//   * a persistent grid, one block per SM, each block walking work items
//     (a 128-row query tile of one head and batch) in snake order; under
//     causal masking the items with the most key tiles come first;
//   * a block has two consumer warpgroups of 64 query rows each and a
//     producer warpgroup (384 threads) whose one thread starts the loads;
//     setmaxnreg moves registers from the producer (24 a thread) to the
//     consumers (240);
//   * the producer loads each item's Q, then its K/V tiles of kBK keys,
//     into a ring of stages in dynamic shared memory with TMA (4-d tensor
//     maps over (hd, seq, head, batch), 128-byte swizzle, so a row of hd
//     values is hd/64 boxes 64 wide); Q, each stage's K and each stage's V
//     have a full mbarrier (transaction bytes) and an empty one that the
//     8 consumer warps arrive on, so the next item's Q and K load while
//     the consumers finish the current one; TMA's zero fill gives the
//     ragged tails of Sq and Sk (keys past Sk are masked, since a zero key
//     gives s = 0, not NEG_INF);
//   * the tiles are traits of the head dim (Smem<HD>): 128 keys a stage
//     at hd 64 (4 stages) and 128 (2); at hd 256, 64 keys and 2 stages, so
//     Q (64 KB) and the ring (2 x (32 + 32) KB) fit the 227 KB a block may
//     use and a consumer thread holds O (128 f32), S (32) and P (16 bf16
//     pairs) within its 240 registers;
//   * S = Q.K^T is hd/16 wgmma m64n{kBK}k16 with both operands in shared
//     memory (K's rows with hd contiguous are the K-major B operand);
//   * the online softmax runs on S's accumulator fragments (each thread
//     holds two rows, a quad of threads shares a row), with ex2.approx and
//     the scale folded in as log2(e) hd^-0.5; the element mask runs only
//     on the diagonal tile, the tile that holds Sk's end and, with a
//     window, the tiles at the window's lower edge;
//   * O += P.V is kBK/16 wgmma m64n{hd}k16 with P from registers (the S
//     fragments, packed to bf16 pairs, are the A operand's layout) and V
//     from shared memory with the transpose bit (V is hd-contiguous);
//   * each step starts tile n's S and tile n-1's P.V together and runs
//     tile n's softmax while P.V is on the tensor cores; the two consumer
//     warpgroups take turns on the tensor cores (named barriers), so one's
//     softmax also overlaps the other's products;
//   * the window is a template flag, so a call without one compiles to
//     the code without it; with one, an item's key loop starts at the
//     tile holding its first row's first windowed key.  A row that sees
//     no key (i >= Sk + window - 1) averages every key, as the
//     reference's softmax over NEG_INF does, so an item holding one
//     visits every key tile: masked logits are kMasked, whose scaled
//     product is exact, so such a row gets p = 1 a key, and the epilogue
//     divides its sum by Sk (the zero-filled keys past Sk add 0 to O);
//   * the epilogue divides by l and stores bf16 pairs through the output's
//     strides, so the model layout [B,S,H,hd] needs no copy;
//   * when a gradient is wanted (the kLse template flag, at every head dim)
//     the epilogue also writes each row's log-sum-exp of its scaled logits,
//     lse = scale m + log l, into f32 [B, H, Sq] for the backward
//     (flash_attention_bwd_wgmma.cuh); a row that sees no key gets NEG_INF,
//     as the reference's logsumexp over NEG_INF logits gives (log Sk is far
//     below one ulp of 2^100, so the backward recognises such a row from
//     its index).  Without the flag the code is the flagless kernel's.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace fa_wgmma {

using namespace tma;

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf
// The windowed kernel's stand-in for NEG_INF: -2^100 times the folded
// scale is exact, so a row that has seen no key yet (m = kMasked) gets
// p = exp2(fma(s, scale, -m scale)) = 1 exactly for its masked keys, as
// the reference's softmax over NEG_INF does; past a seen key, p = 0 as
// with -1e30.
constexpr float kMasked = -0x1p100f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 128;            // query rows per block
constexpr int kConsumerWarps = 8;   // two warpgroups
// and a producer warpgroup, of which one thread starts the loads: the
// registers its setmaxnreg.dec gives back are the ones the consumers'
// setmaxnreg.inc takes (the pool is the block's own), so it must be whole
constexpr int kThreads = 32 * (kConsumerWarps + 4);
constexpr int kBox = 64;            // bf16 values in a 128-byte swizzled row

struct Strides {
  int64_t b, s, h;
};

// Q, then the K and V rings, each tile as hd/64 boxes of [rows][64] bf16,
// every box 1024-byte aligned (the 128-byte swizzle's period).  A stage's
// K and V are released apart: K once S = Q.K^T is done, V once P.V is; Q
// once the item's last S is done, so the next item's Q loads meanwhile.
template <int HD>
struct Smem {
  // keys per K/V stage and stages in the ring, beside Q within the 227 KB
  // a block may use: 128 keys at hd 64 (4 stages) and 128 (2; 3 fit too,
  // and measured no faster); 64 keys at hd 256 (2 stages, 192 KB), where
  // 128-key stages would not fit and an S of 128 keys would hold 32 more
  // registers a consumer thread
  static constexpr int kBK = HD == 256 ? 64 : 128;
  static constexpr int kStages = HD == 64 ? 4 : 2;
  __nv_bfloat16 q[kBQ * HD];
  __nv_bfloat16 k[kStages][kBK * HD];
  __nv_bfloat16 v[kStages][kBK * HD];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(Smem<HD>) + 1024;   // room to align the base to 1024
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading byte offset (the stride between 64-wide boxes of an
// N-major operand; ignored for K-major, where it is set to 16 as CUTLASS
// does) and stride byte offset 1024 (the stride between groups of 8 rows
// of 128 bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running; groups retire
// in order.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the asm statements that start and
// retire it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit alone (results below 2^-126 flush to
// zero; exp2f adds instructions to keep them).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64x128] (+)= A[64x16] . B[16x128]; A and B from shared memory, both
// K-major (no transpose).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x64] (+)= A[64x16] . B[16x64]; A and B from shared memory, both
// K-major (no transpose): S over the 64-key tiles of hd 256.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x128] += A[64x16] . B[16x128]; A from registers (bf16 pairs in the
// accumulator's fragment layout), B from shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64x64] += A[64x16] . B[16x64]; A from registers (bf16 pairs in the
// accumulator's fragment layout), B from shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64x256] += A[64x16] . B[16x256]; A from registers (bf16 pairs in the
// accumulator's fragment layout), B from shared memory N-major (transposed):
// O += P.V at hd 256.  FA_D8(i) names d[i..i+7] as operands.
#define FA_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56), FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88),
        FA_D8(96), FA_D8(104), FA_D8(112), FA_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef FA_D8

// One work item: a 128-row query tile of one (head, batch).  Items are
// numbered with the head fastest, then the batch, then the query tile,
// which runs in reverse under causal masking (the longest first); a block
// takes items in snake order (round r of gridDim.x items left to right
// when r is even, right to left when odd), which balances the decreasing
// causal lengths across the blocks.  Under MQA (one KV head) the heads'
// items in flight read the same K/V tiles, from L2.
struct Item {
  int h, b, q0, k0, n_tiles;   // k0: the first key tile's first key
};

__device__ __forceinline__ int item_of(int j) {   // this block's j-th item
  const int g = gridDim.x, c = blockIdx.x;
  return j * g + ((j & 1) ? g - 1 - c : c);
}

template <int kBK, bool kWindow>
__device__ __forceinline__ Item item_at(int w, int heads, int batch,
                                        int n_qt, int sq, int sk, int causal,
                                        int window) {
  Item it;
  it.h = w % heads;
  it.b = (w / heads) % batch;
  const int z = w / (heads * batch);
  it.q0 = (causal ? n_qt - 1 - z : z) * kBQ;
  // with causal masking, keys past the tile's last row are never seen
  const int kend = causal ? min(sk, it.q0 + kBQ) : sk;
  // with a window the tile's first row sees keys from q0 - window + 1; an
  // item holding a row that sees no key (its last stored row,
  // min(q0 + kBQ, sq) - 1, is window or more past Sk - 1) visits every key
  it.k0 = 0;
  if (kWindow && min(it.q0 + kBQ, sq) - window < sk)
    it.k0 = (max(0, it.q0 - window + 1) / kBK) * kBK;
  it.n_tiles = (kend - it.k0 + kBK - 1) / kBK;
  return it;
}

// The producer: one thread loads each item's Q and its K/V tiles into the
// ring, waiting for the consumers to release Q (or a stage's K or V)
// first.  Tile t counts across items, so the ring's stages and phases run
// on from one item to the next.
template <int HD, bool kWindow>
__device__ __forceinline__ void produce(Smem<HD>& sm, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int n_items,
                                        int heads, int batch, int n_qt,
                                        int group, int sq, int sk, int causal,
                                        int window) {
  constexpr int kBoxes = HD / kBox;
  constexpr int kBK = Smem<HD>::kBK;
  constexpr int kStages = Smem<HD>::kStages;
  constexpr uint32_t kTileBytes = kBK * HD * 2;
  int t = 0;
  for (int j = 0; item_of(j) < n_items; ++j) {
    const Item it = item_at<kBK, kWindow>(item_of(j), heads, batch, n_qt, sq,
                                          sk, causal, window);
    const int g = it.h / group;
    // the first item finds Q's buffer (and every stage) empty
    mbar_wait(&sm.q_empty, (j & 1) ^ 1);
    mbar_expect_tx(&sm.q_full, kBQ * HD * 2);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load(sm.q + c * kBQ * kBox, q_map, &sm.q_full, c * kBox, it.q0,
               it.h, it.b);
    for (int n = 0; n < it.n_tiles; ++n, ++t) {
      const int s = t % kStages;
      const uint32_t parity = ((t / kStages) & 1) ^ 1;
      const int key = it.k0 + n * kBK;
      mbar_wait(&sm.k_empty[s], parity);
      mbar_expect_tx(&sm.k_full[s], kTileBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sm.k[s] + c * kBK * kBox, k_map, &sm.k_full[s], c * kBox,
                 key, g, it.b);
      mbar_wait(&sm.v_empty[s], parity);
      mbar_expect_tx(&sm.v_full[s], kTileBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sm.v[s] + c * kBK * kBox, v_map, &sm.v_full[s], c * kBox,
                 key, g, it.b);
    }
  }
}

// S = Q.K^T over one key tile: hd/16 wgmma with both operands in shared
// memory (K-major); started, not waited for.
template <int HD>
__device__ __forceinline__ void start_qk(float (&sc)[Smem<HD>::kBK / 2],
                                         const __nv_bfloat16* q_wg,
                                         const __nv_bfloat16* k_tile) {
  constexpr int kBK = Smem<HD>::kBK;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk / 4, col = (kk % 4) * 16;
    wgmma_ss(sc, desc_sw128(q_wg + box * kBQ * kBox + col, 16),
             desc_sw128(k_tile + box * kBK * kBox + col, 16), kk > 0);
  }
  wgmma_commit();
}

// O += P.V over one key tile: kBK/16 wgmma with P from registers and V
// N-major from shared memory; started, not waited for.
template <int HD>
__device__ __forceinline__ void start_pv(
    float (&acc)[HD / 2], const uint32_t (&pa)[Smem<HD>::kBK / 16][4],
    const __nv_bfloat16* v_tile) {
  constexpr int kBK = Smem<HD>::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(acc, pa[kk], desc_sw128(v_tile + kk * 16 * kBox,
                                     kBK * kBox * 2), 1);
  wgmma_commit();
}

// The online softmax over the two rows a thread holds: mask (only on the
// diagonal tile, the tile that holds Sk's end and, with a window, the
// tiles at its lower edge), the new running max, alpha = exp(m_old -
// m_new), S replaced by p = exp(s - m_new) and l rescaled and summed (each
// thread sums its own columns; the quad's sums are added in the epilogue).
template <int kBK, bool kWindow>
__device__ __forceinline__ void online_softmax(
    float (&sc)[kBK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const int (&qi)[2], int c0, int k0, int q0, int sk, int causal,
    int window, float scale_log2) {
  if ((causal && k0 + kBK - 1 > q0) || k0 + kBK > sk ||
      (kWindow && q0 + kBQ - 1 - k0 >= window)) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + c0 + (e & 1);
        if (key >= sk || (causal && key > qi[e >> 1]) ||
            (kWindow && qi[e >> 1] - key >= window))
          sc[j * 4 + e] = kWindow ? kMasked : kNegInf;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[j * 4], sc[j * 4 + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
  }
  float mscaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);
    mscaled[r] = mx[r] * scale_log2;
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(sc[j * 4 + e], scale_log2,
                                 -mscaled[e >> 1]));
      sc[j * 4 + e] = p;
      l[e >> 1] += p;
    }
}

// P in bf16 pairs, in the A operand's fragment layout (which is the
// accumulator's: registers 8kk..8kk+7 of S are k-step kk's A fragment).
template <int kBK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4],
                                       const float (&sc)[kBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(sc[kk * 8 + e * 2], sc[kk * 8 + e * 2 + 1]);
}

// Ping-pong between the two consumer warpgroups: a warpgroup starts its
// wgmmas only in its turn (named barrier 1 + wg, both warpgroups' 256
// threads) and then hands the turn to the other, so that one warpgroup's
// softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// Release a stage's K or V: one arrival per consumer warp.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A consumer warpgroup: query rows [64 wg, 64 wg + 64) of each item.  Each
// step starts S = Q.K_n^T and O += P_{n-1}.V_{n-1} together (in its turn),
// waits for S only, and runs the softmax of tile n while P.V is on the
// tensor cores.
template <int HD, bool kWindow, bool kLse>
__device__ __forceinline__ void consume(Smem<HD>& sm, __nv_bfloat16* o,
                                        int sq, int sk, Strides os,
                                        float scale_log2, int causal,
                                        int window, int n_items, int heads,
                                        int batch, int n_qt, int warp,
                                        int lane, float* lse) {
  constexpr int kBK = Smem<HD>::kBK;
  constexpr int kStages = Smem<HD>::kStages;
  constexpr float kMask = kWindow ? kMasked : kNegInf;
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;   // and r0 + 8
  const int c0 = (lane % 4) * 2;   // this thread's first column of an n8
  const __nv_bfloat16* q_wg = sm.q + wg * 64 * kBox;

  float acc[HD / 2];          // O: [64 x HD] over the warpgroup
  float sc[kBK / 2];          // S, then p: [64 x kBK]
  uint32_t pa[kBK / 16][4];   // P as the A operand, bf16 pairs
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;

  if (wg == 1) pass_turn(wg);   // the first turn is warpgroup 0's
  int t = 0;                    // tiles consumed, across items
  for (int j = 0; item_of(j) < n_items; ++j) {
    const Item it = item_at<kBK, kWindow>(item_of(j), heads, batch, n_qt, sq,
                                          sk, causal, window);
    const int qi[2] = {it.q0 + r0, it.q0 + r0 + 8};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMask, kMask};
    float l[2] = {0.f, 0.f};
    float alpha[2];

    // tile 0: S, then its softmax (alpha is moot: O is still zero)
    mbar_wait(&sm.q_full, j & 1);
    mbar_wait(&sm.k_full[t % kStages], (t / kStages) & 1);
    wait_turn(wg);
    wgmma_fence();
    fence_regs(sc);
    start_qk<HD>(sc, q_wg, sm.k[t % kStages]);
    pass_turn(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    if (it.n_tiles == 1) release(&sm.q_empty, lane);
    release(&sm.k_empty[t % kStages], lane);
    online_softmax<kBK, kWindow>(sc, m, l, alpha, qi, c0, it.k0, it.q0, sk,
                                 causal, window, scale_log2);
    pack_p<kBK>(pa, sc);

    for (int n = 1; n < it.n_tiles; ++n) {
      const int s = (t + n) % kStages, ps = (t + n - 1) % kStages;
      mbar_wait(&sm.k_full[s], ((t + n) / kStages) & 1);
      mbar_wait(&sm.v_full[ps], ((t + n - 1) / kStages) & 1);
      wait_turn(wg);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      start_qk<HD>(sc, q_wg, sm.k[s]);
      start_pv<HD>(acc, pa, sm.v[ps]);
      pass_turn(wg);
      wgmma_wait<1>();            // S is done; P.V may still run
      fence_regs(sc);
      if (n == it.n_tiles - 1) release(&sm.q_empty, lane);
      release(&sm.k_empty[s], lane);
      online_softmax<kBK, kWindow>(sc, m, l, alpha, qi, c0,
                                   it.k0 + n * kBK, it.q0, sk, causal,
                                   window, scale_log2);
      wgmma_wait<0>();            // P.V is done
      fence_regs(acc);
      fence_regs(pa);
      release(&sm.v_empty[ps], lane);
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj * 4 + e] *= alpha[e >> 1];
      pack_p<kBK>(pa, sc);
    }

    // the last tile's P.V
    const int ls = (t + it.n_tiles - 1) % kStages;
    mbar_wait(&sm.v_full[ls], ((t + it.n_tiles - 1) / kStages) & 1);
    wait_turn(wg);
    wgmma_fence();
    fence_regs(acc);
    fence_regs(pa);
    start_pv<HD>(acc, pa, sm.v[ls]);
    pass_turn(wg);   // (warpgroup 1's very last is never waited for)
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release(&sm.v_empty[ls], lane);
    t += it.n_tiles;

    // epilogue: o = acc / max(l, 1e-30) in bf16, through the strides (a
    // row that saw no key summed p = 1 over every key tile: its mean is
    // over Sk keys)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (kWindow && m[r] == kMask) l[r] = static_cast<float>(sk);
      if constexpr (kLse) {
        // the quad's first thread writes the row's lse
        if ((lane & 3) == 0 && qi[r] < sq)
          lse[(static_cast<int64_t>(it.b) * heads + it.h) * sq + qi[r]] =
              kWindow && m[r] == kMask
                  ? kNegInf
                  : (m[r] * scale_log2 + log2f(l[r])) * kLn2;
      }
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= sq) continue;
      __nv_bfloat16* orow = o + it.b * os.b +
                            static_cast<int64_t>(qi[r]) * os.s +
                            it.h * os.h + c0;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + jj * 8) = pack_bf16(
            acc[jj * 4 + 2 * r] * l[r], acc[jj * 4 + 2 * r + 1] * l[r]);
    }
  }
}

// Registers a thread after the role split.  The 384 threads start at 168
// (65,536 / 384, rounded down to 8); the producer warpgroup gives back
// 128 x 144, which is what the two consumer warpgroups take (256 x 72).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// lse comes last, so the flagless kernel's other parameters keep their
// offsets (and its code its bits).
template <int HD, bool kWindow, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, int sq, int sk, int heads,
                   int batch, int group, Strides os, float scale_log2,
                   int causal, int window, float* __restrict__ lse) {
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "head dim 64, 128 or 256");
  constexpr int kStages = Smem<HD>::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int n_items = heads * batch * n_qt;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the roles, never rejoined, so setmaxnreg holds
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0)
      produce<HD, kWindow>(sm, &q_map, &k_map, &v_map, n_items, heads, batch,
                           n_qt, group, sq, sk, causal, window);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    consume<HD, kWindow, kLse>(sm, o, sq, sk, os, scale_log2, causal,
                               window, n_items, heads, batch, n_qt, warp,
                               lane, lse);
  }
}

// A 4-d map over (hd, seq, head, batch) of a bf16 tensor given by element
// strides, read in boxes of [rows][64] with the 128-byte swizzle; out of
// bounds reads as zero.  False if the encoder refuses it (a stride that is
// not a multiple of 16 bytes, an unaligned base).
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                     int seq, int hd, Strides st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encode the maps (passed by value, so a captured CUDA graph keeps them),
// raise the kernel's shared-memory limit once, launch.  Returns the
// launch's cudaError_t; a refused map is cudaErrorInvalidValue.  lse is
// f32 [B, H, Sq] when kLse, else unused.
template <int HD, bool kWindow, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int kvh, int sq, int sk, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, int window, float* lse, cudaStream_t stream) {
  constexpr int kBK = Smem<HD>::kBK;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, b, h, sq, HD, qs, kBQ) ||
      !make_map(&km, k, b, kvh, sk, HD, ks, kBK) ||
      !make_map(&vm, v, b, kvh, sk, HD, vs, kBK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<HD>();
  // per device: the shared-memory limit raised once, the SM count
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  static int n_sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<HD, kWindow, kLse>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int64_t n_items =
      static_cast<int64_t>(h) * b * ((sq + kBQ - 1) / kBQ);
  if (n_items > INT32_MAX) return cudaErrorInvalidValue;
  // persistent: one block per SM (at most one per item)
  const int grid =
      static_cast<int>(n_items < n_sms[dev] ? n_items : n_sms[dev]);
  flash_wgmma_kernel<HD, kWindow, kLse><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), sq, sk, h, b, h / kvh, os,
      scale * kLog2e, causal, window, lse);
  return cudaGetLastError();
}

}  // namespace fa_wgmma
