// The grouped matrix product over variable-sized expert groups for Hopper
// (sm_90a): wgmma fed by TMA, bf16 in and f32 accumulation.  No TPU
// kernel: the reference batches its experts with capacity-bounded einsums
// that it leaves to XLA.  A dropless dispatch (repro_torch/models/moe.py)
// sorts the (token, choice) pairs by expert, so each expert's rows are one
// run of the sorted rows whose length only the device knows; no library
// product takes such groups without reading their sizes on the host.
//
// With ends[g] the groups' cumulative ends (start_g = ends[g - 1], 0 for
// g = 0), rows past ends[G - 1] belonging to no group:
//   moe_gmm_kernel:     c[r, :]  = a[r, :] . w[g]        for start_g <= r < ends[g]
//                       (w [G, K, N]; or, K-major, the transpose of a
//                       [G, N, K] tensor: the rows' gradient)
//   moe_gmm_dw_kernel:  dw[g]    = sum over the group's rows r of
//                                  a[r, :]^T d[r, :]     (0 for an empty group)
// each rounded to bf16 once from its f32 sum.  Rows of c past the groups
// are not written (the caller's buffer holds zeros there).
//
// Bound: operations, nearly balanced with bytes.  At the
// train-qwen1.5-moe-a2.7b cell's shape (15 groups, about 16,384 rows in
// all, D 2,048, F 1,408) a product does 2 M D F = 9.45e10 FLOPs, 95.5 us
// at 989 TFLOP/s, and reads and writes (M D + G D F + M F) 2 B = 0.20 GB,
// 59.6 us at 3.35 TB/s.
//
// Design (the shape of flash_attention_wgmma.cuh, whose descriptors and
// wgmma fences it uses):
//   * a block computes a 128 x 128 tile of the output with two consumer
//     warpgroups of 64 rows each and one producer warp, whose one thread
//     starts the TMA loads of 64-deep slices of both operands into a ring
//     of 3 stages (16 KB + 16 KB a stage, 128-byte swizzle; a full and an
//     empty mbarrier a stage); two blocks fit on an SM, so one's
//     epilogue overlaps the other's loads;
//   * moe_gmm_kernel: grid (N / 128, M / 128 + G).  Each block finds its
//     row tile on the device from the groups' ends (a loop over G): group
//     g's rows take ceil(count / 128) tiles in turn, each starting at
//     start_g + 128 i, and the tiles past them exit at once, so the grid's
//     size (an upper bound) needs no host read.  A tile's rows past its
//     group's end are computed with the group's weight and not stored.
//     The weight's slice is two N-major boxes (w [G, K, N], the transpose
//     bit) or one K-major box (the transpose of [G, N, K]);
//   * moe_gmm_dw_kernel: grid (N / 128, K / 128, G).  A block sums its
//     group's rows in slices of 64: a's slice is the M-major A operand (the
//     transpose bit), d's the N-major B operand.  The last slice's rows
//     past the group's end hold the next group's rows: each warpgroup
//     zeroes them in its own box of a before its products (a whole
//     128-byte row of a swizzled box is one row of the tile, whatever the
//     swizzle).  Nothing is added across blocks, so every call gives the
//     same bits;
//   * TMA's zero fill gives the ragged ends of K and of the rows; columns
//     past N are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"
#include "tma.cuh"

namespace grouped {

using namespace tma;
using fa_wgmma::desc_sw128;
using fa_wgmma::fence_regs;
using fa_wgmma::pack_bf16;
using fa_wgmma::wgmma_commit;
using fa_wgmma::wgmma_fence;
using fa_wgmma::wgmma_wait;

constexpr int kBM = 128;   // output rows a block: two warpgroups of 64
constexpr int kBN = 128;   // output columns a block
constexpr int kBK = 64;    // depth a stage: one 128-byte swizzled row
constexpr int kBox = 64;   // bf16 values in a 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kBoxBytes = kBox * kBox * 2;   // a [64][64] box

struct Smem {
  __nv_bfloat16 a[kStages][kBM * kBK];
  __nv_bfloat16 b[kStages][kBK * kBN];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + the alignment

// D[64x128] += A[64x16] . B[16x128], both from shared memory; kTA / kTB
// the transpose bits (1: the operand's M or N dimension is contiguous).
#define GMM_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
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
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : GMM_D8(0), GMM_D8(8), GMM_D8(16), GMM_D8(24), GMM_D8(32),
        GMM_D8(40), GMM_D8(48), GMM_D8(56)
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}
#undef GMM_D8

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ Smem& smem_of(unsigned char* raw) {
  return *reinterpret_cast<Smem*>(raw +
                                  ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

__device__ __forceinline__ void init_barriers(Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The accumulator's fragment: a thread holds rows r0 and r0 + 8 of its
// warpgroup's 64 and, in each 8-column group jj, columns c0 and c0 + 1 as
// acc[4 jj + 2 r + {0, 1}].
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           __nv_bfloat16* out, int64_t ld,
                                           int row0, int row_end, int col0,
                                           int col_end, int warp, int lane) {
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= row_end) continue;
    __nv_bfloat16* orow = out + row * ld + col0 + c0;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
      if (col0 + c0 + jj * 8 < col_end)
        *reinterpret_cast<uint32_t*>(orow + jj * 8) =
            pack_bf16(acc[jj * 4 + 2 * r], acc[jj * 4 + 2 * r + 1]);
  }
}

// The consumers' main loop over n_k stages: wait for a stage, start its
// four k16 products, retire the previous stage's and release it.  `prep`
// runs on a stage after it has arrived and before its products.
template <int kTA, int kTB, typename DescA, typename DescB, typename Prep>
__device__ __forceinline__ void mainloop(Smem& sm, float (&acc)[64], int n_k,
                                         int lane, DescA desc_a,
                                         DescB desc_b, Prep prep) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    prep(i, s);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_128<kTA, kTB>(acc, desc_a(s, kk), desc_b(s, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0) release(&sm.empty[(i - 1) % kStages], lane);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// Which row tile of which group blockIdx.y is: false past the groups.
__device__ __forceinline__ bool find_tile(const int* __restrict__ ends,
                                          int groups, int* g, int* row0,
                                          int* end) {
  const int t = blockIdx.y;
  int before = 0, start = 0;
  for (int i = 0; i < groups; ++i) {
    const int e = ends[i];
    const int tiles = (e - start + kBM - 1) / kBM;
    if (t < before + tiles) {
      *g = i;
      *row0 = start + (t - before) * kBM;
      *end = e;
      return true;
    }
    before += tiles;
    start = e;
  }
  return false;
}

// c = a . w[g] over one 128 x 128 tile; kKMajor: w is the transpose of a
// [G, N, K] tensor (w_map over (K, N, G)), else [G, K, N] (over (N, K, G)).
template <bool kKMajor>
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap w_map,
               __nv_bfloat16* __restrict__ c, const int* __restrict__ ends,
               int k, int n, int groups) {
  int g, row0, end;
  if (!find_tile(ends, groups, &g, &row0, &end)) return;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_of(smem_raw);
  init_barriers(sm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kBN;
  const int n_k = (k + kBK - 1) / kBK;
  if (warp == kConsumerWarps) {
    if (lane != 0) return;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&sm.full[s], (kBM + kBN) * kBK * 2);
      tma_load(sm.a[s], &a_map, &sm.full[s], i * kBK, row0, 0, 0);
      if (kKMajor) {
        tma_load(sm.b[s], &w_map, &sm.full[s], i * kBK, col0, g, 0);
      } else {
        tma_load(sm.b[s], &w_map, &sm.full[s], col0, i * kBK, g, 0);
        tma_load(sm.b[s] + kBox * kBox, &w_map, &sm.full[s], col0 + kBox,
                 i * kBK, g, 0);
      }
    }
    return;
  }
  const int wg = warp / 4;
  float acc[64];
  // a: [128 rows][64] K-major, this warpgroup's 64 rows; w: K-major
  // [128 cols][64], or two N-major boxes [64][64] (16 rows a k16)
  mainloop<0, kKMajor ? 0 : 1>(
      sm, acc, n_k, lane,
      [&](int s, int kk) {
        return desc_sw128(sm.a[s] + wg * 64 * kBox + kk * 16, 16);
      },
      [&](int s, int kk) {
        return kKMajor ? desc_sw128(sm.b[s] + kk * 16, 16)
                       : desc_sw128(sm.b[s] + kk * 16 * kBox, kBoxBytes);
      },
      [](int, int) {});
  store_tile(acc, c, n, row0 + wg * 64, end, col0, n, warp, lane);
}

// dw[g] = a[rows]^T . d[rows] over one 128 x 128 tile of dw [G, K, N].
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_dw_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap d_map,
                  __nv_bfloat16* __restrict__ dw,
                  const int* __restrict__ ends, int k, int n) {
  const int g = blockIdx.z;
  const int start = g > 0 ? ends[g - 1] : 0, end = ends[g];
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_of(smem_raw);
  init_barriers(sm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int n_r = (end - start + kBK - 1) / kBK;
  if (warp == kConsumerWarps) {
    if (lane != 0) return;
    for (int i = 0; i < n_r; ++i) {
      const int s = i % kStages, row = start + i * kBK;
      mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&sm.full[s], (kBM + kBN) * kBK * 2);
      tma_load(sm.a[s], &a_map, &sm.full[s], k0, row, 0, 0);
      tma_load(sm.a[s] + kBox * kBox, &a_map, &sm.full[s], k0 + kBox, row,
               0, 0);
      tma_load(sm.b[s], &d_map, &sm.full[s], col0, row, 0, 0);
      tma_load(sm.b[s] + kBox * kBox, &d_map, &sm.full[s], col0 + kBox, row,
               0, 0);
    }
    return;
  }
  const int wg = warp / 4, t = threadIdx.x % 128;
  float acc[64];
  // a: this warpgroup's box [64 rows][64 of K], M-major; d: two N-major
  // boxes [64 rows][64 of N]
  mainloop<1, 1>(
      sm, acc, n_r, lane,
      [&](int s, int kk) {
        return desc_sw128(sm.a[s] + wg * kBox * kBox + kk * 16 * kBox,
                          kBoxBytes);
      },
      [&](int s, int kk) {
        return desc_sw128(sm.b[s] + kk * 16 * kBox, kBoxBytes);
      },
      [&](int i, int s) {
        const int valid = end - (start + i * kBK);
        if (valid >= kBK) return;
        // the next group's rows: 0 in this warpgroup's box of a
        uint4* box = reinterpret_cast<uint4*>(sm.a[s] + wg * kBox * kBox);
        for (int v = valid * 8 + t; v < kBK * 8; v += 128)
          box[v] = make_uint4(0, 0, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      });
  store_tile(acc, dw + static_cast<int64_t>(g) * k * n, n, k0 + wg * 64, k,
             col0, n, warp, lane);
}

// A map over a bf16 tensor of up to 4 dims (innermost first, the rest 1),
// its rows `row_bytes` apart and its planes `plane_bytes`, read in boxes
// of [box_rows][64] with the 128-byte swizzle; out of bounds reads as 0.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, 1};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {kBox, box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's shared-memory limit, raised once a device.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace grouped

// a [m, k] and c [m, n] contiguous; w [G, k, n] contiguous, or with
// w_kmajor the transpose of a contiguous [G, n, k]; ends [G] int32.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a map the
// encoder refuses).
extern "C" int moe_gmm_launch(const void* a, const void* w, void* c,
                              const int* ends, int m, int k, int n,
                              int groups, int w_kmajor, void* stream) {
  using namespace grouped;
  if (m == 0 || groups == 0 || n == 0) return 0;
  CUtensorMap am, wm;
  const bool ok =
      make_map(&am, a, k, m, 1, kBM) &&
      (w_kmajor ? make_map(&wm, w, k, n, groups, kBN)
                : make_map(&wm, w, n, k, groups, kBK));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static bool done[2][64] = {};
  const cudaError_t err =
      w_kmajor ? configure(moe_gmm_kernel<true>, done[1])
               : configure(moe_gmm_kernel<false>, done[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM + groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(c);
  if (w_kmajor)
    moe_gmm_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(am, wm, out,
                                                             ends, k, n,
                                                             groups);
  else
    moe_gmm_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(am, wm, out,
                                                              ends, k, n,
                                                              groups);
  return static_cast<int>(cudaGetLastError());
}

// a [m, k] and d [m, n] contiguous, ends [G] int32 -> dw [G, k, n].
extern "C" int moe_gmm_dw_launch(const void* a, const void* d, void* dw,
                                 const int* ends, int m, int k, int n,
                                 int groups, void* stream) {
  using namespace grouped;
  if (groups == 0 || k == 0 || n == 0) return 0;
  CUtensorMap am, dm;
  // (m = 0 still launches: every group is empty and writes 0)
  const uint64_t rows = m > 0 ? m : 1;
  if (!make_map(&am, a, k, rows, 1, kBK) ||
      !make_map(&dm, d, n, rows, 1, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  const cudaError_t err = configure(moe_gmm_dw_kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (k + kBM - 1) / kBM, groups);
  moe_gmm_dw_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      am, dm, static_cast<__nv_bfloat16*>(dw), ends, k, n);
  return static_cast<int>(cudaGetLastError());
}
