// The RWKV6 WKV recurrence, for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel repro/kernels/rwkv_scan/kernel.py::wkv6.
//
// Per (b, h), with an [N, N] f32 state S starting at zero, for t = 0..T-1:
//   o_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//          = sum_n r_t[n] * S[n][m] + v_t[m] * c_t,
//     c_t  = sum_n r_t[n] * u[n] * k_t[n],
//   S[n][m] = w_t[n] * S[n][m] + k_t[n] * v_t[m]
// (o_t reads S before step t's update).  Inputs r/k/v/w in f32 or bf16,
// u [H, N] in the same dtype; o is f32.
//
// Bound: bytes.  The function reads r, k, v, w once and writes o once
// (5 * B*H*T*N * 4 B in f32: 0.200 ms at 3.35 TB/s for rwkv6-1.6b's
// B=4, H=32, T=4096, N=64) against 12.8 flops a byte at N = 64, below the
// 20 a byte at which the H100's f32 FMA units (67e12 / 3.35e12) would
// bound it.  With u's term folded into c_t, each state element costs three
// f32 instructions a step (kv = k v, acc = fma(r, S, acc),
// S = fma(w, S, kv)): 6.4e9 at that shape, 0.19 ms on 132 SMs' 128 lanes,
// the same as the bytes.
//
// Design: one block per (b, h), in two roles.
//   * The compute threads split the state into register tiles of kRows
//     rows by kCols columns (at N = 64, 8 by 4: 128 threads, one warp on
//     each of an SM's four schedulers at rwkv6-1.6b's 128 (b, h)).  Each
//     step a thread reads its rows' r, k, w as 16-byte broadcast loads
//     (the lanes of a half-warp read the same rows) and its columns' v,
//     runs 3 instructions an element (the kCols sums over its rows are
//     independent chains), and stores its row group's share
//     sum_{n in rows} r_t[n] S[n][m] of o_t.
//     Wider tiles load fewer bytes from shared memory a step (the loads,
//     not the FMAs, set the pace of the narrower tiles tried), and 8 by 4
//     is the widest that leaves a warp for each scheduler.  A step's share
//     is stored after the next step's operands are fetched, so that store,
//     which ptxas does not move the loads past, keeps them a whole step
//     ahead of their use.
//   * Time runs in chunks of kChunk steps.  The first output thread brings
//     each chunk's r, k, v, w into a ring of kStages shared-memory stages
//     with TMA (4-d tensor maps over (N, T, H, B) built from the caller's
//     strides, zero fill past T), completing on the stage's full mbarrier.
//     A thread waits once a chunk; the step loop reads only shared memory
//     and registers and takes no barrier.
//   * The output threads (4 warps) run a chunk behind: per step they
//     compute c_t = sum_n r_t[n] u[n] k_t[n] (4 threads a step, a shuffle
//     sum), then sum the row groups' shares in order, add v_t c_t, and
//     store the chunk's [kChunk, N] rows of o as 16-byte stores.  The
//     shares are double-buffered between the roles (part_full and
//     part_empty mbarriers), and a stage is refilled once both roles are
//     done with it (its empty mbarrier), so the compute threads never
//     wait on the output pass.
// Nothing is summed with atomics or in an order that depends on timing,
// so two launches give the same bits, and every layout the same bits.
// Every tensor is addressed through (batch, head, time) strides with N
// contiguous, so the model's [B,T,H,N] layout and the kernel layout
// [B,H,T,N] both run without a copy; TMA needs those strides and the
// bases 16-byte aligned (the wrapper checks).
//
// Why not the tensor cores: the bytes bound the function, and the FMA
// units reach that bound.  The chunked matrix form would feed TF32 or bf16
// operands, whose error at |o| of tens exceeds the f32 tolerance of 1e-4
// unless the products were emulated (3xTF32), and its intra-chunk decay
// products (prod w) underflow in f32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using namespace tma;

struct Strides {
  int64_t b, h, t;
};

// The register tile of the state a compute thread holds, per head size.
template <int N>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int kRows = 8, kCols = 4;
};
template <>
struct Tile<32> {
  static constexpr int kRows = 4, kCols = 2;
};
template <>
struct Tile<16> {
  static constexpr int kRows = 2, kCols = 2;
};

constexpr int kChunk = 32;        // time steps a stage holds
constexpr int kStages = 3;
constexpr int kOutThreads = 128;  // the output warps
constexpr int kSplit = kOutThreads / kChunk;   // output threads a step

template <int N>
struct Cfg {
  static constexpr int kRows = Tile<N>::kRows;
  static constexpr int kCols = Tile<N>::kCols;
  static constexpr int kGroups = N / kRows;   // row groups
  static constexpr int kLanes = N / kCols;    // threads of a row group
  static constexpr int kCompute = kGroups * kLanes;   // compute threads
  static constexpr int kThreads = kCompute + kOutThreads;
  static_assert(N % kRows == 0 && N % kCols == 0 && kCompute % 32 == 0,
                "tile must divide the state into whole warps");
  static_assert(kChunk * N / 4 % kOutThreads == 0 && N % (4 * kSplit) == 0,
                "a chunk's o and c must split evenly over the output warps");
};

template <typename T, int N>
struct Smem {
  T in[kStages][4][kChunk * N];   // r, k, v, w: [kChunk][N] each
  float part[2][kChunk * Cfg<N>::kGroups * N];   // [t][group][N]
  float c[2][kChunk];
  uint64_t full[kStages];    // the stage's TMA bytes have landed
  uint64_t empty[kStages];   // every thread is done with the stage
  uint64_t part_full[2];     // the compute threads' partials are in
  uint64_t part_empty[2];    // the output threads have read them
};

template <typename T, int N>
constexpr size_t smem_bytes() {
  return sizeof(Smem<T, N>) + 128;   // room to align the base to 128
}

// K consecutive values from shared memory as f32, in the widest loads
// their alignment allows (the callers keep K-element offsets).
template <int K>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      x[i] = q.x;
      x[i + 1] = q.y;
      x[i + 2] = q.z;
      x[i + 3] = q.w;
    }
  } else {
    static_assert(K == 2, "2 or a multiple of 4 values");
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x;
    x[1] = q.y;
  }
}

// bf16 -> f32 is exact: a bf16's bits are the top half of the f32's.
__device__ __forceinline__ void unpack(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

template <int K>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&x)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      unpack(q.x, x + i);
      unpack(q.y, x + i + 2);
      unpack(q.z, x + i + 4);
      unpack(q.w, x + i + 6);
    }
  } else if constexpr (K == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    unpack(q.x, x);
    unpack(q.y, x + 2);
  } else {
    static_assert(K == 2, "2, 4 or a multiple of 8 values");
    unpack(*reinterpret_cast<const uint32_t*>(p), x);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int K>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
    static_assert(K == 2, "2 or a multiple of 4 values");
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// One step's operands for a compute thread: its rows' r, k, w and its
// columns' v.
template <int R, int C>
struct Operands {
  float r[R], k[R], w[R], v[C];
};

// The compute threads: the recurrence on this thread's tile of the state,
// storing each step its row group's share sum_{n in rows} r_t[n] S[n][m]
// of o_t for the output threads.
template <typename T, int N>
__device__ __forceinline__ void compute(Smem<T, N>& sm, int tid,
                                        int n_chunks, int t_len) {
  using C = Cfg<N>;
  constexpr int R = C::kRows;
  const int g = tid / C::kLanes;                 // rows g*R..
  const int m0 = (tid % C::kLanes) * C::kCols;   // columns m0..
  float st[R][C::kCols];
#pragma unroll
  for (int n = 0; n < R; ++n)
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) st[n][j] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    const int tc = min(kChunk, t_len - i * kChunk);
    const T* rg = sm.in[s][0] + g * R;
    const T* kg = sm.in[s][1] + g * R;
    const T* vm = sm.in[s][2] + m0;
    const T* wg = sm.in[s][3] + g * R;
    float* pg = sm.part[i & 1] + g * N + m0;
    // step t's operands (a row past tc is in the stage, and unused)
    auto fetch = [&](int t, Operands<R, C::kCols>& x) {
      t = min(t, kChunk - 1) * N;
      load_f32(rg + t, x.r);
      load_f32(kg + t, x.k);
      load_f32(wg + t, x.w);
      load_f32(vm + t, x.v);
    };
    // step on x, leaving the row group's share of o_t in acc
    auto step = [&](const Operands<R, C::kCols>& x, float (&acc)[C::kCols]) {
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) acc[j] = 0.f;
#pragma unroll
      for (int n = 0; n < R; ++n)
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) {
          acc[j] = fmaf(x.r[n], st[n][j], acc[j]);
          st[n][j] = fmaf(x.w[n], st[n][j], x.k[n] * x.v[j]);
        }
    };
    auto put = [&](int t, const float (&a)[C::kCols]) {
      store_f32(pg + t * C::kGroups * N, a);
    };

    mbar_wait(&sm.full[s], (i / kStages) & 1);
    mbar_wait(&sm.part_empty[i & 1], ((i >> 1) & 1) ^ 1);
    // two steps a turn; each fetches the next step's operands, then
    // stores the last step's share, then runs
    Operands<R, C::kCols> xa, xb;
    float pa[C::kCols], pb[C::kCols];
    fetch(0, xa);
    for (int t = 0;; t += 2) {
      fetch(t + 1, xb);
      if (t > 0) put(t - 1, pb);
      step(xa, pa);
      if (t + 1 == tc) {
        put(t, pa);
        break;
      }
      fetch(t + 2, xa);
      put(t, pa);
      step(xb, pb);
      if (t + 2 == tc) {
        put(t + 1, pb);
        break;
      }
    }
    mbar_arrive(&sm.part_full[i & 1]);
    mbar_arrive(&sm.empty[s]);
  }
}

// The output threads, a chunk behind the compute threads: c_t, then
// o_t = the row groups' shares, summed in order, + v_t c_t, stored as
// whole 16-byte rows.  Their first thread also runs the TMA loads.
template <typename T, int N>
__device__ __forceinline__ void output(
    Smem<T, N>& sm, int tid, const CUtensorMap* r_map,
    const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* w_map, const T* __restrict__ u, float* out, int b,
    int h, int n_chunks, int t_len, int64_t ost) {
  using C = Cfg<N>;
  constexpr uint32_t kStageBytes = 4 * kChunk * N * sizeof(T);
  constexpr int kQuads = N / 4;          // float4s in a row of o
  constexpr int kShare = N / kSplit;     // this thread's terms of c_t
  // chunk `chunk`'s r, k, v, w into stage s
  auto load = [&](int s, int chunk) {
    mbar_expect_tx(&sm.full[s], kStageBytes);
    const int t0 = chunk * kChunk;
    tma_load(sm.in[s][0], r_map, &sm.full[s], 0, t0, h, b);
    tma_load(sm.in[s][1], k_map, &sm.full[s], 0, t0, h, b);
    tma_load(sm.in[s][2], v_map, &sm.full[s], 0, t0, h, b);
    tma_load(sm.in[s][3], w_map, &sm.full[s], 0, t0, h, b);
  };
  if (tid == 0)
    for (int s = 0; s < kStages && s < n_chunks; ++s) load(s, s);

  const int tc_of = tid / kSplit;              // the step whose c_t ...
  const int n0 = (tid % kSplit) * kShare;      // ... it sums from n0
  float uu[kShare];
#pragma unroll
  for (int n = 0; n < kShare; ++n) uu[n] = to_f32(u[h * N + n0 + n]);

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    const int t0 = i * kChunk;
    const int tc = min(kChunk, t_len - t0);
    const float* part = sm.part[i & 1];
    float* c = sm.c[i & 1];
    mbar_wait(&sm.part_full[i & 1], (i >> 1) & 1);
    mbar_wait(&sm.full[s], (i / kStages) & 1);

    // c_t = sum_n r_t[n] u[n] k_t[n], kSplit threads a step (rows past
    // tc are TMA's zero fill)
    {
      float rr[kShare], kk[kShare];
      load_f32(sm.in[s][0] + tc_of * N + n0, rr);
      load_f32(sm.in[s][1] + tc_of * N + n0, kk);
      float x = 0.f;
#pragma unroll
      for (int n = 0; n < kShare; ++n) x = fmaf(rr[n] * uu[n], kk[n], x);
#pragma unroll
      for (int d = 1; d < kSplit; d <<= 1) x += __shfl_xor_sync(~0u, x, d);
      if (tid % kSplit == 0) c[tc_of] = x;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kOutThreads) : "memory");

#pragma unroll
    for (int it = 0; it < kChunk * kQuads / kOutThreads; ++it) {
      const int idx = tid + it * kOutThreads;
      const int t = idx / kQuads;
      const int q = (idx % kQuads) * 4;
      if (t < tc) {
        const float* p = part + t * C::kGroups * N + q;
        float4 sum = *reinterpret_cast<const float4*>(p);
#pragma unroll
        for (int gg = 1; gg < C::kGroups; ++gg) {
          const float4 x = *reinterpret_cast<const float4*>(p + gg * N);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        float vq[4];
        load_f32(sm.in[s][2] + t * N + q, vq);
        const float ct = c[t];
        sum.x = fmaf(vq[0], ct, sum.x);
        sum.y = fmaf(vq[1], ct, sum.y);
        sum.z = fmaf(vq[2], ct, sum.z);
        sum.w = fmaf(vq[3], ct, sum.w);
        *reinterpret_cast<float4*>(out + (t0 + t) * ost + q) = sum;
      }
    }
    mbar_arrive(&sm.part_empty[i & 1]);
    mbar_arrive(&sm.empty[s]);
    // refill the stage once the compute threads are done with it too
    if (tid == 0 && i + kStages < n_chunks) {
      mbar_wait(&sm.empty[s], (i / kStages) & 1);
      load(s, i + kStages);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<N>::kThreads, 1)
wkv6_kernel(const __grid_constant__ CUtensorMap r_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap w_map,
            const T* __restrict__ u, float* __restrict__ o, int n_heads,
            int t_len, Strides os) {
  using C = Cfg<N>;
  extern __shared__ unsigned char smem_raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], C::kThreads);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&sm.part_full[p], C::kCompute);
      mbar_init(&sm.part_empty[p], kOutThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < C::kCompute)
    compute<T, N>(sm, tid, n_chunks, t_len);
  else
    output<T, N>(sm, tid - C::kCompute, &r_map, &k_map, &v_map, &w_map, u,
                 o + b * os.b + h * os.h, b, h, n_chunks, t_len, os.t);
}

template <typename T>
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
template <>
constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 4-d map over (N, T, H, B) of an input given by element strides, read
// in boxes of [kChunk][N]; out of bounds (past T) reads as zero.  False if
// the encoder refuses it (a stride that is not a multiple of 16 bytes, an
// unaligned base).
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int b, int h, int t, int n,
              Strides st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(t),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * sizeof(T),
                                 static_cast<cuuint64_t>(st.h) * sizeof(T),
                                 static_cast<cuuint64_t>(st.b) * sizeof(T)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(n), kChunk, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, kMapType<T>, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encode the maps (passed by value, so a captured CUDA graph keeps them),
// raise the kernel's shared-memory limit once per device, launch.
template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, float* o, int b, int h,
                   int t, Strides is, Strides os, cudaStream_t stream) {
  CUtensorMap rm, km, vm, wm;
  if (!make_map<T>(&rm, r, b, h, t, N, is) ||
      !make_map<T>(&km, k, b, h, t, N, is) ||
      !make_map<T>(&vm, v, b, h, t, N, is) ||
      !make_map<T>(&wm, w, b, h, t, N, is))
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(b) * h > INT32_MAX) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T, N>();
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(wkv6_kernel<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  wkv6_kernel<T, N><<<b * h, Cfg<N>::kThreads, smem, stream>>>(
      rm, km, vm, wm, static_cast<const T*>(u), o, h, t, os);
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
// contiguous, every stride of a dim longer than 1 and every base 16-byte
// aligned (TMA); u [H,N] contiguous; o [B,H,T,N] f32 with its own strides,
// each a multiple of 4 elements, and a 16-byte aligned base.  dtype 0 =
// f32, 1 = bf16 (inputs).  Returns the launch's cudaError_t; strides or
// bases TMA refuses give cudaErrorInvalidValue.
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
