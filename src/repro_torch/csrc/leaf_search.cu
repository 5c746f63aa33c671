// Batched unsorted-leaf search with the two-level version check (Sherman,
// paper Fig. 9), for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/leaf_search/kernel.py::leaf_search.
//
// For each query lane b: find the first slot s of its leaf row with
// keys[b, s] == qkeys[b]; then
//   node_ok    = fnv[b] == rnv[b] && free[b] == 0
//   consistent = node_ok && (fev[b, s] == rev[b, s] || !found)
//   value      = found && consistent ? vals[b, s] : -1
// and write (value, found && consistent, consistent).
//
// One warp per query lane: the F slots are strided over the warp's 32
// threads (neighbouring threads read neighbouring keys), __ballot_sync
// collects the matches of each 32-slot chunk, and __ffs of the lowest
// chunk with a match gives the first matching slot.  Lane 0 writes the
// three outputs.  The grid covers ceil(B * 32 / 256) blocks of 8 warps and
// masks its own ragged edge, so any B >= 1 and any F <= 256 run.
//
// The work is tiny (a key row plus 22 B per lane and 6 B more where the
// row holds the query, ~47 KB at B = 512, F = 16): the kernel is bound by
// launch latency, not by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

template <typename Ver>
__global__ void leaf_search_kernel(const int32_t* __restrict__ qkeys,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ vals,
                                   const Ver* __restrict__ fev,
                                   const Ver* __restrict__ rev,
                                   const int32_t* __restrict__ fnv,
                                   const int32_t* __restrict__ rnv,
                                   const int32_t* __restrict__ free_bit,
                                   int32_t* __restrict__ out_value,
                                   uint8_t* __restrict__ out_found,
                                   uint8_t* __restrict__ out_consistent,
                                   int64_t b, int f) {
  const int lane = threadIdx.x % kWarp;
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;
  if (q >= b) return;  // uniform across the warp: blockDim is a multiple of 32

  const int32_t key = qkeys[q];
  const int32_t* row = keys + q * f;
  int slot = -1;
  for (int base = 0; base < f; base += kWarp) {
    const int s = base + lane;
    const unsigned match = __ballot_sync(0xffffffffu, s < f && row[s] == key);
    if (match) {
      slot = base + __ffs(match) - 1;
      break;  // every lane sees the same ballot, so the warp leaves together
    }
  }
  if (lane != 0) return;

  const bool found = slot >= 0;
  const int64_t at = q * f + (found ? slot : 0);
  const bool node_ok = fnv[q] == rnv[q] && free_bit[q] == 0;
  const bool entry_ok =
      static_cast<int32_t>(fev[at]) == static_cast<int32_t>(rev[at]);
  const bool consistent = node_ok && (entry_ok || !found);
  out_value[q] = (found && consistent) ? vals[at] : -1;
  out_found[q] = found && consistent;
  out_consistent[q] = consistent;
}

template <typename Ver>
void launch(const void* qkeys, const void* keys, const void* vals,
            const void* fev, const void* rev, const void* fnv,
            const void* rnv, const void* free_bit, void* out_value,
            void* out_found, void* out_consistent, int64_t b, int f,
            cudaStream_t stream) {
  const int64_t blocks = (b * kWarp + kThreads - 1) / kThreads;
  leaf_search_kernel<Ver><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const int32_t*>(qkeys), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(vals), static_cast<const Ver*>(fev),
      static_cast<const Ver*>(rev), static_cast<const int32_t*>(fnv),
      static_cast<const int32_t*>(rnv), static_cast<const int32_t*>(free_bit),
      static_cast<int32_t*>(out_value), static_cast<uint8_t*>(out_found),
      static_cast<uint8_t*>(out_consistent), b, f);
}

}  // namespace

// C entry bound with ctypes.  ``ver_bytes`` is the element size of
// fev/rev: 1 (uint8, the tree's own dtype) or 4 (int32).  Returns
// cudaGetLastError() after the launch; 0 means the launch was accepted.
extern "C" int leaf_search_launch(const void* qkeys, const void* keys,
                                  const void* vals, const void* fev,
                                  const void* rev, const void* fnv,
                                  const void* rnv, const void* free_bit,
                                  void* out_value, void* out_found,
                                  void* out_consistent, int64_t b, int f,
                                  int ver_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ver_bytes == 1) {
    launch<uint8_t>(qkeys, keys, vals, fev, rev, fnv, rnv, free_bit,
                    out_value, out_found, out_consistent, b, f, s);
  } else if (ver_bytes == 4) {
    launch<int32_t>(qkeys, keys, vals, fev, rev, fnv, rnv, free_bit,
                    out_value, out_found, out_consistent, b, f, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
