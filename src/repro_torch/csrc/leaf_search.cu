// Batched unsorted-leaf search with the two-level version check (Sherman,
// paper Fig. 9), for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/leaf_search/kernel.py::leaf_search and the gather around it
// (repro/kernels/leaf_search/ops.py::lookup_leaves).
//
// For each query lane b, with r its leaf row: find the first slot s with
// keys[r, s] == qkeys[b]; then
//   node_ok    = fnv[r] == rnv[r] && free[r] == 0
//   consistent = node_ok && (fev[r, s] == rev[r, s] || !found)
//   value      = found && consistent ? vals[r, s] : -1
// and write (value, found && consistent, consistent).
//
// Two entries share this one body.  With a leaf-id array, r = leaf[b] is a
// row of the node pool itself (wrapped like a negative index, then clamped
// to the pool, as JAX's gather does), and the kernel reads the row where
// it lies: no gathered copy of the rows exists.  Without one (null), r = b
// and the arrays are rows already gathered, the TPU kernel's own
// signature.
//
// Bound: latency, not bytes.  A lane needs its query and leaf id, its key
// row and 3 B of node fields, 6 B more where the row holds the query, and
// writes 6 B: ~45 KB at B = 512, F = 16, ~13 ns of HBM time.  What costs is
// the launch and the dependent memory round trips: the leaf id, then a row
// that is a cold random row of a pool far larger than L2.  So the kernel
// (a) issues every load of the row at once, as soon as the leaf id
// arrives -- the key, value and FEV/REV of the thread's slot and the node
// fields -- and selects in registers: one round trip after the leaf id
// where a search-then-select takes two; (b) gives a lane a group of
// threads, one slot each: F rounded up to a power of two, at most a warp
// (wider rows loop over chunks of 32 slots, so any F <= 256 runs), so at
// F = 16 a warp serves two lanes; a ballot masked to the group and __ffs
// give the first matching slot; (c) reads the pool through the read-only
// path (__ldg) with no shared memory, since no row is read twice.  The
// grid masks its own ragged edge, so any B >= 0 runs.
// scripts/leaf_search_variant_timing.py times edited copies of this file
// (a dependent select, a warp per lane, other block sizes); PERF.md has
// its table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // threads per block

// Ver: element type of fev/rev; Node: of fnv/rnv/free (uint8 for the
// pool's uint8 and bool fields, int32 for the gathered entry's).
template <typename Ver, typename Node>
__global__ void __launch_bounds__(kThreads)
leaf_search_kernel(const int32_t* __restrict__ qkeys,
                   const int32_t* __restrict__ leaf,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const Ver* __restrict__ fev, const Ver* __restrict__ rev,
                   const Node* __restrict__ fnv, const Node* __restrict__ rnv,
                   const Node* __restrict__ free_bit,
                   int32_t* __restrict__ out_value,
                   uint8_t* __restrict__ out_found,
                   uint8_t* __restrict__ out_consistent, int64_t b,
                   int64_t n_rows, int f, int group_log2) {
  const int group = 1 << group_log2;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t q = tid >> group_log2;
  // a whole group is live or dead: groups never straddle a warp
  if (q >= b) return;
  const int t = static_cast<int>(tid & (group - 1));
  const int first = (threadIdx.x % kWarp) & ~(group - 1);  // group's warp lane
  const unsigned gmask =
      group == kWarp ? 0xffffffffu : ((1u << group) - 1u) << first;

  int64_t r = q;
  if (leaf != nullptr) {
    r = __ldg(leaf + q);
    if (r < 0) r += n_rows;
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
  const int32_t key = __ldg(qkeys + q);
  // all three node fields load now, with the row: no short circuit
  const Node fn = __ldg(fnv + r), rn = __ldg(rnv + r);
  const Node fr = __ldg(free_bit + r);
  const int64_t row = r * f;

  bool found = false;
  int32_t value = 0;
  bool entry_ok = true;
  bool owner = t == 0;                  // writes the lane's outputs
  for (int base = 0; base < f; base += group) {
    const bool in = base + t < f;
    const int64_t at = row + base + t;
    int32_t k = 0, v = 0, fe = 0, re = 0;
    if (in) {
      k = __ldg(keys + at);
      v = __ldg(vals + at);
      fe = __ldg(fev + at);
      re = __ldg(rev + at);
    }
    const unsigned ball = __ballot_sync(gmask, in && k == key) >> first;
    if (ball) {                          // the same for the whole group
      found = true;
      owner = t == __ffs(ball) - 1;
      value = v;
      entry_ok = fe == re;
      break;
    }
  }
  if (!owner) return;
  const bool node_ok = (fn == rn) & (fr == 0);
  const bool consistent = node_ok && (entry_ok || !found);
  out_value[q] = (found && consistent) ? value : -1;
  out_found[q] = found && consistent;
  out_consistent[q] = consistent;
}

// Threads per lane: F rounded up to a power of two (so groups tile a
// warp), at most a warp.
int group_log2_for(int f) {
  int lg = 0;
  while ((1 << lg) < f && (1 << lg) < kWarp) ++lg;
  return lg;
}

template <typename Ver, typename Node>
int launch(const void* qkeys, const void* leaf, const void* keys,
           const void* vals, const void* fev, const void* rev,
           const void* fnv, const void* rnv, const void* free_bit,
           void* out_value, void* out_found, void* out_consistent, int64_t b,
           int64_t n_rows, int f, cudaStream_t stream) {
  const int lg = group_log2_for(f);
  const int64_t threads = b << lg;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  leaf_search_kernel<Ver, Node><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(qkeys), static_cast<const int32_t*>(leaf),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<const Ver*>(fev), static_cast<const Ver*>(rev),
      static_cast<const Node*>(fnv), static_cast<const Node*>(rnv),
      static_cast<const Node*>(free_bit), static_cast<int32_t*>(out_value),
      static_cast<uint8_t*>(out_found), static_cast<uint8_t*>(out_consistent),
      b, n_rows, f, lg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry bound with ctypes.  ``leaf`` is null for the gathered-row entry
// (lane b reads row b of [B, F] arrays) or an int32 [B] array of pool rows
// (of [n_rows, F] arrays).  ``ver_bytes`` is the element size of fev/rev
// and ``node_bytes`` of fnv/rnv/free_bit: the pool entry takes the tree's
// own 1 and 1 (uint8 and bool), the gathered-row entry 1 or 4 and 4
// (int32).  Returns cudaGetLastError() after the launch; 0 means the
// launch was accepted.
extern "C" int leaf_search_launch(const void* qkeys, const void* leaf,
                                  const void* keys, const void* vals,
                                  const void* fev, const void* rev,
                                  const void* fnv, const void* rnv,
                                  const void* free_bit, void* out_value,
                                  void* out_found, void* out_consistent,
                                  int64_t b, int64_t n_rows, int f,
                                  int ver_bytes, int node_bytes,
                                  void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LEAF_LAUNCH(V, N)                                                    \
  launch<V, N>(qkeys, leaf, keys, vals, fev, rev, fnv, rnv, free_bit,        \
               out_value, out_found, out_consistent, b, n_rows, f, s)
  if (ver_bytes == 1 && node_bytes == 1) return LEAF_LAUNCH(uint8_t, uint8_t);
  if (ver_bytes == 1 && node_bytes == 4) return LEAF_LAUNCH(uint8_t, int32_t);
  if (ver_bytes == 4 && node_bytes == 4) return LEAF_LAUNCH(int32_t, int32_t);
#undef LEAF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
