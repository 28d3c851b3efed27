// Sorted-key search: lower and upper bounds of int64 queries in a sorted
// int64 column, and the (s, p, o)-prefix range form of the same probe.
//
// Replaces: src/repro/kernels/bsearch.py, search_bounds and
// prefix_range_bounds -> _search_bounds_call -> _kernel, which counts
// #{k < q} and #{k <= q} as a tiled compare-and-reduce over every (query, key)
// pair: O(n * v) VPU work, because a TPU has no cheap dependent gather.
//
// Bound on the H100: memory latency.  The function must read each query and
// key once and write two int32 per query; a binary search instead does
// log2(v) dependent 8-byte loads per query, whose upper levels stay in L2.
// Design: one thread per query runs a branch-free lower bound of its low key
// and upper bound of its high key (the select form keeps a warp's threads in
// step whatever their comparisons).  The plain form uses the query as both
// keys.  The prefix form packs its 1-3 leading 21-bit IDs into the low key
// (free positions 0) and the high key (free positions 2^21 - 1) in registers,
// so the caller never materialises the packed queries.  Either output may be
// NULL to skip that side.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxId = (1LL << 21) - 1;

// #{i : a[i] < x}, or #{i : a[i] <= x} when `upper`; a sorted, len >= 1.
__device__ __forceinline__ long long bound(const long long* __restrict__ a,
                                           long long len, long long x,
                                           bool upper) {
  const long long* base = a;
  while (len > 1) {
    const long long half = len >> 1;
    const long long v = base[half];
    base = (upper ? v <= x : v < x) ? base + half : base;
    len -= half;
  }
  const long long v = *base;
  return (base - a) + ((upper ? v <= x : v < x) ? 1 : 0);
}

__global__ void search_kernel(const long long* __restrict__ queries,
                              const int* __restrict__ prefix, int k,
                              long long n, const long long* __restrict__ keys,
                              long long v, int* __restrict__ lo,
                              int* __restrict__ hi) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  long long lo_key, hi_key;
  if (prefix != nullptr) {
    lo_key = 0;
    hi_key = 0;
    for (int j = 0; j < 3; ++j) {
      const long long c = j < k ? (long long)prefix[g * k + j] : 0;
      lo_key = (lo_key << 21) | c;
      hi_key = (hi_key << 21) | (j < k ? c : kMaxId);
    }
  } else {
    lo_key = queries[g];
    hi_key = lo_key;
  }
  if (lo != nullptr) lo[g] = v > 0 ? (int)bound(keys, v, lo_key, false) : 0;
  if (hi != nullptr) hi[g] = v > 0 ? (int)bound(keys, v, hi_key, true) : 0;
}

cudaError_t launch(const long long* queries, const int* prefix, int k,
                   long long n, const long long* keys, long long v, int* lo,
                   int* hi, void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      queries, prefix, k, n, keys, v, lo, hi);
  return cudaGetLastError();
}

}  // namespace

// queries: (n,) int64; keys: (v,) int64 sorted ascending.
// lo[i] = #{keys < queries[i]}, hi[i] = #{keys <= queries[i]}.
extern "C" int search_bounds(const long long* queries, long long n,
                             const long long* keys, long long v, int* lo,
                             int* hi, void* stream) {
  return (int)launch(queries, nullptr, 0, n, keys, v, lo, hi, stream);
}

// prefix: (n, k) int32 row-major, 1 <= k <= 3.  start/end: the half-open range
// of keys whose leading k 21-bit fields equal the row.
extern "C" int prefix_range_bounds(const int* prefix, long long n, int k,
                                   const long long* keys, long long v,
                                   int* start, int* end, void* stream) {
  return (int)launch(nullptr, prefix, k, n, keys, v, start, end, stream);
}
