// Stable ascending permutation of int64 keys: out == argsort(keys, stable=True).
//
// Replaces: src/repro/kernels/dedup.py, dedup_order -> _rank_call ->
// _rank_kernel, which counts rank[i] = #{k < k_i} + #{k == k_i, j < i} over a
// (query block x key tile) grid.  That is O(n^2) compares: right for the
// TPU's short delta buffers, hopeless at the 2^24-2^25 keys that one round of
// the OpenCyc-scale run streams through process_candidates.
//
// Bound on the H100: memory traffic.  The function must read 8 bytes and
// write 4 per key; the compares are integer instructions far below the ALU
// rate.  Design: a merge sort of (key, index) pairs.
//   1. tile_sort: one block of 1024 threads sorts a tile of 2048 pairs in
//      shared memory with a bitonic network.  The index breaks ties, so the
//      order is total and equals the stable order.
//   2. merge_pass, ceil(log2(n / 2048)) times: each element's output position
//      is its index in its own run plus its rank in the partner run, one binary
//      search per thread: #{right < key} for an element of the left run and
//      #{left <= key} for one of the right run.  Runs cover contiguous input
//      index ranges, left before right, so this is the stable merge.
// Every pass reads and writes each pair once (12 bytes each way) plus
// log2(run) dependent loads per element.  The passes ping-pong between two
// buffer pairs that the caller allocates, ordered so the last pass lands in
// `out`.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kTile = 2048;
constexpr int kTileThreads = 1024;
constexpr int kMergeThreads = 256;

__global__ void tile_sort(const long long* __restrict__ keys, long long n,
                          long long* __restrict__ out_keys,
                          int* __restrict__ out_idx) {
  __shared__ long long sk[kTile];
  __shared__ int si[kTile];
  const long long base = (long long)blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const long long g = base + t;
    if (g < n) {
      sk[t] = keys[g];
      si[t] = (int)g;
    } else {  // padding sorts after every real pair, KEY_MAX ones included
      sk[t] = LLONG_MAX;
      si[t] = INT_MAX;
    }
  }
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
        const int p = t ^ j;
        if (p > t) {
          const long long ka = sk[t], kb = sk[p];
          const int ia = si[t], ib = si[p];
          const bool a_after_b = ka > kb || (ka == kb && ia > ib);
          const bool ascending = (t & k) == 0;
          if (a_after_b == ascending) {
            sk[t] = kb;
            sk[p] = ka;
            si[t] = ib;
            si[p] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const long long g = base + t;
    if (g < n) {
      out_keys[g] = sk[t];
      out_idx[g] = si[t];
    }
  }
}

// #{i < len : a[i] < x}  (or <= x when `upper`), a sorted ascending.
__device__ __forceinline__ long long rank_in(const long long* a, long long len,
                                             long long x, bool upper) {
  long long lo = 0;
  while (len > 0) {
    const long long half = len >> 1;
    const long long v = a[lo + half];
    const bool right = upper ? (v <= x) : (v < x);
    lo = right ? lo + half + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

__global__ void merge_pass(const long long* __restrict__ in_keys,
                           const int* __restrict__ in_idx,
                           long long* __restrict__ out_keys,
                           int* __restrict__ out_idx, long long n,
                           long long width) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const long long start = g / (2 * width) * (2 * width);
  const long long mid = start + width < n ? start + width : n;
  const long long end = start + 2 * width < n ? start + 2 * width : n;
  const long long key = in_keys[g];
  long long pos;
  if (g < mid) {
    pos = g + rank_in(in_keys + mid, end - mid, key, false);
  } else {
    pos = start + (g - mid) + rank_in(in_keys + start, mid - start, key, true);
  }
  out_keys[pos] = key;
  out_idx[pos] = in_idx[g];
}

}  // namespace

// keys: (n,) int64.  kbuf0/kbuf1: (n,) int64 scratch; ibuf: (n,) int32
// scratch; out: (n,) int32 result.  Returns the launch status.
extern "C" int dedup_order(const long long* keys, long long n, long long* kbuf0,
                           long long* kbuf1, int* ibuf, int* out,
                           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int passes = 0;
  for (long long w = kTile; w < n; w *= 2) ++passes;
  // buffer pair 0 = (kbuf0, out), pair 1 = (kbuf1, ibuf); the tile sort
  // writes the pair that makes the last merge pass end in pair 0
  long long* kb[2] = {kbuf0, kbuf1};
  int* ib[2] = {out, ibuf};
  int cur = passes & 1;
  const long long tiles = (n + kTile - 1) / kTile;
  tile_sort<<<(unsigned)tiles, kTileThreads, 0, s>>>(keys, n, kb[cur], ib[cur]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + kMergeThreads - 1) / kMergeThreads;
  for (long long w = kTile; w < n; w *= 2) {
    merge_pass<<<(unsigned)blocks, kMergeThreads, 0, s>>>(
        kb[cur], ib[cur], kb[cur ^ 1], ib[cur ^ 1], n, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
