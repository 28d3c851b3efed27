// Sorted-key search: lower and upper bounds of int64 queries in a sorted
// int64 column, and the (s, p, o)-prefix range form of the same probe.
//
// Replaces: src/repro/kernels/bsearch.py, search_bounds and
// prefix_range_bounds -> _search_bounds_call -> _kernel, which counts
// #{k < q} and #{k <= q} as a tiled compare-and-reduce over every (query, key)
// pair: O(n * v) VPU work, because a TPU has no cheap dependent gather.
//
// Bound on the H100: memory.  The function must read each query and key
// once and write 4 bytes a side a query.  A search of its own for every
// query instead pays log2(v) dependent 8-byte loads a side.
//
// Almost every caller sends sorted queries (the membership probe of the
// deduplicated stream, the cumsum gathers of compaction and joins, merges,
// the segment plan's offsets), and then the queries of a tile all answer
// inside one narrow window of keys.  Design, one block a tile of kTile
// queries (thread t takes the tile's queries t, t + kThreads, ...):
//   1. the block checks that its tile is non-decreasing (each query against
//      the next one, then a block-wide AND); meanwhile warps 0 and 1 find
//      the window's ends, the bound of the tile's first and of its last
//      query, each by a 32-way search (the warp's lanes probe 32 evenly
//      spaced keys a round: 5 dependent loads for 2^22 keys, not 23).  A
//      tile that is not sorted takes the whole column as its window;
//   2. a tile whose queries are all equal is answered by the two ends;
//   3. otherwise the block loads the window, coalesced, into shared memory,
//      or every s-th key of it when it holds more than kWindow keys (the
//      KEY_MAX tail of the arena and a cumsum's plateaus give windows of
//      hundreds of thousands of keys; an unsorted tile samples the column);
//   4. each query counts in shared memory, then, where the window was
//      sampled, among the s - 1 keys between two samples in device memory;
//      a thread runs its queries' searches in lockstep.  In a tile that is
//      not sorted, the high side gallops up from the low side's answer.
// The plain form takes the query as both its low and its high key.  The
// prefix form packs its 1-3 leading 21-bit IDs into the low key (free
// positions 0) and the high key (free positions 2^21 - 1) in registers, so
// the caller never materialises the packed queries; its rows are sorted
// when both packed keys are.  The low side of a query counts the keys
// below its low key, the high side the keys at or below its high key;
// either output may be NULL to skip that side, and the window then spans
// only the side asked for.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                 // queries a thread answers
constexpr int kTile = kThreads * kPerThread;  // queries a block answers
constexpr int kWindow = 4096;                 // keys in shared memory: 32 KB
constexpr long long kMaxId = (1LL << 21) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool below(long long k, long long x, bool upper) {
  return upper ? k <= x : k < x;
}

// #{i < v : keys[i] < x} (or <= x when `upper`) by the 32 lanes of a warp
// together: each round probes 32 evenly spaced keys and keeps the gap the
// answer lies in.
__device__ __forceinline__ long long warp_count_below(const long long* __restrict__ keys,
                                      long long v, long long x, bool upper) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, len = v;  // the answer lies in [lo, lo + len]
  while (len > 32) {
    const long long step = (len + 31) >> 5;
    const long long p = lo + (lane + 1) * step - 1;
    const bool b = p < lo + len && below(keys[p], x, upper);
    const long long end = lo + len;
    lo += __popc(__ballot_sync(kFull, b)) * step;
    len = min(end, lo + step - 1) - lo;
  }
  const bool b = lane < len && below(keys[lo + lane], x, upper);
  return lo + __popc(__ballot_sync(kFull, b));
}

// For each of a thread's kPerThread queries x[j]: #{keys in the window of
// W keys below x[j]}, given every s-th of them in `window` (m samples).
// First among the samples in shared memory, then among the s - 1 keys
// after the last sample below it, in device memory (keys past the window
// count as not below).  Every query's search has the same length, so the
// thread runs them in lockstep: kPerThread independent loads in flight at
// each step, not one chain.  The branch-free steps keep a warp's threads
// in step whatever their comparisons.
__device__ __forceinline__ void count_window(const long long* window, int m,
                                             const long long* __restrict__ wkeys,
                                             long long W, long long s,
                                             const long long (&x)[kPerThread],
                                             bool upper, long long (&out)[kPerThread]) {
  int at[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) at[j] = 0;
  for (int len = m; len > 1;) {  // at[j] + #{samples below x[j]} in [0, len]
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      at[j] = below(window[at[j] + half], x[j], upper) ? at[j] + half : at[j];
    len -= half;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = at[j] + (m > 0 && below(window[at[j]], x[j], upper) ? 1 : 0);
    out[j] = c == 0 ? 0 : (long long)(c - 1) * s + 1;  // the answer is in
  }                                                     // [out, out + s - 1]
  for (long long len = s - 1; len > 0;) {
    const long long half = (len + 1) >> 1;  // probe out + half - 1
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long p = out[j] + half - 1;
      out[j] = p < W && below(wkeys[p], x[j], upper) ? p + 1 : out[j];
    }
    len -= half;
  }
}

// pos[j] = #{keys <= x[j]}, given on entry #{keys < a} for some a <= x[j]:
// galloping up from there.  A query that hits no key stops after its first
// probe, an exact hit of a key without duplicates after three: far fewer
// loads than a second search from the top.  The first probes run in
// lockstep.
__device__ __forceinline__ void gallop_upper(const long long* __restrict__ keys,
                                             long long v,
                                             const long long (&x)[kPerThread],
                                             long long (&pos)[kPerThread]) {
  bool more[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) more[j] = pos[j] < v && keys[pos[j]] <= x[j];
  for (int j = 0; j < kPerThread; ++j) {
    if (!more[j]) continue;
    long long base = pos[j] + 1, step = 1, len;  // keys before base are <= x
    for (;;) {
      const long long p = base + step - 1;
      if (p >= v) {
        len = v - base;
        break;
      }
      if (keys[p] > x[j]) {
        len = step - 1;  // the answer is in [base, p]
        break;
      }
      base = p + 1;
      step <<= 1;
    }
    while (len > 0) {  // the answer is in [base, base + len]
      const long long half = (len + 1) >> 1;
      const long long p = base + half - 1;
      base = keys[p] <= x[j] ? p + 1 : base;
      len -= half;
    }
    pos[j] = base;
  }
}

// the low and high key of query g
template <bool kPrefix>
__device__ __forceinline__ void query_keys(const long long* __restrict__ queries,
                                           const int* __restrict__ prefix, int k,
                                           long long g, long long& a,
                                           long long& b) {
  if (kPrefix) {
    a = 0;
    b = 0;
    for (int j = 0; j < 3; ++j) {
      const long long c = j < k ? (long long)prefix[g * k + j] : 0;
      a = (a << 21) | c;
      b = (b << 21) | (j < k ? c : kMaxId);
    }
  } else {
    a = queries[g];
    b = a;
  }
}

template <bool kPrefix>
__global__ void __launch_bounds__(kThreads, 4)
    search_tile_kernel(const long long* __restrict__ queries,
                       const int* __restrict__ prefix, int k, long long n,
                       const long long* __restrict__ keys, long long v,
                       int* __restrict__ lo_out, int* __restrict__ hi_out) {
  __shared__ long long window[kWindow];
  __shared__ long long ends[2];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long t_end = min(n, t0 + kTile);
  const bool want_lo = lo_out != nullptr, want_hi = hi_out != nullptr;

  long long a[kPerThread], b[kPerThread];  // past the tile's end: unused
  bool sorted = true;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long g = t0 + tid + j * kThreads;
    a[j] = b[j] = 0;
    if (g < t_end) {
      query_keys<kPrefix>(queries, prefix, k, g, a[j], b[j]);
      if (g + 1 < t_end) {
        long long na, nb;
        query_keys<kPrefix>(queries, prefix, k, g + 1, na, nb);
        sorted = sorted && a[j] <= na && b[j] <= nb;
      }
    }
  }
  // the window, were the tile sorted: from the low side's bound of its
  // first query (the high side's when only that is asked for) to the high
  // side's bound of its last (or the low side's)
  if (tid < 64) {
    const bool first = tid < 32;
    long long xa, xb;
    query_keys<kPrefix>(queries, prefix, k, first ? t0 : t_end - 1, xa, xb);
    const bool upper = first ? !want_lo : want_hi;
    const long long pos = warp_count_below(keys, v, upper ? xb : xa, upper);
    if ((tid & 31) == 0) ends[first ? 0 : 1] = pos;
    if (tid == 0) window[0] = xa;  // the first and last query's keys, to
    if (tid == 1) window[1] = xb;  // test the tile for a single value
    if (tid == 32) window[2] = xa;
    if (tid == 33) window[3] = xb;
  }
  sorted = __syncthreads_and(sorted);
  const bool uniform = sorted && window[0] == window[2] && window[1] == window[3];
  const long long L = sorted ? ends[0] : 0;
  const long long W = (sorted ? ends[1] : v) - L;
  if (uniform) {  // every query equals the first: the window's ends answer
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long g = t0 + tid + j * kThreads;
      if (g < t_end) {
        if (want_lo) lo_out[g] = (int)L;
        if (want_hi) hi_out[g] = (int)(L + W);
      }
    }
    return;
  }
  __syncthreads();  // window[0..3] read by every thread
  const long long s = W <= kWindow ? 1 : (W + kWindow - 1) / kWindow;
  const int m = (int)((W + s - 1) / s);
  for (int i = tid; i < m; i += kThreads) window[i] = keys[L + i * s];
  __syncthreads();

  long long c[kPerThread];
  if (want_lo) {
    count_window(window, m, keys + L, W, s, a, false, c);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long g = t0 + tid + j * kThreads;
      if (g < t_end) lo_out[g] = (int)(L + c[j]);
    }
  }
  if (want_hi) {
    if (want_lo && !sorted)  // from the low side's answers (L is 0 here)
      gallop_upper(keys, v, b, c);
    else
      count_window(window, m, keys + L, W, s, b, true, c);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long g = t0 + tid + j * kThreads;
      if (g < t_end) hi_out[g] = (int)(L + c[j]);
    }
  }
}

cudaError_t launch(const long long* queries, const int* prefix, int k,
                   long long n, const long long* keys, long long v, int* lo,
                   int* hi, void* stream) {
  if (n <= 0 || (lo == nullptr && hi == nullptr)) return cudaSuccess;
  const long long blocks = (n + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  if (prefix != nullptr)
    search_tile_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        queries, prefix, k, n, keys, v, lo, hi);
  else
    search_tile_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        queries, prefix, k, n, keys, v, lo, hi);
  return cudaGetLastError();
}

}  // namespace

// queries: (n,) int64; keys: (v,) int64 sorted ascending, v < 2^31.
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
