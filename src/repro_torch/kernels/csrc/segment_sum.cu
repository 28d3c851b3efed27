// Segment sum: out[s] = sum of the rows x[i] with seg[i] == s, for s in
// [0, n); rows whose segment lies outside [0, n) are dropped and empty
// segments are zero.  f32 sums, one rounding to x's type at the end.
//
// Replaces: src/repro/kernels/segment_sum.py, segment_sum -> _kernel
// (pallas_call :60), which multiplies a transposed one-hot of each
// (segment tile x input block) with x on the MXU: O(n * E) work, a TPU
// workaround.  Here the work is O(E * K).
//
// Bound on the H100: memory.  The function must read the E rows of x once
// (E * K * 4 bytes in f32: 0.67 GB for the OpenCyc-scale graph at K 70) and
// write n * K values; it adds once per value read.
//
// The plan (built once per graph by the caller, with the port's own
// kernels): perm, a stable sort of seg (dedup_order), so a segment's rows
// are visited in their original order; sseg = seg[perm]; offsets (n + 1,),
// offsets[s] = #{seg < s} (search_bounds).  The in-range rows are the sorted
// positions [offsets[0], offsets[n]).
//
// The segments can be very uneven (one node of the OpenCyc-scale graph has
// 412,800 of its 2,398,800 in-edges), so the work is cut by rows:
//
//   pass 1: a grid of as many blocks as the card holds at once (from the
//     occupancy API) cuts the in-range rows into one equal range a warp, a
//     multiple of 32 rows, warps of a block side by side.  A warp walks its
//     range in order and writes every segment that begins and ends inside
//     it; the partial sum of its first segment, when that began before the
//     range, and of its last, when that goes on after it, go to shared
//     memory.  The block then adds those partials in warp order: a segment
//     that begins and ends inside the block is written; the block's first
//     segment, when it began in an earlier block, leaves its partial in
//     carry[b][0], its last, when it goes on into a later block, in
//     carry[b][1] (a segment that covers the whole block: slot 0).
//       Wide rows (K > 8): lanes over the columns, in vectors of 4, 2 or 1
//     values (the widest that divides K and x's alignment: K 70 in f32 is
//     35 float2), up to 4 groups of 32 vectors at once.  The rows are
//     gathered by cp.async into a double buffer in shared memory, up to 32
//     rows a stage, two stages in flight a warp, and added from there.
//       Narrow rows (K <= 8, the degree counts' K 1): lanes over rows, 128
//     rows' loads in flight (and the next 128 rows' ids), then a segmented
//     scan of each 32 rows by warp shuffles; the last lane of a run holds
//     its sum.
//   pass 2: a warp a 32 segments.  An empty segment writes zero; a segment
//     that spans blocks b0 < b1 adds carry[b0][1] + carry[b0 + 1][0] + ...
//     + carry[b1][0] in block order; any other segment pass 1 wrote.
//
// No atomics: every value is summed in a fixed order, so two runs on the
// same inputs give the same bits.  Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V values of x loaded or stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The cut of the in-range sorted rows into `warps` equal ranges of `chunk`
// rows, a multiple of 32; block b holds the ranges of its kWarps warps.
struct Cut {
  long long base, end, chunk;
  __device__ __forceinline__ Cut(const int* __restrict__ offsets, long long n, long long warps) {
    base = offsets[0];
    end = offsets[n];
    const long long c = (end - base + warps - 1) / warps;
    chunk = c < 32 ? 32 : (c + 31) / 32 * 32;
  }
  __device__ __forceinline__ long long block_of(long long p) const {
    return (unsigned)(p - base) / (unsigned)(chunk * kWarps);  // both < 2^32
  }
};

// One warp's range [lo, hi) of sorted rows and its two edge segments.
struct Range {
  long long lo, hi;
  int first_seg, last_seg;
  bool first_split, last_split;  // begins before the range, goes on after it
  __device__ __forceinline__ Range(const Cut& cut, long long warp, const int* __restrict__ sseg) {
    lo = min(cut.base + warp * cut.chunk, cut.end);
    hi = min(lo + cut.chunk, cut.end);
    const bool any = lo < hi;
    first_seg = any ? sseg[lo] : -1;
    last_seg = any ? sseg[hi - 1] : -1;
    first_split = any && lo > cut.base && sseg[lo - 1] == first_seg;
    last_split = any && hi < cut.end && sseg[hi] == last_seg;
  }
  // where a finished run of segment s goes: 0 the head partial, 1 the tail
  // partial, 2 the output
  __device__ __forceinline__ int route(int s) const {
    if (s == first_seg && first_split) return 0;
    if (s == last_seg && last_split) return 1;
    return 2;
  }
};

// What the block's combine needs to know of one warp's partials.
struct WarpMeta {
  int head_seg;
  bool any, has_head, head_closes, has_tail;
};

__device__ __forceinline__ WarpMeta meta_of(const Range& r) {
  WarpMeta m;
  m.head_seg = r.first_seg;
  m.any = r.lo < r.hi;
  const bool one = r.first_seg == r.last_seg;
  m.has_head = r.first_split;
  m.head_closes = !(one && r.last_split);
  m.has_tail = r.last_split && !(one && r.first_split);
  return m;
}

// The block adds its warps' partials in warp order, one thread a column of
// the pass: piece[(w * 2 + slot) * pc + c] is warp w's head (slot 0) or
// tail (1) partial of column col0 + c.
template <typename T>
__device__ __forceinline__ void combine_block(const WarpMeta* meta, const float* piece, int pc,
                              int col0, int ncols, int K, T* __restrict__ out,
                              float* __restrict__ carry) {
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    const int col = col0 + c;
    float run = 0.f;
    bool open = false, from_before = false;
    for (int w = 0; w < kWarps && meta[w].any; ++w) {
      const WarpMeta m = meta[w];
      if (m.has_head) {
        const float p = piece[(w * 2) * pc + c];
        if (open) {
          run += p;
        } else {  // the block's first warp: the segment began before it
          run = p;
          open = from_before = true;
        }
        if (m.head_closes) {
          if (from_before)
            carry[(b * 2) * K + col] = run;
          else
            out[(long long)m.head_seg * K + col] = from_f32<T>(run);
          open = false;
        }
      }
      if (m.has_tail) {
        run = piece[(w * 2 + 1) * pc + c];
        open = true;
        from_before = false;
      }
    }
    if (open) carry[(b * 2 + (from_before ? 0 : 1)) * K + col] = run;
  }
}

// A wide warp's finished run of segment s (warp-uniform): its sums go to
// the output, or to the warp's head or tail partial in shared memory, and
// are zeroed.
template <typename T, int V, int G>
__device__ __forceinline__ void flush_wide(float (&acc)[G][V], int where, int s,
                                          int v0, int nv, int lane,
                                          Vec<T, V>* __restrict__ ov,
                                          float* part) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int vi = v0 + g * 32 + lane;
    if (vi < nv) {
      if (where == 2) {
        Vec<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(acc[g][e]);
        ov[(long long)s * nv + vi] = o;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) part[(g * 32 + lane) * V + e] = acc[g][e];
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }
}

// cp.async: B bytes (4, 8 or 16) from device memory to shared memory,
// in flight until copy_wait; copy_commit closes a group of them.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(B));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lane u < R of a wide warp holds the id and row of the u-th row of stage
// j of its range (R rows a stage).
__device__ __forceinline__ void stage_ids(const Range& r, long long j, int R,
                                          int lane, const int* __restrict__ sseg,
                                          const int* __restrict__ perm, int& seg,
                                          int& row) {
  const long long i = r.lo + j * R + lane;
  seg = -1;
  row = 0;
  if (lane < R && i < r.hi) {
    seg = sseg[i];
    row = perm[i];
  }
}

// Start the copies of stage j's rows (this pass's pv vectors of each, from
// vector v0 on) into buf, one group; a stage past the range is an empty
// group.  Lanes over the vectors, a row at a time.
template <typename T, int V, int G>
__device__ __forceinline__ void stage_issue(Vec<T, V>* buf,
                                            const Vec<T, V>* __restrict__ xv,
                                            int row, const Range& r, long long j,
                                            int R, int nv, int v0, int pv,
                                            int lane) {
  const long long cnt = min((long long)R, r.hi - (r.lo + j * R));
  for (int u = 0; u < cnt; ++u) {
    const long long src = (long long)__shfl_sync(kFull, row, u) * nv + v0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int vi = g * 32 + lane;
      if (vi < pv) {
        if constexpr (sizeof(Vec<T, V>) >= 4)
          copy_async<sizeof(Vec<T, V>)>(buf + u * pv + vi, xv + src + vi);
        else  // 2-byte vectors (bf16 rows of odd width): too small to copy async
          buf[u * pv + vi] = xv[src + vi];
      }
    }
  }
  copy_commit();
}

// Pass 1, wide rows: lanes over vectors of V values, G groups of 32
// vectors a column pass.  Each warp gathers its rows R at a time into a
// double buffer in shared memory with cp.async, two stages in flight (the
// compiler cannot sink these copies next to their use, as it does loads
// into registers), and adds them from there.  Dynamic shared memory:
// kWarps * 2 * 32 * G * V partials, then each warp's 2 * R * pw vectors,
// pw = min(K / V, 32 * G).
template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads, 2)
    seg_wide_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                    const int* __restrict__ sseg, const int* __restrict__ offsets,
                    long long n, int K, long long warps, int R,
                    T* __restrict__ out, float* __restrict__ carry) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WarpMeta meta[kWarps];
  constexpr int kPC = 32 * G * V;  // columns a pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Cut cut(offsets, n, warps);
  const Range r(cut, (long long)blockIdx.x * kWarps + warp, sseg);
  if (lane == 0) meta[warp] = meta_of(r);
  const int nv = K / V;  // vectors a row
  const int pw = min(nv, 32 * G);
  float* piece = reinterpret_cast<float*>(smem);
  Vec<T, V>* stages = reinterpret_cast<Vec<T, V>*>(piece + kWarps * 2 * kPC) +
                      warp * 2 * R * pw;
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  Vec<T, V>* ov = reinterpret_cast<Vec<T, V>*>(out);
  const long long n_stages = (r.hi - r.lo + R - 1) / R;

  for (int v0 = 0; v0 < nv; v0 += 32 * G) {
    const int pv = min(nv - v0, 32 * G);  // this pass's vectors a row
    float acc[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
    int cur = r.first_seg;
    // ids of stages j (seg0), j + 1 (seg1) and j + 2 (seg2, row2)
    int seg0, seg1, seg2, row0, row1, row2;
    stage_ids(r, 0, R, lane, sseg, perm, seg0, row0);
    stage_ids(r, 1, R, lane, sseg, perm, seg1, row1);
    stage_ids(r, 2, R, lane, sseg, perm, seg2, row2);
    stage_issue<T, V, G>(stages, xv, row0, r, 0, R, nv, v0, pv, lane);
    stage_issue<T, V, G>(stages + R * pw, xv, row1, r, 1, R, nv, v0, pv, lane);
    for (long long j = 0; j < n_stages; ++j) {
      copy_wait<1>();  // stage j has landed; j + 1 may be in flight
      __syncwarp();
      Vec<T, V>* buf = stages + (j & 1) * R * pw;
      const int cnt = (int)min((long long)R, r.hi - (r.lo + j * R));
      for (int u = 0; u < cnt; ++u) {
        const int s = __shfl_sync(kFull, seg0, u);
        if (s != cur) {
          const int where = r.route(cur);
          flush_wide<T, V, G>(acc, where, cur, v0, nv, lane, ov,
                              piece + (warp * 2 + where % 2) * kPC);
          cur = s;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int vi = g * 32 + lane;
          if (vi < pv) {
            const Vec<T, V> w = buf[u * pv + vi];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[g][e] += to_f32(w.v[e]);
          }
        }
      }
      __syncwarp();  // buf is read: stage j + 2 may overwrite it
      stage_issue<T, V, G>(buf, xv, row2, r, j + 2, R, nv, v0, pv, lane);
      seg0 = seg1;
      seg1 = seg2;
      stage_ids(r, j + 3, R, lane, sseg, perm, seg2, row2);
    }
    copy_wait<0>();
    if (r.lo < r.hi) {
      const int where = r.route(cur);
      flush_wide<T, V, G>(acc, where, cur, v0, nv, lane, ov,
                          piece + (warp * 2 + where % 2) * kPC);
    }
    __syncthreads();
    combine_block<T>(meta, piece, kPC, v0 * V, pv * V, K, out, carry);
    __syncthreads();  // the next pass reuses piece
  }
}

// Pass 1, narrow rows (K <= KM <= 8): lanes over rows.
template <typename T, int KM>
__global__ void __launch_bounds__(kThreads, 2)
    seg_narrow_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                      const int* __restrict__ sseg, const int* __restrict__ offsets,
                      long long n, int K, long long warps, T* __restrict__ out,
                      float* __restrict__ carry) {
  __shared__ float piece[kWarps * 2 * KM];
  __shared__ WarpMeta meta[kWarps];
  constexpr int kU = 4;  // runs of 32 rows whose loads are in flight together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Cut cut(offsets, n, warps);
  const Range r(cut, (long long)blockIdx.x * kWarps + warp, sseg);
  if (lane == 0) meta[warp] = meta_of(r);

  int carry_seg = -1;  // the run that goes on from the last 32 rows, and its sum
  float carry_v[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) carry_v[j] = 0.f;
  int next_sg[kU], next_row[kU];  // the ids and rows of the next 32 * kU
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long i = r.lo + u * 32 + lane;
    next_sg[u] = i < r.hi ? sseg[i] : -2;
    next_row[u] = i < r.hi ? perm[i] : 0;
  }
  for (long long b0 = r.lo; b0 < r.hi; b0 += 32 * kU) {
    int sg[kU];
    float v[kU][KM];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      sg[u] = next_sg[u];
#pragma unroll
      for (int j = 0; j < KM; ++j)
        v[u][j] = sg[u] != -2 && j < K ? to_f32(x[(long long)next_row[u] * K + j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = b0 + (kU + u) * 32 + lane;
      next_sg[u] = i < r.hi ? sseg[i] : -2;
      next_row[u] = i < r.hi ? perm[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long first = b0 + u * 32;
      if (first >= r.hi) break;  // warp-uniform
      // inclusive scan of each run of equal ids (a run is contiguous):
      // lane l adds lane l - d's sum while l - d is in its run
      const int prev = __shfl_up_sync(kFull, sg[u], 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != sg[u]);
      const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          const float o = __shfl_up_sync(kFull, v[u][j], d);
          if (lane - d >= start) v[u][j] += o;
        }
      }
      if (sg[u] == carry_seg) {  // the first run goes on from before
#pragma unroll
        for (int j = 0; j < KM; ++j) v[u][j] += carry_v[j];
      }
      const int next = __shfl_down_sync(kFull, sg[u], 1);
      const long long last = min(first + 31, r.hi - 1);
      const int last_lane = (int)(last - first);
      const bool goes_on = last + 1 < r.hi && sseg[last + 1] == sseg[last];
      const bool run_end = lane <= last_lane && (lane == last_lane || next != sg[u]);
      if (run_end && !(lane == last_lane && goes_on)) {
        const int where = r.route(sg[u]);
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j >= K) break;
          if (where == 2)
            out[(long long)sg[u] * K + j] = from_f32<T>(v[u][j]);
          else
            piece[(warp * 2 + where) * KM + j] = v[u][j];
        }
      }
      carry_seg = goes_on ? __shfl_sync(kFull, sg[u], last_lane) : -1;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        const float c = __shfl_sync(kFull, v[u][j], last_lane);
        carry_v[j] = goes_on ? c : 0.f;
      }
    }
  }
  __syncthreads();
  combine_block<T>(meta, piece, KM, 0, K, K, out, carry);
}

// Pass 2: empty segments and segments that span blocks, a warp a 32
// segments (lane l tests segment 32 w + l).  Empty rows are zeroed, by
// their own lane for narrow rows, else by the warp's lanes side by side
// over its 32 rows (one stretch of memory); then the warp adds each
// spanning segment's partials, lanes over the columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    seg_fix_kernel(const int* __restrict__ offsets, long long n, int K,
                   long long warps, const float* __restrict__ carry,
                   T* __restrict__ out) {
  const Cut cut(offsets, n, warps);
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s0 = s - lane;  // the warp's first segment
  long long b0 = 0, b1 = 0;
  bool empty = false;
  if (s < n) {
    const long long so = offsets[s], eo = offsets[s + 1];
    empty = so == eo;
    if (!empty) {
      b0 = cut.block_of(so);
      b1 = cut.block_of(eo - 1);
    }
  }
  if (K <= 8) {
    if (empty)
      for (int col = 0; col < K; ++col) out[s * K + col] = from_f32<T>(0.f);
  } else if (const unsigned m = __ballot_sync(kFull, empty)) {
    T* base = out + s0 * K;
    const long long total = min(32LL, n - s0) * K;
    int row = lane / K, col = lane % K;
    for (long long i = lane; i < total; i += 32) {
      if ((m >> row) & 1) base[i] = from_f32<T>(0.f);
      for (col += 32; col >= K; col -= K) ++row;
    }
  }
  for (unsigned m = __ballot_sync(kFull, b0 != b1); m; m &= m - 1) {
    const int l = __ffs(m) - 1;
    const long long c0 = __shfl_sync(kFull, b0, l), c1 = __shfl_sync(kFull, b1, l);
    T* row = out + (s0 + l) * K;
    for (int col = lane; col < K; col += 32) {
      float acc = carry[(c0 * 2 + 1) * K + col];
#pragma unroll 16
      for (long long b = c0 + 1; b <= c1; ++b) acc += carry[b * 2 * K + col];
      row[col] = from_f32<T>(acc);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Pass 1's grid: the blocks the card holds at once, no more than the rows
// fill (32 a warp) or the carry scratch has room for.
template <typename Kernel>
long long grid_of(Kernel kernel, int& occupancy, size_t smem, long long E,
                  long long max_blocks) {
  if (occupancy == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, kThreads, smem);
    if (occupancy < 1) occupancy = 1;
  }
  long long grid = (long long)sm_count() * occupancy;
  grid = min(grid, (E + kThreads - 1) / kThreads);
  grid = min(grid, max_blocks);
  return grid < 1 ? 1 : grid;
}

struct Args {
  const void* x;
  const int *perm, *sseg, *offsets;
  long long E, n;
  int K;
  void* out;
  float* carry;
  long long max_blocks;
  cudaStream_t st;
};

constexpr int kStageBytes = 10240;  // a wide warp's two stages of rows, at most

template <typename T, int V, int G>
long long launch_wide(const Args& a) {
  static int occupancy = 0;
  static size_t occupancy_smem = 0;
  const int pw = min(a.K / V, 32 * G);
  const size_t row_bytes = sizeof(Vec<T, V>) * pw;
  int R = 32;  // rows a stage: the most whose two stages fit
  while (R > 1 && 2 * R * row_bytes > kStageBytes) R /= 2;
  const size_t smem = sizeof(float) * kWarps * 2 * 32 * G * V +
                      kWarps * 2 * R * row_bytes;
  if (smem != occupancy_smem) {  // ask again for another footprint
    cudaFuncSetAttribute(seg_wide_kernel<T, V, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    occupancy = 0;
    occupancy_smem = smem;
  }
  const long long grid = grid_of(seg_wide_kernel<T, V, G>, occupancy, smem, a.E,
                                 a.max_blocks);
  seg_wide_kernel<T, V, G><<<(unsigned)grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.x), a.perm, a.sseg, a.offsets, a.n, a.K,
      grid * kWarps, R, static_cast<T*>(a.out), a.carry);
  return grid;
}

template <typename T, int KM>
long long launch_narrow(const Args& a) {
  static int occupancy = 0;
  const long long grid = grid_of(seg_narrow_kernel<T, KM>, occupancy, 0, a.E,
                                 a.max_blocks);
  seg_narrow_kernel<T, KM><<<(unsigned)grid, kThreads, 0, a.st>>>(
      static_cast<const T*>(a.x), a.perm, a.sseg, a.offsets, a.n, a.K,
      grid * kWarps, static_cast<T*>(a.out), a.carry);
  return grid;
}

template <typename T, int V>
long long launch_wide_g(const Args& a) {
  const int groups = (a.K / V + 31) / 32;  // column groups of 32 vectors
  if (groups <= 1) return launch_wide<T, V, 1>(a);
  if (groups == 2) return launch_wide<T, V, 2>(a);
  if (groups == 3) return launch_wide<T, V, 3>(a);
  return launch_wide<T, V, 4>(a);  // and more column passes beyond 4
}

template <typename T>
int launch(const Args& a) {
  long long grid = 1;
  if (a.E > 0) {
    if (a.K <= 1)
      grid = launch_narrow<T, 1>(a);
    else if (a.K <= 2)
      grid = launch_narrow<T, 2>(a);
    else if (a.K <= 4)
      grid = launch_narrow<T, 4>(a);
    else if (a.K <= 8)
      grid = launch_narrow<T, 8>(a);
    else {
      // the widest vector that divides the row and x's alignment
      const unsigned long long addr = (unsigned long long)a.x;
      const int v4 = 4 * sizeof(T), v2 = 2 * sizeof(T);
      if (a.K % 4 == 0 && addr % v4 == 0)
        grid = launch_wide_g<T, 4>(a);
      else if (a.K % 2 == 0 && addr % v2 == 0)
        grid = launch_wide_g<T, 2>(a);
      else
        grid = launch_wide_g<T, 1>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  seg_fix_kernel<T><<<(unsigned)blocks, kThreads, 0, a.st>>>(
      a.offsets, a.n, a.K, grid * kWarps, a.carry, static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, K) contiguous, f32 (is_bf16 = 0) or bf16; perm, sseg: (E,) int32,
// the plan's stable sort of seg and the sorted ids; offsets: (n + 1,) int32;
// out: (n, K) of x's type; carry: f32 scratch of 2 * K * max_blocks values,
// max_blocks at least segment_sum_max_blocks().  E < 2^31.
extern "C" int segment_sum(const void* x, const int* perm, const int* sseg,
                           const int* offsets, long long E, long long n, int K,
                           void* out, float* carry, long long max_blocks,
                           int is_bf16, void* stream) {
  if (n <= 0 || K <= 0) return (int)cudaSuccess;
  if (E < 0 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const Args a{x, perm, sseg, offsets, E, n, K, out, carry, max_blocks,
               (cudaStream_t)stream};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// The most blocks pass 1 runs: as many as the card holds at once, at most
// 2048 threads an SM.
extern "C" long long segment_sum_max_blocks() {
  return (long long)sm_count() * (2048 / kThreads);
}
