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
// The segments can be very uneven: one node of the OpenCyc-scale graph has
// 412,800 of its 2,398,800 in-edges.  A warp or a block per segment would
// run that segment alone for milliseconds, so the work is cut by edges:
//
//   plan (built once per graph by the caller, with the port's own kernels):
//     perm    a stable sort of seg (dedup_order), so a segment's rows are
//             visited in their original order;
//     sseg    seg[perm], the sorted segment ids;
//     offsets (n + 1,): offsets[s] = #{seg < s} (search_bounds); the
//             in-range rows are the sorted positions [offsets[0], offsets[n]).
//   pass 1 (seg_chunk_kernel): the in-range sorted positions are cut into
//     chunks of `chunk` rows; one warp walks a chunk in order, lanes over
//     the columns, and keeps the running sum of the current segment in
//     registers.  A segment that begins and ends inside the chunk is
//     written to out directly.  The chunk's first segment, when it began in
//     an earlier chunk, leaves its partial sum in carry[c][0]; its last
//     segment, when it goes on into a later chunk, in carry[c][1] (a
//     segment that covers the whole chunk is its first: slot 0).
//   pass 2 (seg_carry_kernel): one thread per output value.  An empty
//     segment writes zero; a segment that spans chunks c0 < c1 adds
//     carry[c0][1] + carry[c0 + 1][0] + ... + carry[c1][0] in chunk order;
//     any other segment was written by pass 1.
//
// No atomics: every value is summed in a fixed order, so two runs on the
// same inputs give the same bits.  Rows of x are gathered through perm (a
// row of 70 f32 values is 280 bytes, read by the warp's lanes side by
// side); each lane batches 8 rows' loads before it adds them, so that a
// warp keeps several loads in flight.  Nothing here allocates or
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // rows whose loads a lane issues before it adds them
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// G column groups of 32 per lane pass; columns [k0, k0 + 32 * G).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    seg_chunk_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                     const int* __restrict__ sseg,
                     const int* __restrict__ offsets, long long n, int K,
                     int chunk, long long n_chunks, T* __restrict__ out,
                     float* __restrict__ carry) {
  const long long c = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;  // the whole warp leaves together
  const long long base = offsets[0], end = offsets[n];
  const long long lo = base + c * chunk;
  if (lo >= end) return;
  const long long hi = lo + chunk < end ? lo + chunk : end;
  // does the chunk's first segment begin before it, its last go on after it?
  const bool first_split = lo > base && sseg[lo - 1] == sseg[lo];
  const bool last_split = hi < end && sseg[hi] == sseg[hi - 1];

  for (int k0 = 0; k0 < K; k0 += 32 * G) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    int cur = -1;
    bool is_first = true;
    // write the finished run of segment s (warp-uniform)
    auto flush = [&](int s, bool is_last) {
      const bool head = is_first && first_split;
      const bool tail = is_last && last_split;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = k0 + g * 32 + lane;
        if (col >= K) continue;
        if (head || tail)
          carry[(c * 2 + (head ? 0 : 1)) * K + col] = acc[g];
        else
          store(out + (long long)s * K + col, acc[g]);
        acc[g] = 0.f;
      }
      is_first = false;
    };
    for (long long b = lo; b < hi; b += 32) {
      const long long idx = b + lane;
      int my_seg = 0, my_row = 0;
      if (idx < hi) {
        my_seg = sseg[idx];
        my_row = perm[idx];
      }
      const int cnt = hi - b < 32 ? (int)(hi - b) : 32;
      for (int t0 = 0; t0 < cnt; t0 += kBatch) {
        int s[kBatch];
        float v[kBatch][G];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + u;
          s[u] = __shfl_sync(kFull, my_seg, t & 31);
          const long long r = __shfl_sync(kFull, my_row, t & 31);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int col = k0 + g * 32 + lane;
            v[u][g] = (t < cnt && col < K) ? to_f32(x[r * K + col]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u >= cnt) break;
          if (s[u] != cur) {
            if (cur >= 0) flush(cur, false);
            cur = s[u];
          }
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += v[u][g];
        }
      }
    }
    flush(cur, true);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_carry_kernel(const int* __restrict__ offsets, long long n, int K,
                     int chunk, const float* __restrict__ carry,
                     T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n * K) return;
  const long long s = g / K;
  const int col = (int)(g - s * K);
  const long long so = offsets[s], eo = offsets[s + 1];
  if (so == eo) {
    store(out + g, 0.f);
    return;
  }
  const long long base = offsets[0];
  const long long c0 = (so - base) / chunk, c1 = (eo - 1 - base) / chunk;
  if (c0 == c1) return;  // pass 1 wrote it
  float acc = carry[(c0 * 2 + 1) * K + col];
#pragma unroll 8
  for (long long c = c0 + 1; c <= c1; ++c) acc += carry[c * 2 * K + col];
  store(out + g, acc);
}

template <typename T, int G>
void launch_chunks(const void* x, const int* perm, const int* sseg,
                   const int* offsets, long long n, int K, int chunk,
                   long long n_chunks, void* out, float* carry,
                   cudaStream_t st) {
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  seg_chunk_kernel<T, G><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), perm, sseg, offsets, n, K, chunk, n_chunks,
      static_cast<T*>(out), carry);
}

template <typename T>
int launch(const void* x, const int* perm, const int* sseg, const int* offsets,
           long long E, long long n, int K, int chunk, void* out, float* carry,
           cudaStream_t st) {
  const long long n_chunks = (E + chunk - 1) / chunk;
  if (n_chunks > 0) {
    // hold up to 4 column groups (128 columns) in registers; wider rows
    // take several column passes over the chunk
    if (K <= 32)
      launch_chunks<T, 1>(x, perm, sseg, offsets, n, K, chunk, n_chunks, out,
                          carry, st);
    else if (K <= 64)
      launch_chunks<T, 2>(x, perm, sseg, offsets, n, K, chunk, n_chunks, out,
                          carry, st);
    else if (K <= 96)
      launch_chunks<T, 3>(x, perm, sseg, offsets, n, K, chunk, n_chunks, out,
                          carry, st);
    else
      launch_chunks<T, 4>(x, perm, sseg, offsets, n, K, chunk, n_chunks, out,
                          carry, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n * K + kThreads - 1) / kThreads;
  seg_carry_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      offsets, n, K, chunk, carry, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, K) contiguous, f32 (is_bf16 = 0) or bf16; perm, sseg: (E,) int32,
// the plan's stable sort of seg and the sorted ids; offsets: (n + 1,) int32;
// out: (n, K) of x's type; carry: f32 scratch of 2 * K * ceil(E / chunk)
// values.  E < 2^31.
extern "C" int segment_sum(const void* x, const int* perm, const int* sseg,
                           const int* offsets, long long E, long long n, int K,
                           int chunk, void* out, float* carry, int is_bf16,
                           void* stream) {
  if (n <= 0 || K <= 0) return (int)cudaSuccess;
  if (E < 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, perm, sseg, offsets, E, n, K, chunk,
                                         out, carry, st)
                 : launch<float>(x, perm, sseg, offsets, E, n, K, chunk, out,
                                 carry, st);
}
