// Flash attention forward: GQA, causal or not, with a query offset for
// decoding against a KV cache.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd ->
// _flash_kernel (pallas_call :121), with the (B, S, H, D) wrapper of
// src/repro/kernels/ops.py:68.  The Pallas kernel walks a (B, H, S/bq, T/bk)
// grid with the KV axis innermost and carries the online-softmax state
// (m, l, acc) in VMEM scratch across the KV steps of one query block.
//
// Semantics (those of the Pallas kernel): query head h reads KV head
// h / (H / KV); scores in f32 from the inputs cast to f32, times
// scale = 1 / sqrt(D); masked with -1e30 (not -inf) where the key is at or
// beyond T or, when causal, where q_offset + i < j; online softmax with f32
// running max, denominator and accumulator; out = acc / max(l, 1e-30) cast
// to the input type.
//
// Bound on the H100: operations at long prefill (4 * D flops per query and
// admitted key against 989 TFLOP/s of bf16 tensor cores), bytes at decode
// (the KV rows once).  This first version is exact and simple and does its
// arithmetic in f32 FMAs on the CUDA cores, not the tensor cores; wgmma and
// TMA are later work.
// Design:
//   * One block per (64 flat query rows, KV head, batch row).  The rows of a
//     block are the flattened (query position, head in the group) pairs of
//     one KV head, f = s * G + g, so the G query heads that share a KV head
//     share every K/V tile that the block loads, and a decode step (S = 1)
//     fills G rows of a block rather than one.
//   * The block walks the keys in tiles of 64 through shared memory, loaded
//     with 16-byte vector loads through the strides it is given (a layer of
//     the KV arena is read in place).  Tiles wholly beyond the last key that
//     the block's last query may see are skipped: their scores would be
//     -1e30 and add exactly 0 once the running max is a real score, which it
//     is after the first tile, because key 0 is admitted for every query
//     (q_offset >= 0).  So no row ever meets a tile that is all masked before
//     a real score has set its max.
//   * 128 threads: thread (ty, tx) owns query rows 4ty..4ty+3 and keys
//     tx + 8j of the tile (32 scores); row max and row sum reduce over the 8
//     lanes of a row group with shuffles.  P goes through shared memory for
//     the P.V product, where the thread owns columns tx + 8c of its 4 rows.
//   * Shared rows are padded by one float so that column reads hit distinct
//     banks.  Shared memory: (3 * 64 * (D + 1) + 64 * 65) * 4 bytes, 66,560
//     at D = 64 and 115,712 at D = 128, above the 48 KB default, so the
//     launcher raises the kernel's dynamic limit first.
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // flat (query, group head) rows per block
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 128; // 16 row groups x 8 lanes
constexpr int kLP = kKeys + 1;
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long B, S, T, H, KV;
  long long qs_b, qs_s, qs_h, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h;
  long long q_offset;
  int causal;
  float scale;
};

__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Load `n` rows of D values into shared rows of stride D + 1 as f32; row r
// starts at base + offset(r) elements, or is zero when offset(r) < 0.
template <typename T, int D, typename Offset>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int n,
                                          Offset offset) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    const long long off = offset(r);
    float vals[kVec];
    if (off >= 0) {
      const uint4 u = *reinterpret_cast<const uint4*>(base + off + c);
      unpack(u, vals, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * (D + 1) + c + e] = vals[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;              // kRows x LD
  float* sK = sQ + kRows * LD;   // kKeys x LD
  float* sV = sK + kKeys * LD;   // kKeys x LD
  float* sP = sV + kKeys * LD;   // kRows x kLP

  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const long long G = a.H / a.KV;
  const long long n_rows = a.S * G;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  load_tile<T, D>(sQ, Q, kRows, [&](int r) -> long long {
    const long long f = row0 + r;
    if (f >= n_rows) return -1;
    const long long s = f / G, h = kvh * G + f % G;
    return b * a.qs_b + s * a.qs_s + h * a.qs_h;
  });

  long long qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = min(row0 + ty * 4 + i, n_rows - 1);
    qpos[i] = a.q_offset + f / G;
  }
  long long kend = a.T;
  if (a.causal) {
    const long long s_last = (min(row0 + kRows, n_rows) - 1) / G;
    kend = min(kend, a.q_offset + s_last + 1);
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = 0; k0 < kend; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, K, kKeys, [&](int r) -> long long {
      const long long j = k0 + r;
      return j < a.T ? b * a.ks_b + j * a.ks_t + kvh * a.ks_h : -1;
    });
    load_tile<T, D>(sV, V, kKeys, [&](int r) -> long long {
      const long long j = k0 + r;
      return j < a.T ? b * a.vs_b + j * a.vs_t + kvh * a.vs_h : -1;
    });
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long key = k0 + tx + 8 * j;
        const bool ok = key < a.T && (!a.causal || qpos[i] >= key);
        sc[i][j] = ok ? sc[i][j] * a.scale : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sP[(ty * 4 + i) * kLP + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kLP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[j * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* O = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = row0 + ty * 4 + i;
    if (f >= n_rows) continue;
    const long long s = f / G, h = kvh * G + f % G;
    T* o = O + ((b * a.S + s) * a.H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o + tx + 8 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = (3 * kRows * (D + 1) + kRows * kLP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.S * (a.H / a.KV) + kRows - 1) / kRows;
  const dim3 grid((unsigned)blocks, (unsigned)a.KV, (unsigned)a.B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, D), k and v: (B, T, KV, D), f32 (is_bf16 = 0) or bf16, each
// with the given element strides for its first three dimensions and a
// contiguous last one; every row 16-byte aligned.  out: (B, S, H, D)
// contiguous, of q's type.  H % KV == 0, q_offset >= 0, D in {64, 128}.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, long long B, long long S, long long T,
                               long long H, long long KV, long long qs_b,
                               long long qs_s, long long qs_h, long long ks_b,
                               long long ks_t, long long ks_h, long long vs_b,
                               long long vs_t, long long vs_h, int causal,
                               long long q_offset, float scale, int D,
                               int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || q_offset < 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, S, T, H, KV, qs_b, qs_s, qs_h, ks_b, ks_t,
               ks_h, vs_b, vs_t, vs_h, q_offset, causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return is_bf16 ? launch<__nv_bfloat16, 64>(a, st)
                              : launch<float, 64>(a, st);
  if (D == 128) return is_bf16 ? launch<__nv_bfloat16, 128>(a, st)
                               : launch<float, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}
