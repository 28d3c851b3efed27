// EmbeddingBag: out[b] = sum_f table[ids[b, f]] for ids (B, F) into a
// (V, K) table; an id outside [0, V) adds zero.  f32 sums over the fields
// in order, one rounding to the table's type at the end.
//
// Replaces: src/repro/kernels/embedding_bag.py, embedding_bag -> _kernel
// (pallas_call :60), which gathers through a one-hot matmul of the ids
// against every table tile on the MXU (a TPU has no cheap dynamic gather):
// O(B * F * V) work.  Here each id costs one row read.
//
// Bound on the H100: memory, and random reads.  The function must read the
// ids once, one table row per id, and write B * K values.  A row read at a
// random place costs whole 32-byte sectors, however narrow the row: the
// FM's first-order weights are rows of one f32 (4 bytes), so each of the
// 262,144 x 39 lookups of a bulk batch moves a 32-byte sector, 8x the bytes
// it uses.  The bound counts sectors, not the bytes the sum uses.
//
// Design: one thread per output value (b, k); for K = 1 that is one thread
// per bag.  The threads of a bag read its ids (the same addresses, served
// by L1) and neighbouring columns of each row.  A thread loads 8 ids, then
// the 8 rows they name, then adds them in field order, so that several
// random reads are in flight at once.  Nothing here allocates or
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // ids whose rows a thread loads before it adds them

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const int* __restrict__ ids, const T* __restrict__ table,
               long long B, int F, long long V, int K, T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= B * K) return;
  const long long b = g / K;
  const int k = (int)(g - b * K);
  const int* row = ids + b * F;
  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = f0 + u;
      const int id = f < F ? row[f] : -1;
      v[u] = (id >= 0 && id < V) ? to_f32(table[(long long)id * K + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += v[u];
  }
  store(out + g, acc);
}

}  // namespace

// ids: (B, F) int32 contiguous; table: (V, K) contiguous, f32 (is_bf16 = 0)
// or bf16; out: (B, K) of the table's type.
extern "C" int embedding_bag(const int* ids, const void* table, long long B,
                             int F, long long V, int K, void* out, int is_bf16,
                             void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (F < 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B * K + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    bag_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        ids, static_cast<const __nv_bfloat16*>(table), B, F, V, K,
        static_cast<__nv_bfloat16*>(out));
  else
    bag_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        ids, static_cast<const float*>(table), B, F, V, K,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}
