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
// ids once, each table row they name, and write B * K values.  Device
// memory moves whole 32-byte sectors, however narrow the row: the FM's
// first-order weights are rows of one f32 (4 bytes), 8 rows a sector.  The
// bound counts each sector the ids touch once; a sector read again comes
// from L2 only if it is still there.
//
// What sets the pace is where those sectors come from.  The FM lays its
// rows out field after field (3.46 MB of first-order weights a field) and
// a bag holds one id of each field, so the lookups of a few fields fall in
// a few bands of the table; all 39 bands (135 MB) do not fit the 50 MB L2.
// Lookups that all fall in one band ran about 3x faster on the card than
// lookups over the whole table, and no order inside one launch kept the
// resident warps on few fields for long (blocks drift apart).
//
// Narrow route (K < 8: the FM's first-order bag, K 1): lanes over (output
// value, field), 8 lanes an output value (bag, k), each reading one id and
// its row, a field apart (an output's 8 lanes read 8 consecutive ids); the
// output's first lane adds the 8 values in field order (shuffles), 8
// fields at a time.  A large f32 bag over a large table (at least 2^20
// lookups, at least 32 MB) is swept: one launch per group of 8 fields,
// each adding its fields to the sums the launch before left in out, so the
// whole card reads from 8 bands at a time and rows read again come from
// L2.  The sums keep field order across launches.  A smaller bag, or a
// bf16 one (whose sums must not be rounded between launches), takes one
// launch over all fields.
//
// Wide route (K >= 8: the retrieval query's K 10): one warp per bag, lanes
// over the row in vectors of up to 16 bytes (the widest that divides K and
// the table's alignment) and over groups of consecutive fields; each group
// sums its fields in order, and the groups' sums are added in field order
// through shared memory.
//
// Every value is summed in a fixed order: two calls give the same bits.
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // fields a launch of a sweep, and a row's loads in flight
constexpr int kLanes = kUnroll;  // narrow route: lanes an output value, a field each
// a narrow f32 bag is swept by groups of kUnroll fields when it has at least
// this many lookups, over a table of at least this many bytes
constexpr long long kSweepLookups = 1LL << 20;
constexpr long long kSweepTableBytes = 32LL << 20;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The table value of (id, k), zero for an id off the table.
template <typename T>
__device__ __forceinline__ float value_of(const T* __restrict__ table, int id,
                                          long long V, int K, int k) {
  return (id >= 0 && id < V) ? to_f32(table[(long long)id * K + k]) : 0.f;
}

// Fields [f0, f1) of every bag: out = (f0 > 0 ? out : 0) + their values,
// added in field order.  A launch with f0 > 0 runs only on f32, after the
// launch that wrote out for the fields before f0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
    bag_narrow_kernel(const int* __restrict__ ids, const T* __restrict__ table,
                      long long B, int F, long long V, int K, int f0, int f1,
                      T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g = i / kLanes;  // the output value (bag, k)
  const bool live = g < B * K;
  const long long b = g / K;
  const int k = (int)(g - b * K);
  const int* row = ids + b * F;
  float acc = (f0 > 0 && live) ? to_f32(out[g]) : 0.f;
  // lane j of the output's 8 reads field c0 + j; every lane adds the 8
  // values in field order, the first one stores
  const int j = (int)(i % kLanes), lead = (threadIdx.x & 31) - j;
  for (int c0 = f0; c0 < f1; c0 += kLanes) {
    const float v = live && c0 + j < f1 ? value_of(table, row[c0 + j], V, K, k) : 0.f;
#pragma unroll
    for (int u = 0; u < kLanes; ++u) acc += __shfl_sync(0xffffffffu, v, lead + u);
  }
  if (live && j == 0) store(out + g, acc);
}

// V values of T read as one aligned vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    bag_wide_kernel(const int* __restrict__ ids, const T* __restrict__ table,
                    long long B, int F, long long Vrows, int K,
                    T* __restrict__ out) {
  __shared__ float part[kWarps][32 * V];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + warp;
  if (bag >= B) return;  // the whole warp leaves together
  const int* row_ids = ids + bag * F;
  const int vecs = K / V;                    // vectors a row
  const int lanes_row = min(32, vecs);       // lanes over one row
  const int groups = 32 / lanes_row;         // groups of consecutive fields
  const int g = lane / lanes_row, j = lane - g * lanes_row;
  const int per = (F + groups - 1) / groups;
  const int f_lo = min(F, g * per), f_hi = min(F, f_lo + per);
  const Pack<T, V>* rows = reinterpret_cast<const Pack<T, V>*>(table);
  for (int c0 = 0; c0 < vecs; c0 += lanes_row) {  // a pass over 32 vectors at most
    const int c = c0 + j;
    const bool active = g < groups && c < vecs;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    if (active) {
      for (int f0 = f_lo; f0 < f_hi; f0 += kUnroll) {
        Pack<T, V> p[kUnroll];
        bool on[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int f = f0 + u;
          const int id = f < f_hi ? row_ids[f] : -1;
          on[u] = id >= 0 && id < Vrows;
          if (on[u]) p[u] = rows[(long long)id * vecs + c];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (on[u]) {
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += to_f32(p[u].v[e]);
          }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) part[warp][(g * lanes_row + j) * V + e] = acc[e];
    }
    __syncwarp();
    if (g == 0 && c < vecs) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float total = 0.f;
        for (int h = 0; h < groups; ++h) total += part[warp][(h * lanes_row + j) * V + e];
        store(out + bag * K + c * V + e, total);
      }
    }
    __syncwarp();
  }
}

template <typename T, int V>
void launch_wide(const int* ids, const void* table, long long B, int F,
                 long long Vrows, int K, void* out, cudaStream_t st) {
  const long long blocks = (B + kWarps - 1) / kWarps;
  bag_wide_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(
      ids, static_cast<const T*>(table), B, F, Vrows, K, static_cast<T*>(out));
}

template <typename T>
void launch(const int* ids, const void* table, long long B, int F, long long V,
            int K, void* out, cudaStream_t st) {
  if (K < 8) {
    const long long blocks = (B * K * kLanes + kThreads - 1) / kThreads;
    const bool sweep = sizeof(T) == 4 && B * F * K >= kSweepLookups &&
                       V * K * (long long)sizeof(T) >= kSweepTableBytes;
    const int group = sweep ? kUnroll : F;
    int f0 = 0;
    do {  // one launch, or one a group of fields in order
      const int f1 = min(F, f0 + group);
      bag_narrow_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
          ids, static_cast<const T*>(table), B, F, V, K, f0, f1,
          static_cast<T*>(out));
      f0 = f1;
    } while (f0 < F);
    return;
  }
  // the widest vector (16 bytes at most) that divides K and the table's
  // alignment
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  constexpr int kMax = 16 / sizeof(T);
  int vec = kMax;
  while (vec > 1 && (K % vec || base % (vec * sizeof(T)))) vec /= 2;
  switch (vec) {
    case 8: launch_wide<T, kMax < 8 ? 1 : 8>(ids, table, B, F, V, K, out, st); break;
    case 4: launch_wide<T, 4>(ids, table, B, F, V, K, out, st); break;
    case 2: launch_wide<T, 2>(ids, table, B, F, V, K, out, st); break;
    default: launch_wide<T, 1>(ids, table, B, F, V, K, out, st);
  }
}

}  // namespace

// ids: (B, F) int32 contiguous; table: (V, K) contiguous, f32 (is_bf16 = 0)
// or bf16; out: (B, K) of the table's type.
extern "C" int embedding_bag(const int* ids, const void* table, long long B,
                             int F, long long V, int K, void* out, int is_bf16,
                             void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (F < 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(ids, table, B, F, V, K, out, st);
  else
    launch<float>(ids, table, B, F, V, K, out, st);
  return (int)cudaGetLastError();
}
