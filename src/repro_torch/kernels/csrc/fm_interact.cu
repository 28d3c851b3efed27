// FM second-order interaction by the sum-square trick:
// out[b] = 0.5 * sum_k((sum_f x[b,f,k])^2 - sum_f x[b,f,k]^2), in f32, cast
// to x's type.
//
// Replaces: src/repro/kernels/fm_interact.py, fm_interact -> _kernel
// (pallas_call :39), which reduces one (block, F*K) slab of rows per grid
// step in VMEM.
//
// Bound on the H100: memory.  The function must read B * F * K values once
// and write B; the arithmetic is 3 operations per value.  The input is one
// contiguous array, so the whole problem is a stream of bytes: what the
// kernel has to do is keep enough of them in flight to cover the memory's
// latency (about 2 MB on the card at 3.35 TB/s), and stay out of the
// stream's way while it reduces.
//
// Slab route (K <= 32, 16-byte aligned x, a row that fits a stage): a
// persistent grid (the blocks the card holds at once) walks slabs of R
// consecutive rows, R * F * K * sizeof(x) bytes of the stream, R chosen so
// that a slab is a multiple of 16 bytes, fits a stage and has a thread for
// each (row, k).  A block copies each slab into shared memory with
// cp.async in 16-byte pieces (the last slab's odd tail by plain loads),
// into a ring of four stages: three slabs are in flight while it reduces
// a fourth, about 100 KB a block, two blocks an SM.  (At the FM's shape,
// slabs of 16 rows, 25 KB, beat slabs of 22 rows in three stages, and
// three or more blocks an SM of smaller slabs.)  Then one thread per
// (row, k) sums s and sq over f in field order from shared memory, squares
// rounded before they are added (no fused multiply-add, as the reference
// computes them), and leaves s*s - sq in shared memory; one thread per row
// adds its K partials in k order and writes the row's value, so the
// outputs of a slab are written together.  At a small batch the slabs
// shrink until every SM has one.
//
// Row route (K > 32, a misaligned x, or a row larger than a stage): one
// warp per row, lanes over k, a loop over the fields that keeps each k's
// sums in registers, then a shuffle reduction over the lanes.
//
// Both routes sum every value in a fixed order: two calls give the same
// bits.  Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStageBytes = 25 * 1024;  // four stages a block, two blocks an SM
constexpr int kRowsPerBlock = kThreads / 32;  // row route: a warp a row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// cp.async of 16 bytes, device memory to shared memory, around L1
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of slab s (rows [s R, s R + R) of x, fewer at the end)
// into stage; every slab but the last is a multiple of 16 bytes.
template <typename T>
__device__ __forceinline__ void issue_slab(T* stage, const T* __restrict__ x,
                                           long long s, long long B, int R,
                                           int row_elems) {
  constexpr int kVec = 16 / sizeof(T);
  const long long r0 = s * R;
  const int n = (int)min((long long)R, B - r0) * row_elems;
  const T* src = x + r0 * row_elems;
  const int n16 = n / kVec;
  for (int i = threadIdx.x; i < n16; i += kThreads)
    copy16(stage + i * kVec, src + i * kVec);
  for (int i = n16 * kVec + threadIdx.x; i < n; i += kThreads) stage[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fm_slab_kernel(const T* __restrict__ x, T* __restrict__ out, long long B,
                   int F, int K, int R) {
  constexpr int stage_elems = kStageBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const int row_elems = F * K;
  const long long n_slabs = (B + R - 1) / R;
  const long long step = gridDim.x;
  const int t = threadIdx.x;
  const int r = t / K, k = t - r * K;  // this thread's (row, k) of a slab

  long long s = blockIdx.x;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (s + p * step < n_slabs)
      issue_slab(stages + p * stage_elems, x, s + p * step, B, R, row_elems);
    copy_commit();  // an empty group past the end keeps the count
  }
  for (int it = 0; s < n_slabs; s += step, ++it) {
    // the slab kStages - 1 ahead goes into the stage reduced last time
    const long long ahead = s + (kStages - 1) * step;
    if (ahead < n_slabs)
      issue_slab(stages + ((it + kStages - 1) % kStages) * stage_elems, x, ahead,
                 B, R, row_elems);
    copy_commit();
    copy_wait<kStages - 1>();  // this slab's group has landed
    __syncthreads();
    const T* xs = stages + (it % kStages) * stage_elems;
    const int rows = (int)min((long long)R, B - s * R);
    float total = 0.f;
    if (r < rows) {
      const T* p = xs + r * row_elems + k;
      float sum = 0.f, sq = 0.f;
#pragma unroll 8
      for (int f = 0; f < F; ++f) {
        const float v = to_f32(p[f * K]);
        sum += v;
        sq += __fmul_rn(v, v);
      }
      total = __fmul_rn(sum, sum) - sq;
    }
    part[t] = total;
    __syncthreads();  // also: no thread reads this stage any more
    if (t < rows) {
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc += part[t * K + j];
      store(out + s * R + t, 0.5f * acc);
    }
  }
  copy_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fm_row_kernel(const T* __restrict__ x, T* __restrict__ out, long long B,
                  int F, int K) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // the whole warp leaves together
  const T* xr = x + row * F * K;
  float total = 0.f;
  for (int k = lane; k < K; k += 32) {
    float s = 0.f, sq = 0.f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float v = to_f32(xr[f * K + k]);
      s += v;
      sq += __fmul_rn(v, v);
    }
    total += __fmul_rn(s, s) - sq;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) total += __shfl_xor_sync(0xffffffffu, total, w);
  if (lane == 0) store(out + row, 0.5f * total);
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

// Rows a slab for the slab route, or 0 for the row route: a thread for
// each (row, k), a slab within a stage and a multiple of 16 bytes; at a
// small batch no more than gives every SM a slab.
int slab_rows(long long B, int F, int K, int elem, const void* x) {
  const long long row_bytes = (long long)F * K * elem;
  if (K < 1 || K > 32 || row_bytes == 0 || reinterpret_cast<uintptr_t>(x) % 16)
    return 0;
  const long long low_bit = row_bytes & -row_bytes;
  const int align = low_bit >= 16 ? 1 : (int)(16 / low_bit);  // rows a 16-byte step
  long long R = min((long long)(kThreads / K), kStageBytes / row_bytes);
  R = R / align * align;
  if (R == 0) return 0;
  const long long sms = sm_count();
  const long long spread = ((B + sms - 1) / sms + align - 1) / align * align;
  return (int)min(R, spread);
}

// The slab kernel's shared memory: the stages and the (row, k) partials,
// the same whatever R (a slab fits a stage)
constexpr size_t kSlabSmem = kStages * kStageBytes + sizeof(float) * kThreads;

template <typename T>
void launch_slab(const T* x, T* out, long long B, int F, int K, int R,
                 cudaStream_t st) {
  static int occupancy = 0;
  if (occupancy == 0) {
    cudaFuncSetAttribute(fm_slab_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSlabSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, fm_slab_kernel<T>,
                                                  kThreads, kSlabSmem);
    if (occupancy < 1) occupancy = 1;
  }
  const long long slabs = (B + R - 1) / R;
  const long long grid = min(slabs, (long long)sm_count() * occupancy);
  fm_slab_kernel<T><<<(unsigned)grid, kThreads, kSlabSmem, st>>>(
      x, out, B, F, K, R);
}

template <typename T>
void launch(const void* xv, void* outv, long long B, int F, int K,
            cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int R = slab_rows(B, F, K, sizeof(T), xv);
  if (R > 0) {
    launch_slab<T>(x, out, B, F, K, R, st);
  } else {
    const long long blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
    fm_row_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(x, out, B, F, K);
  }
}

}  // namespace

// x: (B, F, K) contiguous, f32 (is_bf16 = 0) or bf16; out: (B,) of x's type.
extern "C" int fm_interact(const void* x, void* out, long long B, int F, int K,
                           int is_bf16, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (F < 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(x, out, B, F, K, st);
  else
    launch<float>(x, out, B, F, K, st);
  return (int)cudaGetLastError();
}
