// FM second-order interaction by the sum-square trick:
// out[b] = 0.5 * sum_k((sum_f x[b,f,k])^2 - sum_f x[b,f,k]^2), in f32, cast
// to x's type.
//
// Replaces: src/repro/kernels/fm_interact.py, fm_interact -> _kernel
// (pallas_call :39), which reduces one (block, F*K) slab of rows per grid
// step in VMEM.
//
// Bound on the H100: memory.  The function must read B * F * K values once
// and write B; the arithmetic is 3 operations per value.  Design: one warp
// per row, lanes over k (strided by 32 when K > 32), a loop over the fields
// that keeps the sum and the sum of squares of each k in registers, then a
// shuffle reduction over the lanes.  A row's values are contiguous, so a
// warp reads its row front to back.  Squares are rounded before they are
// summed (no fused multiply-add), as the reference computes them.
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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
    fm_kernel(const T* __restrict__ x, T* __restrict__ out, long long B, int F,
              int K) {
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

}  // namespace

// x: (B, F, K) contiguous, f32 (is_bf16 = 0) or bf16; out: (B,) of x's type.
extern "C" int fm_interact(const void* x, void* out, long long B, int F, int K,
                           int is_bf16, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (F < 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    fm_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        B, F, K);
  else
    fm_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, F, K);
  return (int)cudaGetLastError();
}
