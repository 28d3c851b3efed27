// Triple rewrite out = rho[spo] with a per-row changed flag.
//
// Replaces: src/repro/kernels/rewrite_triples.py, rewrite_triples -> _kernel,
// which gathers through a one-hot matmul over rho tiles on the MXU (a TPU has
// no cheap dynamic gather), O(n * V) work.
//
// Bound on the H100: memory.  The function must read 12 bytes of spo per row
// and the rho table once, and write 12 bytes plus a flag per row; the three
// rho lookups per row are random 4-byte reads that the 50 MB L2 mostly serves
// (rho of the OpenCyc-scale run is 3.9 MB).  Design: one thread per row
// gathers rho for s, p and o and writes the row and its flag in one pass.
// Indices are clamped into rho, as the reference's gathers clamp.  Two
// optional masks fold the engine's surrounding element-wise work in:
//   valid (normalise):     out = valid ? rho[spo] : 0, changed &= valid;
//   epoch/marked (sweep):  changed &= epoch >= 0 && !marked (the live rows).
// Nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lookup(const int* __restrict__ rho, long long V,
                                      int x) {
  const long long i = x < 0 ? 0 : (x >= V ? V - 1 : x);
  return rho[i];
}

__global__ void rewrite_kernel(const int* __restrict__ spo, long long n,
                               const int* __restrict__ rho, long long V,
                               const bool* __restrict__ valid,
                               const int* __restrict__ epoch,
                               const bool* __restrict__ marked,
                               int* __restrict__ out,
                               bool* __restrict__ changed) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int s = spo[3 * g], p = spo[3 * g + 1], o = spo[3 * g + 2];
  const bool keep = valid == nullptr || valid[g];
  const int rs = keep ? lookup(rho, V, s) : 0;
  const int rp = keep ? lookup(rho, V, p) : 0;
  const int ro = keep ? lookup(rho, V, o) : 0;
  bool ch = keep && (rs != s || rp != p || ro != o);
  if (epoch != nullptr) ch = ch && epoch[g] >= 0 && !marked[g];
  out[3 * g] = rs;
  out[3 * g + 1] = rp;
  out[3 * g + 2] = ro;
  changed[g] = ch;
}

}  // namespace

// spo: (n, 3) int32 row-major; rho: (V,) int32, V >= 1.  valid: (n,) bool or
// NULL; epoch: (n,) int32 and marked: (n,) bool, both or neither NULL.
// out: (n, 3) int32; changed: (n,) bool.
extern "C" int rewrite_triples(const int* spo, long long n, const int* rho,
                               long long V, const bool* valid,
                               const int* epoch, const bool* marked, int* out,
                               bool* changed, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  rewrite_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      spo, n, rho, V, valid, epoch, marked, out, changed);
  return (int)cudaGetLastError();
}
