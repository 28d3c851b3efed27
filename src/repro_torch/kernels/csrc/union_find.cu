// Union-find over the representative array rho: compression to the fixpoint
// and min-hooking of sameAs pairs (the CAS mergeInto of the paper's
// Algorithm 5).
//
// Replaces: src/repro/kernels/pointer_jump.py, pointer_jump -> _kernel, one
// doubling step out[i] = table[idx[i]] as a one-hot matmul over table tiles,
// meant for the rep = rep[rep] loop of repro.core.uf._compress_jax and the
// scatter-min hooking of merge_pairs_jax.
//
// Bound on the H100: memory latency.  The function must read and write rho
// once (4 bytes per resource) and each pair once; the work in between is
// chains of dependent 4-byte loads, which L2 serves (rho of the
// OpenCyc-scale run is 3.9 MB).
// Design:
//   uf_compress: every thread follows rep from its resource to the root.
//     Min-hooking keeps rep[x] <= x, so the forest is acyclic and the roots
//     are exactly the fixpoint of rep = rep[rep].  Pass 1 halves the path as
//     it walks (rep[x] = rep[rep[x]]): every value written is an ancestor, so
//     concurrent walks stay valid and shorten each other's paths (one hooking
//     step can leave a chain as long as the pair list, which a plain walk
//     would cross in O(n^2)).  A halving write can overwrite the root that a
//     finished thread stored, so pass 2 walks the now-short paths read-only
//     and each thread writes only its own entry: the result is the fully
//     compressed rep, deterministically.  Walks stop after n steps, so no
//     input can hang the card.
//   uf_hook: pass 1 refreshes each pair to its roots (a = rep[a], b = rep[b]
//     on the compressed rep) and raises `flag` if any valid pair still
//     straddles two roots; pass 2 hooks those with atomicMin(&rep[hi], lo).
//     Two passes keep the roots that hooking reads from the ones it writes;
//     atomicMin makes competing hooks on one root order-independent, so the
//     representative is always the clique's minimum ID.
// Nothing here allocates; uf_hook clears `flag` with a memset on the stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void halve_kernel(int* rep, long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  int x = (int)g;
  for (long long step = 0; step < n; ++step) {
    const int p = __ldcg(rep + x);
    if (p == x) break;
    const int gp = __ldcg(rep + p);
    if (gp != p) rep[x] = gp;
    x = gp;
  }
  rep[g] = x;
}

__global__ void finish_kernel(int* rep, long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  int x = __ldcg(rep + g);
  for (long long step = 0; step < n; ++step) {
    const int p = __ldcg(rep + x);
    if (p == x) break;
    x = p;
  }
  rep[g] = x;
}

__global__ void refresh_kernel(const int* __restrict__ rep, int* __restrict__ a,
                               int* __restrict__ b,
                               const bool* __restrict__ valid, long long m,
                               int* __restrict__ flag) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= m) return;
  const int x = rep[a[g]];
  const int y = rep[b[g]];
  a[g] = x;
  b[g] = y;
  if (valid[g] && x != y) *flag = 1;
}

__global__ void link_kernel(int* rep, const int* __restrict__ a,
                            const int* __restrict__ b,
                            const bool* __restrict__ valid, long long m) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= m) return;
  const int x = a[g];
  const int y = b[g];
  if (valid[g] && x != y) atomicMin(rep + (x > y ? x : y), x < y ? x : y);
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// rep: (n,) int32, an acyclic forest whose roots point at themselves;
// compressed in place so that every entry holds its root.
extern "C" int uf_compress(int* rep, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  halve_kernel<<<blocks_for(n), kThreads, 0, s>>>(rep, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<blocks_for(n), kThreads, 0, s>>>(rep, n);
  return (int)cudaGetLastError();
}

// rep: (n,) int32, compressed.  a, b: (m,) int32 pair endpoints (indices into
// rep), replaced by their roots; valid: (m,) bool.  flag: one int32, set to 1
// when some valid pair joined two roots (and was hooked), else 0.
extern "C" int uf_hook(int* rep, long long n, int* a, int* b, const bool* valid,
                       long long m, int* flag, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess || m <= 0 || n <= 0) return (int)err;
  refresh_kernel<<<blocks_for(m), kThreads, 0, s>>>(rep, a, b, valid, m, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  link_kernel<<<blocks_for(m), kThreads, 0, s>>>(rep, a, b, valid, m);
  return (int)cudaGetLastError();
}
