// Union-find over the representative array rho: a lock-free union of the
// sameAs pairs (the CAS mergeInto of the paper's Algorithm 5) and
// compression to the fixpoint.
//
// Replaces: src/repro/kernels/pointer_jump.py, pointer_jump -> _kernel
// (pallas_call :63), one doubling step out[i] = table[idx[i]] as a one-hot
// matmul over table tiles, meant for the rep = rep[rep] loop of
// repro.core.uf._compress_jax and the scatter-min hooking loop of
// merge_pairs_jax.
//
// Bound on the H100: memory.  The union must read every flag, the pair of
// each valid row and rho at each endpoint once, and write the roots it hooks;
// the work in between is chains of dependent 4-byte loads and CASes, each
// a 32-byte L2 sector access, which L2 serves (rho of the OpenCyc-scale run
// is 3.9 MB).
// Design:
//   uf_union: one pass, no host read.  Each valid pair (x, y) walks both
//     endpoints up to their roots, each step pointing the node it leaves
//     at its grandparent (path splitting), and hooks the larger root under
//     the smaller with atomicCAS(&rep[hi], hi, lo); a failed CAS means hi
//     was hooked meanwhile, and its answer is hi's new parent, from which
//     the walk goes on.  Endpoints that meet at a node or share a parent
//     (or where one's parent is the other) are in one tree: the pair is
//     done.  A root only ever changes by a CAS from itself to a smaller
//     id, so a forest with rep[x] <= x keeps it and stays acyclic, every
//     value a splitting write stores is an ancestor, and the least root of
//     each joined component is never hooked: after uf_compress every
//     resource holds that root, whatever the order of the hooks, which is
//     merge_pairs_jax's result bit for bit.  rep is read and written
//     relaxed at GPU scope (through L2, never a stale L1 line).  A walk's
//     ids only fall and each failed CAS is another pair's hook, so a pair
//     takes at most 3n rounds and no input can hang the card.  What sets
//     the pace is the L2 round trips (two loads to start a pair, one a
//     climb, a CAS a hook), so a persistent grid keeps 2048 threads an SM,
//     a thread a pair, its two walks' loads in flight together.  On an
//     H100 SXM (700 W), two or four pairs a thread, walked in turn or
//     together, were no faster, and neither were weak loads (ld.cg) or
//     walks that do not split the path.
//   uf_compress: every thread follows rep from its resource to the root.
//     Pass 1 halves the path as it walks: concurrent walks stay valid and
//     shorten each other's paths (a union can leave a chain as long as the
//     pair list, which a plain walk would cross in O(n^2)).  A halving
//     write can overwrite the root that a finished thread stored, so pass
//     2 walks the now-short paths read-only and each thread writes only
//     its own entry: the result is the fully compressed rep,
//     deterministically.  Walks stop after n steps.
// Pair ids are clamped into [0, n), as the reference's gathers clamp.
// Nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // the union's persistent grid: 2048 threads an SM

__device__ __forceinline__ int load_rep(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_rep(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// A thread a pair, the grid striding over the pairs.  Each round, a pair
// whose walks meet (a shared node or parent, or one's parent is the other)
// is in one tree and done; at two roots it hooks the larger under the
// smaller by CAS (done, or on failure the hooked root's new parent is the
// CAS's answer); otherwise both walks not at a root climb a step, their
// loads in flight together.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
union_kernel(int* rep, long long n, const int* __restrict__ pairs,
             const bool* __restrict__ valid, long long m) {
  const int top = (int)(n - 1);
  const unsigned char* flags = reinterpret_cast<const unsigned char*>(valid);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < m;
       g += (long long)gridDim.x * kThreads) {
    if (!__ldcs(flags + g)) continue;
    int x = min(max(__ldcs(pairs + 2 * g), 0), top);
    int y = min(max(__ldcs(pairs + 2 * g + 1), 0), top);
    if (x == y) continue;
    int px = load_rep(rep + x), py = load_rep(rep + y);
    // a walk's ids only fall (at most n climbs each) and each failed hook
    // is another pair's (at most n): at most 3n rounds
    for (long long round = 0; round < 3 * n; ++round) {
      if (x == y || px == py || px == y || py == x) break;
      if (px == x && py == y) {
        const int lo = min(x, y), hi = max(x, y);
        const int was = atomicCAS(rep + hi, hi, lo);
        if (was == hi) break;
        (x == hi ? px : py) = was;  // hi was hooked meanwhile
        continue;
      }
      int qx = px, qy = py;
      if (px != x) qx = load_rep(rep + px);
      if (py != y) qy = load_rep(rep + py);
      if (px != x) {
        if (qx != px) store_rep(rep + x, qx);
        x = px;
        px = qx;
      }
      if (py != y) {
        if (qy != py) store_rep(rep + y, qy);
        y = py;
        py = qy;
      }
    }
  }
}

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

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
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

// rep: (n,) int32, a forest with rep[x] <= x (any forest min-hooking and
// compression leave); pairs: (m, 2) int32 row-major; valid: (m,) bool.
// Joins the trees of every valid pair in place; rep is left a forest of the
// same kind, not compressed.
extern "C" int uf_union(int* rep, long long n, const int* pairs,
                        const bool* valid, long long m, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  const long long want = (m + kThreads - 1) / kThreads;
  const long long most = (long long)sm_count() * kBlocksPerSm;
  union_kernel<<<(unsigned)(want < most ? want : most), kThreads, 0,
                 (cudaStream_t)stream>>>(rep, n, pairs, valid, m);
  return (int)cudaGetLastError();
}
