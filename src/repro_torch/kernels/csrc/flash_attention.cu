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
// (the KV rows once).
//
// Rows and tiles, both routes:
//   * A block owns 64 (f32) or 64 * WG (bf16) flat query rows of one KV
//     head and batch row: f = s * G + g, so the G query heads that share a
//     KV head share every K/V tile that the block loads, and a decode step
//     (S = 1) fills G rows of a block rather than one.
//   * The block walks the keys in tiles of 64, read through the strides it
//     is given (a layer of the KV arena, or a transposed K, in place).
//     Tiles wholly beyond the last key that the block's last query may see
//     are skipped: their scores would be -1e30 and add exactly 0 once the
//     running max is a real score, which it is after the first tile,
//     because key 0 is admitted for every query (q_offset >= 0).  So no row
//     ever meets a tile that is all masked before a real score has set its
//     max.
//
// bf16 route (flash_wgmma_kernel): tensor cores.
//   * Blocks of two warpgroups (256 threads); a warpgroup computes 64 flat
//     rows.  For a long prefill each warpgroup owns its own rows and the
//     block loads every K/V tile once for both.  When a grid of such blocks
//     would not give every SM two (a short prefill, a decode step: the
//     time is then the chain of tiles a block walks), both warpgroups own
//     the same 64 rows and take alternate K/V tiles (split KV), each with
//     its own Q copy, ring and named barrier, so that one's softmax runs
//     beside the other's products; the second hands its (m, l, O) to the
//     first through shared memory at the end.  Blocks run the heaviest
//     (latest) row blocks first.  For a long prefill at D = 64 the launch
//     bounds ask for two blocks an SM (128 registers a thread).
//   * S = Q K^T: wgmma m64n64k16 bf16 -> f32, Q and K from shared memory
//     (both K-major).  Products of bf16 values are exact in f32, so the
//     scores keep the reference's f32 precision up to summation order.
//   * P stays f32 for the softmax.  For P.V it is split in registers,
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two register-A wgmma
//     m64nDk16 (P_hi.V, then P_lo.V) add into the same f32 accumulator, V
//     read from shared memory transposed (MN-major).  P_hi carries 8
//     significant bits and P_lo the next 8, so P keeps about 16 of f32's
//     24 (a bf16 P would keep 8, an error of up to 2^-9 of each weight).
//     The tensor cores take no f32 or TF32 operand that keeps more: TF32
//     has 11 bits, and f32 itself is not a wgmma type.  The split costs one
//     more P.V product: 1.5x the flops of a bf16-P kernel.
//   * The softmax runs in log2 units (each weight one FFMA and one ex2);
//     only tiles that cross the causal diagonal or T are masked; a warp
//     whose rows' running max did not move skips the rescale of O.
//   * Q, K and V tiles live in shared memory in the 128-byte swizzled
//     layout that the wgmma descriptors name: row r of 128 bytes holds its
//     16-byte chunk c at chunk c ^ (r % 8), 8-row groups 1,024 bytes apart,
//     a D = 128 tile as two 64-column atoms of 8 KB.  K/V tiles go through
//     a ring of three stages, loaded by cp.async (16 bytes a thread, rows
//     past T zero-filled) two tiles ahead, so tile j + 1 and j + 2 are in
//     flight while tile j's products and softmax run; one barrier a tile.
//   * The accumulator layout of S is the register-A layout of P, so P goes
//     from the scores to the P.V product without shared memory.
//   * Shared memory in 64-row tiles of 64 * D * 2 bytes, plus 1 KB of
//     alignment: 2 Q + 3 x (K, V) = 65 KB at D = 64 and 129 KB at D = 128
//     for a long prefill; twice 1 Q + 3 x (K, V) = 113 KB and 225 KB with
//     split KV.
//
// f32 route (flash_kernel): CUDA cores, kept as it is because the tensor
// cores have no f32 x f32 product and TF32 would change the result.  128
// threads; thread (ty, tx) owns query rows 4ty..4ty+3 and keys tx + 8j of
// the tile (32 scores); row max and row sum reduce over the 8 lanes of a row
// group with shuffles; P goes through shared memory for the P.V product.
// Shared rows are padded by one float so that column reads hit distinct
// banks: (3 * 64 * (D + 1) + 64 * 65) * 4 bytes, 66,560 at D = 64 and
// 115,712 at D = 128.
//
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 64;  // flat (query, group head) rows per warpgroup
constexpr int kKeys = 64;  // keys per tile
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

// ---------------------------------------------------------------- f32 route

constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kLP = kKeys + 1;

// Load `n` rows of D floats into shared rows of stride D + 1; row r starts
// at base + offset(r) elements, or is zero when offset(r) < 0.
template <int D, typename Offset>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int n,
                                          Offset offset) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const long long off = offset(r);
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0) u = *reinterpret_cast<const float4*>(base + off + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;              // kRows x LD
  float* sK = sQ + kRows * LD;   // kKeys x LD
  float* sV = sK + kKeys * LD;   // kKeys x LD
  float* sP = sV + kKeys * LD;   // kRows x kLP

  const float* Q = static_cast<const float*>(a.q);
  const float* K = static_cast<const float*>(a.k);
  const float* V = static_cast<const float*>(a.v);
  const long long G = a.H / a.KV;
  const long long n_rows = a.S * G;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  load_tile<D>(sQ, Q, kRows, [&](int r) -> long long {
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
    load_tile<D>(sK, K, kKeys, [&](int r) -> long long {
      const long long j = k0 + r;
      return j < a.T ? b * a.ks_b + j * a.ks_t + kvh * a.ks_h : -1;
    });
    load_tile<D>(sV, V, kKeys, [&](int r) -> long long {
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

  float* O = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = row0 + ty * 4 + i;
    if (f >= n_rows) continue;
    const long long s = f / G, h = kvh * G + f % G;
    float* o = O + ((b * a.S + s) * a.H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 8 * c] = acc[i][c] / denom;
  }
}

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute stays set, and the call costs host time on every launch.
template <void (*Kernel)(Args)>
cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done.load() >> dev & 1))) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done.fetch_or(1ull << dev);
  return err;
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = (3 * kRows * (D + 1) + kRows * kLP) * (int)sizeof(float);
  cudaError_t err = allow_smem<flash_kernel<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.S * (a.H / a.KV) + kRows - 1) / kRows;
  const dim3 grid((unsigned)blocks, (unsigned)a.KV, (unsigned)a.B);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 route

constexpr int kAtom = 64 * 128;  // bytes: 64 rows x one 128-byte swizzle row
constexpr int kStages = 3;       // K/V tiles in the shared-memory ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid (src is then unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows of D bf16 into the swizzled layout at `dst`; row r starts at
// base + offset(r) elements, or is zero when offset(r) < 0.
template <int D, int NT, typename Offset>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* base, int tid,
                                          Offset offset) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < 64 * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const long long off = offset(r);
    const uint32_t at = dst + (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(at, off >= 0 ? base + off + c * 8 : base, off >= 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(0), F16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, shared,
// MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) . B (16 x 128, shared,
// MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A block is two warpgroups (256 threads); a warpgroup computes 64 flat
// rows.  SPLIT = false: each owns its own 64 rows, and the block loads
// every K/V tile once for both (a long prefill).  SPLIT = true: both own the
// same 64 rows and take alternate K/V tiles, each with its own copy of Q,
// its own ring and its own named barrier, so the two run out of step (one's
// softmax beside the other's products); the second hands its (m, l, O) to
// the first at the end (a short prefill or a decode step, where a block's
// chain of tiles is the time).
template <int D, bool SPLIT>
__global__ void __launch_bounds__(256, D == 64 && !SPLIT ? 2 : 1)
    flash_wgmma_kernel(Args a) {
  constexpr int GT = SPLIT ? 128 : 256;   // threads that load and sync together
  constexpr int RG = SPLIT ? 1 : 2;       // Q tiles (64-row groups) a group holds
  constexpr int kTileBytes = 64 * D * 2;  // one 64-row tile
  constexpr int kGroupBytes = (RG + 2 * kStages) * kTileBytes;
  constexpr int kSteps = D / 16;          // k16 steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gtid = SPLIT ? threadIdx.x & 127 : threadIdx.x;
  const uint32_t sQ = ((smem_addr(smem_raw) + 1023) & ~1023u) +
                      (SPLIT ? wg * kGroupBytes : 0);  // RG tiles
  const uint32_t sK = sQ + RG * kTileBytes;            // kStages
  const uint32_t sV = sK + kStages * kTileBytes;       // kStages
  auto group_sync = [&] {
    if (SPLIT)
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    else
      __syncthreads();
  };

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v);
  // positions and rows fit in 32 bits (the launcher checks); addresses
  // are 64-bit
  const int G = (int)(a.H / a.KV), T = (int)a.T;
  const int n_rows = (int)(a.S * G);
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const int row0 = (int)(gridDim.x - 1 - blockIdx.x) * (64 * RG);
  const int rg = SPLIT ? 0 : wg;  // this warpgroup's 64 rows

#pragma unroll
  for (int w = 0; w < RG; ++w)
    load_rows<D, GT>(sQ + w * kTileBytes, Q, gtid, [&](int r) -> long long {
      const int f = row0 + 64 * w + r;
      if (f >= n_rows) return -1;
      const long long s = f / G, h = kvh * G + f % G;
      return b * a.qs_b + s * a.qs_s + h * a.qs_h;
    });
  int kend = T;
  if (a.causal) kend = min(kend, (int)a.q_offset + (min(row0 + 64 * RG, n_rows) - 1) / G + 1);
  const int n_tiles = (kend + kKeys - 1) / kKeys;
  // the group's tiles: every tile, or with SPLIT every other one from wg
  const int first = SPLIT ? wg : 0, stride = SPLIT ? 2 : 1;
  const int n_mine = n_tiles > first ? (n_tiles - first + stride - 1) / stride : 0;
  auto load_kv = [&](int i) {  // the group's i-th tile into stage i % kStages
    if (i >= n_mine) return;
    const int k0 = (first + i * stride) * kKeys;
    const uint32_t stage = (i % kStages) * kTileBytes;
    load_rows<D, GT>(sK + stage, K, gtid, [&](int r) -> long long {
      return k0 + r < T ? b * a.ks_b + (k0 + r) * a.ks_t + kvh * a.ks_h : -1;
    });
    load_rows<D, GT>(sV + stage, V, gtid, [&](int r) -> long long {
      return k0 + r < T ? b * a.vs_b + (k0 + r) * a.vs_t + kvh * a.vs_h : -1;
    });
  };
  load_kv(0);  // one cp.async group with Q
  cp_async_commit();
  load_kv(1);
  cp_async_commit();

  // this thread's rows of its warpgroup's 64: 16 * warp + lane / 4 (+ 8);
  // its columns of every 8-wide block: 2 * (lane % 4) (+ 1)
  const int f0 = row0 + 64 * rg + 16 * warp + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = (int)a.q_offset + min(f0 + 8 * i, n_rows - 1) / G;
  const int col = 2 * (lane & 3);
  // the first query position of this warpgroup: a tile whose last key it
  // admits needs no causal mask
  const int wg_qpos0 = (int)a.q_offset + min(row0 + 64 * rg, n_rows - 1) / G;
  const float scale2 = a.scale * 1.4426950408889634f;  // log2(e)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // m in log2 units
  float s[32], o[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t q_tile = sQ + rg * kTileBytes;

  // The group's tile i: wait for its loads; issue the loads of tile i + 2
  // into the stage that tile i - 1 used (the whole group is past it once
  // all reach this barrier); S = Q K^T; softmax; O += P V.
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync();
    load_kv(i + 2);
    cp_async_commit();
    const uint32_t k_tile = sK + (i % kStages) * kTileBytes;
    const uint32_t v_tile = sV + (i % kStages) * kTileBytes;

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      mma_ss_n64(s, sdesc(q_tile + off, 16, 1024), sdesc(k_tile + off, 16, 1024),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // mask, online softmax; s[4c + e] is row e / 2, key k0 + 8c + col +
    // e % 2.  A masked score becomes -inf here, and its weight exp2(-inf) =
    // 0, what exp(-1e30 - m) is for the real running max m that every row
    // has from its first tile on.  (With SPLIT a row may see only masked
    // keys in the second warpgroup's tiles: its max stays at the -1e30
    // floor, its l and O stay 0, and the merge weighs them by 0.)  The max
    // and the weights are in log2 units, m2 = max(s) * scale * log2(e), so
    // each weight is one FFMA and one ex2.
    const int k0 = (first + i * stride) * kKeys;
    if (k0 + kKeys > T || (a.causal && k0 + kKeys - 1 > wg_qpos0)) {
      // keys k0 + c' with c' < lim[r] are admitted for row r
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lim[r] = min(T - k0, a.causal ? max(qpos[r] - k0 + 1, 0) : kKeys);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * c + col + (e & 1) >= lim[e >> 1])
            s[4 * c + e] = __int_as_float(0xff800000);  // -inf
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int t = 0; t < 32; ++t) mx[(t >> 1) & 1] = fmaxf(mx[(t >> 1) & 1], s[t]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    // register t of P's A fragments holds s[2t], s[2t + 1] (row t % 2)
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int r = t & 1;
      const float p0 = ex2(fmaf(s[2 * t], scale2, -m[r]));
      const float p1 = ex2(fmaf(s[2 * t + 1], scale2, -m[r]));
      sum[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(hi);
      p_hi[t] = bf16x2_bits(hi);
      p_lo[t] = bf16x2_bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    // a row's max settles after its first tiles: skip the rescale by 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
    }

    // O += P_hi V + P_lo V; V's 8-key groups 1,024 bytes apart, its
    // 64-column atoms kAtom apart
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(o, p_hi + 4 * kk, sdesc(v_tile + kk * 2048, kAtom, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(o, p_lo + 4 * kk, sdesc(v_tile + kk * 2048, kAtom, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }

  if (SPLIT) {
    // the second warpgroup's (m, l, O) through its idle ring: thread t of
    // each warpgroup holds the same rows and columns
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t ring1 =  // the second warpgroup's K stages
        ((smem_addr(smem_raw) + 1023) & ~1023u) + kGroupBytes + kTileBytes;
    float* x = reinterpret_cast<float*>(smem_raw + (ring1 - smem_addr(smem_raw))) +
               (threadIdx.x & 127);
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[128 * r] = m[r];
        x[128 * (2 + r)] = l[r];
      }
#pragma unroll
      for (int c = 0; c < D / 2; ++c) x[128 * (4 + c)] = o[c];
    }
    __syncthreads();
    if (wg == 1) return;
    float w0[2], w1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = x[128 * r], m_new = fmaxf(m[r], m1);
      w0[r] = ex2(m[r] - m_new);
      w1[r] = ex2(m1 - m_new);
      l[r] = l[r] * w0[r] + x[128 * (2 + r)] * w1[r];
    }
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      o[c] = o[c] * w0[(c >> 1) & 1] + x[128 * (4 + c)] * w1[(c >> 1) & 1];
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + 8 * i;
    if (f >= n_rows) continue;
    const long long srow = f / G, h = kvh * G + f % G;
    __nv_bfloat16* out = O + ((b * a.S + srow) * a.H + h) * D + col;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          o[4 * c + 2 * i] / denom, o[4 * c + 2 * i + 1] / denom);
  }
}

template <int D, bool SPLIT>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  const int rows = SPLIT ? 64 : 128;  // flat rows a block
  const int smem = (SPLIT ? 2 * (1 + 2 * kStages) : 2 + 2 * kStages) * 64 * D * 2 + 1024;
  cudaError_t err = allow_smem<flash_wgmma_kernel<D, SPLIT>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.S * (a.H / a.KV) + rows - 1) / rows;
  const dim3 grid((unsigned)blocks, (unsigned)a.KV, (unsigned)a.B);
  flash_wgmma_kernel<D, SPLIT><<<grid, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Split KV while a grid of 128-row blocks would not give every SM two: a
// short prefill or a decode step is bound by the chain of tiles a block
// walks, a long prefill by the tensor cores.
template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long wide = (a.S * (a.H / a.KV) + 127) / 128 * a.KV * a.B;
  return wide >= 2 * sms ? launch_wgmma<D, false>(a, stream)
                         : launch_wgmma<D, true>(a, stream);
}

}  // namespace

// The arguments come packed, to keep the host's work per call small:
// p[0..3] the data pointers of q (B, S, H, D), k and v (B, T, KV, D) and out
// (B, S, H, D); p[4..8] B, S, T, H, KV; p[9..17] the element strides of the
// first three dimensions of q, k and v (the last is contiguous, every row
// 16-byte aligned); p[18] causal; p[19] q_offset; p[20] D; p[21] is_bf16
// (else f32).  out is contiguous, of q's type.  H % KV == 0,
// q_offset >= 0, D in {64, 128}.
extern "C" int flash_attention(const long long* p, float scale, void* stream) {
  const long long B = p[4], S = p[5], T = p[6], H = p[7], KV = p[8];
  const long long q_offset = p[19], D = p[20];
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || q_offset < 0 || B > 65535 || KV > 65535 ||
      T >= (1ll << 31) || S * H >= (1ll << 31) || q_offset + S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{(const void*)p[0], (const void*)p[1], (const void*)p[2],
               (void*)p[3], B, S, T, H, KV, p[9], p[10], p[11], p[12], p[13],
               p[14], p[15], p[16], p[17], q_offset, (int)p[18], scale};
  const bool bf16 = p[21] != 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the dtype picks the route: bf16 on the tensor cores, f32 on the CUDA
  // cores (no tensor-core product keeps f32 operands)
  if (D == 64) return bf16 ? launch_bf16<64>(a, st) : launch_f32<64>(a, st);
  if (D == 128) return bf16 ? launch_bf16<128>(a, st) : launch_f32<128>(a, st);
  return (int)cudaErrorInvalidValue;
}
