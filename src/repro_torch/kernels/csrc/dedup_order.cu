// Stable ascending permutation of int64 keys: out == argsort(keys, stable=True).
//
// Replaces: src/repro/kernels/dedup.py, dedup_order -> _rank_call ->
// _rank_kernel (pallas_call :68, kernel :40), which counts rank[i] =
// #{k < k_i} + #{k == k_i, j < i} over a (query block x key tile) grid.
// That is O(n^2) compares: right for the TPU's short delta buffers,
// hopeless at the 2^24-2^25 keys that one round of the OpenCyc-scale run
// streams through process_candidates.
//
// Bound on the H100: memory traffic.  The function must read 8 bytes and
// write 4 per key (0.120 ms at 2^25 + 1 keys); a sort by 8-bit digits moves
// each (key, index) pair once per digit, and its scattered writes keep a
// pass well below the full bandwidth.  Design: a least-significant-digit
// radix sort of (key, int32 index) pairs, 8 digits of 8 bits.
//   * Signed order: the digits are those of k ^ 2^63 read as unsigned, so
//     negative keys sort first.  Every pass is stable, so equal keys keep
//     their index order with no tie-break.
//   * radix_histogram reads the keys once and counts all 8 digits (per-
//     thread runs of equal digits go to shared memory in one atomic each,
//     so a digit that hardly varies costs few atomics).
//   * radix_plan (one block) turns the counts into each bucket's first
//     output position and decides on the device which digits are trivial
//     (one bucket holds all n keys).  A trivial digit's pass returns at
//     once; the others are numbered j = 0..m-1 and ping-pong between two
//     buffer pairs, the first reading the caller's keys and making the
//     indices (an iota), the last writing only the int32 index into `out`.
//     If every digit is trivial the last digit's pass runs anyway, so `out`
//     is always written.  No host read, no synchronisation.
//   * radix_pass: one sweep per digit with decoupled look-back ("onesweep").
//     A block takes tiles of 4096 keys in order through an atomic counter,
//     so the look-back never waits on a tile that has not started.  Each
//     warp ranks 512 keys in index order with ballot-based match (8
//     ballots a key), the block combines its warps' counts, publishes its
//     bucket counts, adds the counts of all earlier tiles (walking back
//     over their status words until one carries an inclusive prefix),
//     publishes its own inclusive prefix, sorts the tile by digit in shared
//     memory and writes each bucket's run contiguously.
//   * Fewer bytes: a pass writes only the key bits that the later digits
//     read, the upper 32 from digit 3 on and the upper 16 from digit 5.
// Traffic at n keys with no trivial digit: 8n (histogram) + 20n (pass 0:
// key in; key, index out) + 2 x 24n + 20n (pass 3) + 16n + 14n + 12n +
// 10n (pass 7: index out only) = 148n bytes: 5.0 GB, 1.5 ms at 3.35 TB/s,
// at 2^25 + 1 keys.  Status words are 64 bits (count, flag,
// pass tag): the tag lets the eight passes share one array that the caller
// zeroes once.  Nothing here allocates or synchronises; the caller gives
// every buffer.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kDigits = 8;
constexpr int kBuckets = 256;
constexpr int kThreads = 256;  // = kBuckets: thread b owns bucket b
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;     // keys a thread ranks per tile
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // 4096
constexpr int kHistBlocks = 512;
constexpr int kHistUnroll = 4;  // keys a histogram thread loads at once
constexpr unsigned long long kSign = 1ull << 63;
// status word: bits 0-31 count, bit 32 aggregate, bit 33 inclusive prefix,
// bits 34+ the pass tag (pass + 1; zeroed memory carries tag 0)
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr int kTagShift = 34;
// plan word of a pass: -1 skipped, else kFirst | kLast | (code << 2) |
// (j << 4), where the previous pass wrote keys of 64 >> code bits
constexpr int kFirst = 1, kLast = 2;
// A pass writes only the key bits that the later digits read: all 64
// before digit 3, the upper 32 from digit 3 on, the upper 16 from digit 5.
__host__ __device__ constexpr int key_bits_out(int digit) {
  return digit >= 5 ? 16 : digit >= 3 ? 32 : 64;
}

// scratch layout in 32-bit words; the caller zeroes all of it
constexpr long long kHistOff = 0;                           // 8 x 256 counts
constexpr long long kBaseOff = kHistOff + kDigits * kBuckets;  // 8 x 256 bases
constexpr long long kPlanOff = kBaseOff + kDigits * kBuckets;  // 8 plan words
constexpr long long kCounterOff = kPlanOff + kDigits;           // 8 tile counters
constexpr long long kStatusOff = kCounterOff + kDigits;         // tiles x 256 u64

__device__ __forceinline__ unsigned digit_of(long long k, int shift) {
  return (unsigned)((((unsigned long long)k ^ kSign) >> shift) & 0xFF);
}

// Exclusive prefix sum of one value per thread over the block's 256
// threads; `warp_sums` is kWarps words of shared memory.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned off = 0;
  for (int w = 0; w < warp; ++w) off += warp_sums[w];
  __syncthreads();  // warp_sums may be reused
  return off + x - v;
}

__global__ void __launch_bounds__(kThreads)
    radix_histogram(const long long* __restrict__ keys, long long n,
                    unsigned* __restrict__ scratch) {
  __shared__ unsigned sh[kDigits * kBuckets];
  for (int i = threadIdx.x; i < kDigits * kBuckets; i += kThreads) sh[i] = 0;
  __syncthreads();
  unsigned last[kDigits], run[kDigits];
#pragma unroll
  for (int d = 0; d < kDigits; ++d) run[d] = 0, last[d] = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n;
       g += kHistUnroll * stride) {
    long long k[kHistUnroll];  // loads in flight together
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u)
      k[u] = g + u * stride < n ? keys[g + u * stride] : 0;
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (g + u * stride >= n) break;
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        const unsigned dg = digit_of(k[u], 8 * d);
        if (run[d] != 0 && dg != last[d]) {
          atomicAdd(&sh[d * kBuckets + last[d]], run[d]);
          run[d] = 0;
        }
        last[d] = dg;
        ++run[d];
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
    if (run[d] != 0) atomicAdd(&sh[d * kBuckets + last[d]], run[d]);
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kBuckets; i += kThreads)
    if (sh[i] != 0) atomicAdd(&scratch[kHistOff + i], sh[i]);
}

__global__ void __launch_bounds__(kThreads)
    radix_plan(long long n, unsigned* __restrict__ scratch) {
  __shared__ unsigned warp_sums[kWarps];
  __shared__ int trivial[kDigits];
  const int b = threadIdx.x;
  for (int d = 0; d < kDigits; ++d) {
    const unsigned c = scratch[kHistOff + d * kBuckets + b];
    const int triv = __syncthreads_or((long long)c == n);
    scratch[kBaseOff + d * kBuckets + b] = block_exclusive_scan(c, warp_sums);
    if (b == 0) trivial[d] = triv;
  }
  __syncthreads();
  if (b == 0) {
    int m = 0;
    for (int d = 0; d < kDigits; ++d) m += !trivial[d];
    if (m == 0) {  // all keys equal: one pass still writes `out`
      trivial[kDigits - 1] = 0;
      m = 1;
    }
    int* plan = reinterpret_cast<int*>(scratch + kPlanOff);
    for (int d = 0, j = 0, prev = -1; d < kDigits; ++d) {
      if (trivial[d]) {
        plan[d] = -1;
        continue;
      }
      const int bits = prev < 0 ? 64 : key_bits_out(prev);
      const int code = bits == 64 ? 0 : bits == 32 ? 1 : 2;
      plan[d] = (j == 0 ? kFirst : 0) | (j == m - 1 ? kLast : 0) |
                (code << 2) | (j << 4);
      prev = d;
      ++j;
    }
  }
}

struct PassArgs {
  const long long* keys;
  long long n;
  long long* kbuf[2];
  int* ibuf[2];
  int* out;
  unsigned* scratch;
};

// Three blocks an SM (at most 85 registers a thread) keep more loads in
// flight than the two that the unbounded 112 registers allow.
__global__ void __launch_bounds__(kThreads, 3)
    radix_pass(PassArgs a, int pass) {
  const int role = reinterpret_cast<const int*>(a.scratch + kPlanOff)[pass];
  if (role < 0) return;  // trivial digit: the order stands
  extern __shared__ unsigned long long smem[];
  long long* skey = reinterpret_cast<long long*>(smem);        // kTile
  int* sidx = reinterpret_cast<int*>(skey + kTile);            // kTile
  unsigned* whist = reinterpret_cast<unsigned*>(sidx + kTile); // kWarps x 256
  unsigned* sexcl = whist + kWarps * kBuckets;                 // 256
  long long* sadj = reinterpret_cast<long long*>(sexcl + kBuckets);  // 256
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = 8 * pass;
  const bool first = role & kFirst, last = role & kLast;
  const int in_bits = 64 >> ((role >> 2) & 3), out_bits = key_bits_out(pass);
  const int j = role >> 4;
  const bool odd = (j - 1) & 1;  // buffer pair the previous pass wrote
  const long long* kin = first ? a.keys : odd ? a.kbuf[1] : a.kbuf[0];
  const int* iin = odd ? a.ibuf[1] : a.ibuf[0];
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(a.scratch + kStatusOff);
  const unsigned long long tag = (unsigned long long)(pass + 1) << kTagShift;

  if (threadIdx.x == 0)
    s_tile = atomicAdd(&a.scratch[kCounterOff + pass], 1u);
  for (int i = threadIdx.x; i < kWarps * kBuckets; i += kThreads) whist[i] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile + warp * kWarpKeys;

  // 1. rank: warp w holds keys base + 32k + lane, k = 0..kItems-1, and
  // walks them in index order; rank = earlier equal digits in the warp
  long long key[kItems];
  unsigned rank[kItems / 2];  // two 16-bit ranks a word
  // narrow keys hold the upper 32 or 16 bits; the lower digits are done
  const unsigned* kin32 = reinterpret_cast<const unsigned*>(kin);
  const unsigned short* kin16 = reinterpret_cast<const unsigned short*>(kin);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = base + 32 * k + lane;
    if (g >= a.n)
      key[k] = 0;
    else if (in_bits == 16)
      key[k] = (long long)((unsigned long long)kin16[g] << 48);
    else if (in_bits == 32)
      key[k] = (long long)((unsigned long long)kin32[g] << 32);
    else
      key[k] = kin[g];
  }
  unsigned* wh = whist + warp * kBuckets;
  const unsigned lt_mask = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = base + 32 * k + lane < a.n;
    const unsigned d = digit_of(key[k], shift);
    unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const bool set = (d >> bit) & 1;
      const unsigned votes = __ballot_sync(0xffffffffu, set);
      peers &= set ? votes : ~votes;
    }
    const unsigned before = valid ? wh[d] : 0;
    const unsigned r = before + __popc(peers & lt_mask);
    rank[k / 2] = k % 2 ? rank[k / 2] | (r << 16) : r;
    __syncwarp();
    if (valid && (peers & lt_mask) == 0) wh[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. thread b: the tile's count of bucket b, each warp's offset in it
  const int b = threadIdx.x;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = whist[w * kBuckets + b];
    whist[w * kBuckets + b] = count;
    count += c;
  }
  volatile unsigned long long* mine = status + tile * kBuckets + b;
  *mine = tag | (tile == 0 ? kPrefix : kAggregate) | count;
  const unsigned excl = block_exclusive_scan(count, warp_sums);

  // 3. decoupled look-back: the keys of bucket b in all earlier tiles
  unsigned long long before = 0;
  if (tile > 0) {
    for (long long t = tile - 1;; --t) {
      volatile unsigned long long* p = status + t * kBuckets + b;
      unsigned long long w;
      do {
        w = *p;
      } while ((w >> kTagShift) != (unsigned long long)(pass + 1));
      before += w & 0xffffffffull;
      if (w & kPrefix) break;
    }
    *mine = tag | kPrefix | (before + count);
  }
  sexcl[b] = excl;
  sadj[b] = (long long)a.scratch[kBaseOff + pass * kBuckets + b] +
            (long long)before - excl;
  __syncthreads();

  // 4. sort the tile by digit in shared memory, then write bucket runs;
  // the indices load together first, all in flight at once
  int idx[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = base + 32 * k + lane;
    idx[k] = first ? (int)g : g < a.n ? __ldg(iin + g) : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = base + 32 * k + lane;
    if (g < a.n) {
      const unsigned d = digit_of(key[k], shift);
      const unsigned pos = sexcl[d] + wh[d] + ((rank[k / 2] >> (16 * (k % 2))) & 0xffff);
      skey[pos] = key[k];
      sidx[pos] = idx[k];
    }
  }
  __syncthreads();
  const long long left = a.n - tile * kTile;
  const int count_tile = left < kTile ? (int)left : kTile;
  int* iout = last ? a.out : j & 1 ? a.ibuf[1] : a.ibuf[0];
  long long* kout = j & 1 ? a.kbuf[1] : a.kbuf[0];
  unsigned* kout32 = reinterpret_cast<unsigned*>(kout);
  unsigned short* kout16 = reinterpret_cast<unsigned short*>(kout);
  for (int i = threadIdx.x; i < count_tile; i += kThreads) {
    const long long k = skey[i];
    const long long gp = sadj[digit_of(k, shift)] + i;
    iout[gp] = sidx[i];
    if (last) continue;
    if (out_bits == 16)
      kout16[gp] = (unsigned short)((unsigned long long)k >> 48);
    else if (out_bits == 32)
      kout32[gp] = (unsigned)((unsigned long long)k >> 32);
    else
      kout[gp] = k;
  }
}

constexpr int kPassSmem = kTile * (8 + 4) + kWarps * kBuckets * 4 +
                          kBuckets * 4 + kBuckets * 8;

// Raise radix_pass's dynamic shared-memory limit once per device: the
// attribute stays set, and the call costs host time on every launch.
cudaError_t allow_pass_smem() {
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done.load() >> dev & 1))) return err;
  err = cudaFuncSetAttribute(radix_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPassSmem);
  if (err == cudaSuccess && dev < 64) done.fetch_or(1ull << dev);
  return err;
}

}  // namespace

// 32-bit scratch words for n keys: histograms, bases, plan, counters, and
// 256 64-bit status words a tile.  ops.dedup_order asks for this size and
// allocates it zeroed.
extern "C" long long dedup_order_scratch_words(long long n) {
  return kStatusOff + 2 * kBuckets * ((n + kTile - 1) / kTile);
}

// keys: (n,) int64, n < 2^31.  kbuf0/kbuf1: (n,) int64 and ibuf0/ibuf1:
// (n,) int32 ping-pong buffers; scratch: n_scratch >=
// dedup_order_scratch_words(n) 32-bit words, zeroed; out: (n,) int32
// result.  Returns the launch status.
extern "C" int dedup_order(const long long* keys, long long n, long long* kbuf0,
                           long long* kbuf1, int* ibuf0, int* ibuf1,
                           unsigned* scratch, long long n_scratch, int* out,
                           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n >= (1ll << 31) || n_scratch < dedup_order_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  const int hist_blocks = (int)(tiles < kHistBlocks ? tiles : kHistBlocks);
  radix_histogram<<<hist_blocks, kThreads, 0, s>>>(keys, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_plan<<<1, kThreads, 0, s>>>(n, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_pass_smem();
  if (err != cudaSuccess) return (int)err;
  const PassArgs a{keys, n, {kbuf0, kbuf1}, {ibuf0, ibuf1}, out, scratch};
  for (int pass = 0; pass < kDigits; ++pass) {
    radix_pass<<<(unsigned)tiles, kThreads, kPassSmem, s>>>(a, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
