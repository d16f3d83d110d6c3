// Counting-sort kernels for NVIDIA Hopper (sm_90a): the CUDA C++ port of the
// Pallas kernels in simd_radix_sort_tpu/ops/pallas_hist.py (K1-K4) and of the
// packed uint8 run fill in scripts/u8_attack.py (K6).
//
// Plain C entry points, built with nvcc into a shared library and bound with
// ctypes (simd_radix_sort_tpu_torch/ops/_build.py).  The Python wrappers, with
// the plain PyTorch version of each kernel beside it, are in
// simd_radix_sort_tpu_torch/ops/cuda_hist.py.  Every entry launches on the
// caller's stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// All five kernels are bound by device-memory bytes: each reads or writes
// every element once and does a handful of integer operations on it.  The
// designs therefore aim at one streaming pass with 16-byte accesses per
// thread, and keep every per-element counter in registers or shared memory
// so that only a few atomics per block reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHistThreads = 512;  // K1's blocks (one wave of them)

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The least b in [lo, hi] with i < cum[b + 1], or hi if there is none.
// cum is non-decreasing.
__device__ __forceinline__ int bucket_in(const long long* cum, int lo, int hi,
                                         long long i) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid + 1] <= i) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{j < k : cum[j + 1] <= i}, clamped to k - 1: the bucket whose run holds
// output position i.  cum[0..k] is non-decreasing.
__device__ __forceinline__ int bucket_of(const long long* cum, int k,
                                         long long i) {
  return bucket_in(cum, 0, k - 1, i);
}

// K1.  Replaces pallas_hist.py:_hist_kernel / histogram (a (k, 128)
// lane-parallel accumulator carried across a sequential grid) and, for
// k = 256 and 1024, counting.py:mxu_histogram (a one-hot matmul on the MXU).
// out[b] += #{i : (T)(x[i] - base) == b} for b < k; other values drop out.
// Bound: reading n * sizeof(T) bytes.  One launch; each block counts into
// shared memory and adds its counts to `out` once.
//
// The TPU kernel's cost does not depend on the data; a shared atomic per
// row could, since lanes of a warp that hit one counter or one bank are
// served one after another.  Measured on an H100 (PERF.md, shapes S1-S8):
// - With one array of k counters per block and one atomic per row, every
//   distribution took the same time, all rows one value included: 1-byte
//   keys were bound by the instructions issued per row (1.9x their bound;
//   more of them made it slower, fewer faster), 4-byte keys by memory
//   (1.17x).
// - 1-byte keys (histogram_kernel_u8) are counted by their raw byte, with
//   base and k applied to the 256 counts at the block's end, so a row costs
//   no subtraction and no range test.  Byte v of lane l counts at int
//   index v * 32 + l: the 32 lanes of an atomic always hit 32 banks, and
//   the byte offsets of two rows are built at once in the 16-bit halves of
//   a word: about 2 instructions and an atomic a row.  32 KB a block.
// - 2- and 4-byte keys (histogram_kernel) keep one array of k counters.
// - A 16-byte vector whose rows all hold one value (the runs of Zero and
//   sorted inputs, most of a nearly constant column) is counted with one
//   atomic.
// - Each thread keeps two 16-byte loads in flight, and the grid is one
//   wave of kHistThreads-thread blocks.
template <typename T>
__device__ __forceinline__ void count_vector(const uint4& w, T base, int k,
                                             int* counts) {
  constexpr int kPer = 16 / sizeof(T);
  const uint32_t first = sizeof(T) == 2 ? __byte_perm(w.x, 0, 0x1010) : w.x;
  T e[kPer];
  memcpy(e, &w, sizeof(w));
  if (w.x == first && w.y == first && w.z == first && w.w == first) {
    const unsigned off = (T)(e[0] - base);
    if (off < (unsigned)k) atomicAdd(&counts[off], kPer);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned off = (T)(e[j] - base);
    if (off < (unsigned)k) atomicAdd(&counts[off], 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const T* __restrict__ x, long long n, T base, int k,
                     int* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  int* counts = reinterpret_cast<int*>(smem);
  for (int b = threadIdx.x; b < k; b += kHistThreads) counts[b] = 0;
  __syncthreads();
  constexpr int kPer = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kHistThreads;
  long long head = 0;
  if (aligned16(x)) {
    const long long nvec = n / kPer;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long v = tid;
    for (; v + stride < nvec; v += 2 * stride) {
      const uint4 a = xv[v], b = xv[v + stride];
      count_vector<T>(a, base, k, counts);
      count_vector<T>(b, base, k, counts);
    }
    if (v < nvec) count_vector<T>(xv[v], base, k, counts);
    head = nvec * kPer;
  }
  // the ragged tail, or all of an input that is not 16-byte aligned
  for (long long i = head + tid; i < n; i += stride) {
    const unsigned off = (T)(x[i] - base);
    if (off < (unsigned)k) atomicAdd(&counts[off], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < k; b += kHistThreads)
    if (counts[b]) atomicAdd(&out[b], counts[b]);
}

// K1 for 1-byte carriers, k <= 1024 (no offset reaches 256).
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel_u8(const uint8_t* __restrict__ x, long long n,
                        unsigned base, int k, int* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  int* counts = reinterpret_cast<int*>(smem);  // [byte][lane]
  for (int i = threadIdx.x; i < 256 * 32; i += kHistThreads) counts[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // the byte address of counter (v, lane) is v * 128 + lane * 4 < 2^15
  const uint32_t lanes = (uint32_t)(lane * 4) * 0x10001u;
  constexpr uint32_t kRows = (0xFFu << 7) * 0x10001u;
  auto count_word = [&](uint32_t w) {
    const uint32_t even = ((w << 7) & kRows) | lanes;  // bytes 0 and 2
    const uint32_t odd = ((w >> 1) & kRows) | lanes;   // bytes 1 and 3
    atomicAdd(reinterpret_cast<int*>(smem + (even & 0xFFFFu)), 1);
    atomicAdd(reinterpret_cast<int*>(smem + (even >> 16)), 1);
    atomicAdd(reinterpret_cast<int*>(smem + (odd & 0xFFFFu)), 1);
    atomicAdd(reinterpret_cast<int*>(smem + (odd >> 16)), 1);
  };
  auto count_vector8 = [&](const uint4& w) {
    const uint32_t first = __byte_perm(w.x, 0, 0);
    if (w.x == first && w.y == first && w.z == first && w.w == first) {
      atomicAdd(&counts[(w.x & 0xFFu) * 32 + lane], 16);
      return;
    }
    count_word(w.x);
    count_word(w.y);
    count_word(w.z);
    count_word(w.w);
  };
  const long long tid = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kHistThreads;
  long long head = 0;
  if (aligned16(x)) {
    const long long nvec = n / 16;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long v = tid;
    for (; v + stride < nvec; v += 2 * stride) {
      const uint4 a = xv[v], b = xv[v + stride];
      count_vector8(a);
      count_vector8(b);
    }
    if (v < nvec) count_vector8(xv[v]);
    head = nvec * 16;
  }
  // the ragged tail, or all of an input that is not 16-byte aligned
  for (long long i = head + tid; i < n; i += stride)
    atomicAdd(&counts[x[i] * 32 + lane], 1);
  __syncthreads();
  // byte v's 32 copies, read from a rotated start: a warp's lanes hit
  // distinct banks
  for (int v = threadIdx.x; v < 256; v += kHistThreads) {
    int sum = 0;
    for (int j = 0; j < 32; ++j) sum += counts[v * 32 + ((j + v) & 31)];
    const unsigned off = (unsigned)(v - (int)base) & 0xFFu;
    if (sum && off < (unsigned)k) atomicAdd(&out[off], sum);
  }
}

// K2.  Replaces pallas_hist.py:_minmax_hist16_kernel / minmax_hist16.
// stats[0] = min u, stats[1] = max u, stats[2 + b] = #{u & 15 == b}, where
// u = (T)(x ^ flip) zero-extended to 32 bits.  stats[18] (the min,
// complemented) and stats[19] (the blocks' ticket) are the kernel's own.
// All kStatsWords words must be 0 on entry: zero is every field's identity,
// so one memset is the whole initialisation, and the last block to finish
// writes stats[0].  CUDA has unsigned atomics, so the TPU's sign flip into
// int32 is not needed.  Bound: reading n * sizeof(T) bytes.
//
// Sixteen compare-and-adds a row (about 36 integer instructions) made the
// pass bound by the instructions it issued, 3.1x its bound on 2-byte keys
// (an H100 80GB HBM3 at 700 W).  So a row costs a few instructions here,
// and the pass is bound by memory: 1.10-1.21x its bound on every
// distribution on the same card (PERF.md):
// - min and max fold two words into the accumulator with one DPX
//   instruction each, __vimin3_u16x2 / __vimax3_u16x2 on the two rows of a
//   word of 2-byte rows, __vimin3_u32 / __vimax3_u32 on 4-byte rows; on
//   sm_90a each is one VIMNMX3 instruction (cuobjdump -sass);
// - each row is counted with one shared-memory atomic into lane-copied
//   counters, (b, lane) at int index b * 32 + lane (2 KB a block), so a
//   warp's 32 lanes hit 32 banks whatever the data; for 2-byte rows the
//   byte offsets of a word's two rows are built at once in its 16-bit
//   halves, as K1 does for 1-byte rows;
// - each thread keeps two 16-byte loads in flight, and the grid is one wave
//   of kStatsThreads-thread blocks.
// Measured and not kept, since the device time did not move: K1's
// one-atomic count of a vector whose rows are equal, and two-input
// __vminu2 / __vmaxu2 in place of the DPX folds.
constexpr int kStatsThreads = 512;  // one warp a residue at the block's end
constexpr int kStatsWords = 20;     // cuda_hist.STATS_WORDS
static_assert(kStatsThreads == 16 * 32, "one counter a thread to clear");

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
    minmax_hist16_kernel(const T* __restrict__ x, long long n, T flip,
                         unsigned* __restrict__ stats) {
  __shared__ int counts[16 * 32];  // [residue][lane]
  __shared__ unsigned block_mm[2];  // ~min, max
  counts[threadIdx.x] = 0;
  if (threadIdx.x < 2) block_mm[threadIdx.x] = 0;
  __syncthreads();
  constexpr bool kHalves = sizeof(T) == 2;  // two rows a 32-bit word
  constexpr int kPer = 16 / sizeof(T);
  constexpr uint32_t kSplat = kHalves ? 0x10001u : 1u;
  const int lane = threadIdx.x & 31;
  char* const smem = reinterpret_cast<char*>(counts);
  const uint32_t flips = (uint32_t)flip * kSplat;
  // counter (b, lane) sits at byte offset b * 128 + lane * 4 < 2^11
  const uint32_t lane4 = (uint32_t)lane * 4;
  const uint32_t lanes = lane4 * kSplat;
  constexpr uint32_t kRes = (15u << 7) * kSplat;
  uint32_t mn = ~0u, mx = 0u;  // for 2-byte rows, per 16-bit half
  auto fold = [&](uint32_t a, uint32_t b) {
    if constexpr (kHalves) {
      mn = __vimin3_u16x2(mn, a, b);
      mx = __vimax3_u16x2(mx, a, b);
    } else {
      mn = __vimin3_u32(mn, a, b);
      mx = __vimax3_u32(mx, a, b);
    }
  };
  auto count = [&](uint32_t off) {
    atomicAdd(reinterpret_cast<int*>(smem + off), 1);
  };
  auto count_word = [&](uint32_t u) {  // a word of flipped rows
    const uint32_t off = ((u << 7) & kRes) | lanes;
    if constexpr (kHalves) {
      count(off & 0xFFFFu);
      count(off >> 16);
    } else {
      count(off);
    }
  };
  auto stats_vector = [&](uint4 w) {
    w.x ^= flips;
    w.y ^= flips;
    w.z ^= flips;
    w.w ^= flips;
    fold(w.x, w.y);
    fold(w.z, w.w);
    count_word(w.x);
    count_word(w.y);
    count_word(w.z);
    count_word(w.w);
  };
  const long long tid = (long long)blockIdx.x * kStatsThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kStatsThreads;
  long long head = 0;
  if (aligned16(x)) {
    const long long nvec = n / kPer;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long v = tid;
    for (; v + stride < nvec; v += 2 * stride) {
      const uint4 a = xv[v], b = xv[v + stride];
      stats_vector(a);
      stats_vector(b);
    }
    if (v < nvec) stats_vector(xv[v]);
    head = nvec * kPer;
  }
  // the ragged tail, or all of an input that is not 16-byte aligned
  for (long long i = head + tid; i < n; i += stride) {
    const uint32_t u = (T)(x[i] ^ flip);
    fold(u * kSplat, u * kSplat);
    count(((u << 7) & (15u << 7)) | lane4);
  }
  if constexpr (kHalves) {
    mn = min(mn & 0xFFFFu, mn >> 16);
    mx = max(mx & 0xFFFFu, mx >> 16);
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  __syncthreads();
  // warp w sums residue w's 32 copies
  const int warp = threadIdx.x >> 5;
  const int c = __reduce_add_sync(0xffffffffu, counts[warp * 32 + lane]);
  if (lane == 0) {
    atomicMax(&block_mm[0], ~mn);
    atomicMax(&block_mm[1], mx);
    if (c) atomicAdd(&stats[2 + warp], (unsigned)c);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(&stats[18], block_mm[0]);
    atomicMax(&stats[1], block_mm[1]);
    __threadfence();
    if (atomicAdd(&stats[19], 1u) == gridDim.x - 1) {
      __threadfence();  // every block's stats[18] is in
      stats[0] = ~atomicMax(&stats[18], 0u);
    }
  }
}

constexpr int kMaxFillK = 4096;  // cuda_hist.MAX_FILL_K
constexpr int kMaxPrefixPer = kMaxFillK / kThreads;

// cum[0..k] = the int64 exclusive prefix sums of the int32 counts hist[0..k),
// cum[k] the total, built by every block in shared memory: each thread sums
// a contiguous chunk of at most 16 counts held in registers, a warp-shuffle
// scan and a scan over the warps' totals give each chunk its start.  The
// counts are read once per block from L2.  Ends with __syncthreads().
__device__ __forceinline__ void block_prefix(const int* __restrict__ hist,
                                             int k, long long* cum) {
  __shared__ long long warp_start[kThreads / 32];
  const int per = (k + kThreads - 1) / kThreads;
  const int j0 = threadIdx.x * per;
  int h[kMaxPrefixPer];
  long long s = 0;
#pragma unroll
  for (int j = 0; j < kMaxPrefixPer; ++j) {
    h[j] = (j < per && j0 + j < k) ? hist[j0 + j] : 0;
    s += h[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = s;  // inclusive scan of s within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_start[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' totals
    const long long t = lane < kThreads / 32 ? warp_start[lane] : 0;
    long long u = t;
#pragma unroll
    for (int off = 1; off < kThreads / 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, u, off);
      if (lane >= off) u += y;
    }
    if (lane < kThreads / 32) warp_start[lane] = u - t;
  }
  __syncthreads();
  long long c = warp_start[warp] + incl - s;
#pragma unroll
  for (int j = 0; j < kMaxPrefixPer; ++j)
    if (j < per && j0 + j < k) {
      cum[j0 + j] = c;
      c += h[j];
    }
  if (threadIdx.x == kThreads - 1) cum[k] = c;  // the total
  __syncthreads();
}

// One 16-byte vector of kPer copies of v.
template <typename T>
__device__ __forceinline__ uint4 splat(T v) {
  const uint32_t word = (uint32_t)v * (sizeof(T) == 1   ? 0x01010101u
                                       : sizeof(T) == 2 ? 0x00010001u
                                                        : 1u);
  return make_uint4(word, word, word, word);
}

// The core of K4 and K6: out[i] = (T)(base + bucket_of(i)) for the nvec
// 16-byte vectors of an aligned output, cut into tiles of tile_vecs vectors
// that a persistent grid takes in turn.  For each tile two threads find the
// buckets of its first and last position; when they agree (almost every tile
// at the main path's shapes: a run is then far longer than a tile) the block
// stores one splat to every vector of the tile, with no shared-memory read
// per element.  Otherwise each vector searches only between those two
// buckets and walks forward over the boundaries it crosses, so boundary work
// over the grid is O(k + tiles).  Stores stream (__stcs): the output passes
// through L2 once.
template <typename T>
__device__ __forceinline__ void fill_tiles(const long long* cum, int k,
                                           long long nvec, unsigned base,
                                           T flip, long long tile_vecs,
                                           uint4* __restrict__ out) {
  constexpr int kPer = 16 / sizeof(T);
  __shared__ int bounds[2][2];  // [tile parity][first, last]: one sync a tile
  const long long ntiles = (nvec + tile_vecs - 1) / tile_vecs;
  int parity = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, parity ^= 1) {
    const long long v0 = t * tile_vecs;
    const long long v1 = min(v0 + tile_vecs, nvec);
    if (threadIdx.x < 2)
      bounds[parity][threadIdx.x] =
          bucket_of(cum, k, threadIdx.x ? v1 * kPer - 1 : v0 * kPer);
    __syncthreads();
    const int b_lo = bounds[parity][0], b_hi = bounds[parity][1];
    if (b_lo == b_hi) {
      const uint4 w = splat<T>((T)((T)(base + (unsigned)b_lo) ^ flip));
      for (long long v = v0 + threadIdx.x; v < v1; v += kThreads)
        __stcs(out + v, w);
      continue;
    }
    for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const long long i0 = v * kPer;
      int b = bucket_in(cum, b_lo, b_hi, i0);
      T e[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        while (b < b_hi && cum[b + 1] <= i0 + j) ++b;
        e[j] = (T)((T)(base + (unsigned)b) ^ flip);
      }
      uint4 w;
      memcpy(&w, e, sizeof(w));
      __stcs(out + v, w);
    }
  }
}

// K4.  Replaces pallas_hist.py:_fill_kernel / fill_runs: the sorted carrier
// from a histogram, hist[b] copies of (T)(base + b) for k <= 4096 buckets.
// Bound: writing n * sizeof(T) bytes (plus reading 4k).  The TPU kernel
// paints one output block per grid step from a prefetched start bucket and
// walks only the run boundaries inside the block; fill_tiles does the same
// per tile.  The int64 prefix (at most 32.8 KB of shared memory) is built in
// the kernel from `hist`, so a call is this one launch, and more than 2^31
// rows cannot overflow it as the TPU version's int32 prefix could.  The grid
// is one wave, so the blocks' prefix reads stay near 1% of the output bytes
// at the main path's shapes.  The ragged tail (fewer than 16 bytes), or all
// of an output that is not 16-byte aligned, goes element by element.
template <typename T>
__global__ void fill_runs_kernel(const int* __restrict__ hist, int k,
                                 long long n, unsigned base, int tile_bytes,
                                 T* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  long long* cum = reinterpret_cast<long long*>(smem);
  block_prefix(hist, k, cum);
  constexpr int kPer = 16 / sizeof(T);
  long long head = 0;
  if (aligned16(out)) {
    head = n / kPer * kPer;
    fill_tiles<T>(cum, k, n / kPer, base, (T)0, tile_bytes / 16,
                  reinterpret_cast<uint4*>(out));
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = head + tid; i < n; i += stride)
    out[i] = (T)(base + (unsigned)bucket_of(cum, k, i));
}

// K6.  Replaces the kernel inside scripts/u8_attack.py:fill_runs_packed: the
// uint8 run fill stored as packed u32 words, four output bytes per word.
// Output byte i is the bucket b (k <= 256) whose run holds i, so the bytes
// are hist[b] copies of b: K4's function for uint8 and base 0, and it runs
// on K4's core (prefix in the kernel, fill_tiles over 16-byte vectors).
// Bound: writing n bytes (plus reading 4k).  The tail of fewer than four
// words goes word by word: one search for the word's first byte, a walk for
// the other three.
__global__ void fill_runs_packed_kernel(const int* __restrict__ hist, int k,
                                        long long nwords, int tile_bytes,
                                        uint32_t* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  long long* cum = reinterpret_cast<long long*>(smem);
  block_prefix(hist, k, cum);
  long long head = 0;
  if (aligned16(out)) {
    head = nwords / 4 * 4;
    fill_tiles<uint8_t>(cum, k, nwords / 4, 0u, (uint8_t)0,
                        tile_bytes / 16, reinterpret_cast<uint4*>(out));
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = head + tid; w < nwords; w += stride) {
    const long long i0 = w * 4;
    int b = bucket_of(cum, k, i0);
    uint32_t word = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      while (b < k - 1 && cum[b + 1] <= i0 + m) ++b;
      word |= (uint32_t)b << (8 * m);
    }
    out[w] = word;
  }
}

// K3, second launch.  Replaces the paint phase of
// pallas_hist.py:_tiny_sort_kernel / tiny_sort16.  The TPU kernel runs its
// stats phase and its paint phase as one sequential grid; CUDA blocks run
// concurrently, so the stats come from a finished minmax_hist16_kernel launch
// on the same stream instead.  Each block rotates the residue histogram by
// min & 15 into the 16 counts (the true ones whenever max - min < 16, and
// the same function of the residue histogram as the TPU kernel's
// otherwise), prefix sums them into 17 int64 boundaries in shared memory and
// paints with K4's tile-driven core over those 16 buckets:
// out[i] = (T)(min + bucket) ^ flip.  Bound: writing n * sizeof(T) bytes
// (K2's launch reads them).  A binary search over the boundaries for every
// 16-byte vector and a shared-memory compare for every element took 1.45x
// the write bound on 2-byte keys (an H100 80GB HBM3 at 700 W); the tiles
// take one splat store a vector wherever a run covers the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fill16_kernel(const unsigned* __restrict__ stats, long long n, T flip,
                  int tile_bytes, T* __restrict__ out) {
  __shared__ long long cum[17];
  const unsigned mn = stats[0];
  if (threadIdx.x == 0) {
    long long c = 0;
    cum[0] = 0;
    for (int j = 0; j < 16; ++j) {
      c += stats[2 + ((mn + (unsigned)j) & 15u)];
      cum[j + 1] = c;
    }
  }
  __syncthreads();
  constexpr int kPer = 16 / sizeof(T);
  long long head = 0;
  if (aligned16(out)) {
    head = n / kPer * kPer;
    fill_tiles<T>(cum, 16, n / kPer, mn, flip, tile_bytes / 16,
                  reinterpret_cast<uint4*>(out));
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = head + tid; i < n; i += stride)
    out[i] = (T)((T)(mn + (unsigned)bucket_of(cum, 16, i)) ^ flip);
}

// One wave of a persistent grid of `threads`-thread blocks for `items`
// units of work (a fill's tiles): as many blocks as the SMs hold at once, no
// more than there are items, at least one.
template <typename K>
int wave_grid(K kernel, int threads, long long items, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  long long blocks = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > items) blocks = items;
  return blocks < 1 ? 1 : (int)blocks;
}

constexpr int kMaxHistK = 1024;  // cuda_hist.MAX_HIST_K

// K1's launch: one wave of blocks, no more than the input has 16-byte
// vectors for; 1-byte carriers on histogram_kernel_u8 (32 KB of counters a
// block), wider ones with k int32 counters a block.
template <typename T>
int launch_histogram(const T* x, long long n, T base, int k, int* out,
                     cudaStream_t s) {
  const long long vecs = (n * (long long)sizeof(T) + 15) / 16;
  const long long items = (vecs + kHistThreads - 1) / kHistThreads;
  if constexpr (sizeof(T) == 1) {
    const size_t smem = 256 * 32 * sizeof(int);
    const int grid =
        wave_grid(histogram_kernel_u8, kHistThreads, items, smem);
    histogram_kernel_u8<<<grid, kHistThreads, smem, s>>>(x, n, base, k, out);
  } else {
    const size_t smem = (size_t)k * sizeof(int);
    const int grid =
        wave_grid(histogram_kernel<T>, kHistThreads, items, smem);
    histogram_kernel<T><<<grid, kHistThreads, smem, s>>>(x, n, base, k, out);
  }
  return (int)cudaGetLastError();
}

// K4's launch.  `hist` holds k int32 counts; tile_bytes, a positive multiple
// of 16, is the output tile a block fills at a time.
template <typename T>
int launch_fill_runs(const int* hist, int k, long long n, unsigned base,
                     int tile_bytes, T* out, cudaStream_t s) {
  const size_t smem = (size_t)(k + 1) * sizeof(long long);
  const long long tiles =
      (n * (long long)sizeof(T) + tile_bytes - 1) / tile_bytes;
  const int grid = wave_grid(fill_runs_kernel<T>, kThreads, tiles, smem);
  fill_runs_kernel<T><<<grid, kThreads, smem, s>>>(hist, k, n, base,
                                                  tile_bytes, out);
  return (int)cudaGetLastError();
}

// K2's launch: one memset of the stats, then one wave of blocks, no more
// than the input has 16-byte vectors for.
template <typename T>
int launch_minmax_hist16(const T* x, long long n, T flip, unsigned* stats,
                         cudaStream_t s) {
  cudaMemsetAsync(stats, 0, kStatsWords * sizeof(unsigned), s);
  const long long vecs = (n * (long long)sizeof(T) + 15) / 16;
  const long long items = (vecs + kStatsThreads - 1) / kStatsThreads;
  const int grid =
      wave_grid(minmax_hist16_kernel<T>, kStatsThreads, items, 0);
  minmax_hist16_kernel<T><<<grid, kStatsThreads, 0, s>>>(x, n, flip, stats);
  return (int)cudaGetLastError();
}

// K3's fill: one wave of blocks, no more than there are output tiles.
template <typename T>
int launch_fill16(const unsigned* stats, long long n, T flip, int tile_bytes,
                  T* out, cudaStream_t s) {
  const long long tiles =
      (n * (long long)sizeof(T) + tile_bytes - 1) / tile_bytes;
  const int grid = wave_grid(fill16_kernel<T>, kThreads, tiles, 0);
  fill16_kernel<T><<<grid, kThreads, 0, s>>>(stats, n, flip, tile_bytes,
                                             out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* srs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int srs_histogram(const void* x, int width, long long n, unsigned base, int k,
                  void* out, void* stream) {
  if (k < 1 || k > kMaxHistK) return (int)cudaErrorInvalidValue;
  switch (width) {
    case 1:
      return launch_histogram((const uint8_t*)x, n, (uint8_t)base, k,
                              (int*)out, (cudaStream_t)stream);
    case 2:
      return launch_histogram((const uint16_t*)x, n, (uint16_t)base, k,
                              (int*)out, (cudaStream_t)stream);
    case 4:
      return launch_histogram((const uint32_t*)x, n, (uint32_t)base, k,
                              (int*)out, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int srs_minmax_hist16(const void* x, int width, long long n, unsigned flip,
                      void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* st = (unsigned*)stats;
  switch (width) {
    case 2:
      return launch_minmax_hist16((const uint16_t*)x, n, (uint16_t)flip, st,
                                  s);
    case 4:
      return launch_minmax_hist16((const uint32_t*)x, n, (uint32_t)flip, st,
                                  s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int srs_fill16(const void* stats, int width, long long n, unsigned flip,
               int tile_bytes, void* out, void* stream) {
  if (tile_bytes < 16 || tile_bytes % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned* st = (const unsigned*)stats;
  switch (width) {
    case 2:
      return launch_fill16(st, n, (uint16_t)flip, tile_bytes, (uint16_t*)out,
                           s);
    case 4:
      return launch_fill16(st, n, (uint32_t)flip, tile_bytes, (uint32_t*)out,
                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int srs_fill_runs(const void* hist, int k, long long n, unsigned base,
                  int width, int tile_bytes, void* out, void* stream) {
  if (k < 1 || k > kMaxFillK || tile_bytes < 16 || tile_bytes % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* h = (const int*)hist;
  switch (width) {
    case 1:
      return launch_fill_runs(h, k, n, base, tile_bytes, (uint8_t*)out, s);
    case 2:
      return launch_fill_runs(h, k, n, base, tile_bytes, (uint16_t*)out, s);
    case 4:
      return launch_fill_runs(h, k, n, base, tile_bytes, (uint32_t*)out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int srs_fill_runs_packed(const void* hist, int k, long long n, int tile_bytes,
                         void* out, void* stream) {
  if (k < 1 || k > 256 || n % 4 || tile_bytes < 16 || tile_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(k + 1) * sizeof(long long);
  const int grid = wave_grid(fill_runs_packed_kernel, kThreads,
                             (n + tile_bytes - 1) / tile_bytes, smem);
  fill_runs_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)hist, k, n / 4, tile_bytes, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
