// Segmented inclusive scan for NVIDIA Hopper (sm_90a), K7: the scans that
// group_aggregate reads at each group's last row.
//
// Replaces no Pallas kernel.  The JAX package runs these scans through
// jax.lax.associative_scan over (start flag, value) pairs
// (simd_radix_sort_tpu/ops/hashagg.py:40, _segmented_scan), which XLA
// lowers for the TPU.  torch has no associative scan; written out as
// Hillis-Steele doubling (the plain version in cuda_scan.py) it takes
// ceil(log2 n) passes, each reading and writing every stream: O(n log n)
// bytes for an O(n) problem, and the kernel replaces it on the card.
//
// Plain C entry point, built with nvcc into the shared library of
// simd_radix_sort_tpu_torch/ops/_build.py and bound with ctypes.  The Python
// wrapper, with the plain PyTorch version beside it, is
// simd_radix_sort_tpu_torch/ops/cuda_scan.py.  The entry launches on the
// caller's stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// What it computes: for each stream, out[i] = x[s] op x[s+1] op ... op x[i],
// s the last row <= i whose start flag is set (or row 0), combined in row
// order; op is add, minimum or maximum, and minimum and maximum propagate
// NaN as torch.minimum and torch.maximum do.  Up to kMaxStreams streams of
// one dtype and op share a launch and its reads of the flags.
//
// Bound: bytes.  The function must read the flags (1 B/row) and every stream
// once and write every stream once.  Blocks run in no order, so a tile
// cannot wait for its predecessors' totals without making the combination
// order, and with it float sums, depend on scheduling.  The design is
// reduce-then-scan, three launches of two kernels on one stream:
//
//   1. seg_tiles_kernel, write false: one block per tile of kTileRows rows
//      writes the tile's summary for each stream: whether a start lies in
//      the tile, and the combination of its rows after the last start (all
//      of them if none).
//   2. seg_spine_kernel: one block per stream scans the summaries with the
//      segmented combiner into each tile's exclusive carry, in place.
//   3. seg_tiles_kernel, write true: each tile scans its rows again from its
//      carry and writes them.
//
// That reads each stream twice and the flags twice: 3 * w + 2 / k bytes a
// row and stream for k streams of w bytes, against the bound's 2 * w + 1 / k.
// Each thread holds 16 consecutive rows; values are loaded as 16-byte
// vectors, a warp's loads coalesced, and moved to each thread's rows through
// shared memory (each thread's 16 rows padded by 16 bytes, so the reads are
// free of bank conflicts).  Every combination happens in a fixed order: in
// row order within a thread, a shuffle tree across a warp, the warps of a
// block in order, and across tiles the spine's tree, so the output is the
// same bits from run to run and a float sum's rounding grows with the depth
// of those trees, not with the length of a segment.
//
// The entry takes 20 (dtype, op) pairs and nvcc compiles 24 kernels for
// them: a maximum runs as a minimum (see Op), and the two tile passes share
// one kernel.  Each kernel adds to the library's build, which a process
// that finds no library in its checkout waits for: this source takes nvcc
// ~9 s, hist_kernels.cu ~4 s (the H100 machine's nvcc, alone).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kTileRows = kThreads * kRowsPerThread;  // 4096
constexpr int kMaxStreams = 8;
constexpr int kSpineThreads = 1024;
constexpr int kSpineItems = 16;  // tile summaries a spine thread holds

// The kernels' ops.  The entry runs a maximum as the minimum of the values
// with their order reversed: each value's bits XORed with Streams::flip on
// load and again on store (a float's sign bit: max(a, b) = -min(-a, -b), NaN
// and ties alike; all of an integer's bits: max(a, b) = ~min(~a, ~b)).
enum Op { kAdd = 0, kMin = 1 };

// 2-byte floats, carried as their bits; arithmetic in float.
struct F16 { uint16_t b; };
struct BF16 { uint16_t b; };

// The streams one launch scans, passed by value as a kernel parameter, and
// the mask their bits are XORed with (0, or a maximum's: see Op).
struct Streams {
  const void* in[kMaxStreams];
  void* out[kMaxStreams];
  int count;
  unsigned long long flip;
};

template <typename T>
constexpr bool kIsInt = std::is_integral<T>::value;
template <typename T>
constexpr bool kIsWide = std::is_same<T, double>::value ||
                         std::is_same<T, float>::value;

// 2-byte floats to float and back (rounding to nearest even) by PTX's own
// conversions: the 2-byte float headers would add a second to the build.
__device__ __forceinline__ float to_float(F16 x) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(x.b));
  return f;
}
__device__ __forceinline__ float to_float(BF16 x) {
  return __uint_as_float((unsigned)x.b << 16);
}
__device__ __forceinline__ F16 rounded(float f, F16) {
  uint16_t b;
  asm("cvt.rn.f16.f32 %0, %1;" : "=h"(b) : "f"(f));
  return F16{b};
}
__device__ __forceinline__ BF16 rounded(float f, BF16) {
  uint16_t b;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(f));
  return BF16{b};
}

// a op b, a the earlier rows.  Minimum returns a NaN operand, else the
// earlier one on a tie.
template <int OP, typename T>
__device__ __forceinline__ T apply(T a, T b) {
  if constexpr (kIsInt<T>) {
    return b < a ? b : a;
  } else if constexpr (kIsWide<T>) {
    if constexpr (OP == kAdd) {
      return a + b;
    } else {
      if (a != a) return a;
      if (b != b) return b;
      return b < a ? b : a;
    }
  } else {
    const float fa = to_float(a), fb = to_float(b);
    if constexpr (OP == kAdd) {
      return rounded(fa + fb, a);
    } else {
      if (fa != fa) return a;
      if (fb != fb) return b;
      return fb < fa ? b : a;
    }
  }
}

// The identity of op: identity op x is x, bit for bit (-0.0 for a float
// sum, since +0.0 + -0.0 is +0.0).
template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if constexpr (kIsInt<T>) {
    using U = typename std::make_unsigned<T>::type;
    return (T)((U)~(U)0 >> 1);
  } else if constexpr (std::is_same<T, double>::value) {
    return OP == kAdd ? -0.0 : __longlong_as_double(0x7ff0000000000000LL);
  } else if constexpr (std::is_same<T, float>::value) {
    return OP == kAdd ? -0.0f : __int_as_float(0x7f800000);
  } else if constexpr (std::is_same<T, F16>::value) {
    return F16{(uint16_t)(OP == kAdd ? 0x8000 : 0x7c00)};
  } else {
    return BF16{(uint16_t)(OP == kAdd ? 0x8000 : 0x7f80)};
  }
}

// v's bits XORed with the low bits of m.
template <typename T>
__device__ __forceinline__ T flipped(T v, unsigned long long m) {
  if constexpr (sizeof(T) == 8) {
    unsigned long long b;
    memcpy(&b, &v, 8);
    b ^= m;
    memcpy(&v, &b, 8);
  } else {
    unsigned b = 0;
    memcpy(&b, &v, sizeof(T));
    b ^= (unsigned)m;
    memcpy(&v, &b, sizeof(T));
  }
  return v;
}

// The value of the segmented combination of two (flag, value) pairs, the
// earlier first: the later value alone if a start lies in it.
template <int OP, typename T>
__device__ __forceinline__ T combined(T earlier, bool later_flag, T later) {
  return later_flag ? later : apply<OP>(earlier, later);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int off) {
  if constexpr (sizeof(T) == 8) {
    long long b;
    memcpy(&b, &v, 8);
    b = __shfl_up_sync(0xffffffffu, b, off);
    memcpy(&v, &b, 8);
  } else {
    unsigned bits = 0;
    memcpy(&bits, &v, sizeof(T));
    bits = __shfl_up_sync(0xffffffffu, bits, off);
    memcpy(&v, &bits, sizeof(T));
  }
  return v;
}

// v of lane src.
template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  if constexpr (sizeof(T) == 8) {
    long long b;
    memcpy(&b, &v, 8);
    b = __shfl_sync(0xffffffffu, b, src);
    memcpy(&v, &b, 8);
  } else {
    unsigned bits = 0;
    memcpy(&bits, &v, sizeof(T));
    bits = __shfl_sync(0xffffffffu, bits, src);
    memcpy(&v, &bits, sizeof(T));
  }
  return v;
}

// Inclusive segmented scan of (f, v) across the lanes of a warp: a tree of
// shuffles, the same for every run.
template <int OP, typename T>
__device__ __forceinline__ void warp_scan(int lane, bool& f, T& v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T vo = shfl_up(v, off);
    const bool fo = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) {
      v = combined<OP>(vo, f, v);
      f = f || fo;
    }
  }
}

// Bit e of the result: byte e of the word is not 0 (e < 4).
__device__ __forceinline__ unsigned nonzero_bits(unsigned w) {
  w = __vcmpne4(w, 0) & 0x01010101u;
  return (w * 0x01020408u) >> 24;
}

// A thread's 16 start flags as bits: bit e for tile row r0 + e; rows past
// the tile's `rows` read as 0.
__device__ __forceinline__ unsigned load_flags(const uint8_t* tile, int r0,
                                               int rows) {
  uint4 u;
  if (r0 + kRowsPerThread <= rows) {
    u = __ldcs(reinterpret_cast<const uint4*>(tile + r0));
  } else {
    uint8_t b[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) b[e] = r0 + e < rows ? tile[r0 + e] : 0;
    memcpy(&u, b, 16);
  }
  return nonzero_bits(u.x) | nonzero_bits(u.y) << 4 |
         nonzero_bits(u.z) << 8 | nonzero_bits(u.w) << 12;
}

// Geometry of a warp's 512 rows of w-byte values: kVec values a 16-byte
// vector, kNV vectors a thread, and the thread's padded bytes in shared
// memory (a 1-byte thread's rows are one vector: no staging).
template <typename T>
struct Geo {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kNV = kRowsPerThread / kVec;
  static constexpr int kChunk = kNV > 1 ? 16 * kNV + 16 : 16;
  static constexpr int kStage = kNV > 1 ? 32 * kChunk : 16;
};

// Vector k of a warp's rows (in row order) in the staging area: thread
// k / kNV's chunk, part k % kNV.
template <typename T>
__device__ __forceinline__ int staged(int k) {
  return (k / Geo<T>::kNV) * Geo<T>::kChunk + (k % Geo<T>::kNV) * 16;
}

// x[e] = the tile's row r0 + e of `in` (r0 = 16 * thread), or `fill` past
// the tile's `rows`.  The loads are the warp's vectors in order, each lane
// taking every 32nd, through `stage`.
template <typename T>
__device__ __forceinline__ void load_rows(const T* in, int rows, int wrow0,
                                          int lane, uint8_t* stage, T fill,
                                          T (&x)[kRowsPerThread]) {
  using G = Geo<T>;
  if constexpr (G::kNV == 1) {
    const int r = wrow0 + lane * kRowsPerThread;
    if (r + kRowsPerThread <= rows) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(in + r));
      memcpy(x, &u, 16);
    } else {
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e)
        x[e] = r + e < rows ? in[r + e] : fill;
    }
  } else {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < G::kNV; ++j) {
      const int k = j * 32 + lane;
      const int r = wrow0 + k * G::kVec;
      uint4 u;
      if (r + G::kVec <= rows) {
        u = __ldcs(reinterpret_cast<const uint4*>(in + r));
      } else {
        T t[G::kVec];
#pragma unroll
        for (int e = 0; e < G::kVec; ++e) t[e] = r + e < rows ? in[r + e] : fill;
        memcpy(&u, t, 16);
      }
      *reinterpret_cast<uint4*>(stage + staged<T>(k)) = u;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < G::kNV; ++j) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(stage + lane * G::kChunk + j * 16);
      memcpy(&x[j * G::kVec], &u, 16);
    }
  }
}

// The inverse of load_rows for `out`: rows past the tile's `rows` are not
// written.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, int rows, int wrow0,
                                           int lane, uint8_t* stage,
                                           const T (&x)[kRowsPerThread]) {
  using G = Geo<T>;
  if constexpr (G::kNV == 1) {
    const int r = wrow0 + lane * kRowsPerThread;
    if (r + kRowsPerThread <= rows) {
      uint4 u;
      memcpy(&u, x, 16);
      __stcs(reinterpret_cast<uint4*>(out + r), u);
    } else {
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e)
        if (r + e < rows) out[r + e] = x[e];
    }
  } else {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < G::kNV; ++j) {
      uint4 u;
      memcpy(&u, &x[j * G::kVec], 16);
      *reinterpret_cast<uint4*>(stage + lane * G::kChunk + j * 16) = u;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < G::kNV; ++j) {
      const int k = j * 32 + lane;
      const int r = wrow0 + k * G::kVec;
      const uint4 u = *reinterpret_cast<const uint4*>(stage + staged<T>(k));
      if (r + G::kVec <= rows) {
        __stcs(reinterpret_cast<uint4*>(out + r), u);
      } else {
        T t[G::kVec];
        memcpy(t, &u, 16);
#pragma unroll
        for (int e = 0; e < G::kVec; ++e)
          if (r + e < rows) out[r + e] = t[e];
      }
    }
  }
}

// Passes 1 (write false: summaries into carry[q * tiles + tile] and
// has[tile]) and 3 (write true: rows scanned from carry[q * tiles + tile],
// written to the outputs), one kernel so that nvcc compiles one per dtype
// and op.  Four blocks an SM (at most 64 registers a thread): with the two
// that 104 registers allow, pass 3 moved its bytes at 59% of the card's
// bandwidth, at 81% with four (H100, Q1's shape).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, 4)
    seg_tiles_kernel(const uint8_t* __restrict__ starts, long long n,
                     Streams s, T* __restrict__ carry,
                     uint8_t* __restrict__ has, long long tiles, bool write) {
  __shared__ __align__(16) uint8_t stage[kWarps][Geo<T>::kStage];
  __shared__ T warp_v[2][kWarps];
  __shared__ bool warp_f[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * kTileRows;
  const int rows = (int)min((long long)kTileRows, n - row0);
  const int wrow0 = warp * 32 * kRowsPerThread;
  const unsigned flags =
      load_flags(starts + row0, threadIdx.x * kRowsPerThread, rows);
  const T id = identity<OP, T>();

  for (int q = 0; q < s.count; ++q) {
    // the carry from earlier tiles, loaded before the rows so that its
    // latency hides behind theirs
    const T cin = write ? carry[q * tiles + blockIdx.x] : id;
    T x[kRowsPerThread];
    load_rows<T>(static_cast<const T*>(s.in[q]) + row0, rows, wrow0, lane,
                 stage[warp], id, x);
    if (s.flip) {
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e) x[e] = flipped(x[e], s.flip);
    }
    // the thread's rows, in order
    T v = x[0];
#pragma unroll
    for (int e = 1; e < kRowsPerThread; ++e)
      v = (flags >> e) & 1 ? x[e] : apply<OP>(v, x[e]);
    bool f = flags != 0;
    warp_scan<OP>(lane, f, v);
    const T lane_ex = shfl_up(v, 1);  // lanes before this one; lane 0: none
    const bool lane_exf = __shfl_up_sync(0xffffffffu, f, 1);
    const int b = q & 1;
    if (lane == 31) {
      warp_v[b][warp] = v;
      warp_f[b][warp] = f;
    }
    __syncthreads();
    if (!write) {
      if (threadIdx.x == 0) {
        // the tile's summary: the warps' totals in order
        T tot = id;
        bool totf = false;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          tot = combined<OP>(tot, warp_f[b][w], warp_v[b][w]);
          totf = totf || warp_f[b][w];
        }
        carry[q * tiles + blockIdx.x] = tot;
        if (q == 0) has[blockIdx.x] = totf;
      }
    } else {
      // the carry, then earlier warps in order, then earlier lanes
      T p = cin;
      for (int w = 0; w < warp; ++w)
        p = combined<OP>(p, warp_f[b][w], warp_v[b][w]);
      if (lane > 0) p = combined<OP>(p, lane_exf, lane_ex);
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e) {
        p = (flags >> e) & 1 ? x[e] : apply<OP>(p, x[e]);
        x[e] = s.flip ? flipped(p, s.flip) : p;
      }
      store_rows<T>(static_cast<T*>(s.out[q]) + row0, rows, wrow0, lane,
                    stage[warp], x);
    }
  }
}

// Pass 2: block q turns stream q's tile summaries (has[t], carry[q * tiles
// + t]) into exclusive carries, in place: kSpineItems consecutive summaries
// a thread, in rounds of kSpineThreads * kSpineItems, each round a shuffle
// tree over its threads, the rounds chained in order.
template <typename T, int OP>
__global__ void __launch_bounds__(kSpineThreads)
    seg_spine_kernel(T* __restrict__ carry, const uint8_t* __restrict__ has,
                     long long tiles) {
  constexpr int kSpineWarps = kSpineThreads / 32;
  __shared__ T warp_v[kSpineWarps];
  __shared__ bool warp_f[kSpineWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T id = identity<OP, T>();
  T* c = carry + blockIdx.x * tiles;
  T run = id;  // the summaries of earlier rounds, combined
  for (long long base = 0; base < tiles;
       base += (long long)kSpineThreads * kSpineItems) {
    const long long t0 = base + (long long)threadIdx.x * kSpineItems;
    T v[kSpineItems];
    unsigned fl = 0;
#pragma unroll
    for (int i = 0; i < kSpineItems; ++i) {
      const bool in = t0 + i < tiles;
      v[i] = in ? c[t0 + i] : id;
      fl |= (unsigned)(in && has[t0 + i]) << i;
    }
    T a = v[0];
#pragma unroll
    for (int i = 1; i < kSpineItems; ++i)
      a = (fl >> i) & 1 ? v[i] : apply<OP>(a, v[i]);
    bool f = fl != 0;
    warp_scan<OP>(lane, f, a);
    const T lane_ex = shfl_up(a, 1);
    const bool lane_exf = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 31) {
      warp_v[warp] = a;
      warp_f[warp] = f;
    }
    __syncthreads();
    if (warp == 0) {
      bool wf = warp_f[lane];
      T wv = warp_v[lane];
      warp_scan<OP>(lane, wf, wv);
      T ex = shfl_up(wv, 1);
      bool exf = __shfl_up_sync(0xffffffffu, wf, 1);
      if (lane == 0) {
        ex = id;
        exf = false;
      }
      __syncwarp();
      warp_v[lane] = ex;
      warp_f[lane] = exf;
      // the round's total, for the rounds after it
      const T tot = shfl_idx(wv, 31);
      const bool totf = __shfl_sync(0xffffffffu, wf, 31);
      if (lane == 0) {
        // kept beside the prefixes: slot 0's prefix is the identity
        warp_v[0] = tot;
        warp_f[0] = totf;
      }
    }
    __syncthreads();
    const T tot = warp_v[0];
    const bool totf = warp_f[0];
    T p = run;
    if (warp > 0) p = combined<OP>(p, warp_f[warp], warp_v[warp]);
    if (lane > 0) p = combined<OP>(p, lane_exf, lane_ex);
#pragma unroll
    for (int i = 0; i < kSpineItems; ++i) {
      if (t0 + i < tiles) c[t0 + i] = p;
      p = (fl >> i) & 1 ? v[i] : apply<OP>(p, v[i]);
    }
    run = combined<OP>(run, totf, tot);
    __syncthreads();
  }
}

// Passes 1-3 of one dtype and op on `st`.
template <typename T, int OP>
cudaError_t scan(const uint8_t* starts, long long n, const Streams& s,
                 void* carry, uint8_t* has, cudaStream_t st) {
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  T* c = static_cast<T*>(carry);
  seg_tiles_kernel<T, OP>
      <<<(unsigned)tiles, kThreads, 0, st>>>(starts, n, s, c, has, tiles,
                                             false);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_spine_kernel<T, OP><<<s.count, kSpineThreads, 0, st>>>(c, has, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_tiles_kernel<T, OP>
      <<<(unsigned)tiles, kThreads, 0, st>>>(starts, n, s, c, has, tiles,
                                             true);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan_float(int op, const uint8_t* starts, long long n,
                       const Streams& s, void* carry, uint8_t* has,
                       cudaStream_t st) {
  return op == kAdd ? scan<T, kAdd>(starts, n, s, carry, has, st)
                    : scan<T, kMin>(starts, n, s, carry, has, st);
}

}  // namespace

extern "C" {

// `dtype`: 0 float64, 1 float32, 2 float16, 3 bfloat16, 4 int64, 5 int32,
// 6 int16, 7 int8; `op`: 0 add (floats only), 1 minimum, 2 maximum.
// `starts` holds n bool bytes; `ins` and `outs` are host arrays of
// `nstreams` pointers to n values each, 16-byte aligned.  `carry` holds
// nstreams * ceil(n / 4096) values of the dtype and `has` ceil(n / 4096)
// bytes: scratch.
int srs_segmented_scan(const void* starts, long long n, int dtype, int op,
                       int nstreams, void* const* ins, void* const* outs,
                       void* carry, void* has, void* stream) {
  static const int kWidth[] = {8, 4, 2, 2, 8, 4, 2, 1};
  if (n < 1 || nstreams < 1 || nstreams > kMaxStreams || dtype < 0 ||
      dtype > 7 || op < 0 || op > 2 || (dtype >= 4 && op == 0))
    return (int)cudaErrorInvalidValue;
  Streams s{};
  s.count = nstreams;
  for (int q = 0; q < nstreams; ++q) {
    s.in[q] = ins[q];
    s.out[q] = outs[q];
  }
  if (op == 2) {  // maximum: the minimum of the values in reversed order
    const int bits = 8 * kWidth[dtype];
    s.flip = dtype >= 4 ? ~0ULL >> (64 - bits) : 1ULL << (bits - 1);
    op = kMin;
  }
  const uint8_t* f = static_cast<const uint8_t*>(starts);
  uint8_t* h = static_cast<uint8_t*>(has);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)scan_float<double>(op, f, n, s, carry, h, st);
    case 1: return (int)scan_float<float>(op, f, n, s, carry, h, st);
    case 2: return (int)scan_float<F16>(op, f, n, s, carry, h, st);
    case 3: return (int)scan_float<BF16>(op, f, n, s, carry, h, st);
    case 4: return (int)scan<int64_t, kMin>(f, n, s, carry, h, st);
    case 5: return (int)scan<int32_t, kMin>(f, n, s, carry, h, st);
    case 6: return (int)scan<int16_t, kMin>(f, n, s, carry, h, st);
    default: return (int)scan<int8_t, kMin>(f, n, s, carry, h, st);
  }
}

}  // extern "C"
