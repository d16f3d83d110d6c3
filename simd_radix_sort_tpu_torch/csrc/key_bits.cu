// The bits a key stream uses, for NVIDIA Hopper (sm_90a), K8: the window of
// key bits cub's pair sort (sort_pairs.cuh) is given, so that it runs an
// 8-bit pass only over bits in which the keys differ.
//
// Replaces no Pallas kernel: jax.lax.sort compares whole keys and takes no
// bit range.  cub's radix sort takes one (begin_bit, end_bit) and runs
// ceil((end_bit - begin_bit) / 8) passes, each reading and writing every key
// and value; over the full width of a 64-bit key that is 8 passes, where
// order or surrogate keys below 2^30 need 4.
//
// Plain C entry point, built with nvcc into the shared library of
// simd_radix_sort_tpu_torch/ops/_build.py and bound with ctypes.  The Python
// wrapper, with the plain PyTorch version beside it, is
// simd_radix_sort_tpu_torch/ops/cuda_sort.py (`key_bits`,
// `key_bits_plain`).  The entry launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.  It also queues
// the copy of the answer into the caller's pinned word, so that a sort's
// one host read costs one C call and one wait.
//
// What it computes: the OR over every row i of keys[i] ^ keys[0], a key's
// width of bits (1, 2, 4 or 8 bytes, read as raw bits), into words[1].  cub
// twiddles a key by XOR with a constant (the sign bit of a signed key, all
// bits again when descending), which leaves keys[i] ^ keys[0] as it is, so
// the set bits of that OR are the bits in which the twiddled keys differ,
// and a stable sort over [lowest set bit, highest set bit + 1) gives the
// full-width sort's order, ties included.
//
// Two launches on one stream:
//
//   1. key_bits_sample_kernel: one block ORs S = min(n, kSample) keys, at
//      rows j (n - 1) / (S - 1) for j < S (the first and the last key among
//      them), into words[0].  It writes the same OR to words[1] when its
//      window already needs every pass of the key's width, else 0.
//   2. key_bits_kernel: a wave of blocks.  Each first reads words[0], and
//      when that window already needs every pass, returns at once: a sample
//      holds no bit the whole stream lacks, so the whole stream's window
//      needs every pass too and the sort keeps the full width.  Otherwise
//      its threads OR 16-byte vectors of the stream, each XORed with
//      keys[0] repeated across the vector, the rows before the first and
//      after the last 16-byte boundary one at a time, and each block makes
//      one atomicOr into words[1].
//
// Bound: bytes.  The whole stream is read once, n * width bytes; a stream
// whose sample needs every pass costs the sample and a launch whose blocks
// return at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 16-byte loads a thread has in flight
constexpr int kSample = 4096;  // cuda_sort.SAMPLE
constexpr int kSampleThreads = 1024;

typedef unsigned long long u64;

// The 8-bit passes a window of the OR `w` needs.
__device__ __forceinline__ int passes(u64 w) {
  if (w == 0) return 0;
  const int end = 64 - __clzll((long long)w);
  const int begin = __ffsll((long long)w) - 1;
  return (end - begin + 7) / 8;
}

template <int W>
__device__ __forceinline__ u64 load_key(const unsigned char* p) {
  if constexpr (W == 1)
    return *p;
  else if constexpr (W == 2)
    return *reinterpret_cast<const uint16_t*>(p);
  else if constexpr (W == 4)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return *reinterpret_cast<const u64*>(p);
}

// k, a W-byte key, repeated across 8 bytes.
template <int W>
__device__ __forceinline__ u64 repeated(u64 k) {
  if constexpr (W == 1)
    return k * 0x0101010101010101ull;
  else if constexpr (W == 2)
    return k * 0x0001000100010001ull;
  else if constexpr (W == 4)
    return k | (k << 32);
  else
    return k;
}

// The OR of the W-byte lanes of x.
template <int W>
__device__ __forceinline__ u64 folded(u64 x) {
  if constexpr (W <= 4) x = (x | (x >> 32)) & 0xffffffffull;
  if constexpr (W <= 2) x = (x | (x >> 16)) & 0xffffull;
  if constexpr (W == 1) x = (x | (x >> 8)) & 0xffull;
  return x;
}

// The OR of v over the block, in thread 0.
__device__ __forceinline__ u64 block_or(u64 v) {
  __shared__ u64 warps[32];
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = warps[lane];
    for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <int W>
__global__ void __launch_bounds__(kSampleThreads)
    key_bits_sample_kernel(const unsigned char* __restrict__ x, long long n,
                           u64* words) {
  const long long s = n < kSample ? n : kSample;
  const u64 k0 = load_key<W>(x);
  constexpr int kPerThread = kSample / kSampleThreads;
  u64 keys[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {  // every load in flight at once
    const long long j = threadIdx.x + (long long)u * kSampleThreads;
    const long long i = s > 1 ? j * (n - 1) / (s - 1) : 0;
    keys[u] = j < s ? load_key<W>(x + i * W) : k0;
  }
  u64 acc = 0;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc |= keys[u] ^ k0;
  acc = block_or(acc);
  if (threadIdx.x == 0) {
    words[0] = acc;
    words[1] = passes(acc) == W ? acc : 0;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    key_bits_kernel(const unsigned char* __restrict__ x, long long n,
                    u64* words) {
  if (passes(words[0]) == W) return;
  const u64 k0 = load_key<W>(x);
  const uintptr_t start = (uintptr_t)x, stop = start + (uintptr_t)(n * W);
  uintptr_t head_end = (start + 15) & ~(uintptr_t)15;
  uintptr_t tail_start = stop & ~(uintptr_t)15;
  if (head_end >= tail_start) head_end = tail_start = stop;
  u64 acc = 0;
  if (head_end < tail_start) {
    const uint4* v = reinterpret_cast<const uint4*>(head_end);
    const long long vecs = (long long)((tail_start - head_end) / 16);
    const u64 pat = repeated<W>(k0);
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    u64 lanes = 0;
    for (; i + (kUnroll - 1) * stride < vecs; i += kUnroll * stride) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(v + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        lanes |= ((((u64)r[u].y << 32) | r[u].x) ^ pat) |
                 ((((u64)r[u].w << 32) | r[u].z) ^ pat);
    }
    for (; i < vecs; i += stride) {
      const uint4 r = __ldcs(v + i);
      lanes |= ((((u64)r.y << 32) | r.x) ^ pat) |
               ((((u64)r.w << 32) | r.z) ^ pat);
    }
    acc = folded<W>(lanes);
  }
  if (blockIdx.x == 0) {  // the rows outside the vectors: fewer than 32
    const long long t = threadIdx.x;
    if (start + t * W < head_end) acc |= load_key<W>(x + t * W) ^ k0;
    if (tail_start + t * W < stop)
      acc |= load_key<W>((const unsigned char*)tail_start + t * W) ^ k0;
  }
  acc = block_or(acc);
  if (threadIdx.x == 0 && acc != 0) atomicOr(words + 1, acc);
}

// One wave of kThreads-thread blocks, no more than the stream has
// kUnroll * kThreads vectors for, at least one.  The kernel's occupancy is
// asked once a process: a sort waits for K8, so its host time counts.
template <int W>
int wave_grid(long long vecs) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, key_bits_kernel<W>,
                                                  kThreads, 0);
    return b;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks =
      (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const long long items =
      (vecs + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  if (blocks > items) blocks = items;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int W>
int launch_key_bits(const unsigned char* x, long long n, u64* words,
                    cudaStream_t s) {
  key_bits_sample_kernel<W><<<1, kSampleThreads, 0, s>>>(x, n, words);
  const int grid = wave_grid<W>(n * W / 16);
  key_bits_kernel<W><<<grid, kThreads, 0, s>>>(x, n, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The OR of keys[i] ^ keys[0] over n >= 1 keys of `width` bytes into
// words[1] (two 8-byte words; words[0] gets the sample's OR), and, unless
// host_word is null, words[1] copied into host_word (8 bytes of pinned
// memory) after them on the same stream.
int srs_key_bits(const void* keys, int width, long long n, void* words,
                 void* host_word, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const unsigned char* x = (const unsigned char*)keys;
  u64* w = (u64*)words;
  const cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (width) {
    case 1: err = launch_key_bits<1>(x, n, w, s); break;
    case 2: err = launch_key_bits<2>(x, n, w, s); break;
    case 4: err = launch_key_bits<4>(x, n, w, s); break;
    case 8: err = launch_key_bits<8>(x, n, w, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || host_word == nullptr) return err;
  return (int)cudaMemcpyAsync(host_word, w + 1, sizeof(u64),
                              cudaMemcpyDeviceToHost, s);
}

}  // extern "C"
