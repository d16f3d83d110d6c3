// Stable two-way partition for NVIDIA Hopper (sm_90a), K5: the CUDA C++ port
// of the Pallas kernel in simd_radix_sort_tpu/ops/pallas_partition.py
// (_partition_kernel, called by partition_pass).
//
// Plain C entry points, built with nvcc into the shared library of
// simd_radix_sort_tpu_torch/ops/_build.py and bound with ctypes.  The Python
// wrapper, with the plain PyTorch version beside it, is
// simd_radix_sort_tpu_torch/ops/cuda_partition.py.  Every entry launches on
// the caller's stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// What it computes: every stream's rows with mask == 0 first, then the rows
// with mask != 0, each side in input order (the reference's compress-store
// partition pass).  The TPU kernel ranks rows inside a block with a
// triangular-count matmul, permutes them with a one-hot matmul, and leaves
// joining the blocks' runs to a gather over searchsorted offsets, because
// the TPU has no scatter and no unaligned store.  Hopper has both, so the
// design here is a plain scan-and-scatter in two launches (blocks run in no
// order, so the per-tile offsets need a pass of their own):
//
//   1. partition_count_kernel: one block per tile of `tile_rows` rows counts
//      the tile's mask == 0 rows (16-byte mask loads, __vcmpne4 + __popc).
//   2. The wrapper turns the counts into int64 exclusive offsets with one
//      torch.cumsum: left_off[t], and left_off[tiles] = all left rows.
//   3. partition_scatter_kernel: the tile ranks its rows again with
//      __ballot_sync / __popc per warp and a shared-memory scan over the
//      (row step, warp) counts, then writes each row of every stream to
//      left_off[t] + rank0 or total_left + right_off[t] + rank1, where
//      right_off[t] = t * tile_rows - left_off[t] (earlier tiles are full).
//
// Bound: bytes.  The function must read the mask (1 B/row) and every stream
// once and write every stream once; the count launch reads the mask a second
// time.  Rows are striped over the threads (row = j * 256 + thread), so the
// stream reads are coalesced and the rows of one side that a warp writes land
// in consecutive addresses.  The ragged last tile is masked in the kernels;
// no padding rows exist.  Offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerThread = 16;  // tile_rows <= 4096
constexpr int kMaxStreams = 8;

// The streams one scatter launch moves, passed by value as a kernel
// parameter: widths are 4 or 8 bytes.
struct Streams {
  const void* in[kMaxStreams];
  void* out[kMaxStreams];
  int width[kMaxStreams];
  int count;
};

__global__ void partition_count_kernel(const uint8_t* __restrict__ mask,
                                       long long n, int tile_rows,
                                       int* __restrict__ left_counts) {
  __shared__ int warp_right[kWarps];
  const long long base = (long long)blockIdx.x * tile_rows;
  const long long rows = min((long long)tile_rows, n - base);
  const uint8_t* m = mask + base;
  int right = 0;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(m) & 15) == 0) {
    const long long nvec = rows / 16;
    const uint4* mv = reinterpret_cast<const uint4*>(m);
    for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 w = mv[v];
      right += (__popc(__vcmpne4(w.x, 0)) + __popc(__vcmpne4(w.y, 0)) +
                __popc(__vcmpne4(w.z, 0)) + __popc(__vcmpne4(w.w, 0))) >> 3;
    }
    head = nvec * 16;
  }
  for (long long i = head + threadIdx.x; i < rows; i += blockDim.x)
    right += m[i] != 0;
  right = __reduce_add_sync(0xffffffffu, right);
  if ((threadIdx.x & 31) == 0) warp_right[threadIdx.x >> 5] = right;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_right[w];
    left_counts[blockIdx.x] = (int)rows - total;
  }
}

__global__ void partition_scatter_kernel(
    const uint8_t* __restrict__ mask, long long n, int rows_per_thread,
    const long long* __restrict__ left_off, int tiles, Streams s) {
  // left rows of each (row step j, warp) group, then their exclusive scan in
  // row order: index j * kWarps + warp
  __shared__ int group_left[kMaxRowsPerThread * kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * rows_per_thread * kThreads;

  unsigned left_bits[kMaxRowsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxRowsPerThread; ++j) {
    left_bits[j] = 0;
    if (j < rows_per_thread) {
      const long long row = base + (long long)j * kThreads + threadIdx.x;
      left_bits[j] = __ballot_sync(0xffffffffu, row < n && mask[row] == 0);
      if (lane == 0) group_left[j * kWarps + warp] = __popc(left_bits[j]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // at most 128 groups: four consecutive ones per lane
    const int groups = rows_per_thread * kWarps;
    int v[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = lane * 4 + q;
      v[q] = g < groups ? group_left[g] : 0;
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = lane * 4 + q;
      if (g < groups) group_left[g] = run;
      run += v[q];
    }
  }
  __syncthreads();

  const long long left0 = left_off[blockIdx.x];
  const long long right0 = left_off[tiles] + base - left0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kMaxRowsPerThread; ++j) {
    if (j >= rows_per_thread) break;
    const int r = j * kThreads + threadIdx.x;  // the row's place in the tile
    const long long row = base + r;
    if (row >= n) break;
    // left rows before this one in the tile; every row before it is valid
    const int before = group_left[j * kWarps + warp] +
                       __popc(left_bits[j] & below);
    const long long dest = ((left_bits[j] >> lane) & 1u)
                               ? left0 + before
                               : right0 + (r - before);
#pragma unroll
    for (int q = 0; q < kMaxStreams; ++q) {
      if (q >= s.count) break;
      if (s.width[q] == 8)
        static_cast<uint64_t*>(s.out[q])[dest] =
            static_cast<const uint64_t*>(s.in[q])[row];
      else
        static_cast<uint32_t*>(s.out[q])[dest] =
            static_cast<const uint32_t*>(s.in[q])[row];
    }
  }
}

bool valid_tile(int tile_rows) {
  return tile_rows >= kThreads && tile_rows <= kThreads * kMaxRowsPerThread &&
         tile_rows % kThreads == 0;
}

}  // namespace

extern "C" {

int srs_partition_count(const void* mask, long long n, int tile_rows,
                        void* left_counts, void* stream) {
  if (!valid_tile(tile_rows) || n < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  partition_count_kernel<<<(unsigned)tiles, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, tile_rows, (int*)left_counts);
  return (int)cudaGetLastError();
}

// `left_off` holds tiles + 1 int64 exclusive offsets of the count launch's
// left counts (left_off[tiles] = all left rows); `ins`, `outs` and `widths`
// are host arrays of `nstreams` entries.
int srs_partition_scatter(const void* mask, long long n, int tile_rows,
                          const void* left_off, int nstreams,
                          void* const* ins, void* const* outs,
                          const int* widths, void* stream) {
  if (!valid_tile(tile_rows) || n < 1 || nstreams < 1 ||
      nstreams > kMaxStreams)
    return (int)cudaErrorInvalidValue;
  Streams s{};
  s.count = nstreams;
  for (int q = 0; q < nstreams; ++q) {
    if (widths[q] != 4 && widths[q] != 8) return (int)cudaErrorInvalidValue;
    s.in[q] = ins[q];
    s.out[q] = outs[q];
    s.width[q] = widths[q];
  }
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  partition_scatter_kernel<<<(unsigned)tiles, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, tile_rows / kThreads,
      (const long long*)left_off, (int)tiles, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
