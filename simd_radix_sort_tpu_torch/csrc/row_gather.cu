// Rows gathered by an index, for NVIDIA Hopper (sm_90a), K9: out[i, :] =
// src[idx[i], :] for n rows of `row_bytes` bytes, the assembly of
// sort_packed's output from the rows and the sorted row index.
//
// Replaces no Pallas kernel: the JAX package leaves the combined layout's
// assembly to XLA, a gather of the payload bytes by the sorted index and a
// concatenation of byte columns (simd_radix_sort_tpu/ops/sort.py:165-260).
// A row's key is its own leading bytes, so after a pair sort of (key, row
// index) the sorted output is the whole rows in the index's order, and one
// pass writes it: no intermediate of the payload bytes, no concatenation.
//
// Plain C entry point, built with nvcc into the shared library of
// simd_radix_sort_tpu_torch/ops/_build.py and bound with ctypes.  The Python
// wrapper, with the plain PyTorch version beside it, is
// simd_radix_sort_tpu_torch/ops/cuda_rows.py (`row_gather`,
// `row_gather_plain`).  The entry launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.  It trusts the
// index: every idx[i] must be a row of src.
//
// Bound: bytes.  The index is read once (8n), each source row it names once
// and each output row written once (2 n row_bytes): 136n bytes at 64-byte
// rows.  The writes are sequential; the reads are random rows, each one
// whole run of row_bytes bytes (at 64 bytes, half of a 128-byte L2 line), so
// the pass is bound by how many bytes the card keeps in flight against the
// memory's latency.  The design:
//
//   - each thread moves one vector of W bytes of a row (W = 16 at 64-byte
//     rows: 4 lanes a row, 8 rows a warp), the wrapper choosing the widest W
//     of 16, 8, 4, 2, 1 that divides the row and both base addresses, so a
//     row is a whole number of aligned vectors;
//   - the lanes of a row read one index; the rows of a warp read neighbouring
//     index entries and write neighbouring output rows (coalesced);
//   - each thread takes kRows rows a pass and issues every load before any
//     store, so a full card keeps kRows * W bytes a thread in flight (17 MB
//     over 132 SMs at W = 16, several times what 3.35 TB/s at HBM latency
//     needs);
//   - source loads are read-only (`__ldg`), output stores streaming
//     (`__stcs`): neither is kept for reuse;
//   - every offset is 64-bit: 10^8 rows of 64 bytes are 6.4e9 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread has in flight

template <int W> struct Vec;
template <> struct Vec<16> { typedef uint4 T; };
template <> struct Vec<8> { typedef uint2 T; };
template <> struct Vec<4> { typedef unsigned int T; };
template <> struct Vec<2> { typedef unsigned short T; };
template <> struct Vec<1> { typedef unsigned char T; };

// A block's threads form teams of `team` threads, one row a team: team =
// lanes where a row has at most kThreads lanes (each thread one lane), else
// kThreads (each thread every kThreads-th lane).  A pass of the block moves
// kRows * teams rows: row base + u * teams + slot for u < kRows.
template <int W>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const unsigned char* __restrict__ src,
                      unsigned char* __restrict__ dst,
                      const long long* __restrict__ idx, long long n,
                      int lanes, int team) {
  typedef typename Vec<W>::T V;
  const int teams = kThreads / team;
  const int slot = threadIdx.x / team;
  const int first_lane = threadIdx.x - slot * team;
  if (slot >= teams) return;
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long chunk = (long long)kRows * teams;
  for (long long base = (long long)blockIdx.x * chunk; base < n;
       base += (long long)gridDim.x * chunk) {
    long long from[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = base + (long long)u * teams + slot;
      from[u] = r < n ? __ldg(idx + r) : -1;
    }
    for (int lane = first_lane; lane < lanes; lane += team) {
      V v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)  // every load in flight at once
        if (from[u] >= 0) v[u] = __ldg(s + from[u] * lanes + lane);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long r = base + (long long)u * teams + slot;
        if (r < n) __stcs(d + r * lanes + lane, v[u]);
      }
    }
  }
}

// One wave of blocks, no more than the rows have passes for, at least one.
// The kernel's occupancy is asked once a process.
template <int W>
int wave_grid(long long passes) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, row_gather_kernel<W>,
                                                  kThreads, 0);
    return b;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks =
      (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > passes) blocks = passes;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int W>
int launch_row_gather(const void* src, void* dst, const long long* idx,
                      long long n, long long row_bytes, cudaStream_t s) {
  const int lanes = (int)(row_bytes / W);
  const int team = lanes < kThreads ? lanes : kThreads;
  const long long chunk = (long long)kRows * (kThreads / team);
  row_gather_kernel<W><<<wave_grid<W>((n + chunk - 1) / chunk), kThreads, 0,
                         s>>>((const unsigned char*)src, (unsigned char*)dst,
                              idx, n, lanes, team);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i, :] = src[idx[i], :] for i < n: rows of row_bytes bytes, moved in
// vectors of `width` bytes (16, 8, 4, 2 or 1), which must divide row_bytes
// and both addresses; idx holds n int64 rows of src.
int srs_row_gather(const void* src, void* dst, const void* idx, long long n,
                   long long row_bytes, int width, void* stream) {
  if (n < 0 || row_bytes < 1 || width < 1 || row_bytes % width ||
      row_bytes / width > (1LL << 30) || (uintptr_t)src % width ||
      (uintptr_t)dst % width || (uintptr_t)idx % 8)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long* x = (const long long*)idx;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: return launch_row_gather<16>(src, dst, x, n, row_bytes, s);
    case 8: return launch_row_gather<8>(src, dst, x, n, row_bytes, s);
    case 4: return launch_row_gather<4>(src, dst, x, n, row_bytes, s);
    case 2: return launch_row_gather<2>(src, dst, x, n, row_bytes, s);
    case 1: return launch_row_gather<1>(src, dst, x, n, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
