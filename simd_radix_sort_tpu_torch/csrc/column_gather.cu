// Output columns gathered by an index in groups, for NVIDIA Hopper (sm_90a),
// K10: the assembly of sort_multi's output.  Two entries:
//
//   - pack: a group of columns (fields of 1, 2, 4 or 8 bytes, any element
//     stride) read in order and written interleaved as staged rows of
//     row_bytes = 4, 8, 16 or 32 bytes, each field at its fixed offset, the
//     padding zero;
//   - gather: for each output row i, idx[i] read once, the source row
//     idx[i] read in one or two vectors, and each of its fields written to
//     its own output column.  The source is a pack's staged rows, or one
//     column read straight as rows of its own width (a group of one column
//     needs no staging).
//
// Replaces no Pallas kernel: the JAX package's sort_multi carries every
// column through one variadic jax.lax.sort as operands
// (simd_radix_sort_tpu/ops/sort.py:281-330), and has no gather.  torch's
// sorts take one tensor, so the port sorts the keys into a permutation and
// gathers the columns by it.  Before K10 it did so with torch's
// index_select, one random pass a column: each pass reads a random 32-byte
// sector a row whatever the column's width, and the index again.  K10
// stages the columns in groups of up to 32 bytes, so the card reads one
// random sector a row a group (4 passes for TPC-H lineitem's 16 columns,
// not 16) and the index once a group.
//
// Plain C entry points, built with nvcc into the shared library of
// simd_radix_sort_tpu_torch/ops/_build.py and bound with ctypes.  The Python
// wrapper, with the plain PyTorch versions beside it and the plan of the
// groups, is simd_radix_sort_tpu_torch/ops/cuda_columns.py (`pack`,
// `gather_split`, `gather_columns`).  The entries launch on the caller's
// stream, do not synchronise, allocate nothing and return a cudaError_t.
// The gather trusts the index: every idx[i] must be a row of the source.
//
// Bound: bytes.  A pack reads each column once and writes n row_bytes (the
// reads and writes in order); a gather reads the index (4 or 8 bytes a
// row), one source row a row at random, and writes each field once in
// order.  The random reads are the cost: a staged row of 32 bytes is one
// aligned sector, so the pass is bound by how many sectors the card keeps
// in flight against the memory's latency.  The design:
//
//   - one thread a row, kRows rows a thread in flight: the rows of a warp
//     read neighbouring index entries and neighbouring elements of each
//     column, and write neighbouring elements of each output column
//     (coalesced), while each row's random read is one or two 16-byte
//     vectors of one sector;
//   - every load of a pass is issued before any store, as K9 does
//     (csrc/row_gather.cu);
//   - a row is held as 32-bit words in registers; the fields' offsets and
//     widths are the same for every row, so a field is picked from the
//     words by selects the compiler unrolls, never by a local array;
//   - loads are read-only (`__ldg`), stores streaming (`__stcs`), and every
//     offset is 64-bit: 1.8e8 staged rows of 32 bytes are 5.8e9 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread has in flight
constexpr int kMaxFields = 32;

// A group's fields, passed by value: the columns (pack: the sources;
// gather: the outputs), each column's element stride (pack), width and
// offset in the row.
struct Fields {
  void* ptr[kMaxFields];
  long long stride[kMaxFields];
  int width[kMaxFields];
  int offset[kMaxFields];
  int count;
};

// word k of a row's words, by selects over every word
template <int NW>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[NW], int k) {
  uint32_t r = w[0];
#pragma unroll
  for (int j = 1; j < NW; ++j) r = j == k ? w[j] : r;
  return r;
}

template <int NW>
__device__ __forceinline__ void put(uint32_t (&w)[NW], int k, uint32_t v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] |= j == k ? v : 0u;
}

// a row of R bytes, aligned to min(R, 16), into its words
template <int R, int NW>
__device__ __forceinline__ void load_row(const unsigned char* p,
                                         uint32_t (&w)[NW]) {
  if constexpr (R >= 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < R / 16; ++j) {
      const uint4 v = __ldg(q + j);
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else if constexpr (R == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (R == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (R == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

template <int R, int NW>
__device__ __forceinline__ void store_row(unsigned char* p,
                                          const uint32_t (&w)[NW]) {
  if constexpr (R >= 16) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int j = 0; j < R / 16; ++j)
      __stcs(q + j, make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2],
                               w[4 * j + 3]));
  } else if constexpr (R == 8) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
  } else {
    __stcs(reinterpret_cast<unsigned int*>(p), w[0]);
  }
}

// element e of a column of `width` bytes, as its low and high words
__device__ __forceinline__ void load_field(const unsigned char* col,
                                           long long e, int width,
                                           uint32_t& lo, uint32_t& hi) {
  hi = 0;
  switch (width) {
    case 8: {
      const unsigned long long v =
          __ldg(reinterpret_cast<const unsigned long long*>(col) + e);
      lo = (uint32_t)v;
      hi = (uint32_t)(v >> 32);
      break;
    }
    case 4: lo = __ldg(reinterpret_cast<const unsigned int*>(col) + e); break;
    case 2: lo = __ldg(reinterpret_cast<const unsigned short*>(col) + e); break;
    default: lo = __ldg(col + e); break;
  }
}

// the field of `width` bytes at byte `off` of a row's words, stored as
// element r of its column
template <int NW>
__device__ __forceinline__ void store_field(unsigned char* col, long long r,
                                            int width, int off,
                                            const uint32_t (&w)[NW]) {
  const uint32_t lo = pick(w, off >> 2);
  const int shift = (off & 3) * 8;
  switch (width) {
    case 8:
      __stcs(reinterpret_cast<unsigned long long*>(col) + r,
             (unsigned long long)pick(w, (off >> 2) + 1) << 32 | lo);
      break;
    case 4: __stcs(reinterpret_cast<unsigned int*>(col) + r, lo); break;
    case 2:
      __stcs(reinterpret_cast<unsigned short*>(col) + r,
             (unsigned short)(lo >> shift));
      break;
    default: __stcs(col + r, (unsigned char)(lo >> shift)); break;
  }
}

// A pass of a block covers kRows * kThreads rows: row base + u * kThreads +
// threadIdx.x for u < kRows.
template <int R>
__global__ void __launch_bounds__(kThreads)
    column_pack_kernel(unsigned char* __restrict__ dst, long long n,
                       const Fields f) {
  constexpr int NW = R / 4;
  const long long chunk = (long long)kRows * kThreads;
  for (long long base = (long long)blockIdx.x * chunk; base < n;
       base += (long long)gridDim.x * chunk) {
    uint32_t w[kRows][NW];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int j = 0; j < NW; ++j) w[u][j] = 0;
    for (int k = 0; k < f.count; ++k) {
      const unsigned char* col = static_cast<const unsigned char*>(f.ptr[k]);
      const int width = f.width[k], off = f.offset[k];
      uint32_t lo[kRows], hi[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {  // every load in flight at once
        const long long r = base + (long long)u * kThreads + threadIdx.x;
        lo[u] = hi[u] = 0;
        if (r < n) load_field(col, r * f.stride[k], width, lo[u], hi[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        put(w[u], off >> 2, lo[u] << ((off & 3) * 8));
        if (width == 8) put(w[u], (off >> 2) + 1, hi[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = base + (long long)u * kThreads + threadIdx.x;
      if (r < n) store_row<R>(dst + r * R, w[u]);
    }
  }
}

template <int R, typename I>
__global__ void __launch_bounds__(kThreads)
    column_gather_kernel(const unsigned char* __restrict__ src,
                         long long row_stride, const I* __restrict__ idx,
                         long long n, const Fields f) {
  constexpr int NW = R < 4 ? 1 : R / 4;
  const long long chunk = (long long)kRows * kThreads;
  for (long long base = (long long)blockIdx.x * chunk; base < n;
       base += (long long)gridDim.x * chunk) {
    long long from[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = base + (long long)u * kThreads + threadIdx.x;
      from[u] = r < n ? (long long)__ldg(idx + r) : -1;
    }
    uint32_t w[kRows][NW];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {  // every row's load in flight at once
#pragma unroll
      for (int j = 0; j < NW; ++j) w[u][j] = 0;
      if (from[u] >= 0) load_row<R>(src + from[u] * row_stride, w[u]);
    }
    for (int k = 0; k < f.count; ++k) {
      unsigned char* col = static_cast<unsigned char*>(f.ptr[k]);
      const int width = f.width[k], off = f.offset[k];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long r = base + (long long)u * kThreads + threadIdx.x;
        if (r < n) store_field(col, r, width, off, w[u]);
      }
    }
  }
}

// One wave of blocks, no more than the rows have passes for, at least one.
// Each kernel's occupancy is asked once a process.
template <auto Kernel>
int wave_grid(long long n) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, Kernel, kThreads, 0);
    return b;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long chunk = (long long)kRows * kThreads;
  const long long passes = (n + chunk - 1) / chunk;
  long long blocks =
      (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > passes) blocks = passes;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int R>
int launch_pack(void* dst, long long n, const Fields& f, cudaStream_t s) {
  column_pack_kernel<R><<<wave_grid<column_pack_kernel<R>>(n), kThreads, 0,
                          s>>>((unsigned char*)dst, n, f);
  return (int)cudaGetLastError();
}

template <int R, typename I>
int launch_gather(const void* src, long long row_stride, const void* idx,
                  long long n, const Fields& f, cudaStream_t s) {
  column_gather_kernel<R, I>
      <<<wave_grid<column_gather_kernel<R, I>>(n), kThreads, 0, s>>>(
          (const unsigned char*)src, row_stride, (const I*)idx, n, f);
  return (int)cudaGetLastError();
}

template <int R>
int launch_gather_by(const void* src, long long row_stride, const void* idx,
                     int index_bytes, long long n, const Fields& f,
                     cudaStream_t s) {
  return index_bytes == 4
             ? launch_gather<R, int>(src, row_stride, idx, n, f, s)
             : launch_gather<R, long long>(src, row_stride, idx, n, f, s);
}

// The fields as the kernels take them, or false where one does not fit a
// row of row_bytes: 1 to kMaxFields fields of 1, 2, 4 or 8 bytes, each at an
// offset that is a multiple of its width, inside the row and apart from the
// others, each column aligned to its width.
bool fields_of(Fields& f, void* const* ptrs, const long long* strides,
               const int* widths, const int* offsets, int count,
               int row_bytes) {
  if (count < 1 || count > kMaxFields) return false;
  unsigned long long taken = 0;
  f.count = count;
  for (int k = 0; k < count; ++k) {
    const int w = widths[k], off = offsets[k];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || off < 0 || off % w ||
        off + w > row_bytes || (uintptr_t)ptrs[k] % w)
      return false;
    const unsigned long long bytes = ((1ULL << w) - 1) << off;
    if (taken & bytes) return false;
    taken |= bytes;
    f.ptr[k] = ptrs[k];
    f.stride[k] = strides ? strides[k] : 1;
    f.width[k] = w;
    f.offset[k] = off;
  }
  return true;
}

}  // namespace

extern "C" {

// staged[i, offsets[k] : offsets[k] + widths[k]] = cols[k][i * strides[k]]
// for i < n and each of `count` fields, the rest of each staged row zero:
// rows of row_bytes = 4, 8, 16 or 32 bytes, staged aligned to min(16,
// row_bytes).
int srs_column_pack(void* const* cols, const long long* strides,
                    const int* widths, const int* offsets, int count,
                    void* staged, int row_bytes, long long n, void* stream) {
  Fields f;
  if (n < 0 || !fields_of(f, cols, strides, widths, offsets, count,
                          row_bytes) ||
      (uintptr_t)staged % (row_bytes < 16 ? row_bytes : 16))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (row_bytes) {
    case 32: return launch_pack<32>(staged, n, f, s);
    case 16: return launch_pack<16>(staged, n, f, s);
    case 8: return launch_pack<8>(staged, n, f, s);
    case 4: return launch_pack<4>(staged, n, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// outs[k][i] = the field of widths[k] bytes at offsets[k] of source row
// idx[i], for i < n: source rows of row_bytes = 1, 2, 4, 8, 16 or 32 bytes,
// row_stride bytes apart, src and row_stride aligned to min(16, row_bytes);
// idx holds n int32 (index_bytes 4) or int64 (8) rows of the source.
int srs_column_gather(const void* src, long long row_stride, int row_bytes,
                      const void* idx, int index_bytes, long long n,
                      void* const* outs, const int* widths,
                      const int* offsets, int count, void* stream) {
  Fields f;
  const int align = row_bytes < 16 ? row_bytes : 16;
  if (n < 0 || align < 1 ||
      !fields_of(f, outs, nullptr, widths, offsets, count, row_bytes) ||
      (index_bytes != 4 && index_bytes != 8) ||
      (uintptr_t)idx % index_bytes || (uintptr_t)src % align ||
      row_stride < 0 || row_stride % align)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (row_bytes) {
    case 32: return launch_gather_by<32>(src, row_stride, idx, index_bytes,
                                         n, f, s);
    case 16: return launch_gather_by<16>(src, row_stride, idx, index_bytes,
                                         n, f, s);
    case 8: return launch_gather_by<8>(src, row_stride, idx, index_bytes, n,
                                       f, s);
    case 4: return launch_gather_by<4>(src, row_stride, idx, index_bytes, n,
                                       f, s);
    case 2: return launch_gather_by<2>(src, row_stride, idx, index_bytes, n,
                                       f, s);
    case 1: return launch_gather_by<1>(src, row_stride, idx, index_bytes, n,
                                       f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
