// cub's radix sort of (key, value) pairs: the library sort under
// simd_radix_sort_tpu_torch/ops/xla_sort.py for a call with exactly one
// payload stream.
//
// A library call, not a hand-written kernel, and it replaces no TPU kernel.
// The JAX package hands the payload to jax.lax.sort as a non-key operand
// (simd_radix_sort_tpu/ops/xla_sort.py, sort_arrays), the counterpart of the
// reference's separate key and payload datastreams.  torch.sort takes one
// tensor, so through it a payload needs an int64 index sorted as the values
// and a gather by it.  cub, the library torch.sort runs, sorts a key stream
// and one value stream together; this calls it as it is.
//
// Keys go to cub in their own integer type, 1 to 8 bytes, signed or unsigned
// (cub orders signed keys itself), in either direction (SortPairsDescending),
// so unsigned keys need no carrier XOR and a descending sort no NOT.
// Floating keys come as the port's signed carrier (utils/transforms.py
// to_sortable), never through cub's float path, which sorts -0.0 and +0.0 as
// one key where the port's IEEE totalOrder does not.  Values are bit copies,
// by width only.  cub's radix sort is stable in both directions: equal keys
// keep their input order.
//
// Bound: bytes.  cub's onesweep passes read and write every key and value
// once a pass of 8 key bits, (k + v) bytes a row each way for k-byte keys
// and v-byte values.
//
// Each (key type, value width, direction) is one dispatch of cub's, a few
// kernels nvcc compiles for it.  The sources sort_pairs_<key>.cu instantiate
// `sort_pairs` for their key types, one nvcc process each, started together
// by ops/_build.py; sort_pairs.cu holds the C entries.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifdef SRS_SORT_PAIRS_DEFINE
#include <cub/device/device_radix_sort.cuh>
#endif

namespace srs {

// Sorts n (key, value) pairs, K keys and V values (an unsigned type of the
// payload's width), ascending or descending, on `stream`.  With temp ==
// nullptr it writes the temp storage cub needs to *temp_bytes and launches
// nothing; else *temp_bytes is the size of `temp`.  The inputs are left as
// they are.
template <typename K, typename V, bool Descending>
cudaError_t sort_pairs(void* temp, size_t* temp_bytes, const void* keys_in,
                       void* keys_out, const void* values_in,
                       void* values_out, int n, cudaStream_t stream);

#ifdef SRS_SORT_PAIRS_DEFINE

template <typename K, typename V, bool Descending>
cudaError_t sort_pairs(void* temp, size_t* temp_bytes, const void* keys_in,
                       void* keys_out, const void* values_in,
                       void* values_out, int n, cudaStream_t stream) {
  const K* ki = static_cast<const K*>(keys_in);
  K* ko = static_cast<K*>(keys_out);
  const V* vi = static_cast<const V*>(values_in);
  V* vo = static_cast<V*>(values_out);
  const int end_bit = 8 * (int)sizeof(K);
  cudaError_t err;
  if constexpr (Descending)
    err = cub::DeviceRadixSort::SortPairsDescending(
        temp, *temp_bytes, ki, ko, vi, vo, n, 0, end_bit, stream);
  else
    err = cub::DeviceRadixSort::SortPairs(temp, *temp_bytes, ki, ko, vi, vo,
                                          n, 0, end_bit, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A source's instantiations of one key type, inside namespace srs: every
// value width in one direction.
#define SRS_SORT_PAIRS_ONE(K, V, D)                                        \
  template cudaError_t sort_pairs<K, V, D>(void*, size_t*, const void*,   \
                                           void*, const void*, void*, int, \
                                           cudaStream_t);
#define SRS_SORT_PAIRS_DIRECTION(K, D)  \
  SRS_SORT_PAIRS_ONE(K, uint8_t, D)     \
  SRS_SORT_PAIRS_ONE(K, uint16_t, D)    \
  SRS_SORT_PAIRS_ONE(K, uint32_t, D)    \
  SRS_SORT_PAIRS_ONE(K, uint64_t, D)

#endif  // SRS_SORT_PAIRS_DEFINE

}  // namespace srs
