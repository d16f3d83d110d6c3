// The C entries of cub's pair sort (sort_pairs.cuh), bound with ctypes by
// simd_radix_sort_tpu_torch/ops/cuda_sort.py.  Each sorts on the caller's
// stream, does not synchronise, allocates nothing (the wrapper allocates the
// outputs and cub's temp storage) and returns a cudaError_t.  This source
// includes no cub: the key types' instantiations live in sort_pairs_<key>.cu.

#include "sort_pairs.cuh"

namespace {

struct Args {
  void* temp;
  size_t* temp_bytes;
  const void* keys_in;
  void* keys_out;
  const void* values_in;
  void* values_out;
  int n;
  int begin_bit;
  int end_bit;
  cudaStream_t stream;
};

template <typename K, bool D>
cudaError_t by_width(int value_width, const Args& a) {
#define SRS_SORT(V)                                                    \
  srs::sort_pairs<K, V, D>(a.temp, a.temp_bytes, a.keys_in, a.keys_out, \
                           a.values_in, a.values_out, a.n, a.begin_bit, \
                           a.end_bit, a.stream)
  switch (value_width) {
    case 1: return SRS_SORT(uint8_t);
    case 2: return SRS_SORT(uint16_t);
    case 4: return SRS_SORT(uint32_t);
    case 8: return SRS_SORT(uint64_t);
    default: return cudaErrorInvalidValue;
  }
#undef SRS_SORT
}

template <typename K>
cudaError_t by_direction(int value_width, int descending, const Args& a) {
  return descending ? by_width<K, true>(value_width, a)
                    : by_width<K, false>(value_width, a);
}

// `key`: 0 uint8, 1 int8, 2 uint16, 3 int16, 4 uint32, 5 int32, 6 uint64,
// 7 int64.
cudaError_t dispatch(int key, int value_width, int descending,
                     const Args& a) {
  switch (key) {
    case 0: return by_direction<uint8_t>(value_width, descending, a);
    case 1: return by_direction<int8_t>(value_width, descending, a);
    case 2: return by_direction<uint16_t>(value_width, descending, a);
    case 3: return by_direction<int16_t>(value_width, descending, a);
    case 4: return by_direction<uint32_t>(value_width, descending, a);
    case 5: return by_direction<int32_t>(value_width, descending, a);
    case 6: return by_direction<uint64_t>(value_width, descending, a);
    case 7: return by_direction<int64_t>(value_width, descending, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The bytes of temp storage srs_sort_pairs needs for n pairs by the key
// bits [begin_bit, end_bit), into *temp_bytes.  Launches nothing.
int srs_sort_pairs_temp_bytes(int key, int value_width, int descending,
                              int n, int begin_bit, int end_bit,
                              size_t* temp_bytes, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  *temp_bytes = 0;
  const Args a{nullptr, temp_bytes, nullptr, nullptr, nullptr, nullptr, n,
               begin_bit, end_bit, (cudaStream_t)stream};
  return (int)dispatch(key, value_width, descending, a);
}

// Sorts n (key, value) pairs by the key bits [begin_bit, end_bit) into
// keys_out and values_out, the inputs left as they are; `temp` holds at
// least the `temp_bytes` srs_sort_pairs_temp_bytes gives for the same
// arguments (cub refuses less: cudaErrorInvalidValue).
int srs_sort_pairs(int key, int value_width, int descending,
                   const void* keys_in, void* keys_out,
                   const void* values_in, void* values_out, int n,
                   int begin_bit, int end_bit, void* temp, size_t temp_bytes,
                   void* stream) {
  if (n < 0 || temp == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{temp, &temp_bytes, keys_in, keys_out, values_in, values_out,
               n, begin_bit, end_bit, (cudaStream_t)stream};
  return (int)dispatch(key, value_width, descending, a);
}

}  // extern "C"
