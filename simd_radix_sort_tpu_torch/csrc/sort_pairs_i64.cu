// cub's pair sort for int64_t keys: every value width, both directions
// (sort_pairs.cuh).

#define SRS_SORT_PAIRS_DEFINE
#include "sort_pairs.cuh"

namespace srs {
SRS_SORT_PAIRS_DIRECTION(int64_t, false)
SRS_SORT_PAIRS_DIRECTION(int64_t, true)
}  // namespace srs
