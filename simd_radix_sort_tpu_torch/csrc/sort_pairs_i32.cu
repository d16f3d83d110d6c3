// cub's pair sort for int32_t keys: every value width, both directions
// (sort_pairs.cuh).

#define SRS_SORT_PAIRS_DEFINE
#include "sort_pairs.cuh"

namespace srs {
SRS_SORT_PAIRS_DIRECTION(int32_t, false)
SRS_SORT_PAIRS_DIRECTION(int32_t, true)
}  // namespace srs
