// cub's pair sort for uint8_t keys: every value width, both directions
// (sort_pairs.cuh).

#define SRS_SORT_PAIRS_DEFINE
#include "sort_pairs.cuh"

namespace srs {
SRS_SORT_PAIRS_DIRECTION(uint8_t, false)
SRS_SORT_PAIRS_DIRECTION(uint8_t, true)
}  // namespace srs
