"""The port's sort engines, query operators and CUDA kernel wrappers.

Engines: `xla_sort` (comparison sort), `counting` (K1-K4), `radix` (LSD;
K5 for its bit-partition mover), `rank_sort`, `quick_sort`.  Operators:
`filter`, `hashagg`, `hashjoin`, `topk`; every compaction among them is
one K5 launch.  Kernel wrappers: `cuda_hist` (K1-K4, K6) and
`cuda_partition` (K5).
"""

from . import (  # noqa: F401
    counting,
    cuda_hist,
    cuda_partition,
    filter,
    hashagg,
    hashjoin,
    quick_sort,
    radix,
    rank_sort,
    sort,
    topk,
    xla_sort,
)
from .quick_sort import partition  # noqa: F401
from .topk import top_k, unique  # noqa: F401
