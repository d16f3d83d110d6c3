"""Distributed tier on torch.distributed: the distributed sort and query
operators, one process per rank (simd_radix_sort_tpu/parallel/ minus its
hierarchical multi-host layer, which is not ported yet)."""

from . import dist_ops, dist_sort  # noqa: F401
from .dist_ops import (  # noqa: F401
    distributed_filter,
    distributed_group_aggregate,
    distributed_join,
    distributed_top_k,
    distributed_unique,
    gather_filtered,
    gather_joined,
)
from .dist_sort import (  # noqa: F401
    distributed_sort,
    distributed_sort_multi,
    gather_result,
    gather_result_multi,
    make_group,
)

# the JAX package's parallel/multihost.py exports, still to be ported
NOT_YET_PORTED = ("hierarchical_group_aggregate", "hierarchical_sort",
                  "make_hierarchical_mesh")

__all__ = [
    "dist_ops",
    "dist_sort",
    "distributed_filter",
    "distributed_group_aggregate",
    "distributed_join",
    "distributed_sort",
    "distributed_sort_multi",
    "distributed_top_k",
    "distributed_unique",
    "gather_filtered",
    "gather_joined",
    "gather_result",
    "gather_result_multi",
    "make_group",
]
