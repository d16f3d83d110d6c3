"""Distributed tier on torch.distributed: the distributed sort and query
operators, one process per rank, and the hierarchical (multi-host) layer
over them (simd_radix_sort_tpu/parallel/)."""

from . import dist_ops, dist_sort, multihost  # noqa: F401
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
from .multihost import (  # noqa: F401
    hierarchical_group_aggregate,
    hierarchical_sort,
    make_hierarchical_groups,
    make_hierarchical_mesh,
)

# the JAX package's parallel exports that have no counterpart yet
NOT_YET_PORTED = ()

__all__ = [
    "dist_ops",
    "dist_sort",
    "multihost",
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
    "hierarchical_group_aggregate",
    "hierarchical_sort",
    "make_group",
    "make_hierarchical_groups",
    "make_hierarchical_mesh",
]
