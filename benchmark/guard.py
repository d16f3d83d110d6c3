"""The import guard: no JAX and no JAX package in a run's process.

The port's top-level name begins with the JAX package's, so names are
compared whole, the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "simd_radix_sort_tpu")


def top_level(name: str) -> str:
    return name.partition(".")[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))
