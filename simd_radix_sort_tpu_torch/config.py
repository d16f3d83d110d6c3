"""Typed configuration for the sort engine.

Counterpart of simd_radix_sort_tpu/config.py: a `SortConfig` supplies
defaults for every runtime knob of `ops.sort.sort(..., config=...)`, with
explicit keyword arguments taking precedence.
"""

from __future__ import annotations

import dataclasses

# Base-case block size of the quick engine (and the quickseq model's
# threshold); None keeps each engine's own default.
DEFAULT_BLOCK_THRESHOLD = None

# LSD digit width of the radix engine; None keeps the per-key-width
# default (ops/radix.py).
DEFAULT_DIGIT_BITS = None


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Runtime sort policy; every field maps to a `sort()` keyword.

    ascending        — the reference's `Up` template parameter.
    method           — key into methods.REGISTRY ("auto" = static policy).
    stable           — the reference sort is NOT stable; True requests the
                       strictly stronger ordering.
    block_threshold  — cmpSortThreshold analogue for the quick engine.
    digit_bits       — LSD digit width for the radix engine.
    """

    ascending: bool = True
    method: str = "auto"
    stable: bool = False
    block_threshold: int | None = DEFAULT_BLOCK_THRESHOLD
    digit_bits: int | None = DEFAULT_DIGIT_BITS
