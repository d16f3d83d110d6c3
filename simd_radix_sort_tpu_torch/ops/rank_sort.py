"""Rank sort for small blocks (registry name "rank").

Counterpart of simd_radix_sort_tpu/ops/rank_sort.py, the JAX package's
stand-in for the reference's small-array comparison sorters: an O(n^2)
rank sort that is all dense compare-and-sum work,

  rank[i] = #{ j : key[j] < key[i]  or  (key[j] == key[i] and j < i) },

computed from an (n, n) comparison matrix on the key's carrier.  Ties broken
by input index make the sort stable, so its output is byte for byte the
stable comparison sort's.  The JAX package inverts the rank permutation with
a one-hot matmul on the TPU's matrix unit; the port scatters instead.
"""

from __future__ import annotations

import torch

from ..utils import transforms
from .xla_sort import gather

# Above this the (n, n) comparison matrix stops fitting comfortably; larger
# arrays belong to the other engines.
MAX_RANK_SORT_N = 4096


def _ranks(kops) -> torch.Tensor:
    """Stable rank of every element from its key operands (one carrier
    word in the port)."""
    (a,) = kops
    n = a.shape[0]
    lt = a[None, :] < a[:, None]   # lt[i, j] = key_j < key_i
    eq = a[None, :] == a[:, None]
    idx = torch.arange(n, device=a.device)
    before = idx[None, :] < idx[:, None]  # j < i
    return (lt | (eq & before)).sum(dim=1, dtype=torch.int32)


def inverse_perm_matmul(rank: torch.Tensor) -> torch.Tensor:
    """Invert the rank permutation: src[k] = i where rank[i] == k.

    The name is the JAX package's, whose version is a one-hot matmul on the
    TPU's matrix unit (no scatter there).  Here it is one scatter of
    arange(n) to the ranks, `index_copy_`; int32 like the JAX result."""
    n = rank.shape[0]
    src = torch.empty(n, dtype=torch.int32, device=rank.device)
    return src.index_copy_(0, rank.to(torch.int64),
                           torch.arange(n, dtype=torch.int32,
                                        device=rank.device))


def sort_arrays(keys: torch.Tensor, payloads, ascending: bool = True):
    """Stable rank sort of a small array with lock-step payloads.  Returns
    (sorted_keys, tuple_of_sorted_payloads)."""
    n = keys.shape[0]
    if n > MAX_RANK_SORT_N:
        raise ValueError(f"rank sort limited to n<={MAX_RANK_SORT_N}, got {n}")
    if n == 0:
        return keys, tuple(payloads)
    src = inverse_perm_matmul(_ranks(transforms.key_operands(keys,
                                                             ascending)))
    return gather(keys, src), tuple(gather(p, src) for p in payloads)
