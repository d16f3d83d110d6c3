"""The comparison-sort engine (registry name "xla").

Counterpart of simd_radix_sort_tpu/ops/xla_sort.py, whose engine is XLA's
variadic comparison sort.  The module and registry names are kept because
users pass `method="xla"`.  Here the keys go through the order-preserving
transform to a signed carrier (utils/transforms.py), `torch.sort` orders
the carrier, and each payload stream follows with one `index_select` on
its signed view (torch has no gather for uint16/32/64).
"""

from __future__ import annotations

import torch

from ..utils import common, transforms


def gather(p: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """p[idx] along `dim` for any payload dtype, bits preserved."""
    s = common.as_signed(p)
    if idx.dim() == 1:
        return s.index_select(dim, idx).view(p.dtype)
    return s.gather(dim, idx).view(p.dtype)


def sort_arrays(keys: torch.Tensor, payloads, ascending: bool = True,
                stable: bool = False):
    """Sort `keys` (1-D) and reorder each payload stream in lock-step.
    Returns (sorted_keys, tuple_of_sorted_payloads)."""
    c = transforms.to_sortable(keys, ascending)
    if payloads:
        vals, idx = torch.sort(c, stable=stable)
        pays = tuple(gather(p, idx) for p in payloads)
    else:
        vals, pays = torch.sort(c, stable=stable).values, ()
    return transforms.from_sortable(vals, keys.dtype, ascending), pays


def argsort_keys(keys: torch.Tensor, ascending: bool = True,
                 stable: bool = True) -> torch.Tensor:
    """The permutation that sorts `keys` (stable by default), as int32."""
    c = transforms.to_sortable(keys, ascending)
    return torch.argsort(c, stable=stable).to(torch.int32)
