"""The comparison-sort engine (registry name "xla").

Counterpart of simd_radix_sort_tpu/ops/xla_sort.py, whose engine is XLA's
variadic comparison sort.  The module and registry names are kept because
users pass `method="xla"`.  A call with exactly one payload stream (and at
most cuda_sort.MAX_ITEMS rows) sorts the keys and the payload together with
cub's pair sort (ops/cuda_sort.py), as the JAX package hands the payload to
`jax.lax.sort`: integer keys as they are, floating keys as their signed
carrier.  Every other call sends the keys through the order-preserving
transform to a signed carrier (utils/transforms.py), `torch.sort` orders
the carrier, and each payload stream follows with one `index_select` on
its signed view (torch has no gather for uint16/32/64).
"""

from __future__ import annotations

import torch

from ..utils import common, profiling, transforms
from . import cuda_sort


def gather(p: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """p[idx] along `dim` for any payload dtype, bits preserved."""
    s = common.as_signed(p)
    if idx.dim() == 1:
        return s.index_select(dim, idx).view(p.dtype)
    return s.gather(dim, idx).view(p.dtype)


def _sort_pairs(keys: torch.Tensor, payload: torch.Tensor, ascending: bool):
    """`keys` and one payload through cub's pair sort, which is stable."""
    keys, payload = keys.contiguous(), payload.contiguous()
    descending = not ascending
    if not keys.dtype.is_floating_point:
        return cuda_sort.sort_pairs(keys, payload, descending)
    c, pay = cuda_sort.sort_pairs(transforms.to_sortable(keys, True), payload,
                                  descending)
    return transforms.from_sortable(c, keys.dtype, True), pay


def sort_arrays(keys: torch.Tensor, payloads, ascending: bool = True,
                stable: bool = False):
    """Sort `keys` (1-D) and reorder each payload stream in lock-step.
    Returns (sorted_keys, tuple_of_sorted_payloads).  With one payload
    stream the sort is stable, which `stable=False` permits."""
    if len(payloads) == 1 and keys.shape[0] <= cuda_sort.MAX_ITEMS:
        with profiling.span("srs.xla.pairs"):
            profiling.count("xla.pairs_calls")
            keys_out, pay = _sort_pairs(keys, payloads[0], ascending)
        return keys_out, (pay,)
    c = transforms.to_sortable(keys, ascending)
    if payloads:
        with profiling.span("srs.xla.sort"):
            vals, idx = torch.sort(c, stable=stable)
        with profiling.span("srs.xla.gather"):
            pays = tuple(gather(p, idx) for p in payloads)
    else:
        with profiling.span("srs.xla.sort"):
            vals, pays = torch.sort(c, stable=stable).values, ()
    return transforms.from_sortable(vals, keys.dtype, ascending), pays


def argsort_keys(keys: torch.Tensor, ascending: bool = True,
                 stable: bool = True) -> torch.Tensor:
    """The permutation that sorts `keys` (stable by default), as int32."""
    c = transforms.to_sortable(keys, ascending)
    return torch.argsort(c, stable=stable).to(torch.int32)
