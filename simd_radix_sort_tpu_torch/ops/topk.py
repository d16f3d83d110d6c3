"""Top-k and unique: sort-adjacent query operators.

Counterpart of simd_radix_sort_tpu/ops/topk.py.

  * `top_k` — k extreme rows with payloads in lock-step, ties broken by
    input position as the JAX package breaks them.  `torch.topk` leaves
    the order among ties undefined, so it is given distinct values: for
    keys of at most 32 bits the int64 composite (carrier << 32) | position;
    for 64-bit keys, which leave no room for the position, the k-th best
    carrier from `torch.topk` is a threshold, and the rows at or past it
    are stably sorted by carrier (the JAX package's two-level blocked
    selection on (hi, lo, pos) serves the TPU's 32-bit lanes).
  * `unique` — distinct keys of a table: stable sort, neighbour diff, one
    stable compaction (K5, ops/filter.py), returning (count, keys_padded,
    first_payload_rows..., per_key_multiplicity).
"""

from __future__ import annotations

import torch

from ..utils import transforms
from . import filter as filter_op
from . import xla_sort


def _top_k_idx(c: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest (carrier, position) rows, best first."""
    n = c.shape[0]
    if c.element_size() <= 4:
        pos = torch.arange(n, dtype=torch.int64, device=c.device)
        comp = (c.to(torch.int64) << 32) | pos
        return torch.topk(comp, k, largest=False, sorted=True).indices
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=c.device)
    thr = torch.topk(c, k, largest=False, sorted=True).values[-1]
    cand = torch.nonzero(c <= thr).squeeze(1)  # in position order
    order = torch.argsort(c.index_select(0, cand), stable=True)[:k]
    return cand.index_select(0, order)


def top_k(keys: torch.Tensor, *payloads, k: int, largest: bool = True):
    """k largest (or smallest) keys with lock-step payload rows.

    Returns (keys_k, payloads_k...).  Rows are ordered best-first; ties
    are broken by input position."""
    if k > keys.shape[0]:
        raise ValueError(f"k={k} exceeds row count {keys.shape[0]}")
    # the carrier is ascending for the requested order, so the k best rows
    # are its k smallest
    (c,) = transforms.key_operands(keys, ascending=not largest)
    idx = _top_k_idx(c, k)
    return (xla_sort.gather(keys, idx),) + tuple(
        xla_sort.gather(p, idx) for p in payloads)


def unique(keys: torch.Tensor, *payloads):
    """Distinct keys (sorted ascending) with each key's first payload row
    and multiplicity.

    Returns (count, keys_u, payloads_u..., counts_per_key): padded tensors
    with the `count` valid rows packed at the front (ops/filter's layout);
    count is a 0-d int32 tensor, counts_per_key int32."""
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        zero = torch.zeros(0, dtype=torch.int32, device=dev)
        return (torch.zeros((), dtype=torch.int32, device=dev), keys) + \
            tuple(payloads) + (zero,)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    ko, (pos,) = xla_sort.sort_arrays(keys, (idx,), ascending=True,
                                      stable=True)
    (c,) = transforms.key_operands(ko, True)
    # first-of-run mask: row 0, or a carrier that differs from the row before
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = c[1:] != c[:-1]
    sorted_pays = tuple(xla_sort.gather(p, pos) for p in payloads)
    count, ku, start_idx, *pu = filter_op.compact(first, ko, idx,
                                                  *sorted_pays)
    # multiplicity = next run's start - this run's start
    nxt = torch.cat([start_idx[1:], start_idx.new_full((1,), n)])
    nxt = torch.where(idx < count - 1, nxt, n)
    mult = torch.where(idx < count, nxt - start_idx, 0)
    return (count, ku) + tuple(pu) + (mult.to(torch.int32),)
