"""Filter: predicate mask + stable compaction.

Counterpart of simd_radix_sort_tpu/ops/filter.py.  The reference builds this
on its masked compress-store; the JAX package stands in for that with one
stable sort on the inverted mask.  The port has the compress-store itself:
every compaction here is one K5 launch (ops/cuda_partition.partition_pass,
csrc/partition_kernels.cu), a stable two-way partition that moves every
stream in lock-step.  K5 puts mask=False rows first, so it is given `~mask`.

Results keep the padded static-shape form of the JAX package: full-length
streams with the selected rows packed stably at the front, plus a count.
"""

from __future__ import annotations

import torch

from ..utils import common
from . import cuda_partition


def partition_streams(mask: torch.Tensor, streams) -> tuple:
    """Stable two-way partition (K5) of streams of any dtype: mask=False
    rows first, then mask=True rows, each side in input order.  1- and
    2-byte streams travel widened to 4-byte words.  One K5 call for all
    the streams, however many there are."""
    if not streams:
        return ()
    words, metas = zip(*(cuda_partition.to_words(s) for s in streams))
    out = cuda_partition.partition_pass([w for (w,) in words],
                                        mask.contiguous())
    return tuple(cuda_partition.from_words([o], m) for o, m in zip(out, metas))


def _fill(s: torch.Tensor, keep: torch.Tensor, value) -> torch.Tensor:
    """`s` where `keep`, else `value` cast to s's dtype (bits kept; works
    for the unsigned dtypes torch stores but cannot compare)."""
    v = common.as_signed(torch.full((), value, dtype=s.dtype))
    return torch.where(keep, common.as_signed(s),
                       v.to(s.device)).view(s.dtype)


def _resize(s: torch.Tensor, length: int) -> torch.Tensor:
    """The first `length` rows of `s`, zero-padded when it is shorter."""
    if s.shape[0] >= length:
        return s[:length]
    z = common.as_signed(s).new_zeros(length - s.shape[0])
    return torch.cat([common.as_signed(s), z]).view(s.dtype)


def compact(mask: torch.Tensor, *streams, fill=None):
    """Stably pack rows where mask is True to the front of every stream.

    Returns (count, packed_streams...), count a 0-d int32 tensor.  Rows past
    `count` hold the non-selected rows (stably) unless `fill` is given, in
    which case they are overwritten with that scalar."""
    if mask.ndim != 1:
        raise ValueError("mask must be 1-D")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be boolean, got {mask.dtype}")
    n = mask.shape[0]
    packed = partition_streams(~mask, streams)
    count = mask.sum(dtype=torch.int32)
    if fill is not None:
        sel = torch.arange(n, device=mask.device) < count
        packed = tuple(_fill(s, sel, fill) for s in packed)
    return (count,) + packed


def compact_bounded(mask: torch.Tensor, *streams, max_out: int,
                    block: int = 8192):
    """Stably pack rows where mask is True to the front, when the caller can
    bound the number of selected rows by `max_out` (e.g. a group-aggregate
    whose key domain is known, ops/hashagg.py `max_groups`).

    Returns (count, packed_streams...) with streams of length `max_out`
    (not n): rows past `count` are zero-filled.  `count` is the true number
    of selected rows; if count > max_out the first max_out selected rows
    are still returned exactly (truncation, never corruption) and the
    caller must treat the overflow per its own protocol.

    The JAX package sorts `block`-row blocks apart because a block fits the
    TPU's VMEM.  Here one K5 pass is already a single read and write of
    every stream, so this is `compact(..., fill=0)` cut or padded to
    `max_out`; `block` is accepted for the JAX signature and ignored."""
    if mask.ndim != 1:
        raise ValueError("mask must be 1-D")
    out = compact(mask, *streams, fill=0)
    return (out[0],) + tuple(_resize(s, max_out) for s in out[1:])


def filter_rows(predicate, keys: torch.Tensor, *payloads):
    """Filter a table by a row predicate over its keys.

    `predicate` is a callable keys -> bool mask (or an existing mask).
    Returns (count, keys_packed, payloads_packed...)."""
    mask = predicate(keys) if callable(predicate) else predicate
    return compact(mask, keys, *payloads)
