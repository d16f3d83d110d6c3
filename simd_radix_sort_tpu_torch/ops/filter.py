"""Filter: predicate mask + stable compaction.

Counterpart of simd_radix_sort_tpu/ops/filter.py.  The reference builds this
on its masked compress-store; the JAX package stands in for that with one
stable sort on the inverted mask.  The port has the compress-store itself:
every compaction here is one K5 pass (ops/cuda_partition.partition_pass,
csrc/partition_kernels.cu), a stable two-way partition that moves every
stream in lock-step: K5's count launch, then one scatter launch for every
8 streams.  K5 puts mask=False rows first, so it is given `~mask`.

Results keep the padded static-shape form of the JAX package: full-length
streams with the selected rows packed stably at the front, plus a count.
"""

from __future__ import annotations

import torch

from ..utils import common, profiling
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
    for the unsigned dtypes torch stores but cannot compare).  While a
    profiler records, counts the scalar's copy to the device as a host
    sync, and the n + 2*n*w bytes the `where` reads and writes for n
    values of w bytes in `compaction.fill_bytes`."""
    v = common.as_signed(torch.full((), value, dtype=s.dtype))
    if profiling.recording():
        profiling.count("host_syncs.filter.fill")
        profiling.count("compaction.fill_bytes",
                        s.numel() * (1 + 2 * s.element_size()))
    return torch.where(keep, common.as_signed(s),
                       v.to(s.device)).view(s.dtype)


def _resize(s: torch.Tensor, length: int) -> torch.Tensor:
    """The first `length` rows of `s`, zero-padded when it is shorter."""
    if s.shape[0] >= length:
        return s[:length]
    z = common.as_signed(s).new_zeros(length - s.shape[0])
    return torch.cat([common.as_signed(s), z]).view(s.dtype)


def _check_mask(mask: torch.Tensor) -> None:
    if mask.ndim != 1:
        raise ValueError("mask must be 1-D")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be boolean, got {mask.dtype}")


def compact(mask: torch.Tensor, *streams, fill=None):
    """Stably pack rows where mask is True to the front of every stream.

    Returns (count, packed_streams...), count a 0-d int32 tensor.  Rows past
    `count` hold the non-selected rows (stably) unless `fill` is given, in
    which case they are overwritten with that scalar.  The fill's mask of
    the first `count` rows is counted in `compaction.fill_bytes` while a
    profiler records: 8n bytes written by the int64 row numbers, 8n read
    and n written by the compare.

    While a profiler records, the bytes the caller needs are counted in the
    device counter `compact.needed_bytes`: the mask read once (n bytes,
    on the host) and each kept row read once and written once in every
    stream at that stream's own width, 2 * count * sum(w), from `count`
    on the card (capped at `max_out` in `compact_bounded`).  It is
    `benchmark/work/filter_rows.py`'s rule, for every compaction."""
    _check_mask(mask)
    return _compact(mask, streams, fill, None)


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
    `max_out`, inside the same `srs.compact` span; `block` is accepted for
    the JAX signature and ignored."""
    _check_mask(mask)
    return _compact(mask, streams, 0, max_out)


def _compact(mask, streams, fill, max_out):
    """The body of `compact` and `compact_bounded`: all of a compaction's
    work inside one `srs.compact` span, the cut and pad to `max_out` (when
    not None) included."""
    with profiling.span("srs.compact"):
        n = mask.shape[0]
        packed = partition_streams(~mask, streams)
        count = mask.sum(dtype=torch.int32)
        if profiling.recording():
            profiling.count_on_device("compact.needed_bytes", n)
            profiling.count_on_device(
                "compact.needed_bytes", count,
                2 * sum(s.element_size() for s in streams), cap=max_out)
        if fill is not None:
            with profiling.span("srs.fill"):
                profiling.count("compaction.fill_bytes", 17 * n)
                sel = torch.arange(n, device=mask.device) < count
                packed = tuple(_fill(s, sel, fill) for s in packed)
        if max_out is not None:
            packed = tuple(_resize(s, max_out) for s in packed)
    return (count,) + packed


def filter_rows(predicate, keys: torch.Tensor, *payloads):
    """Filter a table by a row predicate over its keys.

    `predicate` is a callable keys -> bool mask (or an existing mask).
    Returns (count, keys_packed, payloads_packed...)."""
    mask = predicate(keys) if callable(predicate) else predicate
    return compact(mask, keys, *payloads)
