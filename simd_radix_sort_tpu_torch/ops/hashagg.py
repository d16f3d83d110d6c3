"""Group-by aggregate (the north star's "hash aggregate").

Counterpart of simd_radix_sort_tpu/ops/hashagg.py, and sort-based like it:
sort rows by key (the comparison engine), mark group boundaries, and reduce
each group with scans read at its last row:

  * integer sum / count: inclusive cumsum diffed at group ends, in the
    value's own dtype, so sums wrap exactly as the JAX package's do;
  * float sum, min, max: a segmented inclusive scan, so rounding stays
    inside the group (a global running total diffed at group ends cancels
    catastrophically once it dwarfs a group's sum) and NaN propagates as
    `torch.minimum`/`torch.maximum` propagate it;

then one stable compaction (ops/filter.py: one K5 launch, however many
streams) packs the group keys and every per-row scan at the group ends.

torch has no associative scan.  On the card the segmented scans are one
hand-written kernel, K7 (ops/cuda_scan.py): reduce-then-scan over tiles of
4096 rows, streams of one dtype and op in one launch, no host sync.  It is
bound by bytes and moves 3 * w + 2 / k bytes a row and stream (k streams
of w bytes), against the 2 * w + 1 / k the scan must move.  On the CPU the
scans are Hillis-Steele doubling over (start flag, value) pairs with the
JAX package's combiner, ceil(log2 n) passes.  Neither adds in
`jax.lax.associative_scan`'s order, so float sums agree with the JAX
package to rounding, not bit for bit.

Returns padded results + num_groups, the JAX package's layout.
"""

from __future__ import annotations

import torch

from ..utils import common, profiling, transforms
from . import cuda_scan
from . import filter as filter_ops
from . import xla_sort

AGGS = ("sum", "count", "min", "max", "mean")

def _mean_int(s: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """s // cnt for an integer dtype as the JAX package computes it
    (`s // cnt.astype(s.dtype)`): the count cast to the value's dtype,
    wrapping; floor division, unsigned for unsigned dtypes; and XLA's
    results for a divisor that wraps to 0 (-2, or -1 when s is 0, for
    signed dtypes; all ones for unsigned ones)."""
    w = 8 * s.element_size()
    sv = common.as_signed(s)
    d = cnt.to(sv.dtype)
    zero = d == 0
    d = torch.where(zero, torch.ones_like(d), d)
    if common.is_signed_int(s.dtype):
        q = sv // d
        at_zero = torch.where(sv != 0, -2, -1).to(sv.dtype)
    elif w < 64:  # zero-extend both, divide exactly in int64
        m = (1 << w) - 1
        q = ((sv.to(torch.int64) & m) // (d.to(torch.int64) & m)).to(
            sv.dtype)
        at_zero = torch.full_like(sv, -1)
    else:  # unsigned 64-bit by a divisor below 2^31: halve, then fix up
        q = (((sv >> 1) & ((1 << 63) - 1)) // d) << 1
        r = sv - q * d  # true remainder < 2 * d
        q = q + (r >= d).to(torch.int64)
        at_zero = torch.full_like(sv, -1)
    return torch.where(zero, at_zero, q).view(s.dtype)


def group_aggregate(keys: torch.Tensor, values, aggs=("sum",),
                    presorted: bool = False, agg_streams=None,
                    max_groups: int | None = None):
    """Aggregate `values` (one tensor or a tuple of tensors) per distinct
    key.

    Returns (num_groups, group_keys, results) where results[agg_index] is a
    tuple with one tensor per value stream (except "count": one tensor).
    All outputs are padded to n rows; rows past num_groups are meaningless.
    Integer sums and means keep the value's dtype (sums wrap); float16 sums
    and means come out float32; counts are int32 below 2^31 rows.

    `agg_streams` (optional, parallel to `aggs`) restricts each aggregate
    to a subset of value-stream indices; results[agg_index] then has one
    entry per selected stream, in selection order.

    `max_groups` (optional): a caller-known bound on the number of
    distinct keys.  Outputs are then padded to max_groups rows
    (ops/filter.compact_bounded).  If the bound is wrong, num_groups is
    still the true group count, the first max_groups groups are exact,
    and the rest are absent.

    The JAX signature's `method` argument, which its body never reads, is
    left out."""
    with profiling.span("srs.hashagg"):
        return _group_aggregate(keys, values, aggs, presorted, agg_streams,
                                max_groups)


def _group_aggregate(keys, values, aggs, presorted, agg_streams, max_groups):
    single = not isinstance(values, (tuple, list))
    vals = (values,) if single else tuple(values)
    for a in aggs:
        if a not in AGGS:
            raise ValueError(f"unknown aggregate {a!r}; have {AGGS}")
    if agg_streams is None:
        agg_streams = [tuple(range(len(vals)))] * len(aggs)
    n = keys.shape[0]

    if not presorted:
        with profiling.span("srs.hashagg.sort"):
            keys, vals = xla_sort.sort_arrays(keys, vals, ascending=True)

    u = transforms.to_sortable(keys, True)
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = u[1:] != u[:-1]
    ends = torch.ones_like(starts)  # last row of each group
    ends[:-1] = starts[1:]

    pos_dtype = torch.int64 if n > 2**31 - 1 else torch.int32
    pos = torch.arange(n, dtype=pos_dtype, device=keys.device)

    # Every aggregate is read at the same group-end rows, so all of them
    # (and the group keys) share one compaction.
    pending = [keys]  # stream 0: the group keys

    def register(arr):
        pending.append(arr)
        return len(pending) - 1

    need_cnt = any(a in ("count", "mean") for a in aggs)
    cnt_slot = register(pos + 1) if need_cnt else None

    # Each stream's scan is registered once per kind (sum and mean share
    # theirs), with the step that turns its value at a group end into the
    # result: diff an integer cumsum; take a float scan as it is; map an
    # integer min/max, scanned on its signed carrier (torch has no
    # minimum/maximum for uint16/32/64), back to the value's dtype.
    plans = []      # (agg, [(slot, finish)...]) per requested aggregate
    scan_memo = {}  # (scan kind, stream index) -> (slot, finish)
    to_scan = []    # (slot, value, op): segmented scans, run together
    for agg, streams in zip(aggs, agg_streams):
        if agg == "count":
            plans.append((agg, [(cnt_slot, _diff_groups)]))
            continue
        slots = []
        for i in streams:
            v, dt = vals[i], vals[i].dtype
            kind = "sum" if agg in ("sum", "mean") else agg
            if (kind, i) not in scan_memo:
                if kind == "sum" and not dt.is_floating_point:
                    sv = common.as_signed(v)
                    slot = register(torch.cumsum(sv, 0, dtype=sv.dtype))
                    finish = (lambda a, dt=dt: _diff_groups(a).view(dt))
                else:
                    finish = None
                    if kind == "sum" and dt == torch.float16:
                        v = v.to(torch.float32)
                    elif not dt.is_floating_point:
                        v = transforms.to_sortable(v)
                        finish = (lambda a, dt=dt:
                                  transforms.from_sortable(a, dt))
                    slot = register(None)
                    to_scan.append((slot, v, kind))
                scan_memo[kind, i] = (slot, finish)
            slots.append(scan_memo[kind, i])
        plans.append((agg, slots))

    with profiling.span("srs.hashagg.scan"):
        scanned = cuda_scan.segmented_scans([v for _, v, _ in to_scan],
                                            starts,
                                            [op for _, _, op in to_scan])
    for (slot, _, _), s in zip(to_scan, scanned):
        pending[slot] = s

    with profiling.span("srs.hashagg.compact"):
        if max_groups is not None:
            packed = filter_ops.compact_bounded(ends, *pending,
                                                max_out=max_groups)
        else:
            packed = filter_ops.compact(ends, *pending)
    num_groups, group_keys = packed[0], packed[1]
    at_ends = packed[1:]

    results = []
    for agg, slots in plans:
        per_stream = [at_ends[s] if finish is None else finish(at_ends[s])
                      for s, finish in slots]
        if agg == "count":
            results.append(per_stream[0])
            continue
        if agg == "mean":
            cnt = _diff_groups(at_ends[cnt_slot])
            per_stream = [s / cnt.to(s.dtype) if s.dtype.is_floating_point
                          else _mean_int(s, cnt) for s in per_stream]
        results.append(tuple(per_stream))

    return num_groups, group_keys, tuple(results)


def _diff_groups(acc_at_ends: torch.Tensor) -> torch.Tensor:
    """Per-group totals from compacted inclusive-cumsum values at group
    ends, in their (signed) dtype, wrapping."""
    acc = common.as_signed(acc_at_ends)
    return torch.cat([acc[:1], acc[1:] - acc[:-1]])
