"""Quicksort family: pivot partition primitive + the device quicksort engine.

Counterpart of simd_radix_sort_tpu/ops/quick_sort.py (the reference's
quicksort variant, quick_sort.hpp):

  * `partition(keys, payloads, pivot)` — the PartitionerSIMD equivalent:
    stable two-way split of key/payload streams around a pivot, returning
    (keys', payloads', split_index, key_min, key_max) like PartitionResult.
    The JAX package sorts by the 1-bit predicate; here the split is one K5
    launch (ops/cuda_partition.py), the compress-store the reference uses.

  * `sort_arrays(...)` — the device quicksort engine (registry "quick"): a
    sampled-splitter multiway partition, then batched block sorts as the
    comparison base case, with the anti-skew fallback.  Its constants
    (MAX_BUCKETS, OVERSAMPLE, BLOCK, the 4096-row target segment) are the
    JAX package's, chosen on a TPU, and stay placeholders on the card
    until they are measured there.

  * `sort_np(...)` — the host model with quickRecursion's exact pivot and
    recursion semantics (registry "quickseq"), copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import common, interop, transforms
from . import filter as filter_ops
from . import xla_sort

CMP_SORT_THRESHOLD = 16  # reference default (radix_sort.hpp:334-337)


def _scalar_like(value, keys: torch.Tensor) -> torch.Tensor:
    """`value` as a 1-element tensor of keys' dtype on keys' device."""
    if isinstance(value, torch.Tensor):
        if value.dtype != keys.dtype:
            raise TypeError(f"pivot dtype {value.dtype} != keys {keys.dtype}")
        return common.as_signed(value).reshape(1).to(keys.device).view(
            keys.dtype)
    return interop.from_numpy(
        np.asarray([value], dtype=common.np_dtype(keys.dtype)), keys.device)


def partition(keys: torch.Tensor, payloads, pivot, ascending: bool = True):
    """Stable two-way partition around `pivot` (inclusive left side).

    Returns (keys_out, payloads_out, split, kmin, kmax): rows with
    key <= pivot (in the requested order) precede the rest, each side in
    input order; `split` is the left-side row count (0-d int32); kmin/kmax
    are the key extremes in the requested order (0-d, keys' dtype)."""
    if keys.shape[0] == 0:
        # no consistent scalar kmin/kmax exists for an empty partition
        raise ValueError("partition requires at least one row")
    (c,) = transforms.key_operands(keys, ascending)
    (p,) = transforms.key_operands(_scalar_like(pivot, keys), ascending)
    le = c <= p
    out = filter_ops.partition_streams(~le, (keys, *payloads))
    split = le.sum(dtype=torch.int32)
    kmin = transforms.from_sortable(c.min(), keys.dtype, ascending)
    kmax = transforms.from_sortable(c.max(), keys.dtype, ascending)
    return out[0], tuple(out[1:]), split, kmin, kmax


# ---------------------------------------------------------------------------
# Device quicksort engine (sampled-splitter multiway partition)
# ---------------------------------------------------------------------------

# Max pivots per partition pass.
MAX_BUCKETS = 1024
# samples per splitter: segment sizes concentrate as ~(1 + 3/sqrt(OS))
OVERSAMPLE = 32
# Cleanup block width: any key interval of <= BLOCK/2 rows lies inside a
# block of one of the two offset phases (offset 0 and BLOCK/2), which makes
# the blocked cleanup exact.
BLOCK = 16384

# Which way each call of `sort_arrays` went: one plain sort (below the
# threshold or past the engine's range), the blocked cleanup, or the
# anti-skew fallback.  Read by tests and chip_smoke.py.
PATHS = {"one_sort": 0, "blocked": 0, "fallback": 0}


def reset_paths() -> None:
    for name in PATHS:
        PATHS[name] = 0


def _splitters(c: torch.Tensor, num_splitters: int) -> torch.Tensor:
    """Sorted, oversampled splitters of the carrier: strided samples,
    sorted, read off at even quantiles (getMedianOf9's sample-then-median
    at multiway scale).  float32 index arithmetic as in the JAX package."""
    n = c.shape[0]
    s = min(n, OVERSAMPLE * (num_splitters + 1))
    idx = ((torch.arange(s, dtype=torch.float32, device=c.device) + 0.5)
           * (n / s)).to(torch.int64)
    samples = torch.sort(c.index_select(0, idx)).values
    spl_idx = (torch.arange(1, num_splitters + 1, dtype=torch.float32,
                            device=c.device)
               * (s / (num_splitters + 1))).to(torch.int64)
    return samples.index_select(0, spl_idx).contiguous()


def _bucket_ids(c: torch.Tensor, spl: torch.Tensor) -> torch.Tensor:
    """bucket[i] = number of splitters <= key[i]: monotone in the key
    order, so a sort keyed (bucket, key) equals a sort keyed (key).  The
    JAX package reduces an (n, C) compare that XLA fuses; torch would
    build it, so this is a binary search.  int16: C <= 1024."""
    return torch.searchsorted(spl, c, right=True, out_int32=True).to(
        torch.int16)


def _sort_streams(streams, stable: bool):
    """Sort every stream by the first (the carrier)."""
    vals, order = torch.sort(streams[0], stable=stable)
    return [vals] + [s.index_select(0, order) for s in streams[1:]]


def _block_sort(streams, offset: int) -> None:
    """Phase of the blocked cleanup: stable-sort every BLOCK-row block that
    starts at `offset` (mod BLOCK) by the carrier, one batched torch.sort
    along dim 1 of a (blocks, BLOCK) view, in place on the engine's own
    padded copies."""
    n_pad = streams[0].shape[0]
    m = n_pad - BLOCK if offset else n_pad
    if m <= 0:
        return
    rows = m // BLOCK
    body = [s[offset:offset + m].view(rows, BLOCK) for s in streams]
    vals, idx = torch.sort(body[0], dim=1, stable=True)
    body[0].copy_(vals)
    for b in body[1:]:
        b.copy_(b.gather(1, idx))


def sort_arrays(keys: torch.Tensor, payloads=(), ascending: bool = True,
                stable: bool = False, block_threshold: int | None = None):
    """Device quicksort engine.  Returns (keys_sorted, payloads_sorted).

      1. sampled-splitter C-way partition: one sort keyed on the bucket id
         groups every segment contiguously;
      2. base case: batched block sorts, phase 0 on aligned BLOCK-row
         blocks, phase 1 on the same blocks offset by BLOCK/2.  Any
         segment of <= BLOCK/2 rows lies inside a block of one phase, and
         segments the first phase finished stay sorted through the second;
      3. anti-skew fallback (quickRecursion's ratio < 0.2 switch): when a
         segment exceeds BLOCK/2 rows, one sort of the partitioned rows.

    The JAX package sorts its cleanup by (bucket, key words, position) with
    the bucket word leading so that padding rows (bucket C) stay behind
    every real row.  torch.sort takes one key, so here every sort after the
    partition is stable and keyed on the carrier alone: for real rows the
    bucket is monotone in the key, padding rows carry the largest carrier
    and sit at the tail, so a stable sort keeps them behind every real row
    of equal carrier.  With `stable=True` the partition is stable too, so
    rows of equal keys keep their input order throughout and no position
    stream is needed.  The JAX package's `lax.cond` on the largest segment
    is one host read of it here."""
    n = keys.shape[0]
    # 4096-row target segments: large enough to keep the bucket search
    # cheap, half the BLOCK/2 engagement bound for sampling headroom
    thr = 4096 if block_threshold is None else block_threshold
    c = transforms.to_sortable(keys, ascending).contiguous()
    streams = [c, *(common.as_signed(p) for p in payloads)]

    # C adapted so segments land near thr rows (cmpSortThreshold role)
    nb = 2
    while nb < MAX_BUCKETS and nb * thr < n:
        nb *= 2

    # Past nb * BLOCK/2 rows even a balanced partition leaves every average
    # segment above the blocked-cleanup bound, so the partition would be
    # pure waste: one plain sort, as below the threshold.
    if n <= max(thr, 2) or n > nb * (BLOCK // 2):
        PATHS["one_sort"] += 1
        return _finish(_sort_streams(streams, stable), keys, payloads,
                       ascending)

    b = _bucket_ids(c, _splitters(c, nb - 1))
    b_s, order = torch.sort(b, stable=stable)
    streams = [s.index_select(0, order) for s in streams]

    # segment sizes from the sorted bucket ids; one host read decides
    starts = torch.searchsorted(
        b_s, torch.arange(nb, dtype=b_s.dtype, device=b_s.device))
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    max_seg = int((ends - starts).max())
    if max_seg > BLOCK // 2:
        PATHS["fallback"] += 1
        return _finish(_sort_streams(streams, True), keys, payloads,
                       ascending)

    PATHS["blocked"] += 1
    pad = -(-n // BLOCK) * BLOCK - n
    top = torch.iinfo(c.dtype).max
    streams = [torch.cat([s, s.new_full((pad,), top if i == 0 else 0)])
               for i, s in enumerate(streams)]
    for offset in (0, BLOCK // 2):
        _block_sort(streams, offset)
    return _finish([s[:n] for s in streams], keys, payloads, ascending)


def _finish(streams, keys, payloads, ascending):
    keys_out = transforms.from_sortable(streams[0], keys.dtype, ascending)
    return keys_out, tuple(s.view(p.dtype)
                           for s, p in zip(streams[1:], payloads))


# ---------------------------------------------------------------------------
# Host recursion driver (differential model of quick_sort.hpp semantics),
# a copy of the JAX package's
# ---------------------------------------------------------------------------

def _next_val(v: np.uint64, umax: np.uint64) -> np.uint64:
    """nextVal on the unsigned carrier (quick_sort.hpp:237-246)."""
    return v if v == umax else v + np.uint64(1)


def _get_average(a: np.uint64, b: np.uint64) -> np.uint64:
    """Overflow-safe midpoint (a&b) + ((a^b)>>1) (quick_sort.hpp:263-268)."""
    return (a & b) + ((a ^ b) >> np.uint64(1))


def _median(a, b, c):
    """median(a, b, c) (quick_sort.hpp:256-274)."""
    return max(min(a, b), min(max(a, b), c))


def _median_of_3(u: np.ndarray, left: int, right: int):
    """getMedianOf3 (quick_sort.hpp:276-283): values at left, the interval's
    own midpoint, and right."""
    mid = left + (right - left) // 2
    return _median(u[left], u[mid], u[right])


def _median_of_9(u: np.ndarray, left: int, right: int):
    """getMedianOf9 (quick_sort.hpp:285-294), index arithmetic replicated
    exactly: thirds boundaries leftMid = left + (right-left)/3 and
    rightMid = left + 2*(right-left)/3, median of the three medians-of-3
    over [left, leftMid], [leftMid+1, rightMid], [rightMid+1, right]."""
    left_mid = left + (right - left) // 3
    right_mid = left + 2 * (right - left) // 3
    return _median(_median_of_3(u, left, left_mid),
                   _median_of_3(u, left_mid + 1, right_mid),
                   _median_of_3(u, right_mid + 1, right))


def _quick_recursion(u: np.ndarray, pays: list, left0: int, right0: int,
                     choose_avg0: bool, avg0: np.uint64, umax: np.uint64,
                     threshold: int):
    """quickRecursion (quick_sort.hpp:296-332) on the unsigned carrier,
    driven by an explicit work stack (same call tree, LIFO order, immune to
    Python recursion limits on adversarial inputs)."""
    stack = [(left0, right0, choose_avg0, avg0)]
    while stack:
        left, right, choose_avg, avg = stack.pop()
        if right - left <= 0:
            continue
        if right - left < threshold:  # insertion-sort base -> stable sort
            order = np.argsort(u[left:right + 1], kind="stable")
            u[left:right + 1] = u[left:right + 1][order]
            for p in pays:
                p[left:right + 1] = p[left:right + 1][order]
            continue

        pivot = avg if choose_avg else _median_of_9(u, left, right)
        seg = u[left:right + 1]
        le = seg <= pivot
        smallest, largest = seg.min(), seg.max()
        order = np.argsort(~le, kind="stable")  # stable partition
        u[left:right + 1] = seg[order]
        for p in pays:
            p[left:right + 1] = p[left:right + 1][order]
        split = left + int(le.sum())

        # anti-skew toggle: ratio = min(split-left, right-split+1)/n < 0.2
        # flips the pivot strategy (quick_sort.hpp:313-319)
        n = right - left + 1
        ratio = min(split - left, right - split + 1) / n
        next_choose = not choose_avg if ratio < 0.2 else choose_avg

        # constant-range pruning + child interval midpoints, exactly
        # quick_sort.hpp:321-331 (Up branch; descending is handled by the
        # carrier complement).  Push right child first so the left child
        # pops first, matching the reference's call order.
        if _next_val(pivot, umax) < largest:
            stack.append((split, right, next_choose,
                          _get_average(pivot, largest)))
        if pivot > smallest:
            stack.append((left, split - 1, next_choose,
                          _get_average(pivot, smallest)))


def sort_np(keys: np.ndarray, *payloads: np.ndarray, ascending: bool = True,
            threshold: int = CMP_SORT_THRESHOLD):
    """Host quicksort with the reference's exact pivot/recursion semantics.
    Returns (keys_sorted, *payloads_sorted)."""
    u = transforms.to_sortable_np(np.asarray(keys), ascending).copy()
    pays = [np.asarray(p).copy() for p in payloads]
    n = u.shape[0]
    umax = np.uint64(np.iinfo(u.dtype).max).astype(u.dtype)
    if n > 1:
        # initial call: chooseAvg = FALSE (median-of-9 picks the first
        # pivot) with avg = midpoint of the full type range carried
        # down (quick_sort.hpp:334-361)
        _quick_recursion(u, pays, 0, n - 1, False,
                         _get_average(u.dtype.type(0), umax), umax,
                         threshold)
    keys_out = transforms.from_sortable_np(u, np.asarray(keys).dtype,
                                           ascending)
    return (keys_out, *pays)
