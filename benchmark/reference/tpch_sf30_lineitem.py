"""Plain reference of the `tpch_sf30_lineitem` configuration: NumPy only.

It imports nothing of the port.  `order` gives the stable lexicographic
order of integer key columns, each ascending or descending, by `np.lexsort`
(a descending key through its bitwise complement, which reverses the order
of any integer dtype without overflow).  To use the host's cores it first
splits the rows by ranges of the first key, each range's rows kept in
their input order, and lexsorts each range in a thread of its own; the
ranges in turn are the whole order.  `column` takes one column in that
order, so the sorted table is worked out a column at a time.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

RANGES = 32  # ranges of the first key, lexsorted side by side


def _ascending(key: np.ndarray, up: bool) -> np.ndarray:
    key = np.asarray(key)
    if key.dtype.kind not in "iu":
        raise TypeError(f"the reference orders integer keys, not {key.dtype}")
    return key if up else ~key


def order(keys, ascending) -> np.ndarray:
    """The int64 permutation that sorts the rows by `keys` (1-D integer
    arrays of one length, the first the most significant), each ascending
    where its flag says so, ties kept in their input order."""
    keys = [_ascending(k, up) for k, up in zip(keys, ascending, strict=True)]
    first = keys[0]
    n = first.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    sample = np.sort(first[::max(1, n // 100_000)])
    edges = np.unique(sample[(np.arange(1, RANGES) * sample.size) // RANGES])
    workers = max(1, min(8, os.cpu_count() or 1))
    step = -(-n // (4 * workers))
    bucket = np.empty(n, dtype=np.uint8)  # the range of each row

    def label(lo):
        bucket[lo:lo + step] = np.searchsorted(edges, first[lo:lo + step],
                                               side="right")

    def one(b):  # a range's rows, in their input order, then lexsorted
        idx = np.flatnonzero(bucket == b)
        return idx[np.lexsort(tuple(k[idx] for k in reversed(keys)))]

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(label, range(0, n, step)))
        return np.concatenate(list(pool.map(one, range(edges.size + 1))))


def column(values: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """One column of the sorted table: `values` taken in the order
    `perm`."""
    return np.asarray(values)[perm]
