"""Plain reference of the `sort_thesis_combined` configuration: NumPy only.

It imports nothing of the port.  A row is a key and its fields, each field
a function of the key (`sort_thesis`'s payload rule), so the sorted table
is the sorted keys with every field worked out again from them.  The
answer is given a column at a time, so that a 10^8-row table is never
held whole: column 0 the keys, column 1 + j field j, each as uint64, in
ascending order of the keys, each column worked out on its own (so that
columns can be worked out side by side).
"""

from __future__ import annotations

import numpy as np

from benchmark import harness

thesis = harness.load_file_module("reference", "sort_thesis")
sort_keys = thesis.sort_keys


def payload(keys: np.ndarray, stream: int) -> np.ndarray:
    """`sort_thesis`'s payload stream `stream` of uint64 keys (splitmix64
    of the key xor (stream + 1) * SALT), worked out in place: two arrays
    where that rule's form makes eight, a third of its time at 10^8 keys,
    which the comparison of seven fields a table pays."""
    with np.errstate(over="ignore"):
        z = keys ^ np.uint64((stream + 1) * thesis.SALT % 2**64)
        z += np.uint64(thesis.M1)
        t = z >> np.uint64(30)
        z ^= t
        z *= np.uint64(thesis.M2)
        np.right_shift(z, np.uint64(27), out=t)
        z ^= t
        z *= np.uint64(thesis.M3)
        np.right_shift(z, np.uint64(31), out=t)
        z ^= t
    return z


def column(ordered: np.ndarray, c: int) -> np.ndarray:
    """Column c of the sorted table, given its keys sorted ascending
    (`sort_keys`): the keys themselves for c = 0, else field c - 1 of each
    sorted key."""
    return ordered if c == 0 else payload(ordered, c - 1)


def row_words(rows: np.ndarray) -> np.ndarray | None:
    """An (n, row_bytes) uint8 table as (n, row_bytes / 8) uint64 words, or
    None where it is not such a table."""
    if rows.ndim != 2 or rows.dtype != np.uint8 or rows.shape[1] % 8:
        return None
    return np.ascontiguousarray(rows).view(np.uint64)
