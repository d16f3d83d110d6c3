"""Plain reference of the `sort_thesis` configuration: NumPy only.

It imports nothing of the port.  It sorts the benchmark's own input keys
and works each payload out again from its sorted key by the configuration's
rule (splitmix64 of the key's bits), so the comparison covers the order of
the keys and every payload beside its key.
"""

from __future__ import annotations

import numpy as np

M1 = 0x9E3779B97F4A7C15  # splitmix64's constants
M2 = 0xBF58476D1CE4E5B9
M3 = 0x94D049BB133111EB
SALT = 0xA5A5A5A5A5A5A5A5  # payload stream j mixes in (j + 1) * SALT


def unsigned(a: np.ndarray) -> np.ndarray:
    """The raw bits of an integer array as unsigned integers of its width."""
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + np.uint64(M1)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(M2)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(M3)
        return z ^ (z >> np.uint64(31))


def payload(keys: np.ndarray, stream: int = 0) -> np.ndarray:
    """Payload stream `stream` of each key: splitmix64 of the key's bits
    (zero-extended) xor (stream + 1) * SALT, as uint64."""
    with np.errstate(over="ignore"):
        salt = np.uint64((stream + 1) * SALT % 2**64)
    return splitmix64(unsigned(keys).astype(np.uint64) ^ salt)


def sort_keys(keys: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The keys in order of their values (integer keys).  Equal integer
    keys are alike, so any sort gives the one answer: NumPy's radix sort
    (`stable`) for keys of 1 and 2 bytes, its default sort for wider ones,
    each the faster there."""
    out = np.sort(keys, kind="stable" if keys.dtype.itemsize <= 2 else None)
    return out if ascending else out[::-1].copy()


def sortable(keys: np.ndarray) -> np.ndarray:
    """Unsigned values whose order is the keys' order."""
    u = unsigned(keys)
    if keys.dtype.kind == "i":
        u = u ^ u.dtype.type(1 << (8 * keys.dtype.itemsize - 1))
    return u
