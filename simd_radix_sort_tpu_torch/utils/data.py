"""Dataset generation and the self-validating oracle (NumPy only).

A copy of simd_radix_sort_tpu/utils/data.py, kept here so the port never
imports the JAX package: the same seed gives the same keys and payloads in
both packages.

  * the 8 input distributions of the reference harness (data.hpp:64-170);
  * the payload protocols: every payload is a deterministic function of
    its key, so validation regenerates the expected payload from each
    sorted key.  "fast" (the default) is splitmix64 of the key bits and
    the stream index; "cpp" replicates the reference's glibc srand/rand
    byte draws bit for bit (utils/cpp_rng.py), for datasets that must
    equal the reference's;
  * the oracle: sortedness in the key dtype's bit order, payload
    regeneration and key multiset equality.
"""

from __future__ import annotations

import enum
import math

import numpy as np

from . import common, transforms


class Distribution(enum.Enum):
    UNIFORM = "Uniform"
    GAUSSIAN = "Gaussian"
    ZERO = "Zero"
    ZERO_ONE = "ZeroOne"
    SORTED = "Sorted"
    REVERSE_SORTED = "ReverseSorted"
    ALMOST_SORTED = "AlmostSorted"
    ALMOST_REVERSE_SORTED = "AlmostReverseSorted"


ALL_DISTRIBUTIONS = tuple(Distribution)


def _fill_uniform(rng: np.random.Generator, num: int, dtype: np.dtype):
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=num, dtype=dtype,
                            endpoint=True)
    return rng.uniform(-1.0, 1.0, size=num).astype(dtype)


def _fill_gaussian(rng: np.random.Generator, num: int, dtype: np.dtype):
    if dtype.kind in "iu":
        vals = np.round(rng.normal(0.0, 100.0, size=num))
        # out-of-range draws wrap through int64 (two's complement), as the
        # reference's double->int conversion does
        return vals.astype(np.int64).astype(dtype)
    return rng.normal(0.0, 1.0, size=num).astype(dtype)


def make_keys(num: int, dtype, distribution: Distribution,
              seed: int = 0) -> np.ndarray:
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if distribution is Distribution.ZERO:
        return np.zeros(num, dtype=dtype)
    if distribution is Distribution.ZERO_ONE:
        return rng.integers(0, 2, size=num).astype(dtype)
    if distribution is Distribution.UNIFORM:
        return _fill_uniform(rng, num, dtype)
    if distribution is Distribution.GAUSSIAN:
        return _fill_gaussian(rng, num, dtype)

    # Sorted family: integral keys start uniform, floats start gaussian,
    # sorted in the dtype's bit order.
    if dtype.kind in "iu":
        keys = _fill_uniform(rng, num, dtype)
    else:
        keys = _fill_gaussian(rng, num, dtype)
    order = np.argsort(transforms.to_sortable_np(keys), kind="stable")
    keys = keys[order]
    if distribution in (Distribution.REVERSE_SORTED,
                        Distribution.ALMOST_REVERSE_SORTED):
        keys = keys[::-1].copy()
    if distribution in (Distribution.ALMOST_SORTED,
                        Distribution.ALMOST_REVERSE_SORTED) and num > 0:
        num_displacements = int(math.exp2(math.log10(num))) if num > 1 else 0
        for _ in range(num_displacements):
            i, j = rng.integers(0, num, size=2)
            keys[i], keys[j] = keys[j], keys[i]
    return keys


def _key_bits64(keys: np.ndarray) -> np.ndarray:
    """Raw key bit pattern zero-extended to uint64."""
    return keys.view(common.unsigned_of(keys.dtype)).astype(np.uint64)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def make_payload_fast(keys: np.ndarray, stream_index: int,
                      dtype) -> np.ndarray:
    """Payload stream = splitmix64(key_bits ^ f(stream_index)), truncated to
    the payload width."""
    dtype = np.dtype(dtype)
    with np.errstate(over="ignore"):
        h = _splitmix64(
            _key_bits64(keys) ^ (np.uint64(stream_index + 1)
                                 * np.uint64(0xA5A5A5A5A5A5A5A5)))
    w = dtype.itemsize
    if w == 8:
        bits = h
    else:
        bits = (h & np.uint64((1 << (8 * w)) - 1)).astype(
            common.unsigned_of(dtype))
    return bits.view(dtype)


def make_payload_cpp(keys: np.ndarray, payload_dtypes):
    """Reference-exact payloads: glibc rand seeded with the key's low 4
    bytes, sizeof(P) bytes drawn per payload in declaration order."""
    from . import cpp_rng

    dtype = np.dtype(keys.dtype)
    seed_bytes = min(dtype.itemsize, 4)
    u = keys.view(common.unsigned_of(dtype)).astype(np.uint64)
    seeds = (u & np.uint64((1 << (8 * seed_bytes)) - 1)).astype(np.uint32)
    total_bytes = sum(np.dtype(p).itemsize for p in payload_dtypes)
    draws = cpp_rng.glibc_rand_bytes(seeds, total_bytes)  # (n, total) u8
    out, off = [], 0
    for p in payload_dtypes:
        p = np.dtype(p)
        out.append(np.ascontiguousarray(draws[:, off:off + p.itemsize])
                   .reshape(-1).view(p))
        off += p.itemsize
    return tuple(out)


def make_payloads(keys: np.ndarray, payload_dtypes, protocol: str = "fast"):
    if protocol == "fast":
        return tuple(make_payload_fast(keys, j, p)
                     for j, p in enumerate(payload_dtypes))
    if protocol == "cpp":
        return make_payload_cpp(keys, payload_dtypes)
    raise ValueError(f"unknown payload protocol {protocol!r}")


def make_dataset(num: int, key_dtype, payload_dtypes,
                 distribution: Distribution, seed: int = 0,
                 protocol: str = "fast"):
    """Keys and their payloads: the reference's Data<K, Ps...>
    constructor."""
    keys = make_keys(num, key_dtype, distribution, seed)
    return keys, make_payloads(keys, payload_dtypes, protocol)


def is_sorted(keys: np.ndarray, ascending: bool = True) -> bool:
    """Sortedness in the key dtype's bit order."""
    u = transforms.to_sortable_np(np.asarray(keys))
    if not ascending:
        u = u[::-1]
    return bool(np.all(u[:-1] <= u[1:]))


def check_payloads(keys: np.ndarray, payloads, protocol: str = "fast") -> bool:
    """Regenerate every payload from its key and compare bit patterns."""
    expected = make_payloads(np.asarray(keys),
                             [np.asarray(p).dtype for p in payloads], protocol)
    for got, want in zip(payloads, expected):
        if not np.array_equal(np.asarray(got).view(np.uint8),
                              np.asarray(want).view(np.uint8)):
            return False
    return True


def check_data(sorted_keys, sorted_payloads, original_keys,
               ascending: bool = True, protocol: str = "fast") -> str:
    """checkData equivalent: "" on pass, else an error description."""
    errors = []
    sorted_keys = np.asarray(sorted_keys)
    original_keys = np.asarray(original_keys)
    if not is_sorted(sorted_keys, ascending):
        u = transforms.to_sortable_np(sorted_keys)
        if not ascending:
            u = u[::-1]
        bad = int(np.sum(u[:-1] > u[1:]))
        errors.append(f"not sorted ({bad} out of {len(u) - 1} pairs)")
    if not check_payloads(sorted_keys, sorted_payloads, protocol):
        errors.append("payloads are not ok")
    a = np.sort(sorted_keys.view(common.unsigned_of(sorted_keys.dtype)))
    b = np.sort(original_keys.view(common.unsigned_of(original_keys.dtype)))
    if not np.array_equal(a, b):
        errors.append("key multiset changed")
    if errors and np.array_equal(
            sorted_keys.view(np.uint8), original_keys.view(np.uint8)):
        errors.append("(keys are the same)")
    return ", ".join(errors)
