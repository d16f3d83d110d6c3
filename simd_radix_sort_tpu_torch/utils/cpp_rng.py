"""Bit-exact replicas of the C/C++ random number generators the reference
harness's datasets depend on (NumPy only).

A copy of simd_radix_sort_tpu/utils/cpp_rng.py, kept here so the port never
imports the JAX package:

  * glibc `srand`/`rand` (TYPE_3 additive feedback, deg=31 sep=3), which
    the key-seeded payload protocol draws from (the reference's data.hpp,
    lines 55-62 and 393-406), vectorised over many seeds at once;
  * `std::mt19937`, the key generator (data.hpp:108): the standardised
    MT19937 with Knuth initialisation, as libstdc++ and libc++ have it
    (NumPy's seeding differs, so NumPy's cannot stand in).

tests/test_cpp_rng.py holds the JAX copy against golden values from small
C++ programs built with the system compiler; tests/test_torch_host_engines.py
holds this copy against the same goldens and against the JAX copy.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# glibc rand(): TYPE_3 additive feedback generator (random_r.c semantics)
# ---------------------------------------------------------------------------

_DEG = 31
_SEP = 3
_MOD = 2147483647
_MULT = 16807


def _srandom_states(seeds: np.ndarray) -> np.ndarray:
    """Vectorised glibc srandom: (n, 31) int64 states (int32 values)."""
    seeds = np.asarray(seeds, dtype=np.uint32)
    n = seeds.shape[0]
    state = np.empty((n, _DEG), dtype=np.int64)
    s = seeds.astype(np.int64)
    s = np.where(s == 0, 1, s)
    # state[0] = (int32_t) seed
    state[:, 0] = s.astype(np.int32)
    for i in range(1, _DEG):
        word = state[:, i - 1]
        hi = np.trunc(word / 127773).astype(np.int64)  # C trunc division
        lo = word - hi * 127773
        word = _MULT * lo - 2836 * hi
        word = np.where(word < 0, word + _MOD, word)
        state[:, i] = word
    return state


def glibc_rand_stream(seeds: np.ndarray, ndraws: int) -> np.ndarray:
    """(n, ndraws) int32: the first `ndraws` rand() results for each seed,
    after glibc's 310 warm-up discards."""
    state = _srandom_states(seeds).astype(np.uint32)  # additive ring, mod 2^32
    n = state.shape[0]
    out = np.empty((n, ndraws), dtype=np.int32)
    f, r = _SEP, 0
    for k in range(10 * _DEG + ndraws):
        val = state[:, f] + state[:, r]  # uint32 wrap
        state[:, f] = val
        if k >= 10 * _DEG:
            out[:, k - 10 * _DEG] = ((val >> np.uint32(1))
                                     & np.uint32(0x7FFFFFFF)).astype(np.int32)
        f = (f + 1) % _DEG
        r = (r + 1) % _DEG
    return out


def glibc_rand_bytes(seeds: np.ndarray, nbytes: int) -> np.ndarray:
    """(n, nbytes) uint8: successive rand() draws truncated to bytes, as
    the reference's getRandom<T> fills `randomBytes[i] = rand()`."""
    draws = glibc_rand_stream(seeds, nbytes)
    return (draws & 0xFF).astype(np.uint8)


# ---------------------------------------------------------------------------
# std::mt19937 (MT19937 with Knuth initialisation, as standardised)
# ---------------------------------------------------------------------------

_N, _M = 624, 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class Mt19937:
    """Model of std::mt19937(seed): `next()` / `draw(k)` return the same
    uint32 stream as the C++ engine's operator()."""

    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, dtype=np.uint32)
        mt[0] = np.uint32(seed)
        for i in range(1, _N):
            prev = mt[i - 1]
            mt[i] = np.uint32(
                (np.uint64(1812433253) * np.uint64(prev ^ (prev >> np.uint32(30)))
                 + np.uint64(i)) & np.uint64(0xFFFFFFFF))
        self._mt = mt
        self._idx = _N

    def _twist(self):
        # Vectorised genrand_int32 twist.  mt[kk] = mt[(kk+M)%N] ^ (y>>1) ^
        # mag, where the source entry is the ALREADY-UPDATED value once
        # (kk+M)%N < kk, so the update goes in dependency-free stages of
        # width N-M = 227 (plus the final wrap element, whose y mixes the
        # new mt[0]).
        old = self._mt
        y = (old & _UPPER) | (np.concatenate([old[1:], old[:1]]) & _LOWER)
        mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
        step = (y >> np.uint32(1)) ^ mag
        new = np.empty_like(old)
        new[0:227] = old[397:624] ^ step[0:227]
        new[227:454] = new[0:227] ^ step[227:454]
        new[454:623] = new[227:396] ^ step[454:623]
        y_last = (old[623] & _UPPER) | (new[0] & _LOWER)
        mag_last = _MATRIX_A if (y_last & np.uint32(1)) else np.uint32(0)
        new[623] = new[396] ^ (y_last >> np.uint32(1)) ^ mag_last
        self._mt = new
        self._idx = 0

    def draw(self, k: int) -> np.ndarray:
        """Next k tempered uint32 outputs."""
        out = np.empty(k, dtype=np.uint32)
        filled = 0
        while filled < k:
            if self._idx >= _N:
                self._twist()
            take = min(k - filled, _N - self._idx)
            y = self._mt[self._idx:self._idx + take].copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled:filled + take] = y
            self._idx += take
            filled += take
        return out

    def next(self) -> int:
        return int(self.draw(1)[0])
