"""LSD radix sort with three per-pass movers (registry name "radix").

Counterpart of simd_radix_sort_tpu/ops/radix.py.  Each pass reorders every
stream stably by one digit of the key's order-preserving value `u`, from the
least significant digit up, so the result is the stable sort by key:
unique, and byte for byte the JAX package's, whatever `stable` says.

The port holds keys as the signed carrier `c = u ^ sign` (utils/common.py).
Every bit of `c` below the top one is a bit of `u`; the top bit is `u`'s
flipped.  So a digit is taken from `c` masked, with the top bit flipped back
(or, for a sort key, with the arithmetic shift, whose signed order is `u`'s).

A 64-bit key stays one word here (the JAX package splits it into two u32
words for the TPU), so the digit width defaults on the key's logical
width: 32-bit digits for 64-bit keys, 16-bit digits otherwise, capped at
the key's width (8 for 1-byte keys).
"""

from __future__ import annotations

import torch

from ..utils import common, transforms
from . import cuda_partition

ENGINES = ("sort", "scatter", "pallas")
# Elements of the scatter mover's per-chunk (rows, buckets) one-hot: a
# chunk of 2^16 rows for 8-bit digits.
ONEHOT_BUDGET = 1 << 24
MAX_SCATTER_DIGIT_BITS = 16

_SIGNED_BY_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32,
                   64: torch.int64}


def _passes(key_bits: int, digit_bits: int):
    """(shift, width) of each digit, least significant first."""
    return [(s, min(digit_bits, key_bits - s))
            for s in range(0, key_bits, digit_bits)]


def _sort_digit(c: torch.Tensor, shift: int, b: int) -> torch.Tensor:
    """A signed tensor, in the narrowest type that holds it, whose order is
    the order of u's digit [shift, shift + b)."""
    w = 8 * c.element_size()
    t = next(t for t in (8, 16, 32, 64) if t >= b)
    if shift + b == w:
        # top digit: the arithmetic shift keeps the carrier's sign, whose
        # signed order is u's unsigned order
        d = c >> shift
    else:
        d = (c >> shift) & ((1 << b) - 1)
        if b == t:
            d = d - (1 << (t - 1))
    return d.to(_SIGNED_BY_BITS[t])


def _unsigned_digit(c: torch.Tensor, shift: int, b: int) -> torch.Tensor:
    """u's digit [shift, shift + b) as int64 in [0, 2^b)."""
    d = (c.to(torch.int64) >> shift) & ((1 << b) - 1)
    if shift + b == 8 * c.element_size():
        d = d ^ (1 << (b - 1))
    return d


def _sort_passes(c, pays, digit_bits):
    """Mover "sort": each pass is one stable torch.sort of the digit and
    one index_select per stream, the counterpart of the JAX package's
    stable variadic lax.sort."""
    streams = [c, *pays]
    for shift, b in _passes(8 * c.element_size(), digit_bits):
        perm = torch.argsort(_sort_digit(streams[0], shift, b), stable=True)
        streams = [s.index_select(0, perm) for s in streams]
    return streams


def _pass_dest(d: torch.Tensor, num_buckets: int, chunk: int):
    """Destination of every row under a stable counting sort by the digits
    `d`: histogram, exclusive scan, then the stable rank within the bucket,
    computed on chunks of `chunk` rows with the per-bucket counts carried
    from chunk to chunk."""
    hist = torch.bincount(d, minlength=num_buckets)
    base = torch.cumsum(hist, 0) - hist
    carry = torch.zeros_like(base)
    ids = torch.arange(num_buckets, device=d.device)
    dest = torch.empty_like(d)
    for lo in range(0, d.numel(), chunk):
        dc = d[lo:lo + chunk]
        # (buckets, rows): the scan runs along the contiguous last axis,
        # one row of the one-hot per bucket (a scan along the first axis
        # of a (rows, buckets) one-hot runs one thread per bucket on CUDA)
        seen = torch.cumsum((ids[:, None] == dc).to(torch.int32), 1,
                            dtype=torch.int32)
        rank = seen.gather(0, dc[None, :]).squeeze(0) - 1
        dest[lo:lo + chunk] = base[dc] + carry[dc] + rank
        carry += seen[:, -1]
    return dest


def _scatter_passes(c, pays, digit_bits, block):
    """Mover "scatter", the semantic model of a radix pass: histogram,
    exclusive scan, stable rank, then a scatter of every stream."""
    if digit_bits > MAX_SCATTER_DIGIT_BITS:
        raise ValueError(f"engine='scatter' takes digit_bits <= "
                         f"{MAX_SCATTER_DIGIT_BITS}")
    key_bits = 8 * c.element_size()
    num_buckets = 1 << min(digit_bits, key_bits)
    chunk = block or max(1, ONEHOT_BUDGET // num_buckets)
    streams = [c, *pays]
    for shift, b in _passes(key_bits, digit_bits):
        dest = _pass_dest(_unsigned_digit(streams[0], shift, b), num_buckets,
                          chunk)
        streams = [torch.empty_like(s).index_copy_(0, dest, s)
                   for s in streams]
    return streams


def _bitpart_passes(c, pays, block):
    """Mover "pallas": one stable two-way partition (K5) per key bit, LSB
    to MSB, the reference's pass structure.  Every stream travels as 4- or
    8-byte words."""
    (key,), key_dtype = cuda_partition.to_words(c)
    words, metas = [key], [key_dtype]
    for p in pays:
        (w,), meta = cuda_partition.to_words(p)
        words.append(w)
        metas.append(meta)
    key_bits = 8 * c.element_size()
    word_bits = 8 * key.element_size()
    for s in range(key_bits):
        k = words[0]
        if s == word_bits - 1:
            mask = k >= 0  # u's top bit is the carrier's sign bit flipped
        elif s == key_bits - 1:
            mask = (k & (1 << s)) == 0  # the same, for a widened key
        else:
            mask = (k & (1 << s)) != 0
        words = cuda_partition.partition_pass(words, mask, block=block)
    return [cuda_partition.from_words([w], m) for w, m in zip(words, metas)]


def sort_arrays(keys: torch.Tensor, payloads, ascending: bool = True,
                stable: bool = True, digit_bits: int | None = None,
                block: int | None = None, engine: str = "sort"):
    """LSD radix sort of `keys` (1-D) with lock-step payload streams.
    Returns (sorted_keys, tuple_of_sorted_payloads).

    Movers (`engine`):
      * "sort" (default): a stable torch.sort of each digit, then one
        gather per stream.
      * "scatter": histogram, exclusive scan, stable rank and scatter, on
        chunks of `block` rows (default: a one-hot of ONEHOT_BUDGET
        elements).  Plain PyTorch: no kernel of the JAX package is on it.
      * "pallas": one K5 partition per key bit (ops/cuda_partition.py),
        `block` being K5's tile.  The name is the JAX package's, which
        callers pass.  It has no digit width, so `digit_bits` raises.
    All three are stable, so `stable` changes nothing."""
    if engine not in ENGINES:
        raise ValueError(f"unknown radix engine {engine!r}; have {ENGINES}")
    if engine == "pallas" and digit_bits is not None:
        raise ValueError("engine='pallas' sorts 1 bit per pass; digit_bits "
                         "does not apply (use engine='sort' or 'scatter' "
                         "for multi-bit digits)")
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    c = transforms.to_sortable(keys, ascending)
    pays = [common.as_signed(p) for p in payloads]
    key_bits = 8 * c.element_size()
    if keys.numel() == 0:
        streams = [c, *pays]
    elif engine == "sort":
        if digit_bits is None:
            digit_bits = 32 if key_bits == 64 else 16
        streams = _sort_passes(c, pays, min(digit_bits, key_bits))
    elif engine == "scatter":
        streams = _scatter_passes(c, pays, digit_bits or 8, block)
    else:
        streams = _bitpart_passes(c, pays, block or cuda_partition.PART_BLOCK)
    keys_out = transforms.from_sortable(streams[0], keys.dtype, ascending)
    return keys_out, tuple(s.view(p.dtype)
                           for s, p in zip(streams[1:], payloads))
