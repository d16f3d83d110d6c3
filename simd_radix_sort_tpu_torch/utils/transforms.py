"""Order-preserving bit transforms on torch tensors.

Counterpart of simd_radix_sort_tpu/utils/transforms.py.  Every key dtype
maps to an unsigned value `u` whose natural order equals the key order:

  * unsigned:  u = x
  * signed:    u = bits(x) XOR sign_mask
  * float:     u = bits(x) XOR (x < 0 ? all_ones : sign_mask)   (IEEE totalOrder)
  * descending: u = NOT u

The port holds `u` as a signed same-width CARRIER `c = u XOR sign_mask`
(see utils/common.py), so `torch.sort` on `c` orders exactly like an
unsigned sort of `u`.  Written in the carrier domain the transform is short:

  * unsigned:  c = bits XOR sign_mask
  * signed:    c = bits                        (no work at all)
  * float:     c = bits XOR (bits < 0 ? max_positive : 0)   (an involution)
  * descending: c = NOT c

A 64-bit key stays one int64 word; the JAX package's (hi, lo) u32 split
exists only for the TPU's 32-bit lanes and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common, profiling


def _masks(nbits: int):
    sign = 1 << (nbits - 1)
    ones = (1 << nbits) - 1
    return sign, ones


def _sign_s(nbits: int) -> int:
    """The sign bit as a signed Python int of that width."""
    return -(1 << (nbits - 1))


def _max_s(nbits: int) -> int:
    return (1 << (nbits - 1)) - 1


# ---------------------------------------------------------------------------
# torch versions
# ---------------------------------------------------------------------------


def sortable_from_bits(bits: torch.Tensor, dtype,
                       ascending: bool = True) -> torch.Tensor:
    """Carrier of keys of `dtype` whose raw bit pattern `bits` holds in any
    same-width integer tensor.  Returns the signed carrier (may alias
    `bits` for ascending signed keys)."""
    dtype = common.np_dtype(dtype)
    nbits = dtype.itemsize * 8
    if bits.element_size() != dtype.itemsize:
        raise TypeError(f"{bits.dtype} bits do not hold {dtype} keys")
    b = common.as_signed(bits)
    if common.is_unsigned_int(dtype):
        c = b ^ _sign_s(nbits)
    elif common.is_signed_int(dtype):
        c = b
    elif common.is_float(dtype):
        c = b ^ ((b >> (nbits - 1)) & _max_s(nbits))
    else:
        raise TypeError(f"unsupported key dtype {dtype}")
    if not ascending:
        c = ~c
    return c


def to_sortable(keys: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Map keys to the same-width signed carrier with matching order."""
    with profiling.span("srs.transform"):
        return sortable_from_bits(keys, common.np_dtype(keys.dtype),
                                  ascending)


def bits_from_sortable(c: torch.Tensor, dtype,
                       ascending: bool = True) -> torch.Tensor:
    """Inverse of `sortable_from_bits`: the raw key bit pattern, returned
    as the unsigned torch dtype of the key's width."""
    dtype = common.np_dtype(dtype)
    nbits = dtype.itemsize * 8
    c = common.as_signed(c)
    if not ascending:
        c = ~c
    if common.is_unsigned_int(dtype):
        b = c ^ _sign_s(nbits)
    elif common.is_signed_int(dtype):
        b = c
    elif common.is_float(dtype):
        # the carrier keeps the key's sign bit, so the float step inverts
        # itself
        b = c ^ ((c >> (nbits - 1)) & _max_s(nbits))
    else:
        raise TypeError(f"unsupported key dtype {dtype}")
    return b.view(common.torch_dtype(common.unsigned_of(dtype)))


def from_sortable(c: torch.Tensor, dtype, ascending: bool = True) -> torch.Tensor:
    """Inverse of `to_sortable`: keys of `dtype` back from their carrier."""
    with profiling.span("srs.transform"):
        return bits_from_sortable(c, dtype, ascending).view(
            common.torch_dtype(dtype))


def key_operands(keys: torch.Tensor, ascending: bool = True,
                 logical_dtype=None):
    """Tuple of carrier operands whose order equals the requested key order:
    always one signed word here.  With `logical_dtype`, `keys` holds the
    raw bit pattern of keys of that dtype."""
    if logical_dtype is None:
        return (to_sortable(keys, ascending),)
    return (sortable_from_bits(keys, logical_dtype, ascending),)


def keys_from_operands(ops, dtype, ascending: bool = True,
                       as_bits: bool = False) -> torch.Tensor:
    """Keys (or, with as_bits=True, their raw bits) from sorted operands."""
    (c,) = ops
    if as_bits:
        return bits_from_sortable(c, dtype, ascending)
    return from_sortable(c, dtype, ascending)


# ---------------------------------------------------------------------------
# NumPy versions (host-side model, used by the oracle and the seq engine)
# ---------------------------------------------------------------------------


def to_sortable_np(keys: np.ndarray, ascending: bool = True) -> np.ndarray:
    dtype = np.dtype(keys.dtype)
    udtype = common.unsigned_of(dtype)
    nbits = dtype.itemsize * 8
    sign, ones = _masks(nbits)

    if common.is_unsigned_int(dtype):
        u = keys.copy()
    elif common.is_signed_int(dtype):
        u = keys.view(udtype) ^ udtype.type(sign)
    elif common.is_float(dtype):
        b = keys.view(udtype)
        neg = (b >> udtype.type(nbits - 1)).astype(bool)
        mask = np.where(neg, udtype.type(ones), udtype.type(sign))
        u = b ^ mask
    else:
        raise TypeError(f"unsupported key dtype {dtype}")
    if not ascending:
        u = ~u
    return u.astype(udtype)


def from_sortable_np(u: np.ndarray, dtype, ascending: bool = True) -> np.ndarray:
    dtype = np.dtype(dtype)
    udtype = common.unsigned_of(dtype)
    nbits = dtype.itemsize * 8
    sign, ones = _masks(nbits)

    u = np.asarray(u, dtype=udtype)
    if not ascending:
        u = ~u
    if common.is_unsigned_int(dtype):
        return u.astype(dtype)
    if common.is_signed_int(dtype):
        return (u ^ udtype.type(sign)).view(dtype)
    if common.is_float(dtype):
        was_pos = (u >> udtype.type(nbits - 1)).astype(bool)
        mask = np.where(was_pos, udtype.type(sign), udtype.type(ones))
        return (u ^ mask).view(dtype)
    raise TypeError(f"unsupported key dtype {dtype}")


def sort_np(keys: np.ndarray, *payloads: np.ndarray, ascending: bool = True):
    """Scalar reference model: stable argsort on transformed keys (the
    reference's BitSorterSequential role, src/radix_sort.hpp:66-92)."""
    u = to_sortable_np(keys, ascending)
    perm = np.argsort(u, kind="stable")
    return (keys[perm],) + tuple(p[perm] for p in payloads)
