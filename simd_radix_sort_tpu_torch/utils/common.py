"""Core type utilities for the PyTorch/CUDA sort engine.

Counterpart of simd_radix_sort_tpu/utils/common.py: the dtype registry that
maps every supported key dtype to its same-width carrier, plus the torch
side of that registry and the device rule every public entry point follows.

Carriers are held as SIGNED torch integers of the key's width.  torch has
`uint16/32/64` only as storage types (no `>>`, `index_select` or `gather` on
the CPU), so an unsigned sortable value `u` is kept as `u ^ sign_bit` viewed
as a signed int: two's-complement order of that view equals unsigned order
of `u`.  Public outputs in an unsigned dtype are returned as
`torch.uint16/32/64` views of the signed result.
"""

from __future__ import annotations

import numpy as np
import torch

# The 10 key dtypes of the reference test matrix (src/test.cpp:156-168).
KEY_DTYPES = (
    np.dtype(np.uint8),
    np.dtype(np.uint16),
    np.dtype(np.uint32),
    np.dtype(np.uint64),
    np.dtype(np.int8),
    np.dtype(np.int16),
    np.dtype(np.int32),
    np.dtype(np.int64),
    np.dtype(np.float32),
    np.dtype(np.float64),
)

# Payload dtypes are any fixed-width scalar.
PAYLOAD_DTYPES = KEY_DTYPES

_UNSIGNED_BY_WIDTH = {
    1: np.dtype(np.uint8),
    2: np.dtype(np.uint16),
    4: np.dtype(np.uint32),
    8: np.dtype(np.uint64),
}

# Labels follow the reference's type_name<T> convention
# (src/common.hpp:16-39).
TYPE_NAMES = {
    np.dtype(np.uint8): "uint8",
    np.dtype(np.uint16): "uint16",
    np.dtype(np.uint32): "uint32",
    np.dtype(np.uint64): "uint64",
    np.dtype(np.int8): "int8",
    np.dtype(np.int16): "int16",
    np.dtype(np.int32): "int32",
    np.dtype(np.int64): "int64",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}

NAME_TO_DTYPE = {v: k for k, v in TYPE_NAMES.items()}

TORCH_OF = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
NUMPY_OF = {v: k for k, v in TORCH_OF.items()}

SIGNED_BY_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return NUMPY_OF[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return TORCH_OF[np.dtype(dtype)]


def type_name(dtype) -> str:
    return TYPE_NAMES[np_dtype(dtype)]


def unsigned_of(dtype) -> np.dtype:
    """Same-width unsigned carrier dtype for a key dtype."""
    return _UNSIGNED_BY_WIDTH[np_dtype(dtype).itemsize]


def signed_of(dtype) -> torch.dtype:
    """Same-width signed torch dtype: the port's carrier type."""
    return SIGNED_BY_WIDTH[np_dtype(dtype).itemsize]


def is_signed_int(dtype) -> bool:
    return np_dtype(dtype).kind == "i"


def is_unsigned_int(dtype) -> bool:
    return np_dtype(dtype).kind == "u"


def is_float(dtype) -> bool:
    return np_dtype(dtype).kind == "f"


def key_bits(dtype) -> int:
    return np_dtype(dtype).itemsize * 8


def is_power_of_two(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def element_size(key_dtype, payload_dtypes) -> int:
    """Byte size of the combined-layout element (key first, then payloads),
    mirroring DataElement<K, Ps...> (src/data.hpp:25-40)."""
    return np_dtype(key_dtype).itemsize + sum(
        np_dtype(p).itemsize for p in payload_dtypes
    )


def as_signed(t: torch.Tensor) -> torch.Tensor:
    """Bit-identical signed view of an integer or float tensor."""
    return t.view(SIGNED_BY_WIDTH[t.element_size()])


def resolve_device(device=None) -> torch.device:
    """The device rule: None means "cuda".  A CUDA device on a machine
    without one raises; nothing falls back to the CPU unless the caller
    asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
