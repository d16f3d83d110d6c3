"""cub's radix sort of (key, value) pairs: the library sort that
xla_sort.sort_arrays runs for a call with exactly one payload stream.

No Pallas kernel is replaced and no kernel is written by hand.  The JAX
package hands the payload to `jax.lax.sort` as a non-key operand
(simd_radix_sort_tpu/ops/xla_sort.py, `sort_arrays`); `torch.sort` takes one
tensor, so through it a payload needs an index and a gather.  `sort_pairs`
sorts the keys and one value stream together.  For a CUDA tensor it calls
cub's `DeviceRadixSort::SortPairs` or `SortPairsDescending` through the C
entries of csrc/sort_pairs.cu (built by ops/_build.py) or raises; for a CPU
tensor it runs `sort_pairs_plain`, `torch.sort` of the keys' carrier with
an index and a gather by it, which the card's tests also hold the library
call against.

Keys are integers of 1 to 8 bytes, signed or unsigned, as cub takes them;
xla_sort hands floating keys over as their signed carrier
(utils/transforms.to_sortable).  Values are any dtype of 1, 2, 4 or 8 bytes,
moved as bits.  The sort is stable in both directions.  The entries pass
cub a 32-bit `num_items`, so a call sorts at most MAX_ITEMS pairs.

`LAUNCHES["sort_pairs"]` counts the library's sorts, one C call each.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import common, transforms
from . import _build

LAUNCHES = {"sort_pairs": 0}

MAX_ITEMS = 2**31 - 1  # the entries' int num_items
# csrc/sort_pairs.cu's key codes
KEY_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
             torch.uint32: 4, torch.int32: 5, torch.uint64: 6, torch.int64: 7}
VALUE_WIDTHS = (1, 2, 4, 8)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dtype not in KEY_CODES:
        raise TypeError(f"no pair sort of {keys.dtype} keys")
    if values.element_size() not in VALUE_WIDTHS:
        raise TypeError(f"no pair sort of {values.dtype} values")
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError("keys and values must be 1-D of one length")
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    if keys.device != values.device:
        raise ValueError("keys and values must be on one device")
    if keys.numel() > MAX_ITEMS:
        raise ValueError(f"at most {MAX_ITEMS} pairs a call")


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor,
                     descending: bool = False):
    """A stable `torch.sort` of the keys' carrier with its index, and the
    values gathered by the index: the order cub's pair sort gives."""
    dt = common.np_dtype(keys.dtype)
    c = transforms.sortable_from_bits(keys, dt, not descending)
    vals, idx = torch.sort(c, stable=True)
    keys_out = transforms.bits_from_sortable(vals, dt, not descending)
    return (keys_out.view(keys.dtype),
            common.as_signed(values).index_select(0, idx).view(values.dtype))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               descending: bool = False):
    """(keys, values) sorted by key, ascending or descending, each value
    beside its key and equal keys in their input order: new tensors, the
    inputs left as they are.  `keys` and `values` are contiguous 1-D
    tensors of one length on one device."""
    _check(keys, values)
    if not _build.on_cuda(keys):
        return sort_pairs_plain(keys, values, descending)
    n = keys.numel()
    keys_out, values_out = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return keys_out, values_out
    kind = (KEY_CODES[keys.dtype], values.element_size(), int(descending))
    temp_bytes = ctypes.c_size_t(0)
    _build.launch("srs_sort_pairs_temp_bytes", keys.device, *kind, n,
                  ctypes.byref(temp_bytes))
    temp = torch.empty(max(temp_bytes.value, 1), dtype=torch.uint8,
                       device=keys.device)
    _build.launch("srs_sort_pairs", keys.device, *kind, keys.data_ptr(),
                  keys_out.data_ptr(), values.data_ptr(),
                  values_out.data_ptr(), n, temp.data_ptr(), temp_bytes.value)
    LAUNCHES["sort_pairs"] += 1
    return keys_out, values_out
