"""Whole rows gathered by an index (K9): the assembly of `sort_packed`'s
output.

No Pallas kernel is replaced.  The JAX package assembles the combined
layout's output with XLA's gather of the payload bytes by the sorted index
and a concatenation of byte columns (simd_radix_sort_tpu/ops/sort.py).  A
row's key is its own leading bytes, so after the pair sort of (key, row
index) the sorted output is the rows in the index's order, and
`row_gather` writes it in one pass.  For a CUDA tensor it launches the
hand-written kernel of csrc/row_gather.cu (built by ops/_build.py) or
raises; for a CPU tensor it runs `row_gather_plain`, `index_select` of
whole rows, which the card's tests also hold the kernel against.

The kernel moves each row as vectors of `vector_width` bytes: the widest of
16, 8, 4, 2 and 1 that divides the row and both base addresses, so 16 at
64-byte rows, 8 at 24-byte rows and 1 at odd row sizes or on a view off
the source's alignment.

`LAUNCHES["row_gather"]` counts the kernel's launches, one a call on a
CUDA tensor with at least one row.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build

LAUNCHES = {"row_gather": 0}
WIDTHS = (16, 8, 4, 2, 1)  # csrc/row_gather.cu's vector widths, in bytes


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def vector_width(row_bytes: int, *addresses: int) -> int:
    """The widest of WIDTHS that divides `row_bytes` and every address."""
    return next(w for w in WIDTHS
                if all(x % w == 0 for x in (row_bytes, *addresses)))


def _check(rows: torch.Tensor, idx: torch.Tensor) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("expected an (n, row_bytes) uint8 matrix of rows")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError("expected a 1-D int64 index")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("rows and index must be contiguous")
    if rows.device != idx.device:
        raise ValueError("rows and index must be on one device")
    if rows.shape[1] < 1:
        raise ValueError("rows of at least one byte")


def row_gather_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rows.index_select(0, idx)


def row_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[idx]: a new (len(idx), row_bytes) uint8 tensor whose row i is
    row idx[i] of the contiguous uint8 matrix `rows`.  On a card the index
    is trusted (every entry a row of `rows`); the plain version raises on
    one that is not.  While a profiler records, counts the calls that
    launch the kernel (`row_gather.calls`) and those whose row size or
    source address forced vectors narrower than 16 bytes
    (`row_gather.narrow_calls`)."""
    _check(rows, idx)
    if not _build.on_cuda(rows):
        return row_gather_plain(rows, idx)
    row_bytes = rows.shape[1]
    out = torch.empty((idx.numel(), row_bytes), dtype=torch.uint8,
                      device=rows.device)
    if idx.numel() == 0:
        return out
    width = vector_width(row_bytes, rows.data_ptr(), out.data_ptr())
    _build.launch("srs_row_gather", rows.device, rows.data_ptr(),
                  out.data_ptr(), idx.data_ptr(), idx.numel(), row_bytes,
                  width)
    LAUNCHES["row_gather"] += 1
    profiling.count("row_gather.calls")
    if width < WIDTHS[0]:
        profiling.count("row_gather.narrow_calls")
    return out
