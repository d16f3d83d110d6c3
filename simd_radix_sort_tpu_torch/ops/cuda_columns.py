"""Columns gathered by an index in groups (K10): the assembly of
`sort_multi`'s output.

No Pallas kernel is replaced.  The JAX package's `sort_multi` carries every
column through one variadic `jax.lax.sort` and gathers nothing
(simd_radix_sort_tpu/ops/sort.py); torch's sorts take one tensor, so the
port sorts the keys into a permutation and gathers the columns by it.  One
`index_select` a column reads a random 32-byte sector a row whatever the
column's width, and the index again.  `gather_columns` instead packs the
columns into groups of up to 32 bytes a row (`pack`, K10's first entry:
the columns read in order, written interleaved as staged rows) and gathers
each group's staged rows by the index into the group's columns
(`gather_split`, K10's second entry: the index read once, one staged row a
row, each field written to its own column).  A group of one column is
gathered straight from the column, as rows of its own width.  For CUDA
tensors the entries launch the hand-written kernels of
csrc/column_gather.cu (built by ops/_build.py) or raise; for CPU tensors
they run the plain versions (`pack_plain`, `gather_split_plain`: integer
views of the rows, `index_select` of the rows and their split), which the
card's tests also hold the kernels against.

The groups follow `plan_groups`, a pure function of the row count and the
columns' widths.  Outputs are fresh contiguous tensors of the input
dtypes, every bit as `index_select` gives it.

`LAUNCHES["column_pack"]` and `LAUNCHES["column_gather"]` count the two
entries' launches, one a call on CUDA tensors with at least one row.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import profiling
from . import _build, cuda_sort

LAUNCHES = {"column_pack": 0, "column_gather": 0}
ROW_BYTES = (4, 8, 16, 32)  # a staged row's sizes, csrc/column_gather.cu's
FIELD_WIDTHS = (1, 2, 4, 8)
MAX_FIELDS = 32  # csrc/column_gather.cu kMaxFields
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Group(NamedTuple):
    """Output columns gathered in one pass: their positions among the
    widths `plan_groups` was given, each one's byte offset in a staged row,
    and the row's size (a column's own width where the group is that
    column alone, gathered straight and not staged)."""
    columns: tuple
    offsets: tuple
    row_bytes: int

    @property
    def staged(self) -> bool:
        return len(self.columns) > 1


def index_bytes(n: int) -> int:
    """Bytes an index entry takes for n rows: int32 where cub's sorts can
    address the rows (n <= cuda_sort.MAX_ITEMS), else int64."""
    return 4 if n <= cuda_sort.MAX_ITEMS else 8


def narrow_index(perm: torch.Tensor) -> torch.Tensor:
    """The int64 permutation as `index_bytes` says: a new int32 copy (the
    caller drops the int64 one), or `perm` itself."""
    if index_bytes(perm.numel()) == 4:
        return perm.to(torch.int32)
    return perm


def staged_row(used: int) -> int:
    """The staged row that holds `used` bytes of fields: the least of
    ROW_BYTES at or above it."""
    return next(s for s in ROW_BYTES if s >= used)


def plan_groups(n: int, widths) -> tuple:
    """The groups `gather_columns` assembles n rows of columns of `widths`
    bytes in, the first width the first key's (whose carrier the caller
    held until its key passes ended).

    The columns are taken widest first (ties in their order) and each group
    filled greedily up to 32 bytes, its staged row padded to the next of 4,
    8, 16 and 32 bytes, so that every field sits at an offset that is a
    multiple of its width.  A group takes 32 bytes only if the live bytes
    (the outputs allocated so far, this group's included, its staged rows
    and the index) stay within n·(Σw + 16 + w₀), what the call held at its
    peak before its gathers were grouped (the outputs, the int64 permutation
    and the last key pass's int64 sort and carrier); else 16, then 8; else
    the widest column left alone, gathered straight from itself."""
    widths = [int(w) for w in widths]
    if any(w not in FIELD_WIDTHS for w in widths):
        raise ValueError(f"K10 moves fields of {FIELD_WIDTHS} bytes, "
                         f"not {widths}")
    if not widths:
        return ()
    limit = sum(widths) + 16 + widths[0]
    index = index_bytes(n)
    left = sorted(range(len(widths)), key=lambda i: -widths[i])
    done, groups = 0, []
    while left:
        for cap in (32, 16, 8):
            take, used = [], 0
            for i in left:
                if used + widths[i] <= cap:
                    take.append(i)
                    used += widths[i]
            staging = staged_row(used) if len(take) > 1 else 0
            if done + used + staging + index <= limit:
                break
        else:
            take, used = left[:1], widths[left[0]]
        offsets, off = [], 0
        for i in take:
            offsets.append(off)
            off += widths[i]
        groups.append(Group(tuple(take), tuple(offsets),
                            staged_row(used) if len(take) > 1 else used))
        left = [i for i in left if i not in take]
        done += used
    return tuple(groups)


def _byte_rows(col: torch.Tensor) -> torch.Tensor:
    """A 1-D column as (n, width) uint8 rows, its element stride kept."""
    return col.unsqueeze(1).view(torch.uint8)


def _check_fields(widths, offsets, row_bytes: int) -> None:
    """1 to MAX_FIELDS fields of FIELD_WIDTHS bytes, each at an offset that
    is a multiple of its width, inside the row and apart from the others."""
    if not 1 <= len(widths) <= MAX_FIELDS or len(offsets) != len(widths):
        raise ValueError(f"1 to {MAX_FIELDS} fields, one offset each")
    taken = set()
    for w, off in zip(widths, offsets):
        if w not in FIELD_WIDTHS or off % w or off < 0 \
                or off + w > row_bytes:
            raise ValueError(f"a {w}-byte field at offset {off} does not "
                             f"fit a {row_bytes}-byte row")
        span = set(range(off, off + w))
        if span & taken:
            raise ValueError("fields overlap")
        taken |= span


def pack_plain(columns, offsets, row_bytes: int) -> torch.Tensor:
    # rows and fields as the widest integers that tile them: no operation
    # on more elements than the rows hold words
    n, word = columns[0].shape[0], min(row_bytes, 8)
    staged = torch.zeros((n, row_bytes // word), dtype=_SIGNED[word],
                         device=columns[0].device).view(torch.uint8)
    for col, off in zip(columns, offsets):
        w = col.element_size()
        staged.view(_SIGNED[w])[:, off // w] = col.view(_SIGNED[w])
    return staged


def pack(columns, offsets, row_bytes: int) -> torch.Tensor:
    """The columns (1-D, one length, any dtype of 1, 2, 4 or 8 bytes, any
    element stride) interleaved as a new (n, row_bytes) uint8 tensor of
    staged rows: each column's bytes at its offset (a multiple of its
    width), the rest zero; row_bytes one of ROW_BYTES."""
    columns = list(columns)
    if row_bytes not in ROW_BYTES:
        raise ValueError(f"staged rows of {ROW_BYTES} bytes")
    _check_fields([c.element_size() for c in columns], offsets, row_bytes)
    if any(c.dim() != 1 or c.shape != columns[0].shape
           or c.device != columns[0].device for c in columns):
        raise ValueError("columns must be 1-D of one length on one device")
    if not _build.on_cuda(columns[0]):
        return pack_plain(columns, offsets, row_bytes)
    n, k = columns[0].shape[0], len(columns)
    staged = torch.empty((n, row_bytes), dtype=torch.uint8,
                         device=columns[0].device)
    if n == 0:
        return staged
    _build.launch("srs_column_pack", staged.device,
                  (ctypes.c_void_p * k)(*(c.data_ptr() for c in columns)),
                  (ctypes.c_longlong * k)(*(c.stride(0) for c in columns)),
                  (ctypes.c_int * k)(*(c.element_size() for c in columns)),
                  (ctypes.c_int * k)(*offsets), k, staged.data_ptr(),
                  row_bytes, n)
    LAUNCHES["column_pack"] += 1
    return staged


def _check_rows(rows: torch.Tensor, idx: torch.Tensor, dtypes,
                offsets) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.stride(1) != 1:
        raise TypeError("expected (rows, row_bytes) uint8 rows, each one "
                        "run of bytes")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise TypeError("expected a contiguous 1-D int32 or int64 index")
    if rows.device != idx.device:
        raise ValueError("rows and index must be on one device")
    if rows.shape[1] not in FIELD_WIDTHS + ROW_BYTES:
        raise ValueError(f"rows of {FIELD_WIDTHS + ROW_BYTES} bytes")
    align = min(rows.shape[1], 16)
    if rows.data_ptr() % align or rows.stride(0) % align:
        raise ValueError(f"rows of {rows.shape[1]} bytes must start and "
                         f"lie apart at multiples of {align} bytes")
    _check_fields([torch.empty((), dtype=d).element_size() for d in dtypes],
                  offsets, rows.shape[1])


def gather_split_plain(rows: torch.Tensor, idx: torch.Tensor, dtypes,
                       offsets) -> tuple:
    word = min(rows.shape[1], 8)
    picked = rows.view(_SIGNED[word]).index_select(0, idx).view(torch.uint8)
    out = tuple(torch.empty(idx.numel(), dtype=d, device=rows.device)
                for d in dtypes)
    for col, off in zip(out, offsets):
        w = col.element_size()
        col.view(_SIGNED[w]).copy_(picked.view(_SIGNED[w])[:, off // w])
    return out


def gather_split(rows: torch.Tensor, idx: torch.Tensor, dtypes,
                 offsets) -> tuple:
    """For each dtype, a new column whose element i is the field of that
    dtype at its offset in row idx[i] of `rows` ((m, row_bytes) uint8 rows,
    each one run of bytes, rows any stride apart: a `pack`'s staged rows,
    or a column as rows of its own bytes).  On a card the index is trusted
    (every entry a row of `rows`); the plain version raises on one that is
    not."""
    dtypes = list(dtypes)
    _check_rows(rows, idx, dtypes, offsets)
    if not _build.on_cuda(rows):
        return gather_split_plain(rows, idx, dtypes, offsets)
    n, k = idx.numel(), len(dtypes)
    outs = tuple(torch.empty(n, dtype=d, device=rows.device) for d in dtypes)
    if n == 0:
        return outs
    _build.launch("srs_column_gather", rows.device, rows.data_ptr(),
                  rows.stride(0), rows.shape[1], idx.data_ptr(),
                  idx.element_size(), n,
                  (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs)),
                  (ctypes.c_int * k)(*(o.element_size() for o in outs)),
                  (ctypes.c_int * k)(*offsets), k)
    LAUNCHES["column_gather"] += 1
    return outs


def gather_columns(columns, idx: torch.Tensor) -> tuple:
    """column[idx] for each of `columns` (1-D, one length, dtypes of 1, 2,
    4 or 8 bytes), in their order, group by group as `plan_groups(len(idx),
    widths)` plans them: each group's outputs allocated as it is gathered,
    its staged rows made for it and dropped after it.  While a profiler
    records, counts the groups (`column_gather.groups`, one gather a group)
    and the bytes of their staged rows (`column_gather.staged_bytes`)."""
    columns = list(columns)
    n = idx.numel()
    out = [None] * len(columns)
    for g in plan_groups(n, [c.element_size() for c in columns]):
        cols = [columns[i] for i in g.columns]
        if g.staged:
            rows = pack(cols, g.offsets, g.row_bytes)
            profiling.count("column_gather.staged_bytes", rows.numel())
        else:
            rows = _byte_rows(cols[0])
        got = gather_split(rows, idx, [c.dtype for c in cols], g.offsets)
        del rows
        profiling.count("column_gather.groups")
        for i, col in zip(g.columns, got):
            out[i] = col
    return tuple(out)
