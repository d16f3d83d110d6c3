"""Segmented inclusive scans (K7): the scans group_aggregate reads at each
group's last row.

No Pallas kernel is replaced: the JAX package scans (start flag, value)
pairs with `jax.lax.associative_scan` (simd_radix_sort_tpu/ops/hashagg.py,
`_segmented_scan`).  `segmented_scans` computes the same function.  For a
CUDA tensor it launches the hand-written kernel (csrc/scan_kernels.cu,
built by ops/_build.py) or raises; for a CPU tensor it runs
`segmented_scans_plain`, which tests/test_torch_scan_card.py also holds
the kernel against on the card.

The kernel is bound by bytes.  It is reduce-then-scan in three launches on
one stream (tile summaries, one block's scan of them, each tile's rows
again from its carry), so it reads every stream and the flags twice and
writes every stream once; no host sync, and every combination in an order
fixed by the shapes alone, so its output is the same bits from run to run.

`LAUNCHES["segmented_scan"]` counts the kernel's launches: one per group of
up to MAX_STREAMS streams of one dtype and op (one C call, its three passes).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

LAUNCHES = {"segmented_scan": 0}

TILE_ROWS = 4096   # rows a block of the kernel scans (csrc kTileRows)
MAX_STREAMS = 8    # streams one launch scans (csrc kMaxStreams)

OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_FLOATS = (torch.float64, torch.float32, torch.float16, torch.bfloat16)
_CARRIERS = (torch.int64, torch.int32, torch.int16, torch.int8)
_DTYPE_CODES = {dt: i for i, dt in enumerate(_FLOATS + _CARRIERS)}
_OP_CODES = {"sum": 0, "min": 1, "max": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(dtype: torch.dtype, op: str) -> bool:
    """Sums of floats; minimum and maximum of floats and of the signed
    integer carriers (utils/transforms.to_sortable)."""
    return op in OPS and (dtype in _FLOATS or
                          (dtype in _CARRIERS and op != "sum"))


def k7_bytes(n: int, streams: int, width: int) -> int:
    """Bytes one launch reads and writes: the n flag bytes twice, each
    stream's n values of `width` bytes read twice and written once.  The
    tile summaries (n / TILE_ROWS values a stream) are left out."""
    return 2 * n + 3 * streams * n * width


def _check(vals, starts: torch.Tensor, ops) -> None:
    if starts.dtype != torch.bool or starts.dim() != 1 or \
            not starts.is_contiguous():
        raise TypeError("expected a contiguous 1-D bool `starts`")
    if len(vals) != len(ops):
        raise ValueError("one op per value stream")
    for v, op in zip(vals, ops):
        if not supported(v.dtype, op):
            raise TypeError(f"no segmented {op!r} scan of {v.dtype}")
        if v.shape != starts.shape or not v.is_contiguous():
            raise ValueError("streams must be contiguous and match `starts`")
        if v.device != starts.device:
            raise ValueError("streams and `starts` must be on one device")


def segmented_scans_plain(vals, starts: torch.Tensor, ops):
    """Hillis-Steele doubling over (start flag, value) pairs with the JAX
    package's combiner, ceil(log2 n) passes: pass d combines row i with
    row i - d unless row i has already met its segment start."""
    out = [v.clone() for v in vals]
    spare = [torch.empty_like(v) for v in vals]  # each pass writes the other
    flag = starts.clone()
    d, n = 1, starts.numel()
    while out and d < n:
        open_ = ~flag[d:]
        for j, op in enumerate(ops):
            v, w = out[j], spare[j]
            w[:d] = v[:d]
            OPS[op](v[:-d], v[d:], out=w[d:])
            torch.where(open_, w[d:], v[d:], out=w[d:])
            out[j], spare[j] = w, v
        flag[d:] = flag[d:] | flag[:-d]
        d *= 2
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data is not 16-byte aligned (a view at
    an odd offset): the kernel loads 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def segmented_scans(vals, starts: torch.Tensor, ops):
    """Inclusive segmented scans of every value stream in `vals`, each with
    its op in `ops` ("sum", "min" or "max"), within segments that begin
    where `starts` is True (row 0 always begins one).  Minimum and maximum
    propagate NaN as `torch.minimum` and `torch.maximum` do.  Returns a
    list of new tensors, one per stream.

    On the card, streams of one dtype and op share launches (up to
    MAX_STREAMS a launch), and while a profiler records each launch adds 1
    to `hashagg.scan.k7_launches` and its `k7_bytes` to
    `hashagg.scan.k7_bytes`."""
    vals, ops = list(vals), list(ops)
    _check(vals, starts, ops)
    if not _build.on_cuda(starts):
        return segmented_scans_plain(vals, starts, ops)
    n = starts.numel()
    outs = [torch.empty_like(v) for v in vals]
    if n == 0 or not vals:
        return outs
    starts = _aligned(starts)
    tiles = -(-n // TILE_ROWS)
    groups: dict = {}
    for i, (v, op) in enumerate(zip(vals, ops)):
        groups.setdefault((v.dtype, op), []).append(i)
    for (dtype, op), members in groups.items():
        for g in range(0, len(members), MAX_STREAMS):
            part = members[g:g + MAX_STREAMS]
            k = len(part)
            ins = [_aligned(vals[i]) for i in part]
            carry = torch.empty((k, tiles), dtype=dtype, device=starts.device)
            has = torch.empty(tiles, dtype=torch.uint8, device=starts.device)
            _build.launch(
                "srs_segmented_scan", starts.device, starts.data_ptr(), n,
                _DTYPE_CODES[dtype], _OP_CODES[op], k,
                (ctypes.c_void_p * k)(*(t.data_ptr() for t in ins)),
                (ctypes.c_void_p * k)(*(outs[i].data_ptr() for i in part)),
                carry.data_ptr(), has.data_ptr())
            LAUNCHES["segmented_scan"] += 1
            profiling.count("hashagg.scan.k7_launches")
            profiling.count("hashagg.scan.k7_bytes",
                            k7_bytes(n, k, ins[0].element_size()))
    return outs
