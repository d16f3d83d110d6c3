"""Stable two-way partition of lock-step word streams by a mask (K5).

Counterpart of simd_radix_sort_tpu/ops/pallas_partition.py: the
reference's compress-store partition pass, the one primitive its radix sort
is built on.  `partition_pass` puts every mask=False row first and every
mask=True row after them, each side in input order.  For a CUDA tensor it
launches the hand-written kernel (csrc/partition_kernels.cu, built by
ops/_build.py) or raises; for a CPU tensor it runs `partition_pass_plain`,
which chip_smoke.py also holds the kernel against on the card.

The kernel moves 4- and 8-byte words as they are: the JAX version splits
8-byte values into two u32 words only because its kernel carries 16-bit
halves in f32 lanes.  `to_words` widens 1- and 2-byte payloads to 4-byte
words and `from_words` narrows them back, bit for bit.

`LAUNCHES["partition_pass"]` counts the kernel's launches: one per call
on a CUDA tensor (a count launch and a scatter launch).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import common
from . import _build, cuda_hist

LAUNCHES = {"partition_pass": 0}

# Rows per tile of the kernel: 256 threads x 16 rows.  A tile is a multiple
# of 256 rows and at most 4096 (csrc kMaxRowsPerThread).
PART_BLOCK = 4096
_MAX_STREAMS = 8  # streams one scatter launch moves (csrc kMaxStreams)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(streams, mask: torch.Tensor, block: int) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 or \
            not mask.is_contiguous():
        raise TypeError("expected a contiguous 1-D bool mask")
    if not streams:
        raise ValueError("partition_pass needs at least one stream")
    for s in streams:
        if s.dtype == torch.bool or s.element_size() not in (4, 8):
            raise TypeError(f"expected 4- or 8-byte word streams, got "
                            f"{s.dtype} (widen with to_words)")
        if s.shape != mask.shape or not s.is_contiguous():
            raise ValueError("streams must be contiguous and match the mask")
        if s.device != mask.device:
            raise ValueError("streams and mask must be on one device")
    if block % 256 or not 256 <= block <= PART_BLOCK:
        raise ValueError(f"block={block}: a multiple of 256 in "
                         f"[256, {PART_BLOCK}]")


def partition_pass_plain(streams, mask: torch.Tensor):
    order = torch.argsort(mask, stable=True)
    return [common.as_signed(s).index_select(0, order).view(s.dtype)
            for s in streams]


def partition_pass(streams, mask: torch.Tensor, *, block: int = PART_BLOCK):
    """Stable two-way partition of lock-step streams of 4- or 8-byte words
    (any dtype; bits are moved as they are) by a bool mask: all mask=False
    rows first, then all mask=True rows, both sides in input order.
    `block` is the kernel's tile in rows.  Returns a list of new tensors."""
    streams = list(streams)
    _check(streams, mask, block)
    if not _build.on_cuda(mask):
        return partition_pass_plain(streams, mask)
    n = mask.numel()
    outs = [torch.empty_like(s) for s in streams]
    if n == 0:
        return outs
    tiles = -(-n // block)
    counts = torch.empty(tiles, dtype=torch.int32, device=mask.device)
    _build.launch("srs_partition_count", mask.device, mask.data_ptr(), n,
                  block, counts.data_ptr())
    left_off = cuda_hist.prefix_counts(counts)
    for g in range(0, len(streams), _MAX_STREAMS):
        ins, group = streams[g:g + _MAX_STREAMS], outs[g:g + _MAX_STREAMS]
        k = len(ins)
        _build.launch(
            "srs_partition_scatter", mask.device, mask.data_ptr(), n, block,
            left_off.data_ptr(), k,
            (ctypes.c_void_p * k)(*(s.data_ptr() for s in ins)),
            (ctypes.c_void_p * k)(*(o.data_ptr() for o in group)),
            (ctypes.c_int * k)(*(s.element_size() for s in ins)))
    LAUNCHES["partition_pass"] += 1
    return outs


# ---------------------------------------------------------------------------
# word transport for streams of any dtype
# ---------------------------------------------------------------------------


def to_words(t: torch.Tensor):
    """A stream of any dtype as the word streams the kernel moves, plus the
    meta `from_words` needs (the dtype).  There is always one contiguous
    word stream: 1- and 2-byte values are zero-extended to int32, 4- and
    8-byte values are their signed views."""
    w = t.element_size()
    s = common.as_signed(t)
    if w < 4:
        s = s.to(torch.int32) & ((1 << (8 * w)) - 1)
    return [s.contiguous()], t.dtype


def from_words(words, meta) -> torch.Tensor:
    """Inverse of `to_words`."""
    (s,) = words
    w = torch.empty((), dtype=meta).element_size()
    return s.to(common.SIGNED_BY_WIDTH[w]).view(meta)
