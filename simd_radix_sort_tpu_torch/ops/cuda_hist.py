"""Counting-sort kernels: histogram, min/max + residue histogram, the
tiny-range sort, the run fill and its packed uint8 form.

Counterpart of simd_radix_sort_tpu/ops/pallas_hist.py (K1-K4) and of
`fill_runs_packed` in scripts/u8_attack.py (K6).  Each wrapper checks
its inputs and allocates its outputs; for a CUDA tensor it launches its
hand-written kernel (csrc/hist_kernels.cu, built by ops/_build.py) or
raises, and for a CPU tensor it runs the plain PyTorch version defined
beside it.  The plain versions compute the same function on any device, and
tests/test_torch_kernels_card.py holds each kernel against its plain
version on the card.

Carriers are 1-, 2- or 4-byte integer tensors of any signedness; the
kernels read their raw bits as unsigned integers of that width.

`LAUNCHES[name]` counts the launches of each kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import common
from . import _build

LAUNCHES = {"histogram": 0, "minmax_hist16": 0, "tiny_sort16": 0,
            "fill_runs": 0, "fill_runs_packed": 0}

MAX_HIST_K = 1024   # K1 keeps k int32 counters in shared memory
MAX_FILL_K = 4096   # K4 keeps k + 1 int64 prefix counts in shared memory
MAX_PACKED_K = 256  # K6 writes one byte per row
FILL_TILE_BYTES = 8192  # output bytes a K3/K4/K6 block fills at a time
STATS_WORDS = 20  # K2's output: min, max, hist_mod[16], two words of its own
_MAX_N = (1 << 31) - 1  # counts are int32, as in the JAX package


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _mask(width: int) -> int:
    return (1 << (8 * width)) - 1


def _check_carrier(x: torch.Tensor, widths) -> None:
    if x.dtype.is_floating_point or x.dtype == torch.bool or \
            x.element_size() not in widths:
        raise TypeError(f"expected an integer carrier of {widths} bytes, "
                        f"got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("expected a contiguous 1-D tensor")
    if x.numel() > _MAX_N:
        raise ValueError(f"{x.numel()} rows exceed the int32 counts")


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    _build.launch(entry, device, *args)
    LAUNCHES[name] += 1


def _unsigned_bits(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a 1/2/4-byte carrier as non-negative int64."""
    return common.as_signed(x).to(torch.int64) & _mask(x.element_size())


def _from_bits(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in [0, 2^w) -> tensor of `dtype` (w bytes) with those
    bits."""
    w = torch.empty((), dtype=dtype).element_size()
    half = 1 << (8 * w - 1)
    signed = torch.where(v >= half, v - 2 * half, v)
    return signed.to(common.SIGNED_BY_WIDTH[w]).view(dtype)


def _paint_plain(cum: torch.Tensor, n: int, base, flip: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """out[i] = ((base + b(i)) mod 2^w) ^ flip, b(i) = #{j : cum[j+1] <= i}
    clamped to k - 1: the run fill both K3 and K4 paint."""
    k = cum.numel() - 1
    i = torch.arange(n, dtype=torch.int64, device=cum.device)
    b = torch.searchsorted(cum[1:].contiguous(), i, right=True)
    w = torch.empty((), dtype=dtype).element_size()
    v = ((base + b.clamp_max(k - 1)) & _mask(w)) ^ flip
    return _from_bits(v, dtype)


# ---------------------------------------------------------------------------
# K1: histogram
# ---------------------------------------------------------------------------


def histogram_plain(values: torch.Tensor, k: int, base: int = 0) -> torch.Tensor:
    off = (_unsigned_bits(values) - base) & _mask(values.element_size())
    return torch.bincount(off[off < k], minlength=k).to(torch.int32)


def histogram(values: torch.Tensor, k: int, base: int = 0) -> torch.Tensor:
    """hist[b] = #{i : (values_i - base) mod 2^w == b} for b in [0, k),
    w the carrier's width in bits; other values are dropped.  With int32
    values and base 0 this is pallas_hist.histogram: negative values and
    values >= k are dropped.  Returns (k,) int32."""
    _check_carrier(values, (1, 2, 4))
    if not 1 <= k <= MAX_HIST_K:
        raise ValueError(f"k={k} outside [1, {MAX_HIST_K}]")
    base &= _mask(values.element_size())
    if not _build.on_cuda(values):
        return histogram_plain(values, k, base)
    out = torch.zeros(k, dtype=torch.int32, device=values.device)
    if values.numel():
        _launch("histogram", "srs_histogram", values.device,
                values.data_ptr(), values.element_size(), values.numel(),
                base, k, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K2: min, max and residue histogram in one pass
# ---------------------------------------------------------------------------


def minmax_hist16_plain(x: torch.Tensor, flip: int = 0):
    u = _unsigned_bits(x) ^ flip
    hist = torch.bincount(u & 15, minlength=16).to(torch.int32)
    return u.min(), u.max(), hist


def _empty_stats(device):
    z = torch.zeros((), dtype=torch.int64, device=device)
    return z, z.clone(), torch.zeros(16, dtype=torch.int32, device=device)


def _minmax_stats(x: torch.Tensor, flip: int) -> torch.Tensor:
    """Launch K2: (STATS_WORDS,) int32 words, the first 18 holding u32 min,
    max, hist_mod[16]."""
    stats = torch.empty(STATS_WORDS, dtype=torch.int32, device=x.device)
    _launch("minmax_hist16", "srs_minmax_hist16", x.device, x.data_ptr(),
            x.element_size(), x.numel(), flip, stats.data_ptr())
    return stats


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values as int64, in one operation (a
    call at the count engine's smaller sizes is bound by its host work)."""
    return words.view(torch.uint32).to(torch.int64)


def minmax_hist16(x: torch.Tensor, flip: int = 0):
    """(min, max, hist_mod) of u = x ^ flip (the 2- or 4-byte carrier's
    bits, zero-extended) in one pass: min and max as int64 0-dim tensors,
    hist_mod[b] = #{i : u_i & 15 == b} as (16,) int32.  With a uint32
    carrier and flip 0 this is pallas_hist.minmax_hist16.  When
    max - min < 16 the true histogram is hist[j] = hist_mod[(min + j) & 15].
    For n = 0 it returns (0, 0, zeros)."""
    _check_carrier(x, (2, 4))
    flip &= _mask(x.element_size())
    if not x.numel():
        return _empty_stats(x.device)
    if not _build.on_cuda(x):
        return minmax_hist16_plain(x, flip)
    stats = _minmax_stats(x, flip)
    mm = _u32(stats[:2])
    return mm[0], mm[1], stats[2:18]


# ---------------------------------------------------------------------------
# K3: tiny-range counting sort
# ---------------------------------------------------------------------------


def tiny_sort16_plain(x: torch.Tensor, flip: int = 0):
    mn, mx, hist_mod = minmax_hist16_plain(x, flip)
    j = torch.arange(16, dtype=torch.int64, device=x.device)
    counts = hist_mod.to(torch.int64)[(mn + j) & 15]
    cum = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return _paint_plain(cum, x.numel(), mn, flip, x.dtype), mn, mx


def tiny_sort16(x: torch.Tensor, flip: int = 0):
    """Tiny-range counting sort of a 2- or 4-byte carrier ordered by
    u = x ^ flip.  Returns (sorted, min, max) with min and max of u as
    int64 0-dim tensors, always exact.  `sorted` is the carrier of
    hist[j] copies of min + j (j < 16), and equals the sorted input only
    when max - min < 16: callers gate on min and max.  With a uint32
    carrier and flip 0 this is pallas_hist.tiny_sort16.

    On the card it is two launches on one stream, K2 then a fill that
    reads K2's stats from device memory: no host round trip between them."""
    _check_carrier(x, (2, 4))
    flip &= _mask(x.element_size())
    if not x.numel():
        mn, mx, _ = _empty_stats(x.device)
        return x.clone(), mn, mx
    if not _build.on_cuda(x):
        return tiny_sort16_plain(x, flip)
    stats = _minmax_stats(x, flip)
    out = torch.empty_like(x)
    _launch("tiny_sort16", "srs_fill16", x.device, stats.data_ptr(),
            x.element_size(), x.numel(), flip, FILL_TILE_BYTES,
            out.data_ptr())
    mm = _u32(stats[:2])
    return out, mm[0], mm[1]


# ---------------------------------------------------------------------------
# K4: run fill
# ---------------------------------------------------------------------------


def prefix_counts(hist: torch.Tensor) -> torch.Tensor:
    """(k + 1,) int64 exclusive prefix sums of int32 counts, with the total
    last (cum[0] = 0): int64 so that more than 2^31 rows cannot overflow.
    The plain fills use it; the kernels build the same prefix themselves."""
    return torch.cat([hist.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(hist, 0, dtype=torch.int64)])


def fill_runs_plain(hist: torch.Tensor, n: int, base: int,
                    dtype) -> torch.Tensor:
    dtype = common.torch_dtype(dtype)
    return _paint_plain(prefix_counts(hist), n, base, 0, dtype)


def fill_runs(hist: torch.Tensor, n: int, base: int, dtype) -> torch.Tensor:
    """Expand a histogram into the sorted carrier: the concatenation over b
    of hist[b] copies of (base + b) mod 2^w, as an (n,) tensor of the 1-,
    2- or 4-byte integer `dtype`.  Requires sum(hist) == n; positions past
    the last run repeat the last bucket.  On the card this is one launch,
    which builds the prefix of `hist` itself."""
    dtype = common.torch_dtype(dtype)
    w = dtype.itemsize
    if dtype.is_floating_point or w not in (1, 2, 4):
        raise TypeError(f"unsupported fill dtype {dtype}")
    if hist.dtype != torch.int32 or hist.dim() != 1:
        raise TypeError("expected a 1-D int32 histogram")
    k = hist.numel()
    if not 1 <= k <= MAX_FILL_K:
        raise ValueError(f"k={k} outside [1, {MAX_FILL_K}]")
    base &= _mask(w)
    if not _build.on_cuda(hist):
        return fill_runs_plain(hist, n, base, dtype)
    hist = hist.contiguous()
    out = torch.empty(n, dtype=dtype, device=hist.device)
    if n:
        _launch("fill_runs", "srs_fill_runs", hist.device, hist.data_ptr(),
                k, n, base, w, FILL_TILE_BYTES, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6: packed uint8 run fill
# ---------------------------------------------------------------------------


def fill_runs_packed_plain(hist: torch.Tensor, n: int) -> torch.Tensor:
    return _paint_plain(prefix_counts(hist), n, 0, 0, torch.uint8)


def fill_runs_packed(hist: torch.Tensor, n: int) -> torch.Tensor:
    """The uint8 run fill written as packed u32 words: an (n,) uint8
    tensor of hist[b] copies of b for a histogram of at most 256 buckets,
    equal to fill_runs(hist, n, 0, torch.uint8).  n must be a multiple of
    4, as in the JAX version.  Requires sum(hist) == n; positions past the
    last run repeat the last bucket.  On the card this is one launch."""
    if n % 4:
        raise ValueError(f"n={n} is not a multiple of 4")
    if hist.dtype != torch.int32 or hist.dim() != 1:
        raise TypeError("expected a 1-D int32 histogram")
    k = hist.numel()
    if not 1 <= k <= MAX_PACKED_K:
        raise ValueError(f"k={k} outside [1, {MAX_PACKED_K}]")
    if not _build.on_cuda(hist):
        return fill_runs_packed_plain(hist, n)
    hist = hist.contiguous()
    out = torch.empty(n, dtype=torch.uint8, device=hist.device)
    if n:
        _launch("fill_runs_packed", "srs_fill_runs_packed", hist.device,
                hist.data_ptr(), k, n, FILL_TILE_BYTES, out.data_ptr())
    return out


def tile_edge_cases(width: int, k_max: int = MAX_FILL_K) -> dict:
    """label -> (hist, n): histograms whose runs meet the edges of the fill
    kernels' tiles (FILL_TILE_BYTES of output, here in elements of `width`
    bytes), for holding K4 and K6 against their plain versions.  `hist` is a
    NumPy int32 array of at most `k_max` buckets.  Every case but "sum below
    n" has sum(hist) == n."""
    e = FILL_TILE_BYTES // width
    rng = np.random.default_rng(width)
    cuts = sorted({m * e + d for m in (1, 2) for d in (-15, -1, 0, 1, 15)})
    short = rng.integers(1, 4, k_max)
    cases = {
        # run boundaries at the tile edges, and at +-1 and +-15 around them
        "tile edges": np.diff([0, *cuts, 3 * e + 5]),
        "one run": np.array([2 * e + 3]),
        # a boundary every 1-3 elements: many in every vector
        "k max, short runs": short,
        # empty buckets before, after and at the tile edges
        "empty buckets at edges": np.array([0, e - 3, 0, 0, 0, 5, 0, 0,
                                            e - 2, 0, 0, 9, 0]),
        "below one tile": np.bincount(rng.integers(0, 7, e // 2 + 3)),
        # not a multiple of 16 elements
        "ragged tail": np.bincount(rng.integers(0, 5, 2 * e + 13)),
    }
    out = {label: (h.astype(np.int32), int(h.sum()))
           for label, h in cases.items()}
    # positions past sum(hist) repeat the last bucket, over whole tiles
    out["sum below n"] = (np.array([e + 7, 3], np.int32), 3 * e + 5)
    return out


def k23_edge_cases(width: int, big: int = 70_000) -> dict:
    """label -> (carrier, flip, start): inputs that reach every path of K2
    and K3 on a `width`-byte carrier (a NumPy int16 or int32 array, read
    from `start`: 1 puts the first row 2 or 4 bytes past 16-byte
    alignment), each with flip 0 and with the sign flip.  Rows are
    u = carrier ^ flip: all-equal vectors and vectors with one differing
    row; 0 and the width's maximum in the low and the high half of a 32-bit
    word; the min in the last row; n = 1-17 and ragged tails; a misaligned
    start; `big` rows of one residue in no all-equal vector (more than a
    16-bit or a packed per-thread counter holds); ranges of 16 and wider."""
    mask = (1 << (8 * width)) - 1
    per = 16 // width
    rng = np.random.default_rng(100 + width)

    def small(n, lo=0x1230):  # a range below 16
        return lo + rng.integers(0, 16, n)

    one_off = np.full(per * 64, 0x5A5A)
    one_off[np.arange(64) * per + np.arange(64) % per] += 3
    last_min = small(4 * per, 0x7001) + 1
    last_min[-1] = 0x7001
    cases = {
        "all-equal vectors": (np.full(per * 40, 0x3C3C), 0),
        "one differing row a vector": (one_off, 0),
        "0 low, max high": (np.tile([0, mask], per * 8), 0),
        "max low, 0 high": (np.tile([mask, 0], per * 8 + 1), 0),
        "min in the last row": (last_min, 0),
        "min in the last row of a ragged tail": (
            np.append(last_min + 1, 0x7001), 0),
        "ragged tail": (small(per * 100 + per - 1), 0),
        "misaligned start": (small(per * 50 + 1), 1),
        f"{big} rows of one residue": (
            0x40 + 16 * rng.integers(0, 4, big), 0),
        "range 16": (small(3000, mask - 15), 0),
        "full range": (rng.integers(0, mask + 1, 2 * per + 1), 0),
    }
    for n in range(1, 18):
        cases[f"n={n}"] = (small(n), 0)
    itype = {2: np.int16, 4: np.int32}[width]
    utype = {2: np.uint16, 4: np.uint32}[width]
    out = {}
    for label, (u, start) in cases.items():
        u = np.asarray(u, np.int64) & mask
        for name, flip in (("flip 0", 0), ("sign flip", mask // 2 + 1)):
            carrier = (u ^ flip).astype(utype).view(itype)
            out[f"{label}, {name}"] = (carrier, flip, start)
    return out
