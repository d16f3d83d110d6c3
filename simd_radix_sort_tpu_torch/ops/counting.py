"""Counting / histogram sort for keys-only integer keys of 32 bits or fewer.

Counterpart of simd_radix_sort_tpu/ops/counting.py.  For keys-only sorts
the sorted output is determined by the histogram, so no element moves:
a histogram pass and a run fill replace the sort.

  * 1-byte keys: a fixed 256-bucket histogram (K1) and the run fill (K4).
  * 2- and 4-byte keys: the tiny-range sort (K3, which includes K2) first;
    it returns exact min and max.  Range < 16: its output is the answer.
    Otherwise, at n >= SMALL_MIN_N and range < 1024: K1 with 1024 buckets
    and K4.  Otherwise: the comparison sort.

This is the TPU branch of the JAX engine (counting.py:185-217), taken on
every device: a CPU tensor runs the same control flow through the plain
versions of the kernels.  The branch is chosen on the host from min and
max, read back once per call (one device sync).  The JAX package's
`mxu_histogram` (an einsum on the TPU's matrix unit, not a Pallas kernel)
has no counterpart: K1 serves k = 256 and 1024 in its place.

The thresholds are the H100's: campaign part g (workloads/campaign.py)
timed the 1024-bucket branch against the comparison-sort fallback and
`xla` on an NVIDIA H100 80GB HBM3 at 700.00 W, and
tests/test_torch_branch_gates.py holds each to its table by the rule
stated beside it.
"""

from __future__ import annotations

import torch

from ..utils import common, profiling, transforms
from . import cuda_hist

# Bucket budget of the adaptive branch: K1's limit (cuda_hist.MAX_HIST_K).
# Rule: it stays at the limit if the branch beats the fallback at the
# widest span part g draws, 1023, at every row from SMALL_MIN_N.  It does
# (bench_out_h100/large_n/gate-<type>-Span1023.dat, NVIDIA H100 80GB HBM3,
# 700.00 W, after K2's and K3's redesign): branch/fallback 0.30-0.48 at
# 2^24 rows and 0.15-0.24 at 2^27 over int16, uint16, int32 and uint32.
K_MAX_RANGE = 1024
# Below this size the adaptive path skips from tiny-range straight to the
# comparison sort; "auto" sends no 2- or 4-byte keys to count below it
# (methods.COUNT_MIN_N_ADAPTIVE*).  Rule: the smallest power of two from
# which no row of any large_n/gate-<type>-<shape>.dat (int16, uint16,
# int32, uint32; Uniform, Zipf, OneValue; 2^14..2^27 rows, 5 rounds of the
# columns in turns; NVIDIA H100 80GB HBM3, 700.00 W) shows the branch
# resolvably slower than the fallback: its median above the fallback's
# with its fastest round slower than the fallback's slowest (the rounds
# are in bench_out_h100/logs/campaign-gate-<type>.out).  Since K2's and
# K3's redesign no row does, so the rule gives the smallest swept size:
# below 2^24 a call is host-bound and branch/fallback runs 0.33-1.40 with
# the rounds overlapping wherever the branch's median is the higher; from
# 2^24 it is 0.15-0.61.  It was 2^22 before the redesign (int16 OneValue
# at 2^21, 1.07x, rounds apart); the TPU's value was 2^21.
SMALL_MIN_N = 1 << 14
# Width of the tiny-range sort's residue histogram.
K_TINY_RANGE = 16


def counting_sort_carrier(c: torch.Tensor, k: int, base: int) -> torch.Tensor:
    """Sort a carrier whose raw bits all lie in [base, base + k) modulo
    2^w: a histogram pass and a run fill."""
    hist = cuda_hist.histogram(c, k, base)
    return cuda_hist.fill_runs(hist, c.shape[0], base, c.dtype)


def sort_keys(keys: torch.Tensor, ascending: bool = True):
    """Keys-only sort: fixed 256-bucket counting for 1-byte keys, adaptive
    range counting with comparison-sort fallback for 2- and 4-byte keys.
    Returns (sorted_keys, ())."""
    dtype = common.np_dtype(keys.dtype)
    n = keys.shape[0]
    if n == 0:
        return keys, ()
    c = transforms.to_sortable(keys, ascending)
    # the carrier holds u ^ sign; offsets are taken modulo 2^w, so the
    # carrier of unsigned value v is simply v ^ sign
    sign = 1 << (8 * dtype.itemsize - 1)
    if dtype.itemsize == 1:
        with profiling.span("srs.count.u8"):
            out = counting_sort_carrier(c, 256, sign)
    else:
        with profiling.span("srs.count.tiny"):
            sorted_c, mn, mx = cuda_hist.tiny_sort16(c, flip=sign)
        with profiling.span("srs.count.range"):
            profiling.count("host_syncs.count.range")
            lo, hi = torch.stack((mn, mx)).tolist()  # the one host sync
        if hi - lo < K_TINY_RANGE:
            out = sorted_c
        elif n >= SMALL_MIN_N and hi - lo < K_MAX_RANGE:
            with profiling.span("srs.count.k1024"):
                out = counting_sort_carrier(c, K_MAX_RANGE, lo ^ sign)
        else:
            with profiling.span("srs.count.fallback"):
                out = torch.sort(c).values
    return transforms.from_sortable(out, dtype, ascending), ()


def supports(key_dtype, payload_dtypes, n) -> bool:
    """Capability predicate: keys-only integer keys up to 32 bits, any n."""
    if payload_dtypes:
        return False
    dt = common.np_dtype(key_dtype)
    return dt.kind in "ui" and dt.itemsize <= 4
