"""Analytic NVLink/InfiniBand scaling model for the distributed splitter sort.

Counterpart of simd_radix_sort_tpu/models/scaling.py, with the same phase
model and the H100's constants.  It prices every phase of
`parallel.dist_sort` (local sort -> splitter gather -> all-to-all -> final
sort) and of `parallel.multihost.hierarchical_sort` (the extra
between-hosts tier) from

  * the MEASURED single-card sort: case (a) of chip_smoke.py, u64 key +
    u64 payload at 10^8 rows on one H100 (`torch.sort` on the carrier plus
    one gather), local time scaled as c * n * log2(n);
  * the MEASURED blocked final pass, collective latency and exchange rates
    (chip_smoke.py phase 6); and
  * NVIDIA's published NVLink and InfiniBand figures, derated by an
    explicit achievable-fraction knob rather than silently: no machine
    this was measured on joins two cards by a link, so they are
    specification figures, not measurements.

Phase accounting mirrors `dist_sort.splitter_sort_core`:

  1. local sort of the n/P-row shard          -> t_sort(n/P)
  2. sample + all_gather splitters            -> latency-dominated term
  3. all-to-all: uniform keys send (P-1)/P of the shard's bytes over
     NVLink (each row leaves its source with prob (P-1)/P)
  4. final local sort of the received shard   -> t_sort(n/P * slack)

The model keeps the JAX package's form exactly (phase 4 priced as a sort of
the capacity_factor-padded receive buffer), so both packages' functions
agree to rounding under the same constants.  The port's final pass sorts
only the valid prefix; the constants absorb that: the blocked rate below
is stated in padded rows per second.

`final_mode="blocked"` models the segment-aligned exchange variant (K
key-range segments per rank, each sorted on its own in the final pass).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Interconnect figures for one system.

    ici_gbps: published per-GPU aggregate scale-up bandwidth, Gbit/s, both
      directions (the JAX package's name for the TPU's ICI; here NVLink 4
      on an HGX H100: 18 links, 900 GB/s bidirectional = 7200 Gbit/s).
      all_to_all effective throughput per GPU is `ici_gbps/8 * ici_frac`
      GB/s: half of the published figure is one direction, and an
      all-to-all through NVSwitch sustains a fraction of that; both are
      folded into ici_frac, an assumed derate.
    dcn_gbps_per_host: scale-out NIC bandwidth per host (HGX H100: one
      400 Gb/s NDR InfiniBand adapter per GPU, 8 a host).
    """

    name: str
    ici_gbps: float
    ici_frac: float
    dcn_gbps_per_host: float
    chips_per_host: int

    @property
    def ici_bytes_per_s(self) -> float:
        return self.ici_gbps / 8 * 1e9 * self.ici_frac

    @property
    def dcn_bytes_per_s_per_chip(self) -> float:
        return self.dcn_gbps_per_host / 8 * 1e9 / self.chips_per_host


# NVIDIA specification figures (HGX H100 data sheet: NVLink 4 at 900 GB/s
# per GPU; ConnectX-7 NDR at 400 Gb/s, one per GPU), NOT measurements.  The
# 0.4 derate is the JAX model's assumption (0.8 of one direction), not
# measured either.
LINKS = {
    "hgx-h100": LinkSpec("hgx-h100", 7200.0, 0.4, 3200.0, 8),
}

# Measured single-card anchor: case (a), u64 key + u64 payload, 10^8 rows,
# sort(method="auto") -> xla, median of 5 event-timed calls.
MEASURED_ANCHOR = {
    "rows_per_s": 1e8 / 17.578304290771484e-3,
    "n": 1e8,
    "row_bytes": 16,
    "provenance": "chip_smoke.py case (a), NVIDIA H100 80GB HBM3 at "
                  "700.00 W: 17.578304290771484 ms (PERF.md §6, the "
                  "measurement layer's run 2)",
}

# Measured communication constants (chip_smoke.py phase 6, NVIDIA H100
# 80GB HBM3 at 700.00 W, PERF.md §6, the measurement layer's run 2):
#   * collective_latency_s_nccl: one int32 all_reduce in a 64-deep
#     dependent chain on an NCCL group of ONE rank, issued from the host
#     (no link is crossed: this is the c10d call and NCCL's launch and
#     kernel floor, not a link latency);
#   * nccl_self_exchange_bytes_per_s: `all_to_all_single` of (n, 16) int8
#     rows to itself at P = 1: a device copy, not a link;
#   * gloo_bytes_per_s_per_proc / collective_latency_s_gloo: two Gloo
#     ranks, two processes on the chip machine's CPU (loopback), running
#     `dist_sort.exchange_by_bounds` on 2^22 u64+u64 rows each, and a
#     64-deep all_reduce chain: a HOST figure, the software floor of the
#     cross-process path, not a NIC.  The rate is fitted to
#     multiproc_exchange_seconds' accounting ((P-1) * n_local * row_bytes
#     over the measured wall time).
MEASURED_COMM = {
    "collective_latency_s_nccl": 0.00010304850339889526,
    "nccl_self_exchange_bytes_per_s": 1240048612354.5376,
    "gloo_bytes_per_s_per_proc": 800650782.2625437,
    "collective_latency_s_gloo": 0.0011000006093748738,
    "provenance": "chip_smoke.py phase 6, NVIDIA H100 80GB HBM3 at "
                  "700.00 W; the Gloo ranks on that machine's CPU "
                  "(PERF.md §6, the measurement layer's run 2)",
}


def multiproc_exchange_seconds(n_local: float, num_procs: int,
                               row_bytes: int = 16) -> float:
    """Predicted exchange WALL time of the multi-process Gloo path on one
    host (fitted rate is the effective wall rate per process)."""
    cross = (num_procs - 1) * n_local * row_bytes
    return cross / MEASURED_COMM["gloo_bytes_per_s_per_proc"]


def dcn_required_for_clause(n_per_chip: float = 1e8, row_bytes: int = 16,
                            num_slices: int = 2, chips_per_slice: int = 8,
                            target_eff: float = 0.80,
                            capacity_factor: float = 2.0,
                            final_mode: str = "sort",
                            link: "LinkSpec | None" = None,
                            anchor: dict | None = None) -> float:
    """The between-hosts bytes/s/GPU at which the weak-scaling clause
    (eff >= target at `num_slices` hosts vs 1 host) exactly holds: the
    prediction restated as a falsifiable THRESHOLD.  Measured constants
    price every term except the NIC, and a real 2-host run settles which
    side of this number the hardware lands on.  The NDR specification
    gives 50e9 B/s/GPU."""
    link = link or LINKS["hgx-h100"]
    base = hierarchical_sort_phases(
        n_per_chip * chips_per_slice, 1, chips_per_slice, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor)
    multi = hierarchical_sort_phases(
        n_per_chip * num_slices * chips_per_slice, num_slices,
        chips_per_slice, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor)
    # T_multi(B) = (multi.total_s - t_dcn_at_link) + dcn_bytes / B
    dcn_bytes = n_per_chip * row_bytes * (num_slices - 1) / num_slices
    t_dcn_at_link = dcn_bytes / link.dcn_bytes_per_s_per_chip
    t_fixed = multi.total_s - t_dcn_at_link
    t_budget = base.total_s / target_eff - t_fixed
    if t_budget <= 0:
        return float("inf")
    return dcn_bytes / t_budget


# Measured blocked final pass (chip_smoke.py phase 6): case (q)'s blocked
# shape at P = 1, 8 segments of 2.5·10^7 padded rows (capacity factor 2,
# each half filled with u64+u64 rows of its key range), each segment's
# valid prefix sorted as `dist_sort._sort_prefix` does; the rate counts
# padded rows, the model's unit (2·10^8 padded rows in 17.66 ms, the
# same run).  A radix sort's time is linear in n, so on the card the blocked
# pass is no faster per row than the full sort (the TPU's batched block
# sorts were 6x faster than its full sort).
BLOCKED_SORT_ROWS_PER_S = 11326485366.020954

# Per-collective latency floor (seconds): the measured NCCL chain above.
COLLECTIVE_LATENCY_S = MEASURED_COMM["collective_latency_s_nccl"]


def sort_seconds(n: float, anchor: dict | None = None) -> float:
    """Compare-bound local sort time: c * n * log2(n), c calibrated from
    the measured anchor."""
    a = anchor or MEASURED_ANCHOR
    c = (1.0 / a["rows_per_s"]) / math.log2(a["n"])
    n = max(float(n), 2.0)
    return c * n * math.log2(n)


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    local_sort_s: float
    splitter_s: float
    exchange_s: float
    final_sort_s: float

    @property
    def total_s(self) -> float:
        return (self.local_sort_s + self.splitter_s + self.exchange_s
                + self.final_sort_s)


def distributed_sort_phases(n_global: float, num_chips: int,
                            row_bytes: int = 16,
                            link: LinkSpec | None = None,
                            capacity_factor: float = 2.0,
                            dcn_fraction_of_chips: float = 0.0,
                            final_mode: str = "sort",
                            anchor: dict | None = None) -> PhaseBreakdown:
    """Phase times for `distributed_sort` over `num_chips` GPUs: the final
    pass priced as a sort of the capacity_factor-padded receive buffer,
    including at P=1.

    final_mode: "sort" = one sort of the receive buffer; "blocked" = the
    segment-aligned variant (at the measured BLOCKED_SORT_ROWS_PER_S).

    dcn_fraction_of_chips > 0 models the hierarchical case: that fraction
    of each shard's exchanged bytes crosses InfiniBand (at the per-GPU
    share) instead of NVLink.  For the flat sort inside one host it is 0;
    for S hosts phase 1 ships (S-1)/S of the rows between hosts once
    (multihost.py's "every row crosses between slices at most once").
    """
    link = link or LINKS["hgx-h100"]
    P = max(int(num_chips), 1)
    n_local = n_global / P

    t_sort1 = sort_seconds(n_local, anchor)
    # splitter sample gather + size-matrix all_gather: 3 latency-bound
    # collectives (sample gather, bounds search is local, size matrix)
    t_split = 3 * COLLECTIVE_LATENCY_S * max(math.log2(P), 1.0)
    sent_bytes = n_local * row_bytes * (P - 1) / P
    ici_bytes = sent_bytes * (1.0 - dcn_fraction_of_chips)
    dcn_bytes = sent_bytes * dcn_fraction_of_chips
    t_exch = (ici_bytes / link.ici_bytes_per_s
              + dcn_bytes / link.dcn_bytes_per_s_per_chip)
    if P == 1:
        t_exch = 0.0
    cap = n_local * capacity_factor
    if final_mode == "blocked":
        t_sort2 = cap / BLOCKED_SORT_ROWS_PER_S
    else:
        t_sort2 = sort_seconds(cap, anchor)
    return PhaseBreakdown(t_sort1, t_split, t_exch, t_sort2)


def hierarchical_sort_phases(n_global: float, num_slices: int,
                             chips_per_slice: int, row_bytes: int = 16,
                             link: LinkSpec | None = None,
                             capacity_factor: float = 2.0,
                             final_mode: str = "sort",
                             anchor: dict | None = None) -> PhaseBreakdown:
    """Two-tier (InfiniBand x NVLink) sort: phase 1 moves (S-1)/S of the
    rows between hosts once; phase 2 is a flat NVLink sort within each
    host."""
    link = link or LINKS["hgx-h100"]
    S = max(int(num_slices), 1)
    P = S * chips_per_slice
    n_local = n_global / P

    dcn_bytes = n_local * row_bytes * (S - 1) / S
    t_dcn = dcn_bytes / link.dcn_bytes_per_s_per_chip if S > 1 else 0.0
    inner = distributed_sort_phases(
        n_global / S, chips_per_slice, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor)
    return PhaseBreakdown(inner.local_sort_s,
                          inner.splitter_s + 2 * COLLECTIVE_LATENCY_S * S,
                          inner.exchange_s + t_dcn,
                          inner.final_sort_s)


def scaling_efficiency(n_global: float, num_chips: int,
                       row_bytes: int = 16,
                       link: LinkSpec | None = None,
                       baseline: str = "distributed_p1",
                       capacity_factor: float = 2.0,
                       final_mode: str = "sort",
                       anchor: dict | None = None) -> float:
    """Strong-scaling efficiency T(1) / (P * T(P)).

    baseline="distributed_p1": T(1) is the distributed code at P=1 (the
      conventional scaling-curve baseline; same two-sort shape, no
      exchange).
    baseline="single_chip": T(1) is the plain single-card sort: the
      per-card cost of going distributed; the padded second sort puts it
      near 1/(1+capacity_factor).
    """
    if baseline == "single_chip":
        t1 = sort_seconds(n_global, anchor)
    else:
        t1 = distributed_sort_phases(
            n_global, 1, row_bytes, link, capacity_factor=capacity_factor,
            final_mode=final_mode, anchor=anchor).total_s
    tp = distributed_sort_phases(
        n_global, num_chips, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor).total_s
    return t1 / (num_chips * tp)


def weak_scaling_efficiency(n_per_chip: float, num_chips: int,
                            row_bytes: int = 16,
                            link: LinkSpec | None = None,
                            baseline: str = "distributed_p1",
                            capacity_factor: float = 2.0,
                            final_mode: str = "sort",
                            anchor: dict | None = None) -> float:
    """Weak-scaling efficiency T(1) / T(P) at fixed rows per GPU."""
    if baseline == "single_chip":
        t1 = sort_seconds(n_per_chip, anchor)
    else:
        t1 = distributed_sort_phases(
            n_per_chip, 1, row_bytes, link,
            capacity_factor=capacity_factor, final_mode=final_mode,
            anchor=anchor).total_s
    tp = distributed_sort_phases(
        n_per_chip * num_chips, num_chips, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor).total_s
    return t1 / tp


def projected_rows_per_s(n_global: float, num_chips: int,
                         row_bytes: int = 16,
                         link: LinkSpec | None = None,
                         capacity_factor: float = 2.0,
                         final_mode: str = "sort",
                         anchor: dict | None = None) -> float:
    return n_global / distributed_sort_phases(
        n_global, num_chips, row_bytes, link,
        capacity_factor=capacity_factor, final_mode=final_mode,
        anchor=anchor).total_s


def projection_table(n_per_chip: float = 1e8, row_bytes: int = 16,
                     chips: tuple = (1, 2, 4, 8, 16, 32, 64, 128, 256),
                     link: LinkSpec | None = None,
                     capacity_factor: float = 2.0,
                     final_mode: str = "sort",
                     anchor: dict | None = None) -> list[dict]:
    """Weak-scaling projection rows: rows/s, efficiency (both baselines),
    and the comm share per step at fixed rows per GPU."""
    link = link or LINKS["hgx-h100"]
    rows = []
    for p in chips:
        kw = dict(capacity_factor=capacity_factor, final_mode=final_mode,
                  anchor=anchor)
        ph = distributed_sort_phases(n_per_chip * p, p, row_bytes, link,
                                     **kw)
        rows.append({
            "chips": p,
            "rows_per_s": n_per_chip * p / ph.total_s,
            "rows_per_s_per_chip": n_per_chip / ph.total_s,
            "weak_eff": weak_scaling_efficiency(
                n_per_chip, p, row_bytes, link, **kw),
            "weak_eff_vs_single_chip": weak_scaling_efficiency(
                n_per_chip, p, row_bytes, link, baseline="single_chip",
                **kw),
            "comm_share": ph.exchange_s / ph.total_s,
            "exchange_s": ph.exchange_s,
            "total_s": ph.total_s,
        })
    return rows
