#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simd_radix_sort_tpu_torch) on one card.

    python3 chip_smoke.py [--n ROWS] [--reps R] [--seed S] [--out FILE]

Phases, each raising on failure:
  1. device: the card's name and power limit; build the CUDA kernels.
  2. kernels: each of K1-K6 against its plain PyTorch version on the card,
     exactly (all are integer functions), at the main path's shapes and at
     ragged, misaligned and edge cases; K6 also against K4's uint8 output.
     K7 (the segmented scans) against its plain version at the tile's
     edges and the ragged size (k7_holds): exactly for minimum, maximum
     and integers, float sums to the tests' rtol.
     K4 and K6 also where runs meet their tiles' edges
     (cuda_hist.tile_edge_cases), at the tile the wrappers launch with and
     at a 64-byte tile; K1 also on the inputs that could break its
     counters (k1_inputs), at every width and k.
  3. main paths at --n rows (default 10^8), data made from --seed with the
     port's utils/data.py, each case driven with the launch counts set to 0
     just before it and read just after:
       (a)-(e) `sort(...)` with method="auto", checking the engine it
               resolves to and its output on the device; (b2), (b3) as
               (b) on uint8 Zero and ReverseSorted, each also timed on
               xla;
       (f)     `sort(..., method="radix")`, u64 key + u64 payload;
       (g)     `radix.sort_arrays(..., engine="pallas")`, the same data:
               64 K5 launches;
       (h)     engine="pallas", int32 keys descending, uint16 payload;
       (i)     engine="scatter", int32 keys, int32 payload, 2^22 rows;
       (j)     uint8 keys through K1 and K6, the path of
               scripts/u8_attack.py's packed fill.
     (f)-(j) must equal the stable comparison sort of their input byte for
     byte; (a), (f) and (g) also pass bench.py's checksums.  Then the
     query operators over TPC-H scale factor 10 (tpch_tables: 59,986,052
     lineitems, 15,000,000 orders) and the rank and quick engines, each
     gated on an answer the code under test does not give
     (operator_cases):
       (k)     filter_rows with Q6's predicate: one K5 launch;
       (l)     group_aggregate, Q1's 4 groups, sum/mean/count of three
               float64 columns, with max_groups=4 and without: one K7
               launch;
       (m)     group_aggregate by l_orderkey (15·10^6 groups);
       (n)     lookup_join, semi_join, inner_join_expand and
               merge_join_indices of lineitem and orders;
       (o)     top_k (k=100) over (a)'s data and over int32 keys with
               many ties; unique over int32 keys with 1% distinct;
       (p)     sort(method="quick") at quick_rows() rows (MAX_BUCKETS x
               SEGMENT_TARGET, at most 10^8), stable and not (the blocked
               path must run); quick_sort.partition; method="rank" at
               4096 rows.
     Then the host engines, method="torch" and method="cpp" (the native
     harness, built here with g++), at 10^6 rows of (a)'s data: each must
     equal the stable comparison sort byte for byte.
  3b. (k)-(p) again at 10^6 rows, on the CPU and on the card: the outputs
     must agree (integers exactly, float sums to 1e-12).
  4. times: CUDA events, median of --reps after warm-up, for each kernel
     (kernel, plain version, one library call, bound) and each main-path
     case (rows/s and fraction of the roofline model); one further call of
     each under torch.profiler gives device time by kernel and the
     device's idle share of the call.  K4 and K6 are also timed at tiles
     of 4-64 KiB, and each of their calls must be one kernel on the card;
     K1 at the distributions the count engine hands it (K1_SHAPES,
     k1_shape_timings: S1-S8, and S9-S11 on int16 keys at k = 1024); K2
     and K3 at the reference's eight distributions of int32 and int16
     keys and at S6-S8's draws (k23_shape_timings), each held against its
     plain version there and first on the inputs that reach every path of
     their kernels (k23_edge_holds: cuda_hist.k23_edge_cases, the rows of
     one residue at --n, at 2 and 4 bytes, K3 also at a 64-byte tile); K7
     at Q1's shape at SF30 and at 10^6 rows (k7_timings: five float64
     sums in 4 groups, bit-identical from call to call).
  5. the distributed tier (simd_radix_sort_tpu_torch/parallel/) on P NCCL
     ranks, one card each, P the largest of 1, 2, 4 that the machine has
     (P = 1 runs in this process, P > 1 in spawned ones), each rank making
     phase 3's data from --seed (distributed_phase, distributed_cases):
       (q)     distributed_sort of (a)'s data, final_mode "sort" and
               "blocked";
       (r)     distributed_sort_multi, ORDER BY l_shipdate, l_orderkey DESC
               with l_extendedprice;
       (s)     distributed_filter, Q6;
       (t)     distributed_group_aggregate, Q1's groups and l_orderkey's;
       (u)     distributed_join of lineitem and orders, uniform and with
               one order's key on every fourth lineitem (the hot path);
       (v)     distributed_top_k (k=100) and distributed_unique;
       (w)     the hierarchical tier on an S x C mesh of the ranks ((1, 1),
               (2, 1), (2, 2) at P = 1, 2, 4): hierarchical_sort of (a)'s
               data with exchange_chunks=2, and
               hierarchical_group_aggregate, Q1's groups and l_orderkey's;
     each gated on the whole result (gather_*) against single-card torch
     calls, then timed and profiled (NCCL device time, host reads of split
     sizes, K5 launches, which join the kernels line's counts); then the
     same cases at 10^6 rows on a Gloo group on the CPU and on the NCCL
     group on the card, which must agree.
  6. the measurement layer (measurement_phase), its kernel launches
     joining the kernels line's counts: perf.measure_ns_per_element at
     2^18 rows (xla, radix, quick on u64+u64; count and xla on uint8 and
     int32 keys-only; rank at 4096), each validated on the host, and "auto"
     on u64+u64 at --n rows through the device gate; one cell 5 times (the
     spread); one table of each perf_test family, written under
     build/srs_torch/perf/ and read back, its header the reference's;
     autotune.pick_method for uint32 keys-only and u64+u64 at 2^20 (its
     own cache), then sort(method="autotune") equal byte for byte to the
     stable xla sort; profiling.trace around case (a)'s sort (the exported
     trace must hold CUDA kernel events) and profiling.measure of it; and
     the scaling model's constants: an NCCL one-int all_reduce chain and
     self-exchange at P = 1, two Gloo ranks' exchange on the CPU, case
     (q)'s blocked final pass; then the projection with this run's anchor.
  7. the workload scripts (simd_radix_sort_tpu_torch/workloads/) and the
     examples (workloads_phase), each at its published size, gated, timed
     and profiled, its K5 launches joining the kernels line's counts: the
     headline (bench.py's u64+u64 sort at --n rows); configuration 3 (10^8
     24-byte combined rows, sort_packed); configuration 4 (filter -> sort
     -> aggregate over 10^9 rows in 10 chunks, fused and staged, the host's
     waits counted); configuration 5's card leg (distributed sort of 10^8
     Zipf(1.1) rows, "sort" and "blocked"; joins of 10^8 x 10^7 rows under
     Zipf(1.1) and Zipf(1.5), the hot-key path on and off); the query
     example (against its CPU run) and the distributed example on phase
     5's ranks (against Gloo ranks).  Phase 7 must launch K5.
  8. the measurement-campaign drivers (drivers_phase) through their main:
     perf_suite's default tier at --n 65536, knob_epoch --n 16384,
     remeasure_noise and run_test_matrix 1000, each into build/srs_torch/
     drivers/<name>/: each must exit 0, every table must carry the
     reference's header, the matrix must print ALL PASSED; their K1-K5
     launches join the kernels line's counts.  Then workloads/
     summarize_bench over perf_suite's tables and over bench_out_h100/:
     each must exit 0 with one row a method table.
  9. the entry points (entry_phase, simd_radix_sort_tpu_torch/entry.py):
     entry() on the card, equal to its CPU run and timed;
     dryrun_multichip over NCCL ranks, one a card, twice (the first run's
     K5 launches join the kernels line's counts), then held equal to the
     same dry run on as many Gloo ranks on the CPU; and dryrun_multichip
     on 4 Gloo ranks, so that the hot-key assertion and the hierarchical
     steps run whatever the card count.
  10. the thresholds (floors_phase): count and xla in turns at one power
     of two either side of each `auto` floor and of counting.SMALL_MIN_N,
     their ratio logged; gated on correctness, on auto's pick and on the
     branch count takes, never on the times; its kernel launches join the
     kernels line's counts.

Prints one {"kernels": [...]} line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from simd_radix_sort_tpu_torch.workloads.common import (
    device_checksums, free_port, host_checksums, signed)

REPO = Path(__file__).resolve().parent

HIST_SOURCE = "simd_radix_sort_tpu_torch/csrc/hist_kernels.cu"
PARTITION_SOURCE = "simd_radix_sort_tpu_torch/csrc/partition_kernels.cu"
SCAN_SOURCE = "simd_radix_sort_tpu_torch/csrc/scan_kernels.cu"
# wrapper -> (TPU kernel it replaces, CUDA source)
TPU_KERNELS = {
    "histogram": ("simd_radix_sort_tpu/ops/pallas_hist.py:39", HIST_SOURCE),
    "minmax_hist16": ("simd_radix_sort_tpu/ops/pallas_hist.py:90",
                      HIST_SOURCE),
    "tiny_sort16": ("simd_radix_sort_tpu/ops/pallas_hist.py:177",
                    HIST_SOURCE),
    "fill_runs": ("simd_radix_sort_tpu/ops/pallas_hist.py:325", HIST_SOURCE),
    "partition_pass": ("simd_radix_sort_tpu/ops/pallas_partition.py:64",
                       PARTITION_SOURCE),
    "fill_runs_packed": ("scripts/u8_attack.py:65", HIST_SOURCE),
    # no Pallas kernel: the JAX package's jax.lax.associative_scan
    "segmented_scan": ("none (simd_radix_sort_tpu/ops/hashagg.py:40)",
                       SCAN_SOURCE),
}
# the CUDA functions each wrapper launches, as the profiler names them
KERNEL_FUNCTIONS = {
    "histogram": ("histogram_kernel",),
    "minmax_hist16": ("minmax_hist16_kernel",),
    "tiny_sort16": ("minmax_hist16_kernel", "fill16_kernel"),
    "fill_runs": ("fill_runs_kernel",),
    "partition_pass": ("partition_count_kernel", "partition_scatter_kernel"),
    "fill_runs_packed": ("fill_runs_packed_kernel",),
    "segmented_scan": ("seg_tiles_kernel", "seg_spine_kernel"),
}
# non-tensor-core int32/float32 peak of an H100 SXM (NVIDIA data sheet);
# every kernel here does a few integer operations per byte, far below it
PEAK_OPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


# TPC-H (specification v3, section 4.2): scale factor 10 has 15,000,000
# orders and 59,986,052 lineitems; dates as day numbers since 1970-01-01
SF10_ORDERS, SF10_LINEITEMS = 15_000_000, 59_986_052
STARTDATE, ENDDATE = 8035, 10591  # 1992-01-01, 1998-12-31
CURRENTDATE = 9298  # 1995-06-17
Q6_FROM, Q6_TO = 8766, 9131  # 1994-01-01, 1995-01-01


def tpch_tables(n_orders: int, n_lineitems: int, extra_rows: int,
                seed: int, device, u64_pair=None):
    """`orders` and `lineitem` as dbgen shapes them, made from `seed` on
    `device`, plus the other inputs of cases (o) and (p): `extra_rows`
    int32 keys with many ties and with 1% distinct values, and u64 keys +
    u64 payloads (`u64_pair`, else made here).

    o_orderkey is sparse as dbgen makes it (the first 8 of every 32 keys);
    each order has 1-7 lineitems (nudged to sum to exactly `n_lineitems`),
    in order-key order.  l_quantity 1-50, l_extendedprice = quantity x a
    retail price of 900.00-2098.99, l_discount 0.00-0.10, all float64, and
    kept also as exact integers (units, cents, hundredths) for the gates.
    l_shipdate is 1-121 days after o_orderdate; l_returnflag x l_linestatus
    as in Q1 (4 groups: A/F, N/F, N/O, R/F) is the int32 code `l_rfls`."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def ri(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device)

    t = {}
    i = torch.arange(n_orders, device=device)
    t["o_orderkey"] = (i // 8) * 32 + i % 8 + 1
    t["o_orderdate"] = ri(STARTDATE, ENDDATE - 151 + 1, n_orders).to(
        torch.int32)
    t["o_totalprice"] = ri(85_700, 55_558_628, n_orders).double() / 100
    per = ri(1, 8, n_orders)
    diff = n_lineitems - int(per.sum())
    room = torch.nonzero(per < 7 if diff > 0 else per > 1).squeeze(1)
    per[room[:abs(diff)]] += 1 if diff > 0 else -1
    if int(per.sum()) != n_lineitems:
        raise AssertionError("lineitem count")
    n = n_lineitems
    t["o_lines"] = per
    t["l_orderkey"] = torch.repeat_interleave(t["o_orderkey"], per)
    t["l_orderdate"] = torch.repeat_interleave(t["o_orderdate"], per)
    t["l_rowid"] = torch.arange(n, device=device)
    t["qty_units"] = ri(1, 51, n)
    t["price_cents"] = t["qty_units"] * ri(90_000, 209_900, n)
    t["disc_hundredths"] = ri(0, 11, n)
    t["l_quantity"] = t["qty_units"].double()
    t["l_extendedprice"] = t["price_cents"].double() / 100
    t["l_discount"] = t["disc_hundredths"].double() / 100
    ship = t["l_orderdate"] + ri(1, 122, n).to(torch.int32)
    receipt = ship + ri(1, 31, n).to(torch.int32)
    t["l_shipdate"] = ship
    # A/F 0, N/F 1, N/O 2, R/F 3 (Q1's ORDER BY): returnflag N once
    # received after CURRENTDATE, else A or R; linestatus O once shipped
    # after it (which makes the flag N)
    flag = torch.where(receipt > CURRENTDATE, 1, 3 * ri(0, 2, n))
    t["l_rfls"] = torch.where(ship > CURRENTDATE, 2, flag).to(torch.int32)
    # (o) and (p)
    m = extra_rows
    if u64_pair is None:  # uniform 64-bit patterns from two 32-bit halves
        u64_pair = [((ri(0, 2**32, m) << 32) | ri(0, 2**32, m)).view(
            torch.uint64) for _ in range(2)]
    t["u64"], t["u64_pay"] = u64_pair
    t["ties"] = ri(0, 1000, m).to(torch.int32)
    t["uniq"] = ri(0, max(1, m // 100), m).to(torch.int32)
    t["uniq_row"] = torch.arange(m, dtype=torch.int32, device=device)
    return t


Q6_COLUMNS = ("l_shipdate", "l_quantity", "l_extendedprice", "l_discount")


def q6_mask(t):
    """TPC-H Q6's predicate: shipped in 1994, discount 0.06 +- 0.01,
    quantity < 24."""
    return ((t["l_shipdate"] >= Q6_FROM) & (t["l_shipdate"] < Q6_TO)
            & (t["l_discount"] >= 0.05) & (t["l_discount"] <= 0.07)
            & (t["l_quantity"] < 24))


def flat(out):
    """The tensors of a nested output, in order."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [x for o in out for x in flat(o)]


def time_calls(fn, reps: int, warmup: int = 2) -> float:
    """Median ms of `reps` calls of `fn`, each between CUDA events, after
    `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def profile_call(fn, kernels=()):
    """One call under torch.profiler after a warm-up: its wall time (CUDA
    events, profiler on) and the device time of every kernel, memset or
    copy it issued, by name.  The trace at times comes back without some
    device events, so it is taken again (at most three times) until every
    wrapper in `kernels` shows its CUDA functions; if none is complete, the
    device times are {}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = [f for k in kernels for f in KERNEL_FUNCTIONS[k]]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
        per = {}
        for ev in prof.events():
            # "nccl:..." events are NCCL's annotations of its own kernels
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    not ev.name.startswith("nccl:"):
                per[ev.name] = (per.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
        if per and all(any(f in k for k in per) for f in want):
            return s.elapsed_time(e), per
    return s.elapsed_time(e), {}


SPIN_CYCLES = 50_000_000  # the card's spin before timed launches: ~25 ms


def event_device_ms(launches, rounds: int = 20) -> float:
    """Device ms of one round of `launches`, bare kernel launches that run
    nothing else on the card: CUDA events around `rounds` rounds that the
    host queues while the card spins (`torch.cuda._sleep`), so no launch
    waits for the host.  The spin doubles until it outlasts the queueing."""
    import torch

    for launch in launches:
        launch()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(6):
        spun, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spun.record()
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for _ in range(rounds):
            for launch in launches:
                launch()
        queued_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        e.synchronize()
        if queued_ms < spun.elapsed_time(s):
            return s.elapsed_time(e) / rounds
        cycles *= 2
    raise AssertionError(f"launches took {queued_ms:.1f} ms to queue, "
                         "longer than the card's spin")


# phase 4: K1 at the distributions the main path hands it, as
# (label, key dtype, distribution, k).  S1-S5: sort() of 1-byte keys
# (k = 256); S6-S8 and S9-S11: int32 and int16 keys of range in
# [16, 1024), count's adaptive branch (k = 1024).
K1_SHAPES = (
    ("S1 uint8 Uniform (case b)", "uint8", "Uniform", 256),
    ("S2 uint8 Zero", "uint8", "Zero", 256),
    ("S3 uint8 ZeroOne", "uint8", "ZeroOne", 256),
    ("S4 uint8 Sorted", "uint8", "Sorted", 256),
    ("S5 uint8 ReverseSorted", "uint8", "ReverseSorted", 256),
    ("S6 int32 [-500,500) (case d)", "int32", "[-500,500)", 1024),
    ("S7 int32 Zipf(1.1) ranks mod 1000", "int32", "zipf", 1024),
    ("S8 int32 99% one value", "int32", "status", 1024),
    ("S9 int16 [-500,500)", "int16", "[-500,500)", 1024),
    ("S10 int16 Zipf(1.1) ranks mod 1000", "int16", "zipf", 1024),
    ("S11 int16 99% one value", "int16", "status", 1024),
)
K1_SPREAD_RUNS = 3  # event_device_ms measurements of each K1 shape


def k1_keys(dtype: str, dist: str, n: int, seed: int):
    """The NumPy keys of a K1_SHAPES row: the reference's distributions
    (utils/data.py) for uint8; case (d)'s draw; Zipf(1.1) ranks modulo
    1000 (the hot key about 9% of rows) by config 5's rule; or 99% one
    value and 1% uniform in [0, 1000) at random rows."""
    import numpy as np

    from simd_radix_sort_tpu_torch.utils import data as D
    from simd_radix_sort_tpu_torch.workloads.config5_scale import zipf_ranks

    if dtype == "uint8":
        return D.make_keys(n, np.uint8, D.Distribution(dist), seed)
    rng = np.random.default_rng(seed)
    if dist == "[-500,500)":
        keys = rng.integers(-500, 500, n, dtype=np.int32)
    elif dist == "zipf":
        keys = (zipf_ranks(n, 1.1, 1000, seed) - 1).astype(np.int32)
    else:
        keys = np.zeros(n, np.int32)
        rare = rng.random(n) < 0.01
        keys[rare] = rng.integers(0, 1000, int(rare.sum()), dtype=np.int32)
    return keys.astype(dtype)


def k1_carrier(keys, dev):
    """The carrier and base that count's sort_keys hands K1 for `keys`
    (ascending): base = the carrier of the least key, or of 0 for 1-byte
    keys, whose 256 buckets cover every value."""
    from simd_radix_sort_tpu_torch.utils import interop, transforms

    c = transforms.to_sortable(interop.from_numpy(keys, dev))
    sign = 1 << (8 * keys.dtype.itemsize - 1)
    lo = 0 if keys.dtype.itemsize == 1 else int(
        transforms.to_sortable_np(keys).min())
    return c, lo ^ sign


def k1_inputs(size: int, k: int, zipf, randint, dev) -> dict:
    """label -> int64 offsets from a histogram's base, size + 1 of them
    (the misaligned view drops the first), that can break K1: every row in
    one bucket, two buckets, sorted and reverse-sorted runs, Zipf(1.1)
    ranks mod 1000 (`zipf`, int16, at least size + 1 of them), buckets
    holding exactly 255, 256 and 65,536 rows in runs, and values outside
    [0, k) on both sides, which must drop out."""
    import torch

    m = size + 1
    edge = randint(-8, k + 8, m)
    exact = randint(0, k, m) % max(1, k - 3) + 3  # no row in buckets 0-2
    at = 1 + int(randint(0, max(1, m - 66_048), 1).item())
    runs = torch.repeat_interleave(
        torch.arange(3, device=dev),
        torch.tensor([255, 256, 65_536], device=dev))[:m - at]
    exact[at:at + runs.numel()] = runs
    return {"one value": torch.full((m,), k // 2, dtype=torch.int64,
                                    device=dev),
            "two values": randint(0, 2, m) * (k - 1),
            "sorted": torch.sort(edge).values,
            "reverse-sorted": torch.sort(edge, descending=True).values,
            "zipf": zipf[:m].to(torch.int64),
            "exactly 255, 256, 65536": exact,
            "outside [base, base + k)": randint(-2 * k, 3 * k, m)}


def k1_shape_timings(n: int, seed: int, reps: int, dev, hold) -> list:
    """Phase 4's K1 rows at K1_SHAPES, n rows each: the kernel's device ms
    (event_device_ms of bare launches into one output, K1_SPREAD_RUNS
    times: median and runs), the wrapper's and the plain version's call
    ms, torch.bincount's ms on the same offsets (the library call), the
    bound (the carrier read once at the card's memory rate) and
    device/bound.  The bare launches'
    output is held against the plain version through `hold`."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import _build, cuda_hist as ch

    chip = roofline.chip_for_name(torch.cuda.get_device_name(0))
    rows = []
    for label, dtype, dist, k in K1_SHAPES:
        keys = k1_keys(dtype, dist, n, seed)
        c, base = k1_carrier(keys, dev)
        del keys
        w = c.element_size()
        off = ((c.to(torch.int64) - base) & ((1 << (8 * w)) - 1)).to(
            torch.uint8 if w == 1 else torch.int32)
        out = torch.zeros(k, dtype=torch.int32, device=dev)

        def bare():
            _build.launch("srs_histogram", dev, c.data_ptr(), w, n, base, k,
                          out.data_ptr())

        runs = [event_device_ms([bare]) for _ in range(K1_SPREAD_RUNS)]
        out.zero_()
        bare()
        hold("histogram", (out,), (ch.histogram_plain(c, k, base),),
             f"{label} bare launch")
        device_ms = statistics.median(runs)
        bound = max(roofline.bound_ms(n * w, chip), n / PEAK_OPS * 1e3)
        row = {"name": "histogram", "shape": label, "n": n, "k": k,
               "device_ms": device_ms, "device_ms_runs": runs,
               "spread": max(runs) / min(runs),
               "ms": time_calls(lambda: ch.histogram(c, k, base), reps),
               "plain_ms": time_calls(
                   lambda: ch.histogram_plain(c, k, base), reps),
               "library_ms": time_calls(
                   lambda: torch.bincount(off, minlength=k), reps),
               "library_call": "bincount", "bound_ms": bound,
               "bound_by": "bytes", "device_over_bound": device_ms / bound,
               "top_bucket_share": int(out.max().item()) / n}
        rows.append(row)
        log(f"phase 4: K1 {json.dumps(row)}")
        del c, off, out
    return rows


# phase 4: K2 and K3 where the count engine hands them its 2- and 4-byte
# keys: every call of those widths pays them before it picks a branch
K23_TYPES = ("int32", "int16")
K23_DISTRIBUTIONS = ("Uniform", "Gaussian", "Zero", "ZeroOne", "Sorted",
                     "ReverseSorted", "AlmostSorted", "AlmostReverseSorted")


# K2's and K3's device ms before their redesign (the kernels of fedece8),
# by row name and shape, at n = 10^8, seed 42: the median of two
# k23_shape_timings runs of that checkout on an NVIDIA H100 80GB HBM3 at
# 700.00 W, taken in turns with the redesigned kernels by
# workloads/kernel_ab.py (PERF.md)
PARENT_K23_DEVICE_MS = {
    "minmax_hist16 int32 Uniform": 0.2000,
    "tiny_sort16 int32 Uniform": 0.3404,
    "minmax_hist16 int32 Gaussian": 0.2001,
    "tiny_sort16 int32 Gaussian": 0.3409,
    "minmax_hist16 int32 Zero": 0.1991,
    "tiny_sort16 int32 Zero": 0.3402,
    "minmax_hist16 int32 ZeroOne": 0.1992,
    "tiny_sort16 int32 ZeroOne": 0.3406,
    "minmax_hist16 int32 Sorted": 0.2001,
    "tiny_sort16 int32 Sorted": 0.3405,
    "minmax_hist16 int32 ReverseSorted": 0.2002,
    "tiny_sort16 int32 ReverseSorted": 0.3406,
    "minmax_hist16 int32 AlmostSorted": 0.2000,
    "tiny_sort16 int32 AlmostSorted": 0.3413,
    "minmax_hist16 int32 AlmostReverseSorted": 0.2002,
    "tiny_sort16 int32 AlmostReverseSorted": 0.3406,
    "minmax_hist16 int32 S6 [-500,500)": 0.2000,
    "tiny_sort16 int32 S6 [-500,500)": 0.3407,
    "minmax_hist16 int32 S7 Zipf(1.1) mod 1000": 0.1999,
    "tiny_sort16 int32 S7 Zipf(1.1) mod 1000": 0.3409,
    "minmax_hist16 int32 S8 99% one value": 0.1998,
    "tiny_sort16 int32 S8 99% one value": 0.3414,
    "minmax_hist16 int16 Uniform": 0.1825,
    "tiny_sort16 int16 Uniform": 0.2683,
    "minmax_hist16 int16 Gaussian": 0.1826,
    "tiny_sort16 int16 Gaussian": 0.2682,
    "minmax_hist16 int16 Zero": 0.1816,
    "tiny_sort16 int16 Zero": 0.2687,
    "minmax_hist16 int16 ZeroOne": 0.1817,
    "tiny_sort16 int16 ZeroOne": 0.2686,
    "minmax_hist16 int16 Sorted": 0.1824,
    "tiny_sort16 int16 Sorted": 0.2681,
    "minmax_hist16 int16 ReverseSorted": 0.1825,
    "tiny_sort16 int16 ReverseSorted": 0.2680,
    "minmax_hist16 int16 AlmostSorted": 0.1825,
    "tiny_sort16 int16 AlmostSorted": 0.2680,
    "minmax_hist16 int16 AlmostReverseSorted": 0.1826,
    "tiny_sort16 int16 AlmostReverseSorted": 0.2682,
    "minmax_hist16 int16 S6 [-500,500)": 0.1827,
    "tiny_sort16 int16 S6 [-500,500)": 0.2681,
    "minmax_hist16 int16 S7 Zipf(1.1) mod 1000": 0.1825,
    "tiny_sort16 int16 S7 Zipf(1.1) mod 1000": 0.2683,
    "minmax_hist16 int16 S8 99% one value": 0.1824,
    "tiny_sort16 int16 S8 99% one value": 0.2694,
}


def device_keys(dtype: str, dist: str, n: int, gen, dev):
    """int16 or int32 keys of one of the reference's eight distributions
    (utils/data.py's definitions), drawn on the card from `gen`: Uniform
    over the type, Gaussian (sigma 100, rounded, wrapped through int64),
    Zero, ZeroOne, and the sorted family (uniform keys sorted, reversed,
    with 2^log10(n) pairs swapped for the Almost ones)."""
    import math

    import torch

    tdt = {"int16": torch.int16, "int32": torch.int32}[dtype]
    info = torch.iinfo(tdt)
    if dist == "Zero":
        return torch.zeros(n, dtype=tdt, device=dev)
    if dist == "ZeroOne":
        return torch.randint(0, 2, (n,), generator=gen, device=dev,
                             dtype=tdt)
    if dist == "Gaussian":
        g = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        return torch.round(g * 100.0).to(torch.int64).to(tdt)
    keys = torch.randint(info.min, info.max + 1, (n,), generator=gen,
                         device=dev, dtype=torch.int64).to(tdt)
    if dist == "Uniform":
        return keys
    keys = torch.sort(keys).values
    if "Reverse" in dist:
        keys = keys.flip(0)
    if dist.startswith("Almost"):
        pairs = torch.randint(0, n, (2, int(2 ** math.log10(n))),
                              generator=gen, device=dev)
        first = keys[pairs[0]].clone()
        keys[pairs[0]] = keys[pairs[1]]
        keys[pairs[1]] = first
    return keys


def k23_bare(v, flip: int, tile: int, dev):
    """K2, then K3's fill with a tile of `tile` bytes, as bare launches past
    the wrappers (and their launch counts): the stats and the output."""
    import torch

    from simd_radix_sort_tpu_torch.ops import _build, cuda_hist as ch

    stats = torch.empty(ch.STATS_WORDS, dtype=torch.int32, device=dev)
    out = torch.empty_like(v)
    w, size = v.element_size(), v.numel()
    _build.launch("srs_minmax_hist16", dev, v.data_ptr(), w, size, flip,
                  stats.data_ptr())
    _build.launch("srs_fill16", dev, stats.data_ptr(), w, size, flip, tile,
                  out.data_ptr())
    return stats, out


def k23_edge_holds(n: int, dev, hold) -> None:
    """K2 and K3 held against their plain versions through `hold` on the
    inputs that reach every path of their kernels (cuda_hist.k23_edge_cases,
    the CPU tests' cases with the rows of one residue at n), at 2 and 4
    bytes: through the wrappers, and K3 also as bare launches at a 64-byte
    tile, where runs meet many tiles' edges."""
    import torch

    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch

    for width in (2, 4):
        for label, (c, flip, start) in ch.k23_edge_cases(width, n).items():
            v = torch.from_numpy(c).to(dev)[start:]
            want = ch.minmax_hist16_plain(v, flip)
            hold("minmax_hist16", ch.minmax_hist16(v, flip), want,
                 f"{label} w={width}")
            sorted_want = ch.tiny_sort16_plain(v, flip)
            hold("tiny_sort16", ch.tiny_sort16(v, flip), sorted_want,
                 f"{label} w={width}")
            stats, out = k23_bare(v, flip, 64, dev)
            hold("tiny_sort16", (out, stats[:2].to(torch.int64) & 0xFFFFFFFF,
                                 stats[2:18]),
                 (sorted_want[0], torch.stack(want[:2]), want[2]),
                 f"{label} w={width} tile=64")


def k23_shape_timings(n: int, seed: int, reps: int, dev, hold) -> list:
    """Phase 4's K2 and K3 rows: n keys of int32 and int16 at the eight
    distributions (device_keys) and at S6-S8's draws (k1_keys): each
    kernel's device ms (event_device_ms of bare launches, K1_SPREAD_RUNS
    times: median and runs; K3 is K2's launch and its fill), the
    wrapper's call ms, the bound (K2 reads the keys once, K3 also writes
    them once, at the card's memory rate), device/bound and the device ms
    of the kernels before their redesign (PARENT_K23_DEVICE_MS).  The bare
    launches' outputs are held against the plain versions through
    `hold`, and so are both kernels on k23_edge_holds' inputs first."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import _build, cuda_hist as ch

    k23_edge_holds(n, dev, hold)
    chip = roofline.chip_for_name(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    names = {"[-500,500)": "[-500,500)", "zipf": "Zipf(1.1) mod 1000",
             "status": "99% one value"}
    drawn = {f"{label.split()[0]} {names[dist]}": k1_keys("int32", dist, n,
                                                          seed)
             for label, dtype, dist, _ in K1_SHAPES if dtype == "int32"}
    rows = []
    for dtype in K23_TYPES:
        shapes = [(dist, lambda d=dist: device_keys(dtype, d, n, gen, dev))
                  for dist in K23_DISTRIBUTIONS]
        shapes += [(label, lambda k=keys: torch.from_numpy(k).to(dev).to(
                        getattr(torch, dtype)))
                   for label, keys in drawn.items()]
        for shape, make in shapes:
            x = make()
            w = x.element_size()
            flip = 1 << (8 * w - 1)
            stats = torch.empty(ch.STATS_WORDS, dtype=torch.int32,
                                device=dev)
            out = torch.empty_like(x)

            def k2():
                _build.launch("srs_minmax_hist16", dev, x.data_ptr(), w, n,
                              flip, stats.data_ptr())

            def fill():
                _build.launch("srs_fill16", dev, stats.data_ptr(), w, n,
                              flip, ch.FILL_TILE_BYTES, out.data_ptr())

            for name, launches, nbytes in (("minmax_hist16", [k2], n * w),
                                           ("tiny_sort16", [k2, fill],
                                            2 * n * w)):
                runs = [event_device_ms(launches)
                        for _ in range(K1_SPREAD_RUNS)]
                for launch in launches:
                    launch()
                mn, mx, hist = ch.minmax_hist16_plain(x, flip)
                got = [stats[:2].to(torch.int64) & 0xFFFFFFFF, stats[2:18]]
                want = [torch.stack((mn, mx)), hist]
                if name == "tiny_sort16":
                    got, want = [out], [ch.tiny_sort16_plain(x, flip)[0]]
                hold(name, got, want, f"{dtype} {shape} bare launches")
                device_ms = statistics.median(runs)
                bound = max(roofline.bound_ms(nbytes, chip),
                            n / PEAK_OPS * 1e3)
                wrapper = getattr(ch, name)
                row = {"name": name, "shape": f"{dtype} {shape}", "n": n,
                       "device_ms": device_ms, "device_ms_runs": runs,
                       "parent_device_ms": PARENT_K23_DEVICE_MS.get(
                           f"{name} {dtype} {shape}"),
                       "spread": max(runs) / min(runs),
                       "ms": time_calls(lambda: wrapper(x, flip), reps),
                       "bound_ms": bound, "bound_by": "bytes",
                       "device_over_bound": device_ms / bound}
                rows.append(row)
                log(f"phase 4: K2/K3 {json.dumps(row)}")
            del x, stats, out
    return rows


# K7, the segmented scans: held at the tile's edges and a ragged size, and
# timed at Q1's shape at SF30 (its 1.76e8 selected rows, 4 groups, five
# float64 sums: one launch) and at 10^6 rows
K7_EDGE_ROWS = (1, 4095, 4096, 4097, 1_000_003)
K7_EDGE_CASES = (("float64", "sum"), ("float32", "sum"), ("float64", "min"),
                 ("bfloat16", "max"), ("float16", "min"), ("int64", "max"),
                 ("int32", "min"), ("int8", "max"))
K7_RTOL = {"float32": 1e-5, "float64": 1e-12}  # the parity tests' rtol
Q1_SCAN_ROWS = 176_000_000
K7_TIMED_ROWS = (Q1_SCAN_ROWS, 1_000_000)


def k7_inputs(n: int, streams: int, dtype: str, groups: int, seed: int,
              dev):
    """Start flags of `groups` segments (row 0 and groups - 1 seeded rows;
    every row when groups >= n) and `streams` value streams of `dtype`
    made on `dev`: floats uniform in [0, 10^(k+1)) for the k-th, as Q1's
    columns differ in scale, with a NaN, -0.0 and +0.0 planted; integers
    over their whole range."""
    import torch

    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if groups >= n:
        starts = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        starts = torch.zeros(n, dtype=torch.bool, device=dev)
        starts[0] = True
        starts[torch.randint(0, n, (groups - 1,), generator=g,
                             device=dev)] = True
    vals = []
    for k in range(streams):
        if dt.is_floating_point:
            v = (torch.rand(n, generator=g, device=dev) * 10 ** (k + 1)
                 if dt.itemsize < 8 else
                 torch.rand(n, generator=g, device=dev, dtype=dt)
                 * 10 ** (k + 1)).to(dt)
            if n > 8:
                v[n // 3:n // 3 + 3] = torch.tensor(
                    [float("nan"), -0.0, 0.0], device=dev).to(dt)
        else:
            info = torch.iinfo(dt)
            v = torch.randint(info.min, info.max, (n,), generator=g,
                              device=dev, dtype=torch.int64).to(dt)
        vals.append(v)
    return starts, vals


def k7_hold(got, want, vals, starts, ops, what: str) -> None:
    """K7's outputs against its plain version's: integers, minimum and
    maximum exactly (NaN where NaN); float32 and float64 sums within the
    tests' rtol of the segment's running sum of magnitudes; 2-byte float
    sums exactly (on values whose partial sums are exact in any order).
    Row 0 must start a segment."""
    import torch

    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    first = torch.nonzero(starts).flatten()
    for q, (a, b, v, op) in enumerate(zip(got, want, vals, ops)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"K7 {what} stream {q}: {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        if not a.dtype.is_floating_point:
            same = torch.equal(a, b)
        else:
            x, y = a.to(torch.float64), b.to(torch.float64)
            same = torch.equal(x.isnan(), y.isnan())
            ok = ~y.isnan()
            if op != "sum" or a.dtype.itemsize == 2:
                same = same and torch.equal(x[ok], y[ok])
            else:
                inf = ok & y.isinf()
                fin = ok & ~inf
                m = torch.nan_to_num(v.to(torch.float64).abs(), nan=0.0,
                                     posinf=0.0)
                c = torch.cumsum(m, 0)
                run = c - (c - m)[first][seg.clamp_min(0)]
                rtol = K7_RTOL[str(a.dtype).split(".")[1]]
                same = same and torch.equal(x[inf], y[inf]) and bool(
                    ((x - y).abs()[fin] <= rtol * run[fin]).all())
        if not same:
            raise AssertionError(f"K7 {what} stream {q} ({a.dtype} {op}): "
                                 "kernel differs from its plain version")


def k7_holds(seed: int, dev) -> int:
    """K7 against its plain version at K7_EDGE_ROWS, with one segment,
    segments of ~100 rows and every row its own, for each of
    K7_EDGE_CASES; then each case in one call of two streams (a launch
    each).  Returns the number of comparisons."""
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs

    count = 0
    for n in K7_EDGE_ROWS:
        for groups in (1, n // 100 + 1, n):
            for dtype, op in K7_EDGE_CASES:
                starts, vals = k7_inputs(n, 2, dtype, groups,
                                         seed + n + groups, dev)
                ops = [op, op]
                k7_hold(cs.segmented_scans(vals, starts, ops),
                        cs.segmented_scans_plain(vals, starts, ops), vals,
                        starts, ops, f"{dtype} {op} n={n} groups={groups}")
                count += 1
    return count


def k7_timings(seed: int, reps: int, dev, chip) -> list:
    """K7 at K7_TIMED_ROWS: five float64 sums in 4 groups, Q1's scan.  The
    wrapper's ms (CUDA events), the kernels' device ms (event_device_ms of
    wrapper calls: they run nothing else on the card) and by function
    (profiler), the plain version's ms, torch.cumsum's over the same
    streams (unsegmented: a yardstick), and the bound: the flags read once
    and each stream read once and written once, 81 bytes a row.  Each
    shape is held against the plain version and two calls must give the
    same bits."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs

    rows = []
    ops = ["sum"] * 5
    for n in K7_TIMED_ROWS:
        starts, vals = k7_inputs(n, 5, "float64", 4, seed, dev)
        cs.reset_launches()
        got = cs.segmented_scans(vals, starts, ops)
        again = cs.segmented_scans(vals, starts, ops)
        if cs.LAUNCHES["segmented_scan"] != 2:
            raise AssertionError(f"K7 n={n}: {cs.LAUNCHES}, not one launch "
                                 "a call")
        for a, b in zip(got, again):
            if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
                raise AssertionError(f"K7 n={n}: two calls differ")
        del again
        for q in range(5):
            want = cs.segmented_scans_plain([vals[q]], starts, ["sum"])
            k7_hold([got[q]], want, [vals[q]], starts, ["sum"],
                    f"Q1 shape n={n} stream {q}")
            del want
        del got

        def kern():
            return cs.segmented_scans(vals, starts, ops)

        def plain():
            return cs.segmented_scans_plain(vals, starts, ops)

        def lib():
            return [torch.cumsum(v, 0) for v in vals]

        p1, k1 = time_calls(plain, reps), time_calls(kern, reps)
        k2, p2 = time_calls(kern, reps), time_calls(plain, reps)
        runs = [event_device_ms([kern]) for _ in range(3)]
        _, per = profile_call(kern, ("segmented_scan",))
        nbytes = n * (1 + 5 * 16)
        bound = roofline.bound_ms(nbytes, chip)
        row = {"name": "segmented_scan",
               "shape": f"5 x float64 sums, 4 groups, n={n}",
               "n": n, "ms": min(k1, k2), "ms_runs": [k1, k2],
               "device_ms": statistics.median(runs), "device_ms_runs": runs,
               "device_ms_from": "events",
               "device_ms_profiler": sum(per.values()) if per else None,
               "device_ms_by_function": {k[:80]: v for k, v in per.items()},
               "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
               "library_ms": time_calls(lib, reps),
               "library_call": "torch.cumsum per stream (unsegmented)",
               "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
               "k7_bytes": cs.k7_bytes(n, 5, 8),
               "device_over_bound": statistics.median(runs) / bound}
        rows.append(row)
        log(f"phase 4: K7 {json.dumps(row)}")
        del starts, vals
    return rows


# rows of case (p), at most: the most rows the blocked cleanup gets
QUICK_MAX_N = 100_000_000


def quick_rows() -> int:
    """Case (p)'s rows: the quick engine's MAX_BUCKETS buckets of its
    target segment (SEGMENT_TARGET, at most BLOCK/4: the blocked cleanup's
    BLOCK/2 bound is twice the average segment, headroom for the sampled
    splitters), up to QUICK_MAX_N."""
    from simd_radix_sort_tpu_torch.ops import quick_sort

    return min(QUICK_MAX_N,
               quick_sort.MAX_BUCKETS * quick_sort.SEGMENT_TARGET)


SMALL_N = 1_000_000  # rows of the CPU-against-card comparison


def agree(label, cpu_out, card_out, signed):
    """The same outputs on the CPU and on the card: integers exactly,
    floats to the tests' float64 tolerance (sums in another order)."""
    import torch

    for i, (a, b) in enumerate(zip(flat(cpu_out), flat(card_out),
                                   strict=True)):
        b = signed(b).cpu().view(b.dtype)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label} output {i}: {a.dtype} "
                                 f"{tuple(a.shape)} on the CPU, {b.dtype} "
                                 f"{tuple(b.shape)} on the card")
        if a.dtype.is_floating_point:
            same = torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            same = torch.equal(signed(a), signed(b))
        if not same:
            raise AssertionError(f"{label} output {i}: the CPU and the "
                                 "card differ")


def operator_cases(t, quick_n: int):
    """Cases (k)-(p) over the tables `t`: each (label, engine, rows,
    run(t), gate(t, out), kernels that must launch, K5 launches, bytes a
    row, canon(out)).  `gate` holds the output against an answer that the
    code under test does not give: one known by construction, or other
    torch calls.  `canon` is what of the output must agree between the CPU
    and the card (rows past a count are padding; where the port sorts
    unstably, a sum over pairs stands for their order)."""
    import torch

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch.ops import (filter as filt, hashagg,
                                               hashjoin, quick_sort, topk)

    def signed(x):
        return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])

    def take(x, idx):
        return signed(x).index_select(0, idx)

    def eq(label, got, want):
        if got.shape != want.shape or not torch.equal(signed(got),
                                                      signed(want)):
            raise AssertionError(f"{label}: differs from its gate")

    def close(label, got, want):
        # the tests' float64 tolerance: sums in another order
        if not torch.allclose(got, want, rtol=1e-12, atol=0):
            err = ((got - want).abs() / want.abs()).max().item()
            raise AssertionError(f"{label}: relative error {err}")

    def pair_fp(k, p):
        return ((signed(k) * 0x7FFFFFFF) ^ signed(p)).sum()

    cases = []
    q6 = Q6_COLUMNS

    # (k) filter, Q6's predicate
    def gate_k(t, out):
        mask = q6_mask(t)
        sel, rest = (torch.nonzero(mask).squeeze(1),
                     torch.nonzero(~mask).squeeze(1))
        if int(out[0]) != sel.numel():
            raise AssertionError("(k) count")
        for col, o in zip(q6, out[1:]):
            eq("(k) " + col, o, torch.cat([take(t[col], sel),
                                           take(t[col], rest)]))

    cases.append(("k filter_rows Q6", "filter", "l_shipdate",
                  lambda t: filt.filter_rows(q6_mask(t),
                                             *(t[c] for c in q6)),
                  gate_k, ["partition_pass"], 1, 28, lambda out: out))

    # (l) Q1's group-by; (m) by l_orderkey
    def groupby_ref(t, key, cols):
        uk, inv, cnt = torch.unique(t[key], sorted=True,
                                    return_inverse=True, return_counts=True)
        sums = [torch.zeros(uk.numel(), dtype=torch.int64,
                            device=uk.device).index_add_(0, inv, t[c])
                for c in cols]
        return uk, cnt, sums

    exact = {"l_quantity": ("qty_units", 1), "l_extendedprice":
             ("price_cents", 100), "l_discount": ("disc_hundredths", 100)}

    def group_gate(label, key, cols, aggs):
        def gate(t, out):
            ng, gk, res = out
            uk, cnt, sums = groupby_ref(t, key, [exact[c][0] for c in cols])
            g = uk.numel()
            if int(ng) != g:
                raise AssertionError(f"{label}: {int(ng)} groups, not {g}")
            eq(label + " keys", gk[:g], uk)
            want_sum = [s.double() / exact[c][1] for s, c in zip(sums, cols)]
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r[:g], cnt.to(torch.int32))
                    continue
                for c, got, s in zip(cols, r, want_sum):
                    close(f"{label} {agg} {c}", got[:g],
                          s if agg == "sum" else s / cnt)
        return gate

    def group_canon(aggs):
        def canon(out):
            ng, gk, res = out
            g = int(ng)
            return [ng, gk[:g]] + [x[:g] for agg, r in zip(aggs, res)
                                   for x in ((r,) if agg == "count" else r)]
        return canon

    q1_cols = ("l_quantity", "l_extendedprice", "l_discount")
    q1_aggs = ("sum", "mean", "count")
    for label, kw in (("l Q1 group_aggregate max_groups=4",
                       {"max_groups": 4}),
                      ("l Q1 group_aggregate", {})):
        cases.append((
            label, "hashagg", "l_rfls",
            lambda t, kw=kw: hashagg.group_aggregate(
                t["l_rfls"], tuple(t[c] for c in q1_cols), aggs=q1_aggs,
                **kw),
            group_gate("(l)", "l_rfls", q1_cols, q1_aggs),
            ["partition_pass", "segmented_scan"], 1, 28,
            group_canon(q1_aggs)))
    m_cols, m_aggs = ("l_extendedprice",), ("sum", "count")
    cases.append((
        "m group_aggregate by l_orderkey", "hashagg", "l_orderkey",
        lambda t: hashagg.group_aggregate(
            t["l_orderkey"], (t["l_extendedprice"],), aggs=m_aggs),
        group_gate("(m)", "l_orderkey", m_cols, m_aggs),
        ["partition_pass", "segmented_scan"], 1, 16, group_canon(m_aggs)))

    # (n) joins of lineitem and orders
    def gate_lookup(t, out):
        found, counts, (date, price) = out
        if not bool(found.all()) or not bool((counts == 1).all()):
            raise AssertionError("(n) lookup: a lineitem lost its order")
        eq("(n) lookup o_orderdate", date, t["l_orderdate"])
        eq("(n) lookup o_totalprice", price,
           torch.repeat_interleave(t["o_totalprice"], t["o_lines"]))

    cases.append(("n lookup_join lineitem->orders", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.lookup_join(
                      t["l_orderkey"], t["o_orderkey"],
                      (t["o_orderdate"], t["o_totalprice"])),
                  gate_lookup, [], 0, 8, lambda out: out))

    def gate_semi(t, out):
        if int(out[0]) != t["l_orderkey"].numel():
            raise AssertionError("(n) semi_join count")
        eq("(n) semi keys", out[1], t["l_orderkey"])
        eq("(n) semi price", out[2], t["l_extendedprice"])

    cases.append(("n semi_join lineitem in orders", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.semi_join(
                      t["l_orderkey"], (t["l_extendedprice"],),
                      t["o_orderkey"]),
                  gate_semi, ["partition_pass"], 1, 16, lambda out: out))

    def check_pairs(label, total, ok, n_l):
        """As many pairs as lineitems, each joining equal keys."""
        if int(total) != n_l:
            raise AssertionError(f"{label}: total {int(total)} != {n_l}")
        if not bool(ok.all()):
            raise AssertionError(f"{label}: a pair joins different keys")

    def gate_expand(t, out):
        total, pidx, pk, (pdate,), (rowid,) = out
        check_pairs("(n) inner_join_expand", total,
                    take(t["l_orderkey"], rowid) == pk,
                    t["l_orderkey"].numel())
        eq("(n) expand probe keys", pk, t["l_orderkey"])
        eq("(n) expand probe dates", pdate, t["l_orderdate"])
        eq("(n) expand rows", torch.sort(rowid).values, t["l_rowid"])

    def expand_canon(out):
        total, pidx, pk, pps, (rowid,) = out
        return [total, pidx, pk, *pps,
                torch.sort(pidx.to(torch.int64) * rowid.numel()
                           + rowid).values]

    cases.append(("n inner_join_expand orders x lineitem", "hashjoin",
                  "l_orderkey",
                  lambda t: hashjoin.inner_join_expand(
                      t["o_orderkey"], (t["o_orderdate"],), t["l_orderkey"],
                      (t["l_rowid"],), t["l_orderkey"].numel()),
                  gate_expand, [], 0, 16, expand_canon))

    def gate_merge(t, out):
        total, pidx, bidx = out
        check_pairs("(n) merge_join_indices", total,
                    take(t["o_orderkey"], pidx)
                    == take(t["l_orderkey"], bidx),
                    t["l_orderkey"].numel())
        eq("(n) merge rows", torch.sort(bidx.to(torch.int64)).values,
           t["l_rowid"])

    cases.append(("n merge_join_indices", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.merge_join_indices(
                      (srs.to_sortable(t["o_orderkey"]),),
                      t["o_orderkey"].numel(),
                      (srs.to_sortable(t["l_orderkey"]),),
                      t["l_orderkey"].numel(), t["l_orderkey"].numel()),
                  gate_merge, ["partition_pass"], 1, 8, lambda out: out))

    # (o) top_k and unique
    def topk_gate(label, key, pay):
        def gate(t, out):
            order = torch.sort(srs.to_sortable(t[key], False),
                               stable=True).indices[:100]
            eq(label + " keys", out[0], take(t[key], order))
            if pay:
                eq(label + " payload", out[1], take(t[pay], order))
        return gate

    cases.append(("o top_k k=100 u64+u64", "topk", "u64",
                  lambda t: topk.top_k(t["u64"], t["u64_pay"], k=100),
                  topk_gate("(o) top_k u64", "u64", "u64_pay"), [], 0, 16,
                  lambda out: out))
    cases.append(("o top_k k=100 int32 ties", "topk", "ties",
                  lambda t: topk.top_k(t["ties"], t["uniq_row"], k=100),
                  topk_gate("(o) top_k ties", "ties", "uniq_row"), [], 0, 8,
                  lambda out: out))

    def gate_unique(t, out):
        count, ku, first, mult = out
        uk, inv, cnt = torch.unique(t["uniq"], sorted=True,
                                    return_inverse=True, return_counts=True)
        g = uk.numel()
        if int(count) != g:
            raise AssertionError("(o) unique count")
        eq("(o) unique keys", ku[:g], uk)
        eq("(o) unique multiplicity", mult[:g], cnt.to(torch.int32))
        want = torch.full((g,), t["uniq"].numel(), dtype=torch.int32,
                          device=uk.device).scatter_reduce_(
            0, inv, t["uniq_row"], "amin")
        eq("(o) unique first rows", first[:g], want)

    cases.append(("o unique int32", "topk", "uniq",
                  lambda t: topk.unique(t["uniq"], t["uniq_row"]),
                  gate_unique, ["partition_pass"], 1, 8, lambda out: out))

    # (p) the engines and the pivot partition
    def quick(t, stable):
        quick_sort.reset_paths()
        return srs.sort(t["u64"][:quick_n], t["u64_pay"][:quick_n],
                        method="quick", stable=stable,
                        device=t["u64"].device)

    def quick_gate(stable):
        def gate(t, out):
            if quick_sort.PATHS["blocked"] != 1:
                raise AssertionError(f"(p) quick took {quick_sort.PATHS}")
            k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
            want = srs.sort(k, p, method="xla", stable=True,
                            device=k.device)
            eq("(p) quick keys", out[0], want[0])
            if stable:
                eq("(p) quick payload", out[1], want[1])
            elif int(pair_fp(*out)) != int(pair_fp(k, p)):
                raise AssertionError("(p) quick: a payload left its key")
        return gate

    for stable in (True, False):
        cases.append((f"p sort quick stable={stable}", "quick", quick_n,
                      lambda t, s=stable: quick(t, s), quick_gate(stable),
                      [], 0, 16,
                      (lambda out: out) if stable else
                      (lambda out: [out[0], pair_fp(*out)])))

    def pivot_of(t):
        return t["u64"][quick_n // 2]

    def gate_partition(t, out):
        k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
        c = srs.to_sortable(k)
        le = c <= srs.to_sortable(pivot_of(t).reshape(1))
        left, right = (torch.nonzero(le).squeeze(1),
                       torch.nonzero(~le).squeeze(1))
        order = torch.cat([left, right])
        eq("(p) partition keys", out[0], take(k, order))
        eq("(p) partition payload", out[1][0], take(p, order))
        if int(out[2]) != left.numel():
            raise AssertionError("(p) partition split")
        ends = torch.sort(c).values
        eq("(p) partition kmin", srs.to_sortable(out[3].reshape(1)),
           ends[:1])
        eq("(p) partition kmax", srs.to_sortable(out[4].reshape(1)),
           ends[-1:])

    cases.append(("p quick_sort.partition u64+u64", "quick", quick_n,
                  lambda t: quick_sort.partition(
                      t["u64"][:quick_n], (t["u64_pay"][:quick_n],),
                      pivot_of(t)),
                  gate_partition, ["partition_pass"], 1, 16,
                  lambda out: out))

    def gate_rank(t, out):
        want = srs.sort(t["u64"][:4096], t["u64_pay"][:4096], method="xla",
                        stable=True, device=t["u64"].device)
        eq("(p) rank keys", out[0], want[0])
        eq("(p) rank payload", out[1], want[1])

    cases.append(("p sort rank n=4096", "rank", 4096,
                  lambda t: srs.sort(t["u64"][:4096], t["u64_pay"][:4096],
                                     method="rank", device=t["u64"].device),
                  gate_rank, [], 0, 16, lambda out: out))
    return cases


def distributed_cases(t, world: int, group, device):
    """Cases (q)-(w), the distributed tier (simd_radix_sort_tpu_torch/
    parallel/) on `world` ranks over the tables `t`, which every rank holds
    whole (the entries keep the rank's block of rows): each (label, rows,
    run(), gate(out), K5 launches at P = 1, canon(out)).  Each gate
    assembles the whole result on every rank (gather_*) and holds it
    against single-card torch calls on the whole input; `canon` is what
    must agree between the CPU and the card."""
    import torch

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import parallel as par

    kw = {"group": group, "device": device}
    n_l = t["l_orderkey"].numel()
    cases = []

    def take(x, idx):
        return signed(x).index_select(0, idx)

    def eq(label, got, want):
        if got.shape != want.shape or not torch.equal(signed(got),
                                                      signed(want)):
            raise AssertionError(f"{label}: differs from its gate")

    def close(label, got, want):
        if not torch.allclose(got, want, rtol=1e-12, atol=0):
            err = ((got - want).abs() / want.abs()).max().item()
            raise AssertionError(f"{label}: relative error {err}")

    def no_overflow(label, ov):
        if int(ov.max()):
            raise AssertionError(f"{label}: overflow flagged")

    def pair_fp(k, p):
        return ((signed(k) * 0x7FFFFFFF) ^ signed(p)).sum()

    # (q) the splitter sort of (a)'s data; gate: torch.sort, (a)'s checksums
    k64, p64 = t["u64"], t["u64_pay"]

    def q_gather(out):
        gk, (gp,) = par.gather_result(out[0], out[1], out[2], group)
        return gk, gp

    def q_canon(out):
        gk, gp = q_gather(out)
        return [gk, pair_fp(gk, gp)]

    def q_gate(label):
        def gate(out):
            no_overflow(label, out[3])
            gk, gp = q_gather(out)
            eq(label + " keys", gk, srs.sort(k64, method="xla",
                                             device=k64.device))
            if device_checksums((gk, gp)) != device_checksums((k64, p64)):
                raise AssertionError(f"{label}: checksums differ")
        return gate

    for mode in ("sort", "blocked"):
        label = f"q distributed_sort final_mode={mode} u64+u64"
        cases.append((
            label, k64.numel(),
            lambda mode=mode: par.distributed_sort(k64, p64, final_mode=mode,
                                                   **kw),
            q_gate(label), 0, q_canon))

    # (r) ORDER BY l_shipdate, l_orderkey DESC carrying l_extendedprice;
    # gate: sort_multi(stable=True) column by column (the payload exactly
    # at P = 1, where the distributed sort is stable; else by fingerprint)
    cols = (t["l_shipdate"], t["l_orderkey"])
    price = t["l_extendedprice"]

    def r_gather(out):
        return par.gather_result_multi(out[0], out[1], out[2], group)

    def r_canon(out):
        (g1, g2), (gp,) = r_gather(out)
        return [g1, g2, pair_fp(g2, gp)]

    def r_gate(out):
        no_overflow("(r)", out[3])
        (g1, g2), (gp,) = r_gather(out)
        (w1, w2), (wp,) = srs.sort_multi(cols, price, ascending=(True, False),
                                         stable=True, device=price.device)
        eq("(r) l_shipdate", g1, w1)
        eq("(r) l_orderkey", g2, w2)
        if world == 1:
            eq("(r) l_extendedprice", gp, wp)
        elif int(pair_fp(g2, gp)) != int(pair_fp(w2, wp)):
            raise AssertionError("(r) a payload left its row")

    cases.append((
        "r distributed_sort_multi l_shipdate,l_orderkey desc", n_l,
        lambda: par.distributed_sort_multi(cols, price,
                                           ascending=(True, False), **kw),
        r_gate, 0, r_canon))

    # (s) Q6's filter; gate as (k), on the gathered rows
    mask = q6_mask(t)

    def s_gather(out):
        gk, gp = par.gather_filtered(*out, group=group)
        return [gk, *gp]

    def s_gate(out):
        got = s_gather(out)
        sel = torch.nonzero(mask).squeeze(1)
        if got[0].numel() != sel.numel():
            raise AssertionError("(s) count")
        for col, o in zip(Q6_COLUMNS, got):
            eq("(s) " + col, o, take(t[col], sel))

    cases.append(("s distributed_filter Q6", n_l,
                  lambda: par.distributed_filter(
                      mask, *(t[c] for c in Q6_COLUMNS), **kw),
                  s_gate, 1, s_gather))

    # (t) Q1's groups and l_orderkey's; gate: torch.unique + index_add_ of
    # the exact integer cents
    def t_gate(label, key, aggs):
        def gate(out):
            ng, gk, res = out
            uk, inv, cnt = torch.unique(t[key], sorted=True,
                                        return_inverse=True,
                                        return_counts=True)
            cents = torch.zeros(uk.numel(), dtype=torch.int64,
                                device=uk.device).index_add_(
                0, inv, t["price_cents"])
            if ng != uk.numel():
                raise AssertionError(f"{label}: {ng} groups, not "
                                     f"{uk.numel()}")
            eq(label + " keys", gk, uk)
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r, cnt.to(torch.int32))
                else:
                    want = cents.double() / 100
                    close(f"{label} {agg}", r,
                          want if agg == "sum" else want / cnt)
        return gate

    for label, key, aggs in (
            ("t Q1 distributed_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("t distributed_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label, n_l,
            lambda key=key, aggs=aggs: par.distributed_group_aggregate(
                t[key], price, aggs, **kw),
            t_gate(label, key, aggs), 2,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))

    # (u) lineitem x orders, uniform and with one order's key on every
    # fourth lineitem (hot: flagged by the sample, joined by broadcast);
    # gate: every lineitem matched once, its order's payload as a
    # searchsorted lookup finds it
    okey = t["o_orderkey"]
    build = (t["o_orderdate"], t["o_totalprice"])
    hot = t["l_orderkey"].clone()
    hot[::4] = okey[okey.numel() // 3]
    cap_out = min(2 * n_l // world, n_l)

    def u_gather(out):
        gk, (rowid,), (date, tprice) = par.gather_joined(
            out[0], out[1], out[2], out[3], group)
        order = torch.argsort(rowid)
        return [x.index_select(0, order) for x in (gk, rowid, date, tprice)]

    def u_gate(label, keys, is_hot):
        def gate(out):
            no_overflow(label, out[4])
            gk, rowid, date, tprice = u_gather(out)
            eq(label + " rows", rowid, t["l_rowid"])
            eq(label + " keys", gk, keys)
            at = torch.searchsorted(okey, gk)
            eq(label + " o_orderdate", date, take(build[0], at))
            eq(label + " o_totalprice", tprice, take(build[1], at))
            if is_hot and int(out[5]["hot_key_slots_flagged"]) < 1:
                raise AssertionError(f"{label}: no hot key flagged")
        return gate

    for label, keys, extra in (
            ("u distributed_join uniform", t["l_orderkey"], {}),
            ("u distributed_join hot key", hot, {"hot_min_count": 16})):
        cases.append((
            label, n_l + okey.numel(),
            lambda keys=keys, extra=extra: par.distributed_join(
                keys, (t["l_rowid"],), okey, build,
                out_rows_per_device=cap_out, return_hot_stats=True,
                **extra, **kw),
            u_gate(label, keys, bool(extra)), 5,
            lambda out: [*u_gather(out),
                         out[5]["hot_key_slots_flagged"]]))

    # (v) top_k of (a)'s data; unique of 1%-distinct int32 keys; gates as
    # (o)
    def v_topk_gate(out):
        order = torch.sort(srs.to_sortable(k64, False),
                           stable=True).indices[:100]
        eq("(v) top_k keys", out[0], take(k64, order))
        eq("(v) top_k payload", out[1], take(p64, order))

    cases.append(("v distributed_top_k k=100 u64+u64", k64.numel(),
                  lambda: par.distributed_top_k(k64, p64, k=100, **kw),
                  v_topk_gate, 0, list))

    def v_unique_gate(out):
        ng, gk, mult = out
        uk, cnt = torch.unique(t["uniq"], sorted=True, return_counts=True)
        if ng != uk.numel():
            raise AssertionError("(v) unique count")
        eq("(v) unique keys", gk, uk)
        eq("(v) unique multiplicity", mult, cnt.to(torch.int32))

    cases.append(("v distributed_unique int32", t["uniq"].numel(),
                  lambda: par.distributed_unique(t["uniq"], **kw),
                  v_unique_gate, 2,
                  lambda out: [torch.tensor(out[0]), out[1], out[2]]))

    # (w) the hierarchical tier on an S x C mesh of the ranks: (1, 1) at
    # P = 1, (2, 1) at P = 2, (2, 2) at P = 4; gated as (q) and (t).  At
    # P = 1 the sort is one local sort and each aggregate is tier 0 alone
    # (the one-slice shortcut): one K5 launch each
    slices = 1 if world == 1 else 2
    label = "w hierarchical_sort exchange_chunks=2 u64+u64"
    cases.append((
        label, k64.numel(),
        lambda: par.hierarchical_sort(k64, p64, num_slices=slices,
                                      exchange_chunks=2, **kw),
        q_gate(label), 0, q_canon))
    for label, key, aggs in (
            ("w Q1 hierarchical_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("w hierarchical_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label, n_l,
            lambda key=key, aggs=aggs: par.hierarchical_group_aggregate(
                t[key], price, aggs, num_slices=slices, **kw),
            t_gate(label, key, aggs), 1,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))
    return cases


def distributed_phase(rank: int, world: int, port: int, n: int, seed: int,
                      reps: int, out_path=None):
    """Phase 5 on rank `rank` of `world`, one card per rank: an NCCL group
    (tcp://localhost:port), cases (q)-(w) at full size (--n rows and TPC-H
    SF10, made from --seed on this rank's card), each driven once with the
    launch and host-read counts set to 0 just before it, then timed and
    profiled; then the same cases at 10^6 rows through a Gloo group of the
    same ranks on the CPU and the NCCL group on the card, which must agree.
    Returns rank 0's record (and writes it to `out_path` when given)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch
    from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs
    from simd_radix_sort_tpu_torch.parallel import dist_sort as ds
    from simd_radix_sort_tpu_torch.utils import data as D, interop

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        gloo = dist.new_group(backend="gloo")
        t0 = time.perf_counter()
        keys = D.make_keys(n, np.uint64, D.Distribution.UNIFORM, seed)
        (pay,) = D.make_payloads(keys, [np.uint64])
        pair = (interop.from_numpy(keys, dev), interop.from_numpy(pay, dev))
        del keys, pay
        tables = tpch_tables(SF10_ORDERS, SF10_LINEITEMS, n, seed, dev,
                             u64_pair=pair)
        if rank == 0:
            log(f"phase 5: {world} NCCL rank(s), NCCL "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}; data "
                f"made in {time.perf_counter() - t0:.1f} s")
        results = []
        for (label, rows, run, gate, k5, _) in distributed_cases(
                tables, world, None, dev):
            ch.reset_launches()
            cp.reset_launches()
            cs.reset_launches()
            ds.reset_host_reads()
            out = run()
            torch.cuda.synchronize()
            launches = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
            host_reads = ds.HOST_READS["split_sizes"]
            gate(out)
            del out
            if launches["partition_pass"] < (k5 > 0) or (
                    world == 1 and launches["partition_pass"] != k5):
                raise AssertionError(f"{label}: {launches} K5 launches, "
                                     f"expected {k5}")
            ms = time_calls(run, max(5, reps // 2))
            wall, per = profile_call(run, ["partition_pass"] if k5 else [])
            busy = sum(per.values())
            nccl = sum(v for k, v in per.items() if "nccl" in k.lower())
            top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
            res = {"case": label, "ranks": world, "n": rows, "ms": ms,
                   "rows_per_s": rows / (ms / 1e3),
                   "launches": {k: v for k, v in launches.items() if v},
                   "split_size_host_reads": host_reads,
                   "trace": {"wall_ms_profiled": wall,
                             "device_busy_ms": busy,
                             "nccl_device_ms": nccl if per else None,
                             "idle_share": 1 - busy / ms if per else None,
                             "top": [[k[:90], v] for k, v in top]}}
            results.append(res)
            if rank == 0:
                log(f"phase 5: {json.dumps(res)}")
        del tables, pair
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        small = tpch_tables(SMALL_N // 4, SMALL_N, SMALL_N, seed, "cpu")
        small_dev = {k: signed(v).to(dev).view(v.dtype)
                     for k, v in small.items()}
        agreed = []
        for on_cpu, on_card in zip(
                distributed_cases(small, world, gloo, "cpu"),
                distributed_cases(small_dev, world, None, dev)):
            out_cpu = on_cpu[2]()
            on_cpu[3](out_cpu)
            out_card = on_card[2]()
            on_card[3](out_card)
            agree(on_cpu[0], on_cpu[5](out_cpu), on_card[5](out_card),
                  signed)
            agreed.append(on_cpu[0])
        if rank == 0:
            log(f"phase 5: {len(agreed)} distributed cases agree between "
                f"the CPU (Gloo) and the card (NCCL) at {SMALL_N} rows in "
                f"{time.perf_counter() - t0:.1f} s")
        record = {"ranks": world,
                  "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                  "cases": results, "cpu_card_agree": agreed}
        if out_path is not None and rank == 0:
            with open(out_path, "w") as f:
                json.dump(record, f)
        return record
    finally:
        dist.destroy_process_group()


# phase 6: the header row each table family must carry (the reference's,
# perf.hpp:170-211, 383-385, 435, as the JAX package writes them)
PERF_HEADERS = {
    "perf_test": "sort_method nanoseconds_per_element",
    "perf_test_num": "number_of_elements xla count",
    "perf_test_block": "digitBits nanoseconds_per_element",
    "perf_test_thresh": "cmpThresh nanoseconds_per_element",
    "perf_test_speedup": "key_type factor1 factor2 factor4 factor8",
    "perf_test_packed": "sort_method nanoseconds_per_element",
    "perf_test_combined": "layout nanoseconds_per_element",
}
REF_N = 1 << 18  # the reference harness's default cell size
CHAIN = 64  # depth of the dependent all_reduce chains
GLOO_ROWS = 1 << 22  # u64+u64 rows a Gloo rank exchanges


def collective_chain_s(device) -> float:
    """Seconds of one all_reduce of one int32 in a CHAIN-deep dependent
    chain on the current process group (median of 5 chains)."""
    import torch
    import torch.distributed as dist

    from simd_radix_sort_tpu_torch.utils.profiling import elapsed_seconds

    x = torch.zeros(1, dtype=torch.int32, device=device)

    def chain():
        for _ in range(CHAIN):
            dist.all_reduce(x)

    chain()
    return statistics.median(elapsed_seconds(device, chain)
                             for _ in range(5)) / CHAIN


def gloo_comm_rank(rank: int, world: int, port: int, out_path: str) -> None:
    """One of `world` Gloo ranks on the CPU: time the distributed sort's
    exchange (`dist_sort.exchange_by_bounds`, uniform cuts, so every rank
    receives exactly GLOO_ROWS rows) of GLOO_ROWS u64+u64 rows, median of
    5, and the collective chain; rank 0 writes the record."""
    import torch
    import torch.distributed as dist

    from simd_radix_sort_tpu_torch.parallel import dist_sort as ds

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        g = torch.Generator().manual_seed(rank)
        streams = [torch.randint(-2**62, 2**62, (GLOO_ROWS,), generator=g)
                   for _ in range(2)]
        bounds = torch.arange(1, world) * (GLOO_ROWS // world)

        def exchange():
            return ds.exchange_by_bounds(streams, bounds, None, GLOO_ROWS)

        exchange()
        times = []
        for _ in range(5):
            dist.barrier()
            t0 = time.perf_counter()
            exchange()
            times.append(time.perf_counter() - t0)
        latency = collective_chain_s(torch.device("cpu"))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"ranks": world, "rows_per_rank": GLOO_ROWS,
                           "exchange_s": statistics.median(times),
                           "exchange_s_runs": times,
                           "collective_latency_s": latency}, f)
    finally:
        dist.destroy_process_group()


def measurement_phase(n: int, seed: int, reps: int, a_ms: float,
                      dev) -> dict:
    """Phase 6: the measurement layer (perf.py, autotune.py,
    utils/profiling.py, models/scaling.py) on `dev` (the card; the CPU
    rehearses it, with Gloo in NCCL's place), through the entry points a
    user calls.  Every cell validates its output; every table is read back
    and its header held to the reference's.  `a_ms` is case (a)'s time
    from phase 3.  Returns the record; raises on any failure."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import autotune, perf
    from simd_radix_sort_tpu_torch.models import scaling
    from simd_radix_sort_tpu_torch.ops import _build
    from simd_radix_sort_tpu_torch.parallel import dist_sort as ds
    from simd_radix_sort_tpu_torch.utils import data as D, interop, profiling

    U = D.Distribution.UNIFORM
    on = {"device": dev}
    u64p = (np.uint64, (np.uint64,))
    rec = {}

    # (1) cells at the reference size, then u64+u64 "auto" at --n rows
    t0 = time.perf_counter()
    cells = []
    for method, num, (kdt, pdt) in (
            ("xla", REF_N, u64p), ("radix", REF_N, u64p),
            ("quick", REF_N, u64p), ("count", REF_N, (np.uint8, ())),
            ("xla", REF_N, (np.uint8, ())), ("count", REF_N, (np.int32, ())),
            ("xla", REF_N, (np.int32, ())), ("rank", 4096, u64p)):
        ns = perf.measure_ns_per_element(method, num, kdt, pdt, U, seed=seed,
                                         **on)
        cells.append({"method": method, "n": num,
                      "workload": perf.table_name(kdt, pdt, U, num),
                      "reps_warmups": perf.rep_counts(num), "ns": ns})
    ns = perf.measure_ns_per_element("auto", n, *u64p, U, seed=seed,
                                     validate="device", **on)
    cells.append({"method": "auto", "n": n, "validate": "device",
                  "workload": perf.table_name(*u64p, U, n),
                  "reps_warmups": perf.rep_counts(n), "ns": ns,
                  "ms": ns * n / 1e6, "case_a_ms": a_ms})
    for c in cells:
        log(f"phase 6: cell {json.dumps(c)}")
    # (2) the spread of one cell
    runs = [perf.measure_ns_per_element("xla", REF_N, *u64p, U, seed=seed,
                                        **on) for _ in range(5)]
    rec["spread"] = {"workload": perf.table_name(*u64p, U, REF_N),
                     "method": "xla", "ns_runs": runs, "min": min(runs),
                     "median": statistics.median(runs), "max": max(runs)}
    log(f"phase 6: spread {json.dumps(rec['spread'])}")
    rec["cells"] = cells
    rec["cells_s"] = time.perf_counter() - t0

    # (3) one table of each family, written and read back
    t0 = time.perf_counter()
    perf.OUT_DIR = str(_build.BUILD_DIR / "perf")
    u8, i32 = (np.uint8, ()), (np.int32, ())
    tables = {}
    for family, make in (
            ("perf_test", lambda: perf.perf_test(
                ["xla", "radix", "quick", "count", "rank"], REF_N, *i32,
                D.Distribution.ZERO_ONE, seed=seed, **on)),
            ("perf_test_num", lambda: perf.perf_test_num(
                ["xla", "count"], *u8, U, max_num=1 << 22, min_num=1 << 14,
                **on)),
            ("perf_test_num", lambda: perf.perf_test_num(
                ["xla", "count"], *i32, U, max_num=1 << 22, min_num=1 << 14,
                **on)),
            ("perf_test_block", lambda: perf.perf_test_block(REF_N, *u64p,
                                                             **on)),
            ("perf_test_thresh", lambda: perf.perf_test_thresh(REF_N, *u64p,
                                                               **on)),
            ("perf_test_speedup", lambda: perf.perf_test_speedup(
                "xla", "quick", REF_N, **on)),
            ("perf_test_packed", lambda: perf.perf_test_packed(
                1 << 22, *u64p, **on)),
            ("perf_test_combined", lambda: perf.perf_test_combined(
                1 << 22, *u64p, **on))):
        path = make()
        with open(path) as f:
            lines = f.read().strip().splitlines()
        if lines[0] != PERF_HEADERS[family]:
            raise AssertionError(f"{path}: header {lines[0]!r}, not the "
                                 f"reference's {PERF_HEADERS[family]!r}")
        if len(lines) < 2:
            raise AssertionError(f"{path}: no rows")
        tables[os.path.basename(path)] = lines
        log(f"phase 6: table {os.path.basename(path)}: {lines}")
    rec["tables"] = tables
    rec["tables_s"] = time.perf_counter() - t0

    # (4) autotune, a cache of its own; every candidate measured is logged
    t0 = time.perf_counter()
    autotune._CACHE_PATH = str(_build.BUILD_DIR / "autotune.json")
    autotune._cache = None
    measure = perf.measure_ns_per_element
    picks = []
    for kdt, pdt in ((np.uint32, ()), u64p):
        seen = {}

        def recording(name, *a, seen=seen, **kw):
            seen[name] = measure(name, *a, **kw)
            return seen[name]

        perf.measure_ns_per_element = recording
        try:
            winner = autotune.pick_method(kdt, pdt, 1 << 20, refresh=True,
                                          **on)
        finally:
            perf.measure_ns_per_element = measure
        keys = D.make_keys(1 << 20, kdt, U, seed)
        pays = D.make_payloads(keys, pdt)
        kd = interop.from_numpy(keys, dev)
        pd = tuple(interop.from_numpy(p, dev) for p in pays)
        got = srs.sort(kd, *pd, method="autotune", **on)
        want = srs.sort(kd, *pd, method="xla", stable=True, **on)
        for g, w in zip(flat(got), flat(want), strict=True):
            if not torch.equal(signed(g), signed(w)):
                raise AssertionError(f"autotune ({winner}) differs from the "
                                     "stable xla sort")
        picks.append({"workload": perf.table_name(kdt, pdt, U, 1 << 20),
                      "key": autotune._key(kdt, pdt, 1 << 20, dev),
                      "winner": winner, "candidates_ns": seen})
        log(f"phase 6: autotune {json.dumps(picks[-1])}")
    rec["autotune"] = picks
    rec["autotune_s"] = time.perf_counter() - t0

    # (5) profiling: a trace of case (a)'s sort, then its Report
    t0 = time.perf_counter()
    keys = D.make_keys(n, np.uint64, U, seed)
    (pay,) = D.make_payloads(keys, [np.uint64])
    kd, pd = interop.from_numpy(keys, dev), interop.from_numpy(pay, dev)
    del keys, pay
    srs.sort(kd, pd, **on)
    trace_dir = _build.BUILD_DIR / "trace"
    for attempt in range(3):  # the profiler at times drops device events
        with profiling.trace(str(trace_dir), **on):
            srs.sort(kd, pd, **on)
        with open(trace_dir / profiling.TRACE_FILE) as f:
            events = json.load(f)["traceEvents"]
        kernel_events = [e["name"] for e in events
                         if e.get("cat") == "kernel"]
        if kernel_events or dev.type != "cuda":
            break
    else:
        raise AssertionError("the exported trace holds no CUDA kernel event")
    report = profiling.measure(lambda: srs.sort(kd, pd, **on),
                               name="case (a)", rows=n,
                               reps=max(5, reps // 2), **on)
    log(f"phase 6: {report.line()}")
    rec["profiling"] = {"trace_events": len(events),
                        "kernel_events": len(kernel_events),
                        "kernels": sorted(set(k[:80] for k in kernel_events)),
                        "attempts": attempt + 1,
                        "report": dataclasses.asdict(report)}
    del kd, pd
    rec["profiling_s"] = time.perf_counter() - t0

    # (6) the scaling model's constants: NCCL at P = 1 in this process,
    # two Gloo ranks on the CPU, the blocked final pass on the card
    t0 = time.perf_counter()
    if dev.type == "cuda":
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1,
                                device_id=torch.device(
                                    "cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1)
    try:
        nccl_latency = collective_chain_s(dev)
        wire = torch.empty((n, 16), dtype=torch.int8, device=dev)
        into = torch.empty_like(wire)

        def self_exchange():
            dist.all_to_all_single(into, wire, [n], [n])

        self_exchange()
        xs = statistics.median(profiling.elapsed_seconds(dev, self_exchange)
                               for _ in range(5))
        del wire, into
    finally:
        dist.destroy_process_group()
    gloo_path = _build.BUILD_DIR / "gloo_comm.json"
    torch.multiprocessing.start_processes(
        gloo_comm_rank, nprocs=2, start_method="spawn",
        args=(2, free_port(), str(gloo_path)))
    gloo = json.loads(gloo_path.read_text())
    # case (q) blocked at P = 1: 8 segments of cap_seg rows, each half full
    # of u64+u64 rows of its key range; the final pass sorts each prefix
    seg, cap_seg = 8, -(-2 * n // 8)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k, p = ((torch.randint(0, 2**32, (n,), generator=g, device=dev) << 32)
            | torch.randint(0, 2**32, (n,), generator=g, device=dev)
            for _ in range(2))
    sid = (k >> 61) + 4  # key range of each row: 0..7 in carrier order
    order = torch.argsort(sid, stable=True)
    k, p = k.index_select(0, order), p.index_select(0, order)
    counts = torch.bincount(sid, minlength=seg).tolist()
    del sid, order
    segs, off = [], 0
    for c in counts:
        bufs = [torch.zeros(cap_seg, dtype=torch.int64, device=dev)
                for _ in range(2)]
        bufs[0][:c], bufs[1][:c] = k[off:off + c], p[off:off + c]
        segs.append((bufs, c))
        off += c
    del k, p
    blocked = []
    for _ in range(5):
        work = [([b.clone() for b in bufs], c) for bufs, c in segs]
        blocked.append(profiling.elapsed_seconds(dev, lambda: [
            ds._sort_prefix(bufs, 1, c) for bufs, c in work]))
        for bufs, c in work:
            if not bool((bufs[0][1:c] >= bufs[0][:c - 1]).all()):
                raise AssertionError("blocked final pass: not sorted")
        del work
    del segs
    t_blocked = statistics.median(blocked)
    measured = {
        "case_a_ms": a_ms,
        "anchor_rows_per_s": n / (a_ms / 1e3),
        "collective_latency_s_nccl": nccl_latency,
        "nccl_self_exchange_bytes": n * 16,
        "nccl_self_exchange_s": xs,
        "nccl_self_exchange_bytes_per_s": n * 16 / xs,
        "gloo": gloo,
        "gloo_bytes_per_s_per_proc": (gloo["ranks"] - 1) * GLOO_ROWS * 16
        / gloo["exchange_s"],
        "collective_latency_s_gloo": gloo["collective_latency_s"],
        "blocked_segments": seg, "blocked_cap_seg": cap_seg,
        "blocked_valid_rows": counts, "blocked_pass_s_runs": blocked,
        "blocked_sort_rows_per_s": seg * cap_seg / t_blocked,
    }
    anchor = {"rows_per_s": measured["anchor_rows_per_s"], "n": n,
              "row_bytes": 16}
    link = scaling.LINKS["hgx-h100"]
    rec["scaling"] = {
        "measured": measured,
        "committed": {"anchor": scaling.MEASURED_ANCHOR,
                      "comm": scaling.MEASURED_COMM,
                      "blocked_sort_rows_per_s":
                          scaling.BLOCKED_SORT_ROWS_PER_S},
        "projection": scaling.projection_table(anchor=anchor),
        "projection_blocked": scaling.projection_table(
            anchor=anchor, final_mode="blocked"),
        "dcn_required_for_clause": scaling.dcn_required_for_clause(
            anchor=anchor),
        "dcn_spec_bytes_per_s_per_chip": link.dcn_bytes_per_s_per_chip}
    log(f"phase 6: scaling constants {json.dumps(measured)}")
    for row in rec["scaling"]["projection"]:
        log(f"phase 6: projection {json.dumps(row)}")
    log(f"phase 6: dcn_required_for_clause "
        f"{rec['scaling']['dcn_required_for_clause']:.4g} B/s/GPU against "
        f"the NDR specification's {link.dcn_bytes_per_s_per_chip:.4g}")
    rec["scaling_s"] = time.perf_counter() - t0
    return rec


# phase 7: the workload scripts at their published sizes (BASELINE.json
# configurations 3-5; the headline runs at --n)
WORKLOAD_SIZES = {"combined": 10**8, "pipeline": 10**9, "chunks": 10,
                  "groups": 1 << 20, "sort": 10**8, "probe": 10**8,
                  "build": 10**7}


def workloads_phase(n: int, seed: int, reps: int, world: int, dev,
                    sizes=WORKLOAD_SIZES) -> dict:
    """Phase 7: the workload scripts (simd_radix_sort_tpu_torch/workloads/)
    and the examples on `dev` (the card; the CPU rehearses it at small
    `sizes`), each built through its script's case, driven once with the
    launch counts set to 0 just before and read just after, gated, then
    timed and profiled as phase 3's cases are.  The query example is held
    against its run on the CPU; the distributed one runs on `world` ranks
    and is held against the same ranks on Gloo.  Returns the record; raises
    on any failure, and when no case launched K5."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from simd_radix_sort_tpu_torch import methods
    from simd_radix_sort_tpu_torch.examples import (
        distributed_pipeline as dpipe, query_pipeline as qpipe)
    from simd_radix_sort_tpu_torch.ops import _build
    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch
    from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs
    from simd_radix_sort_tpu_torch.workloads import (
        combined_1e8, common, config5_scale, headline, pipeline_1e9)

    on_card = dev.type == "cuda"
    results = []

    def quiet(msg):
        pass

    def time_ms(fn):
        """CUDA events around each of a few calls, the median; one call on
        the host clock when the CPU rehearses the phase."""
        if on_card:
            return time_calls(fn, max(3, reps // 2), warmup=1)
        return common.timeit(fn, reps=1, warmup=0, device=dev) * 1e3

    def drive(label, rows, call, gate, note=None, **extra):
        """One case: driven once and gated, timed (CUDA events, median),
        one call profiled.  `note(out)` adds what the output says."""
        ch.reset_launches()
        cp.reset_launches()
        cs.reset_launches()
        out = call()
        common.fence(dev)
        launches = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
        gate(out)
        if note is not None:
            extra.update(note(out))
        del out
        ms, wall, per = time_ms(call), None, {}
        if on_card:
            wall, per = profile_call(
                call, ["partition_pass"] if launches["partition_pass"] else [])
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        res = {"case": label, "n": rows, "ms": ms,
               "rows_per_s": rows / (ms / 1e3),
               "launches": {k: v for k, v in launches.items() if v},
               "trace": {"wall_ms_profiled": wall,
                         "device_busy_ms": busy if per else None,
                         "idle_share": 1 - busy / ms if per else None,
                         "top": [[k[:90], v] for k, v in top]}, **extra}
        results.append(res)
        log(f"phase 7: {json.dumps(res)}")
        if on_card:
            torch.cuda.empty_cache()

    # the headline: bench.py's u64+u64 sort, "auto"
    t0 = time.perf_counter()
    keys, pay = headline.make_data(n, seed)
    method, call, gate = headline.case(keys, pay, "auto", dev)
    del keys, pay
    if method != "xla":
        raise AssertionError(f"headline: auto resolved to {method}")
    drive("headline u64+u64 auto", n, call, gate, method=method,
          setup_s=time.perf_counter() - t0)

    # configuration 3: 24-byte combined rows through sort_packed, and its
    # four steps (ops/sort.py: the key bytes copied out, the sort of the key
    # with the row index, the gather of the 16 payload bytes, the cat),
    # each timed alone on the same table
    rows = sizes["combined"]
    call, gate = combined_1e8.case(rows, dev)
    packed = combined_1e8.gen_packed(rows, dev)
    sorter = methods.resolve("auto", np.uint64, (np.int64,), rows)
    row_ids = torch.arange(rows, device=dev)

    def sort_keys():
        return sorter.run(packed[:, :8].reshape(-1).view(torch.uint64),
                          (row_ids,), ascending=True, stable=False,
                          block_threshold=None, digit_bits=None)

    ko, (perm,) = sort_keys()
    key_bytes = ko.view(torch.uint8).reshape(rows, 8)
    rest = packed[:, 8:].index_select(0, perm)
    steps = {name: time_ms(fn) for name, fn in (
        ("key copy", lambda: packed[:, :8].reshape(-1)),
        ("key copy + sort with row index", sort_keys),
        ("gather of 16-byte rows", lambda: packed[:, 8:].index_select(
            0, perm)),
        ("cat", lambda: torch.cat([key_bytes, rest], dim=1)))}
    del packed, row_ids, ko, perm, key_bytes, rest
    drive("config 3 combined u64+2xu64 sort_packed", rows, call, gate,
          steps_ms=steps)

    # configuration 4: filter -> sort -> aggregate, fused and staged
    rows, chunks, groups = sizes["pipeline"], sizes["chunks"], sizes["groups"]
    for mode in pipeline_1e9.MODES:
        call, gate = pipeline_1e9.case(rows, chunks, groups, mode, dev)
        syncs = {}
        if on_card:  # where the host waits, in one chunk and in one pass
            chunk = pipeline_1e9.make_chunk_fn(rows // chunks, groups, mode,
                                               dev)
            for what, fn in (("chunk", lambda: chunk(0)), ("pass", call)):
                at = common.host_syncs(fn)[1]
                syncs[what] = len(at)
                syncs[what + "_at"] = {a: at.count(a) for a in set(at)}
            del chunk
        drive(f"config 4 pipeline {mode}", rows, call, gate,
              note=lambda out: {"pipeline_s": out[0],
                                "groups_out": int(out[1].size),
                                "rows_kept": int(out[3].sum())},
              chunks=chunks, groups=groups, host_syncs=syncs)
        del call, gate

    # configuration 5: the card leg on a process group of one
    t0 = time.perf_counter()
    with common.one_rank_group(dev):
        cases = config5_scale.card_cases(sizes["sort"], sizes["probe"],
                                         sizes["build"], dev)
        setup_s = time.perf_counter() - t0
        for label, rows, skew, call, gate in cases:
            drive(f"config 5 {label}", rows, call, gate,
                  note=(lambda out: {"hot_stats": config5_scale.hot_record(
                      out[5])} if len(out) == 6 else {}),
                  skew=skew, setup_s=setup_s)
        del cases, call, gate

    # the query example, held against its run on the CPU
    want = qpipe.main("cpu", say=quiet)

    def gate_query(got):
        for key, w in want.items():
            g = got[key]
            if key == "sorted_amounts":  # an unstable sort: pairs as a set
                g, w = (a[np.lexsort((a, want["sorted_keys"]))]
                        for a in (g, w))
            ok = (np.allclose(g, w, rtol=1e-5, atol=0)
                  if np.asarray(w).dtype.kind == "f"
                  else np.array_equal(g, w))
            if not ok:
                raise AssertionError(f"query example {key}: the card and "
                                     "the CPU differ")

    drive("example query_pipeline", qpipe.N_ROWS,
          lambda: qpipe.main(dev, say=quiet), gate_query)

    # the distributed example on `world` ranks, held against Gloo ranks
    def same(label, got, want):
        keys = [k for k in want if k not in ("k5_launches",
                                             "sorted_customers")]
        pairs = [sorted(zip(r["sorted_amounts"], r["sorted_customers"]))
                 for r in (got, want)]
        if any(got[k] != want[k] for k in keys) or pairs[0] != pairs[1]:
            raise AssertionError(f"{label}: the card and the CPU differ")

    if world == 1:
        with common.one_rank_group(dev):
            gloo = dist.new_group(backend="gloo")
            want_d = dpipe.run(group=gloo, device="cpu", say=quiet)
            drive("example distributed_pipeline",
                  dpipe.make_tables(1)[0].shape[0],
                  lambda: dpipe.run(device=dev, say=quiet),
                  lambda got: same("distributed example", got, want_d),
                  ranks=1)
    else:
        t0 = time.perf_counter()
        got = dpipe.spawn(world, dev, str(_build.BUILD_DIR / "dpipe.json"))
        ms = (time.perf_counter() - t0) * 1e3
        same("distributed example", got, dpipe.spawn(
            world, "cpu", str(_build.BUILD_DIR / "dpipe_cpu.json")))
        res = {"case": "example distributed_pipeline", "n": got["rows"],
               "ranks": world, "ms_spawned": ms,
               "launches": {"partition_pass": got["k5_launches"]}}
        results.append(res)
        log(f"phase 7: {json.dumps(res)}")

    k5 = sum(r["launches"].get("partition_pass", 0) for r in results)
    if on_card and k5 < 1:
        raise AssertionError("phase 7 launched K5 no time")
    return {"cases": results, "k5_launches": k5}


# phase 8: the measurement-campaign drivers at a smoke grid
DRIVER_SIZES = {"suite_n": 65536, "knob_n": 16384, "matrix_max": 1000}


def reference_header(name: str) -> str:
    """The header row a table of this name must carry (PERF_HEADERS; a
    sweep's lists its methods after number_of_elements)."""
    for prefix, family in (("digits-", "perf_test_block"),
                           ("thresh-quick-", "perf_test_thresh"),
                           ("speedup-", "perf_test_speedup"),
                           ("packed-", "perf_test_packed"),
                           ("combined-", "perf_test_combined")):
        if name.startswith(prefix):
            return PERF_HEADERS[family]
    if name.startswith("tpe-"):
        return "number_of_elements"
    return PERF_HEADERS["perf_test"]


def drivers_phase(dev, sizes=DRIVER_SIZES) -> dict:
    """Phase 8: the measurement-campaign drivers (workloads/perf_suite,
    knob_epoch, remeasure_noise, run_test_matrix) through their `main` on
    `dev` (the card; the CPU rehearses it at small `sizes`), each into a
    directory of its own under build/, its output in a log there.  Each
    must exit 0 and every table it wrote must carry the reference's
    header; run_test_matrix must print ALL PASSED.  Returns the record
    (seconds, tables and K1-K5 launches a driver); raises on any
    failure."""
    import contextlib

    from simd_radix_sort_tpu_torch import perf
    from simd_radix_sort_tpu_torch.ops import _build
    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch
    from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs
    from simd_radix_sort_tpu_torch.workloads import (
        knob_epoch, perf_suite, remeasure_noise, run_test_matrix)

    root = _build.BUILD_DIR / "drivers"
    on = [] if dev.type == "cuda" else ["--device", "cpu"]
    out_dir = perf.OUT_DIR
    results = []
    try:
        for label, driver, argv in (
                ("perf_suite", perf_suite, ["--n", str(sizes["suite_n"])]),
                ("knob_epoch", knob_epoch, ["--n", str(sizes["knob_n"])]),
                ("remeasure_noise", remeasure_noise, []),
                ("run_test_matrix", run_test_matrix,
                 [str(sizes["matrix_max"])])):
            d = root / label
            d.mkdir(parents=True, exist_ok=True)
            for old in d.glob("*.dat"):
                old.unlink()
            perf.OUT_DIR = str(d)
            ch.reset_launches()
            cp.reset_launches()
            cs.reset_launches()
            t0 = time.perf_counter()
            with open(d / "stdout.log", "w") as f, \
                    contextlib.redirect_stdout(f):
                rc = driver.main(argv + on)
            seconds = time.perf_counter() - t0
            launches = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
            lines = (d / "stdout.log").read_text().splitlines()
            if rc != 0:
                raise AssertionError(f"phase 8: {label} {argv} exited {rc}: "
                                     f"{lines[-20:]}")
            tables = {}
            for path in sorted(d.glob("*.dat")):
                head = path.read_text().splitlines()
                want = reference_header(path.name)
                sweep = (want == "number_of_elements"
                         and head[0].startswith(want + " "))
                if head[0] != want and not sweep:
                    raise AssertionError(f"phase 8: {path}: header "
                                         f"{head[0]!r}, not {want!r}")
                if len(head) < 2:
                    raise AssertionError(f"phase 8: {path}: no rows")
                tables[path.name] = len(head) - 1
            res = {"driver": label, "argv": argv, "seconds": seconds,
                   "tables": len(tables), "table_rows": sum(tables.values()),
                   "launches": launches, "last_line": lines[-1]}
            if label == "run_test_matrix":
                if lines[-1] != "ALL PASSED":
                    failed = [x for x in lines if x.startswith("FAILED")]
                    raise AssertionError(f"phase 8: run_test_matrix: "
                                         f"{failed[:20]}")
                res["cells_passed"] = sum(x.startswith("passed ")
                                          for x in lines)
            elif not tables:
                raise AssertionError(f"phase 8: {label} wrote no table")
            results.append(res)
            log(f"phase 8: {json.dumps(res)}")
    finally:
        perf.OUT_DIR = out_dir
    return {"drivers": results}


SUMMARY_SKIPS = ("tpe-", "digits-", "speedup-", "combined-", "thresh-",
                 "quickstudy-")


def summarize_phase(table_dir) -> dict:
    """workloads/summarize_bench over `table_dir`, as a user runs it: it
    must exit 0 and print one row for each method table there (a table
    outside the skipped families with a row of a device engine)."""
    want = 0
    for path in sorted(table_dir.glob("*.dat")):
        rows = [x.split() for x in path.read_text().splitlines()[1:]]
        if not path.name.startswith(SUMMARY_SKIPS) and any(
                len(r) == 2 and r[0] in ("xla", "radix", "count", "rank",
                                         "quick") for r in rows):
            want += 1
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "simd_radix_sort_tpu_torch.workloads.summarize_bench",
         str(table_dir)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    if proc.returncode:
        raise AssertionError(f"phase 8: summarize_bench {table_dir} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    got = [x for x in proc.stdout.splitlines() if " n=" in x]
    if len(got) != want or not want:
        raise AssertionError(f"phase 8: summarize_bench {table_dir}: "
                             f"{len(got)} rows for {want} method tables")
    res = {"dir": str(table_dir), "rows": len(got),
           "seconds": time.perf_counter() - t0}
    log(f"phase 8: summarize_bench {json.dumps(res)}")
    return res


# phase 9: the Gloo dry run's rank count (its hot-key and hierarchical
# steps need at least 4 and an even count)
GLOO_DRYRUN_RANKS = 4


def entry_phase(reps: int, dev) -> dict:
    """Phase 9: the entry points (simd_radix_sort_tpu_torch/entry.py).
    entry()'s step on the card, held equal to its CPU run (keys
    exactly, payloads by the key<->payload pairing: the sort is unstable)
    and timed with CUDA events; dryrun_multichip on one NCCL rank a card,
    twice (the first run's launch counts are the phase's), each step gated
    inside, then held equal to the same dry run on as many Gloo ranks on
    the CPU; dryrun_multichip on 4 Gloo ranks.  Returns the record; raises
    on any failure."""
    import numpy as np
    import torch

    from simd_radix_sort_tpu_torch import entry as E
    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch
    from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs
    from simd_radix_sort_tpu_torch.utils import interop

    step, args = E.entry(dev)
    ch.reset_launches()
    cp.reset_launches()
    cs.reset_launches()
    keys, pay = step(*args)
    torch.cuda.synchronize()
    launches = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
    cpu_step, cpu_args = E.entry("cpu")
    cpu_keys, cpu_pay = (interop.to_numpy(t) for t in cpu_step(*cpu_args))
    keys, pay = interop.to_numpy(keys), interop.to_numpy(pay)
    if not np.array_equal(keys, cpu_keys):
        raise AssertionError("phase 9: entry() keys differ between the card "
                             "and the CPU")
    wide = np.uint64
    if not np.array_equal(
            E.pair_prints(keys.astype(wide), pay.astype(wide)),
            E.pair_prints(cpu_keys.astype(wide), cpu_pay.astype(wide))):
        raise AssertionError("phase 9: entry() key<->payload pairs differ "
                             "between the card and the CPU")
    ms = time_calls(lambda: step(*args), reps)
    rec = {"entry": {"rows": int(keys.shape[0]), "ms": ms,
                     "rows_per_s": keys.shape[0] / ms * 1e3,
                     "launches": launches}}
    log(f"phase 9: entry {json.dumps(rec['entry'])}")

    world = torch.cuda.device_count()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        card = E.dryrun_multichip(world)
        runs.append({"seconds": time.perf_counter() - t0,
                     "steps": card["seconds"],
                     "k5_launches": card["k5_launches"]})
    cpu = E.dryrun_multichip(world, "cpu")
    for key in ("sort_counts", "filter_rows", "aggregate_groups",
                "aggregate_sum", "join_pairs", "join_hot", "hierarchical"):
        if card[key] != cpu[key]:
            raise AssertionError(f"phase 9: dry run {key} differs between "
                                 f"NCCL ({card[key]}) and Gloo ({cpu[key]})")
    if not np.array_equal(card["sorted_keys"], cpu["sorted_keys"]):
        raise AssertionError("phase 9: dry run sorted keys differ between "
                             "NCCL and Gloo")
    if not card["k5_launches"]:
        raise AssertionError("phase 9: the dry run launched K5 no time")
    rec["nccl"] = {"ranks": world, "rows": card["rows"], "runs": runs,
                   "k5_launches": runs[0]["k5_launches"],
                   "join_hot": card["join_hot"],
                   "hierarchical": card["hierarchical"] is not None}
    log(f"phase 9: dryrun_multichip({world}) on NCCL "
        f"{json.dumps(rec['nccl'])}")

    t0 = time.perf_counter()
    gloo = E.dryrun_multichip(GLOO_DRYRUN_RANKS, "cpu")
    if gloo["hierarchical"] is None or \
            gloo["join_hot"]["key_slots_flagged"] < 1:
        raise AssertionError("phase 9: the Gloo dry run skipped a step")
    rec["gloo"] = {"ranks": GLOO_DRYRUN_RANKS, "rows": gloo["rows"],
                   "seconds": time.perf_counter() - t0,
                   "steps": gloo["seconds"], "join_hot": gloo["join_hot"]}
    log(f"phase 9: dryrun_multichip({GLOO_DRYRUN_RANKS}) on Gloo "
        f"{json.dumps(rec['gloo'])}")
    return rec


# phase 10: count against xla one power of two either side of each auto
# floor and of the engine's branch gate, as (label, key type, draw, the
# threshold's name)
FLOOR_POINTS = (
    ("uint8 Uniform", "uint8", "Uniform", "COUNT_CROSSOVER_N_1BYTE"),
    ("int16 Uniform", "int16", "Uniform", "COUNT_MIN_N_ADAPTIVE_2BYTE"),
    ("uint16 Uniform", "uint16", "Uniform", "COUNT_MIN_N_ADAPTIVE_UINT16"),
    ("int32 Uniform", "int32", "Uniform", "COUNT_MIN_N_ADAPTIVE"),
    ("int32 [-500,500)", "int32", "[-500,500)", "SMALL_MIN_N"),
)
FLOOR_ROUNDS = 3  # count and xla timed in turns, this many times each


def floors_phase(seed: int, reps: int, dev) -> dict:
    """Spot-check of the thresholds on the card: at n = threshold / 2 and
    threshold * 2 of each FLOOR_POINTS row, `sort(method="count")` and
    `sort(method="xla")` in turns (FLOOR_ROUNDS times, the order reversed
    each round), their median call ms (time_calls) and ratio logged.  It
    gates on correctness only: count's keys must equal xla's, auto must
    pick xla below a floor and count from it, and count must take its
    1024-bucket branch (a K1 launch) exactly from counting.SMALL_MIN_N.
    The caller counts the kernel launches."""
    import numpy as np
    import torch

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import methods
    from simd_radix_sort_tpu_torch.ops import counting, cuda_hist as ch
    from simd_radix_sort_tpu_torch.utils import data as D, interop

    rows = []
    for label, dtype, draw, name in FLOOR_POINTS:
        owner = counting if name == "SMALL_MIN_N" else methods
        threshold = getattr(owner, name)
        for n in (threshold // 2, threshold * 2):
            keys = (k1_keys(dtype, draw, n, seed) if draw == "[-500,500)"
                    else D.make_keys(n, np.dtype(dtype),
                                     D.Distribution(draw), seed))
            kd = interop.from_numpy(keys, dev)
            pick = methods.resolve("auto", keys.dtype, (), n).name
            if owner is methods and pick != ("count" if n >= threshold
                                             else "xla"):
                raise AssertionError(f"phase 10: {label} n={n}: auto "
                                     f"picked {pick} about {name}")
            runs = {m: lambda m=m: srs.sort(kd, method=m, device=dev)
                    for m in ("count", "xla")}
            before = ch.LAUNCHES["histogram"]
            got = runs["count"]()
            if not torch.equal(signed(got), signed(runs["xla"]())):
                raise AssertionError(f"phase 10: {label} n={n}: count "
                                     "differs from xla")
            branch = ch.LAUNCHES["histogram"] > before
            if name == "SMALL_MIN_N" and branch != (n >= threshold):
                raise AssertionError(f"phase 10: {label} n={n}: the "
                                     f"1024-bucket branch ran: {branch}")
            ms = {"count": [], "xla": []}
            for r in range(FLOOR_ROUNDS):
                for m in (("count", "xla") if r % 2 == 0
                          else ("xla", "count")):
                    ms[m].append(time_calls(runs[m], reps))
            row = {"case": label, "threshold": name, "value": threshold,
                   "n": n, "auto": pick, "branch": branch,
                   "count_ms": statistics.median(ms["count"]),
                   "xla_ms": statistics.median(ms["xla"]),
                   "count_ms_runs": ms["count"], "xla_ms_runs": ms["xla"]}
            row["count_over_xla"] = row["count_ms"] / row["xla_ms"]
            rows.append(row)
            log(f"phase 10: {json.dumps(row)}")
            del kd, got
    return {"points": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import methods
    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                               cuda_partition as cp,
                                               cuda_scan as cs, radix)
    from simd_radix_sort_tpu_torch.utils import (data as D, interop, native,
                                                 transforms)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    chip = roofline.chip_for_name(kind)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"roofline {chip.name} {chip.hbm_gbps} GB/s")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({_build.library_path().name})")
    nvcc_log = _build.library_path().with_suffix(".log")
    if nvcc_log.exists():
        log(nvcc_log.read_text().strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = args.n
    ragged = 1_000_003

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64)

    def as_width(v, width):
        """int64 values -> carrier of `width` bytes holding their low
        bits."""
        bits = v & ((1 << (8 * width)) - 1)
        half = 1 << (8 * width - 1)
        return torch.where(bits >= half, bits - 2 * half, bits).to(
            {1: torch.int8, 2: torch.int16, 4: torch.int32}[width])

    def diff(a, b) -> int:
        """max |a - b| over the integer results, as int64."""
        a = a.to(torch.int64) if a.dim() else a.reshape(1).to(torch.int64)
        b = b.to(torch.int64) if b.dim() else b.reshape(1).to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return int((a - b).abs().max().item()) if a.numel() else 0

    errs = {name: 0 for name in TPU_KERNELS}
    checks = {name: 0 for name in TPU_KERNELS}

    def hold(name, got, want, what):
        e = max(diff(g, w) for g, w in zip(got, want))
        if e:
            raise AssertionError(f"{name} {what}: kernel differs from its "
                                 f"plain version by up to {e}")
        errs[name] = max(errs[name], e)
        checks[name] += 1

    # ---- phase 2: kernels against their plain versions ---------------------
    t0 = time.perf_counter()
    for width in (1, 2, 4):
        for k in (16, 256, 1024):
            for size in (n, ragged):
                base = int(randint(0, 1 << (8 * width), 1).item())
                v = as_width(base + randint(-8, k + 8, size + 1), width)
                # the ragged case reads from an offset (misaligned) view
                x = v[1:] if size == ragged else v[:size]
                hold("histogram", (ch.histogram(x, k, base),),
                     (ch.histogram_plain(x, k, base),),
                     f"w={width} k={k} n={size}")
    # K1 on the inputs that can break it (k1_inputs), each width and k, at
    # full n and on the ragged, misaligned view
    zipf = torch.from_numpy(k1_keys("int32", "zipf", n + 1, args.seed)).to(
        device=dev, dtype=torch.int16)
    for width in (1, 2, 4):
        for k in (16, 256, 1024):
            for size in (n, ragged):
                base = int(randint(0, 1 << (8 * width), 1).item())
                for label, off in k1_inputs(size, k, zipf, randint,
                                            dev).items():
                    v = as_width(base + off, width)
                    x = v[1:] if size == ragged else v[:size]
                    hold("histogram", (ch.histogram(x, k, base),),
                         (ch.histogram_plain(x, k, base),),
                         f"{label} w={width} k={k} n={size}")
                    del v, x, off
    del zipf
    # (lo, carrier bytes, flip, span): windows straddling 2^31 and 2^32, a
    # 2-byte carrier ordered through its sign flip, and one wide range
    # (out of contract: the stats stay exact, the output is defined)
    for lo, width, flip, span in ((0, 4, 0, 16), (2**31 - 5, 4, 0, 16),
                                  (2**32 - 16, 4, 0, 16),
                                  (0x7FF9, 2, 0x8000, 16),
                                  (0, 4, 0x80000000, 1 << 32)):
        mask = (1 << (8 * width)) - 1
        for size in (n, ragged):
            u = (lo + randint(0, span, size)) & mask
            v = as_width(u ^ flip, width)
            hold("minmax_hist16", ch.minmax_hist16(v, flip),
                 ch.minmax_hist16_plain(v, flip), f"lo={lo} n={size}")
            got = ch.tiny_sort16(v, flip)
            hold("tiny_sort16", got, ch.tiny_sort16_plain(v, flip),
                 f"lo={lo} n={size}")
            if span <= 16:  # in contract: the output is the sorted input
                s = (signed(got[0]).to(torch.int64) & mask) ^ flip
                if not torch.equal(s, torch.sort(u).values):
                    raise AssertionError(f"tiny_sort16 lo={lo}: not sorted")
    fill_cases = [(n, 256, torch.int8, 0x80), (n, 1024, torch.int32, 77),
                  (ragged, 1024, torch.int16, 0x7FF0)]
    for size, k, dtype, base in fill_cases:
        hist = torch.bincount(randint(0, k, size), minlength=k).to(
            torch.int32)
        hold("fill_runs", (ch.fill_runs(hist, size, base, dtype),),
             (ch.fill_runs_plain(hist, size, base, dtype),),
             f"k={k} n={size}")
    for hist_list, dtype in (([3] * 512, torch.int32),
                             ([0, 5, 0, 0, 2, 0], torch.uint8),
                             ([0] * 100 + [n] + [0] * 100, torch.int16)):
        hist = torch.tensor(hist_list, dtype=torch.int32, device=dev)
        size = int(sum(hist_list))
        hold("fill_runs", (ch.fill_runs(hist, size, 3, dtype),),
             (ch.fill_runs_plain(hist, size, 3, dtype),),
             f"skewed/empty k={len(hist_list)}")
    def fill_at_tile(hist, size, base, dtype, tile):
        """K4 launched with a tile of `tile` bytes, or K6 for dtype None,
        past the wrappers (and their launch counts)."""
        out = torch.empty(size, dtype=dtype or torch.uint8, device=dev)
        if dtype is None:
            _build.launch("srs_fill_runs_packed", dev, hist.data_ptr(),
                          hist.numel(), size, tile, out.data_ptr())
        else:
            w = out.element_size()
            _build.launch("srs_fill_runs", dev, hist.data_ptr(), hist.numel(),
                          size, base & ((1 << (8 * w)) - 1), w, tile,
                          out.data_ptr())
        return out

    # K4 and K6 where runs meet the tiles' edges: at the wrappers' tile,
    # and at a 64-byte tile, where most runs of these cases span whole
    # tiles; K6 also against K4's uint8 output
    for width, dtype, base in ((1, torch.int8, 0x80),
                               (2, torch.int16, 0x7FF0),
                               (4, torch.int32, 77)):
        for label, (h, size) in ch.tile_edge_cases(width).items():
            hist = torch.from_numpy(h).to(dev)
            want = (ch.fill_runs_plain(hist, size, base, dtype),)
            hold("fill_runs", (ch.fill_runs(hist, size, base, dtype),), want,
                 f"{label} {dtype} n={size}")
            hold("fill_runs", (fill_at_tile(hist, size, base, dtype, 64),),
                 want, f"{label} {dtype} n={size} tile=64")
    for label, (h, size) in ch.tile_edge_cases(1, ch.MAX_PACKED_K).items():
        hist = torch.from_numpy(h).to(dev)
        size -= size % 4
        want = (ch.fill_runs_packed_plain(hist, size),)
        got = ch.fill_runs_packed(hist, size)
        hold("fill_runs_packed", (got,), want, f"{label} n={size}")
        hold("fill_runs_packed", (got,),
             (ch.fill_runs(hist, size, 0, torch.uint8),),
             f"{label} n={size} against K4")
        hold("fill_runs_packed", (fill_at_tile(hist, size, 0, None, 64),),
             want, f"{label} n={size} tile=64")
    # K5: masks all False, all True, alternating and random; 1, 2 and 4
    # streams of 4- and 8-byte words; the ragged size reads offset views
    # (a misaligned mask) and also runs the smallest tile
    def words(size, width):
        if width == 8:
            return randint(-(2**62), 2**62, size + 1)[1:]
        return randint(-(2**31), 2**31 - 1, size + 1).to(torch.int32)[1:]

    for size in (n, ragged):
        idx = torch.arange(size + 1, device=dev)
        masks = {"all False": idx < 0, "all True": idx >= 0,
                 "alternating": idx % 2 == 1,
                 "random": randint(0, 2, size + 1) == 1}
        del idx
        for widths in ((8,), (8, 4), (8, 4, 8, 4)):
            streams = [words(size, w) for w in widths]
            for pattern, m in masks.items():
                mk = m[1:] if size == ragged else m[:size]
                for block in ((256, cp.PART_BLOCK) if size == ragged
                              else (cp.PART_BLOCK,)):
                    hold("partition_pass",
                         cp.partition_pass(streams, mk, block=block),
                         cp.partition_pass_plain(streams, mk),
                         f"{pattern} widths={widths} n={size} "
                         f"block={block}")
            del streams
        del masks
    # K6 against its plain version and against K4's uint8 output: uniform,
    # skewed (one bucket; halving counts) and empty-bucket histograms
    n4 = n - n % 4
    halving = [n4 >> (b + 1) for b in range(255)]
    packed_cases = [
        ("uniform", torch.bincount(randint(0, 256, n4), minlength=256)),
        ("one bucket", torch.tensor([0] * 100 + [n4] + [0] * 155)),
        ("halving", torch.tensor(halving + [n4 - sum(halving)])),
        ("empty buckets", torch.tensor([0, 5, 0, 0, 3, 0])),
        ("ragged uniform", torch.bincount(randint(0, 256, 1_000_004),
                                          minlength=256))]
    for shape, hist in packed_cases:
        hist = hist.to(device=dev, dtype=torch.int32)
        size = int(hist.sum().item())
        got = ch.fill_runs_packed(hist, size)
        hold("fill_runs_packed", (got,),
             (ch.fill_runs_packed_plain(hist, size),), f"{shape} n={size}")
        hold("fill_runs_packed", (got,),
             (ch.fill_runs(hist, size, 0, torch.uint8),),
             f"{shape} n={size} against K4")
    checks["segmented_scan"] += k7_holds(args.seed, dev)
    torch.cuda.synchronize()
    log(f"phase 2: kernels equal their plain versions "
        f"({json.dumps(checks)} comparisons) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3: main paths ------------------------------------------------
    def time_ms(fn, reps=args.reps, warmup=2):
        return time_calls(fn, reps, warmup)

    device_profile = profile_call

    def count_launches(fn):
        ch.reset_launches()
        cp.reset_launches()
        cs.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}

    def as_tuple(out):
        if isinstance(out, torch.Tensor):
            return (out,)
        keys, rest = out[0], out[1:]
        if len(rest) == 1 and isinstance(rest[0], tuple):
            rest = rest[0]  # radix.sort_arrays: (keys, payloads)
        return (keys, *rest)

    def stage(keys, pays):
        return (interop.from_numpy(keys, dev),
                tuple(interop.from_numpy(p, dev) for p in pays))

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    # (label, engine, rows, run, check, kernels expected, roofline)
    cases = []

    def lsd_roofline(row_bytes, key_bits):
        return (f"lsd_radix_8bit({row_bytes} B rows)",
                roofline.radix_sort_roofline_rows_per_s(
                    row_bytes=row_bytes, key_bits=key_bits, chip=chip))

    def stream_roofline(row_bytes):
        return (f"one read + one write of {row_bytes} B rows",
                roofline.stream_roofline_rows_per_s(row_bytes, 1.0,
                                                    chip=chip))

    def sorted_carrier(out, asc):
        c = srs.to_sortable(out, asc)
        return bool((c[1:] >= c[:-1]).all())

    # (a) u64 key + u64 payload: the comparison engine; (f), (g) reuse it
    keys = D.make_keys(n, np.uint64, D.Distribution.UNIFORM, args.seed)
    (pay,) = D.make_payloads(keys, [np.uint64])
    sums64 = host_checksums(keys, pay)
    k64, (p64,) = stage(keys, (pay,))
    del keys, pay

    def check_bench(label, out):
        if not sorted_carrier(out[0], True):
            raise AssertionError(f"{label}: not sorted")
        got = device_checksums(out)
        if got != sums64:
            raise AssertionError(f"{label}: checksums {got} != {sums64}")

    xla_runs = {}  # label -> the same sort on xla, timed beside the case

    def auto_case(label, keys, pays, asc, engine, row_bytes,
                  time_xla=False):
        """A case of sort(method="auto") on the count engine."""
        m = methods.resolve("auto", keys.dtype, [p.dtype for p in pays],
                            keys.shape[0])
        if m.name != engine:
            raise AssertionError(f"{label}: auto resolved to {m.name}, "
                                 f"expected {engine}")
        kd, pd = stage(keys, pays)

        def run():
            return as_tuple(srs.sort(kd, *pd, ascending=asc))

        u = transforms.to_sortable_np(keys)
        span = int(u.max()) - int(u.min())
        if keys.dtype.itemsize == 1:
            expect = ["histogram", "fill_runs"]
        elif span < 16:
            expect = ["minmax_hist16", "tiny_sort16"]
        elif span < 1024:
            expect = ["minmax_hist16", "tiny_sort16", "histogram",
                      "fill_runs"]
        else:
            expect = ["minmax_hist16", "tiny_sort16"]

        def check(out):
            ref = srs.sort(kd, ascending=asc, method="xla")
            if not torch.equal(signed(out[0]), signed(ref)):
                raise AssertionError(f"{label}: differs from the "
                                     "comparison sort of its input")
            if not sorted_carrier(out[0], asc):
                raise AssertionError(f"{label}: not sorted")

        cases.append((label, engine, keys.shape[0], run, check, expect,
                      stream_roofline(row_bytes)))
        if time_xla:
            xla_runs[label] = lambda: srs.sort(kd, *pd, ascending=asc,
                                               method="xla")

    def stable_case(label, engine, kd, pd, asc, run, expect, roof,
                    extra=None):
        """A case whose output must equal the stable comparison sort of
        its input byte for byte, keys and payloads."""
        def check(out):
            want = as_tuple(srs.sort(kd, *pd, ascending=asc, method="xla",
                                     stable=True))
            if len(out) != len(want) or not all(
                    g.dtype == w.dtype and torch.equal(signed(g), signed(w))
                    for g, w in zip(out, want)):
                raise AssertionError(f"{label}: differs from the stable "
                                     "comparison sort of its input")
            if extra is not None:
                extra(out)

        cases.append((label, engine, kd.shape[0], run, check, expect, roof))

    m = methods.resolve("auto", k64.dtype, [p64.dtype], n)
    if m.name != "xla":
        raise AssertionError(f"a: auto resolved to {m.name}, expected xla")
    cases.append(("a u64+u64 Uniform", "xla", n,
                  lambda: as_tuple(srs.sort(k64, p64)),
                  lambda out: check_bench("a u64+u64 Uniform", out), [],
                  lsd_roofline(16, 64)))
    # (b) uint8 keys only: 256-bucket counting
    keys8 = D.make_keys(n, np.uint8, D.Distribution.UNIFORM, args.seed)
    auto_case("b uint8 Uniform", keys8, (), True, "count", 1)
    # (b2), (b3) the skewed 1-byte keys K1 sees on this path, each also
    # timed on xla
    for dist in (D.Distribution.ZERO, D.Distribution.REVERSE_SORTED):
        auto_case(f"b{2 if dist is D.Distribution.ZERO else 3} uint8 "
                  f"{dist.value}", D.make_keys(n, np.uint8, dist, args.seed),
                  (), True, "count", 1, time_xla=True)
    # (c) int32 keys only, tiny range
    for dist in (D.Distribution.ZERO, D.Distribution.ZERO_ONE):
        auto_case(f"c int32 {dist.value}",
                  D.make_keys(n, np.int32, dist, args.seed), (), True,
                  "count", 4)
    # (d) int32 keys only in [-500, 500): the 1024-bucket branch
    auto_case("d int32 [-500,500)",
              rng.integers(-500, 500, n, dtype=np.int32), (), True,
              "count", 4)
    # (e) int16 Gaussian, descending
    auto_case("e int16 Gaussian desc",
              D.make_keys(n, np.int16, D.Distribution.GAUSSIAN, args.seed),
              (), False, "count", 2)
    # (f) the radix engine's default mover: 2 passes of 32-bit digits
    stable_case("f u64+u64 Uniform radix", "radix/sort", k64, (p64,), True,
                lambda: as_tuple(srs.sort(k64, p64, method="radix")), [],
                lsd_roofline(16, 64),
                lambda out: check_bench("f u64+u64 Uniform radix", out))
    # (g) one K5 partition per key bit
    stable_case("g u64+u64 Uniform radix pallas", "radix/pallas", k64,
                (p64,), True,
                lambda: as_tuple(radix.sort_arrays(k64, (p64,),
                                                   engine="pallas")),
                ["partition_pass"], lsd_roofline(16, 64),
                lambda out: check_bench("g u64+u64 Uniform radix pallas",
                                        out))
    # (h) K5 with a widened payload and the top-bit flip of a descending
    # signed key
    keys = D.make_keys(n, np.int32, D.Distribution.UNIFORM, args.seed)
    kh, ph = stage(keys, D.make_payloads(keys, [np.uint16]))
    stable_case("h int32+uint16 Uniform desc radix pallas", "radix/pallas",
                kh, ph, False,
                lambda: as_tuple(radix.sort_arrays(kh, ph, ascending=False,
                                                   engine="pallas")),
                ["partition_pass"], lsd_roofline(6, 32))
    # (i) the scatter mover, the semantic model, at 2^22 rows
    keys = D.make_keys(1 << 22, np.int32, D.Distribution.UNIFORM, args.seed)
    ki, pi = stage(keys, D.make_payloads(keys, [np.int32]))
    stable_case("i int32+int32 Uniform radix scatter", "radix/scatter", ki,
                pi, True,
                lambda: as_tuple(radix.sort_arrays(ki, pi,
                                                   engine="scatter")),
                [], lsd_roofline(8, 32))
    # (j) uint8 keys through K1 and K6: scripts/u8_attack.py's packed-fill
    # path (a histogram of the raw bytes, then the packed run fill)
    kj, _ = stage(keys8[:n4], ())
    stable_case("j uint8 Uniform K1+K6", "K1+K6", kj, (), True,
                lambda: (ch.fill_runs_packed(ch.histogram(kj, 256), n4),),
                ["histogram", "fill_runs_packed"], stream_roofline(1))
    # (k)-(p): the query operators over TPC-H SF10 and the rank and quick
    # engines; top_k and quick reuse (a)'s u64 keys and payloads
    quick_n = min(quick_rows(), n)
    tables = tpch_tables(SF10_ORDERS, SF10_LINEITEMS, n, args.seed, dev,
                         u64_pair=(k64, p64))
    k5_launches = {}
    for (label, engine, rows, run, gate, expect, k5, row_bytes,
         _) in operator_cases(tables, quick_n):
        rows = tables[rows].numel() if isinstance(rows, str) else rows
        cases.append((label, engine, rows,
                      lambda run=run: run(tables),
                      lambda out, gate=gate: gate(tables, out), expect,
                      stream_roofline(row_bytes)))
        k5_launches[label] = k5
    del keys, keys8
    log(f"phase 3: data made in {time.perf_counter() - t0:.1f} s")

    results = []
    for label, engine, rows, run, check, expect, (model, roof) in cases:
        out, launches = count_launches(run)
        check(out)
        del out
        missing = [k for k in expect if launches[k] < 1]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} not launched "
                                 f"({launches})")
        ms = time_ms(run, reps=max(5, args.reps // 2))
        rows_s = rows / (ms / 1e3)
        wall, per = device_profile(run, expect)
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        res = {"case": label, "engine": engine, "n": rows, "ms": ms,
               "rows_per_s": rows_s, "roofline_model": model,
               "roofline_rows_per_s": roof, "roofline_frac": rows_s / roof,
               "launches": {k: v for k, v in launches.items() if v},
               "expected_kernels": expect,
               # idle share against the unprofiled median: the profiler
               # slows the host, not the device
               "trace": {"wall_ms_profiled": wall, "device_busy_ms": busy,
                         "idle_share": 1 - busy / ms if per else None,
                         "top": [[k[:90], v] for k, v in top]}}
        if label in xla_runs:
            res["xla_ms"] = time_ms(xla_runs[label],
                                    reps=max(5, args.reps // 2))
        results.append(res)
        log(f"phase 3: {json.dumps(res)}")
    for case, bits in (("g", 64), ("h", 32)):  # one K5 pass per key bit
        r = next(r for r in results if r["case"].startswith(case + " "))
        if r["launches"].get("partition_pass") != bits:
            raise AssertionError(f"({case}) launched {r['launches']}, "
                                 f"expected {bits} K5 passes")
    for r in results:  # one K5 pass per compaction or pivot partition
        want = k5_launches.get(r["case"])
        if want is not None and r["launches"].get("partition_pass",
                                                  0) != want:
            raise AssertionError(f"({r['case']}) launched {r['launches']}, "
                                 f"expected {want} K5 passes")
    main_launches = {name: sum(r["launches"].get(name, 0) for r in results)
                     for name in TPU_KERNELS}

    # the host engines, torch.sort and the native radix on the host, at
    # SMALL_N rows of (a)'s data: each must equal the stable comparison sort
    t0 = time.perf_counter()
    native.build()
    # the native radix runs one thread per hardware thread it is told of
    host_engines = {"native_build_s": time.perf_counter() - t0,
                    "cpu_count": os.cpu_count(),
                    "cpus_usable": len(os.sched_getaffinity(0))}
    log(f"phase 3: native harness built in "
        f"{host_engines['native_build_s']:.1f} s "
        f"({native.library_path().name})")
    hk, hp = k64[:SMALL_N], p64[:SMALL_N]
    want = srs.sort(hk, hp, method="xla", stable=True)
    for name in ("torch", "cpp"):
        got = srs.sort(hk, hp, method=name)
        if not all(g.device == w.device and torch.equal(signed(g), signed(w))
                   for g, w in zip(got, want)):
            raise AssertionError(f"method={name}: differs from the stable "
                                 "comparison sort of its input")
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            srs.sort(hk, hp, method=name)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        host_engines[name] = {"n": SMALL_N, "host_ms": statistics.median(
            reps), "host_ms_runs": reps}
    log(f"phase 3: host engines equal xla stable=True at {SMALL_N} rows "
        f"u64+u64: {json.dumps(host_engines)}")
    del hk, hp, want, got

    # ---- phase 3b: (k)-(p) at 10^6 rows on the CPU and on the card --------
    t0 = time.perf_counter()
    small = tpch_tables(SMALL_N // 4, SMALL_N, SMALL_N, args.seed, "cpu")
    small_dev = {k: signed(v).to(dev).view(v.dtype) for k, v in small.items()}
    agreed = []
    for on_cpu, on_card in zip(operator_cases(small, SMALL_N),
                               operator_cases(small_dev, SMALL_N)):
        label, run, gate, canon = (on_cpu[0], on_cpu[3], on_cpu[4],
                                   on_cpu[8])
        out_cpu = run(small)
        gate(small, out_cpu)
        out_card = on_card[3](small_dev)
        gate(small_dev, out_card)
        agree(label, canon(out_cpu), canon(out_card), signed)
        agreed.append(label)
    # torch.searchsorted on 1- and 2-byte carriers: the quick engine's
    # bucket ids and a join's probes
    from simd_radix_sort_tpu_torch.ops import hashjoin
    for dt in (torch.int8, torch.int16):
        keys = {d: small_t["ties"].to(dt) for d, small_t in
                (("cpu", small), ("cuda", small_dev))}
        outs = {d: (srs.sort(k, method="quick", device=k.device),
                    hashjoin.lookup_join(k, k[:1000])[:2])
                for d, k in keys.items()}
        agree(f"narrow {dt}", outs["cpu"], outs["cuda"], signed)
        agreed.append(f"narrow {dt}")
    del small, small_dev
    log(f"phase 3b: {len(agreed)} cases agree between the CPU and the card "
        f"at {SMALL_N} rows in {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: kernel times at the main paths' shapes -------------------
    del cases, xla_runs, kh, ph, ki, pi, kj
    u8 = as_width(randint(0, 256, n), 1)
    i32 = as_width(randint(0, 2, n), 4)
    i32w = as_width(randint(-500, 500, n), 4)
    h256 = ch.histogram(u8, 256, 0x80)
    h1024 = ch.histogram(i32w, 1024, (-500) & 0xFFFFFFFF)
    h256u = ch.histogram(u8[:n4], 256, 0)
    flip32 = 0x80000000
    part = [signed(k64), signed(p64)]
    part_mask = randint(0, 2, n) == 1
    u8_values = torch.arange(256, device=dev).to(torch.uint8)

    q6_streams = [tables[c] for c in Q6_COLUMNS]
    q6_keep = ~q6_mask(tables)  # K5 puts mask=False rows first
    n_q6 = q6_keep.numel()

    def bound(nbytes, ops):
        t_bytes = roofline.bound_ms(nbytes, chip)
        t_ops = ops / PEAK_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def argsort_gather(streams, mask):
        order = torch.argsort(mask, stable=True)
        return [signed(s).index_select(0, order) for s in streams]

    def fill_bare(hist, size, base, dtype):
        return [lambda: fill_at_tile(hist, size, base, dtype,
                                     ch.FILL_TILE_BYTES)], None

    def k5_bare(streams, mask, block=cp.PART_BLOCK):
        """K5's two kernels as bare launches, the count and the scatter,
        with the prefix the wrapper builds between them made once here;
        and the scatter's outputs."""
        size = mask.numel()
        counts = torch.empty(-(-size // block), dtype=torch.int32,
                             device=dev)

        def count():
            _build.launch("srs_partition_count", dev, mask.data_ptr(), size,
                          block, counts.data_ptr())

        count()
        left_off = ch.prefix_counts(counts)
        outs = [torch.empty_like(s) for s in streams]
        k = len(streams)
        ptrs = ((ctypes.c_void_p * k)(*(s.data_ptr() for s in streams)),
                (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs)),
                (ctypes.c_int * k)(*(s.element_size() for s in streams)))

        def scatter():
            _build.launch("srs_partition_scatter", dev, mask.data_ptr(), size,
                          block, left_off.data_ptr(), k, *ptrs)

        return [count, scatter], outs

    # (name, shape, kernel, plain, library call, its description, bytes,
    # operations, bare launches of K4-K6 for their event-timed device time)
    # K1's rows are k1_shape_timings' (below)
    shapes = [
        ("minmax_hist16", "int32 n=%d (cases c-e)" % n,
         lambda: ch.minmax_hist16(i32, flip32),
         lambda: ch.minmax_hist16_plain(i32, flip32),
         lambda: (torch.aminmax(i32), torch.bincount(i32 & 15,
                                                     minlength=16)),
         "aminmax + bincount", 4 * n + 18 * 4, n, None),
        ("tiny_sort16", "int32 ZeroOne n=%d (case c)" % n,
         lambda: ch.tiny_sort16(i32, flip32),
         lambda: ch.tiny_sort16_plain(i32, flip32),
         lambda: torch.sort(i32).values,
         "sort", 8 * n, 2 * n, None),
        ("fill_runs", "int8 n=%d k=256 (case b)" % n,
         lambda: ch.fill_runs(h256, n, 0x80, torch.int8),
         lambda: ch.fill_runs_plain(h256, n, 0x80, torch.int8),
         lambda: torch.repeat_interleave(
             torch.arange(256, device=dev).to(torch.int8),
             h256.to(torch.int64), output_size=n),
         "repeat_interleave", n + 257 * 8, n,
         lambda: fill_bare(h256, n, 0x80, torch.int8)),
        ("fill_runs", "int32 n=%d k=1024 (case d)" % n,
         lambda: ch.fill_runs(h1024, n, -500, torch.int32),
         lambda: ch.fill_runs_plain(h1024, n, (-500) & 0xFFFFFFFF,
                                    torch.int32),
         lambda: torch.repeat_interleave(
             torch.arange(-500, 524, device=dev, dtype=torch.int32),
             h1024.to(torch.int64), output_size=n),
         "repeat_interleave", 4 * n + 1025 * 8, n,
         lambda: fill_bare(h1024, n, -500, torch.int32)),
        # the mask read once, two int64 streams read once and written once
        ("partition_pass",
         "2 x int64 streams n=%d, random mask (one pass of case g)" % n,
         lambda: cp.partition_pass(part, part_mask),
         lambda: cp.partition_pass_plain(part, part_mask),
         lambda: argsort_gather(part, part_mask),
         "argsort(mask, stable=True) + one index_select per stream",
         33 * n, n, lambda: k5_bare(part, part_mask)),
        # the Q6 filter's pass (case k): an int32 and three float64 streams
        ("partition_pass",
         "int32 + 3 x float64 streams n=%d, Q6 mask (case k)" % n_q6,
         lambda: cp.partition_pass(q6_streams, q6_keep),
         lambda: cp.partition_pass_plain(q6_streams, q6_keep),
         lambda: argsort_gather(q6_streams, q6_keep),
         "argsort(mask, stable=True) + one index_select per stream",
         57 * n_q6, n_q6, lambda: k5_bare(q6_streams, q6_keep)),
        ("fill_runs_packed", "uint8 n=%d k=256 (case j)" % n4,
         lambda: ch.fill_runs_packed(h256u, n4),
         lambda: ch.fill_runs_packed_plain(h256u, n4),
         lambda: torch.repeat_interleave(u8_values, h256u.to(torch.int64),
                                         output_size=n4),
         "repeat_interleave", n4 + 257 * 8, n4,
         lambda: fill_bare(h256u, n4, 0, None)),
    ]
    timings = []
    for name, shape, kern, plain, lib, lib_call, nbytes, ops, bare in shapes:
        # plain, kernel, kernel, plain: the two versions alternate
        p1, k1 = time_ms(plain), time_ms(kern)
        k2, p2 = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound(nbytes, ops)
        _, per = device_profile(kern, (name,))
        mine = {k: v for k, v in per.items()
                if any(f in k for f in KERNEL_FUNCTIONS[name])}
        if name in ("fill_runs", "fill_runs_packed") and len(per) > 1:
            raise AssertionError(f"{name}: one call ran {sorted(per)} on "
                                 "the card, not its kernel alone")
        profiled = sum(mine.values()) if per else None
        events = None
        if bare is not None:  # K4-K6: this run's device time, always
            launches, outs = bare()
            events = event_device_ms(launches)
            if outs is not None:
                hold(name, outs, plain(), f"{shape} bare launches")
            del launches, outs
        t = {"name": name, "shape": shape, "ms": min(k1, k2),
             "device_ms": profiled if events is None else events,
             "device_ms_from": "profiler" if events is None else "events",
             "device_ms_profiler": profiled,
             "device_ms_by_function": {k[:80]: v for k, v in mine.items()},
             "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
             "plain_ms_runs": [p1, p2], "library_ms": lib_ms,
             "library_call": lib_call,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        timings.append(t)
        log(f"phase 4: {json.dumps(t)}")

    # K1 at the distributions of the main path, S1-S11; K2 and K3 at the
    # eight distributions and S6-S8, int32 and int16
    k1_rows = k1_shape_timings(n, args.seed, args.reps, dev, hold)
    k23_rows = k23_shape_timings(n, args.seed, args.reps, dev, hold)
    timings.extend(k7_timings(args.seed, args.reps, dev, chip))

    # K4 and K6 at tiles of 4-64 KiB, past the wrappers: the kernel's
    # device time from events around launches queued while the card spins,
    # the tiles taken in turn forwards and backwards, twice
    fill_shapes = [("fill_runs", "int8 k=256 (case b)", h256, n, 0x80,
                    torch.int8),
                   ("fill_runs", "int32 k=1024 (case d)", h1024, n, -500,
                    torch.int32),
                   ("fill_runs_packed", "uint8 k=256 (case j)", h256u, n4, 0,
                    None)]
    tiles = (4096, 8192, 16384, 32768, 65536)
    tile_ms = {(shape, tile): [] for _, shape, *_ in fill_shapes
               for tile in tiles}
    for name, shape, hist, size, base, dtype in fill_shapes:
        want = (ch.fill_runs_packed_plain(hist, size) if dtype is None
                else ch.fill_runs_plain(hist, size, base, dtype))
        for tile in tiles:
            hold(name, (fill_at_tile(hist, size, base, dtype, tile),),
                 (want,), f"{shape} tile={tile}")
        del want
        for tile in (*tiles, *reversed(tiles)) * 2:
            tile_ms[(shape, tile)].append(event_device_ms(
                [lambda: fill_at_tile(hist, size, base, dtype, tile)]))
    tile_sweep = [{"name": name, "shape": shape, "tile_bytes": tile,
                   "shipped": tile == ch.FILL_TILE_BYTES,
                   "device_ms_runs": tile_ms[(shape, tile)]}
                  for name, shape, *_ in fill_shapes for tile in tiles]
    for t in tile_sweep:
        log(f"phase 4: tile sweep {json.dumps(t)}")

    # ---- phase 5: the distributed tier --------------------------------------
    # each rank makes its own data; this process's tensors go first
    del shapes, fill_shapes, tables, k64, p64, u8, i32, i32w, part, part_mask
    del q6_streams, q6_keep, h256, h1024, h256u
    torch.cuda.empty_cache()
    world = max(p for p in (1, 2, 4) if p <= torch.cuda.device_count())
    t0 = time.perf_counter()
    if world == 1:
        distributed = distributed_phase(0, 1, free_port(), n, args.seed,
                                        args.reps)
    else:
        record = _build.BUILD_DIR / "distributed_phase.json"
        torch.multiprocessing.start_processes(
            distributed_phase, nprocs=world, start_method="spawn",
            args=(world, free_port(), n, args.seed, args.reps, str(record)))
        distributed = json.loads(record.read_text())
    for r in distributed["cases"]:
        for name, count in r["launches"].items():
            main_launches[name] += count
    log(f"phase 5: the distributed tier on {world} rank(s) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 6: the measurement layer -------------------------------------
    t0 = time.perf_counter()
    ch.reset_launches()
    cp.reset_launches()
    cs.reset_launches()
    case_a = next(r for r in results if r["case"].startswith("a "))
    measurement = measurement_phase(n, args.seed, args.reps, case_a["ms"],
                                    dev)
    measurement["launches"] = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
    for name, count in measurement["launches"].items():
        main_launches[name] += count
    measurement["seconds"] = time.perf_counter() - t0
    log(f"phase 6: the measurement layer in {measurement['seconds']:.1f} s, "
        f"launches {json.dumps(measurement['launches'])}")

    # ---- phase 7: the workload scripts and the examples ---------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    workloads = workloads_phase(n, args.seed, args.reps, world, dev)
    for r in workloads["cases"]:
        for name, count in r["launches"].items():
            main_launches[name] += count
    workloads["seconds"] = time.perf_counter() - t0
    log(f"phase 7: the workload scripts in {workloads['seconds']:.1f} s, "
        f"{workloads['k5_launches']} K5 launches")

    # ---- phase 8: the measurement-campaign drivers -------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drivers = drivers_phase(dev)
    drivers["summaries"] = [
        summarize_phase(d) for d in (_build.BUILD_DIR / "drivers" /
                                     "perf_suite", REPO / "bench_out_h100")]
    for r in drivers["drivers"]:
        for name, count in r["launches"].items():
            main_launches[name] += count
    drivers["seconds"] = time.perf_counter() - t0
    drivers["launches"] = {k: sum(r["launches"][k] for r in drivers["drivers"])
                           for k in main_launches}
    log(f"phase 8: the measurement drivers in {drivers['seconds']:.1f} s, "
        f"launches {json.dumps(drivers['launches'])}")

    # ---- phase 9: the entry points ------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entries = entry_phase(args.reps, dev)
    for name, count in entries["entry"]["launches"].items():
        main_launches[name] += count
    main_launches["partition_pass"] += entries["nccl"]["k5_launches"]
    entries["seconds"] = time.perf_counter() - t0
    log(f"phase 9: the entry points in {entries['seconds']:.1f} s")

    # ---- phase 10: the thresholds, count against xla on either side -------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ch.reset_launches()
    cp.reset_launches()
    cs.reset_launches()
    floors = floors_phase(args.seed, args.reps, dev)
    torch.cuda.synchronize()
    floors["launches"] = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
    for name, count in floors["launches"].items():
        main_launches[name] += count
    floors["seconds"] = time.perf_counter() - t0
    log(f"phase 10: the thresholds in {floors['seconds']:.1f} s, launches "
        f"{json.dumps(floors['launches'])}")

    kernels = []
    for name, (replaces, source) in TPU_KERNELS.items():
        t = next(x for x in k1_rows + timings if x["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": replaces,
            "launches": main_launches[name], "equal": errs[name] == 0,
            "comparisons": checks[name], "max_abs_err": errs[name],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")

    report = {"card": card, "torch": torch.__version__,
              "nvcc_report": (nvcc_log.read_text() if nvcc_log.exists()
                              else None),
              "cuda": torch.version.cuda, "n": n, "seed": args.seed,
              "kernels": kernels, "kernel_timings": timings,
              "k1_shapes": k1_rows,
              "fill_tile_sweep": tile_sweep,
              "main_path": results, "host_engines": host_engines,
              "cpu_card_agree": agreed,
              "distributed": distributed, "measurement": measurement,
              "workloads": workloads, "drivers": drivers,
              "entry_points": entries, "floors": floors,
              "k23_shapes": k23_rows,
              "seconds": time.perf_counter() - t_start}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(f"card: {card}")  # again here, within any tail of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
