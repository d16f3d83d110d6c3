"""Time the port's kernels K1-K8 on one card, and compare checkouts' kernels
in turns.

    python -m simd_radix_sort_tpu_torch.workloads.kernel_ab \\
        --trees TREE[,TREE...] [--n ROWS] [--reps R] [--out FILE]

Each entry of --trees is the root of a checkout of this repository (`.`,
or an unpacked `git archive`); the same root may come more than once, so
that versions alternate (PARENT,CHANGE,CHANGE,PARENT).  For each entry in
order, one child process runs this file, from that root and with that
root's package first on its path: it builds that checkout's kernels, then
records

  - the kernel table (`kernel_rows`): each of K1-K8 at the shape of its row
    (n rows; K7 at Q1's shape at TPC-H SF30 and at 10^6 rows; K8 at 10^8
    and 6.0e8 int64 keys, where the checkout has it): the
    wrapper's call ms, the kernel's device ms, the plain version's ms, one
    library call's ms and the bound (the bytes the kernel must move at the
    card's memory rate);
  - K1 at the distributions the count engine hands it (`k1_shape_timings`:
    K1_SHAPES, S1-S11);
  - K2 and K3 at 22 shapes (`k23_shape_timings`: int32 and int16 keys at
    the eight reference distributions and S6-S8's draws);
  - one host read of K8's word (`host_read_timings`), where the checkout
    has K8.

The outputs of K1-K6's timed launches are held against their plain
versions, K7's calls against each other and K8's words against its plain
version's.  The helpers come from this file and the kernels from the
checkout, so a checkout must have K2's cuda_hist.STATS_WORDS interface; K7
is timed where the checkout has ops/cuda_scan.py.

Then this process times each checkout's `minmax_hist16` and `tiny_sort16`
calls at 2^22 Uniform int32 and int16 keys, the checkouts' packages
imported side by side and timed in turns (CALL_ROUNDS rounds, the order
reversed every other round): a call at that size is host-bound, and host
times differ more between processes than between the versions, so only one
process can compare them.

The records go to --out (JSON: one per entry, in order, and the turns);
each tree's kernel table and medians go to standard output.  Needs one
CUDA card; nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALL_N = 1 << 22
CALL_ROUNDS = 5
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


def _held(name, got, want, what):
    import torch

    for g, w in zip(got, want, strict=True):
        if not torch.equal(g.to(torch.int64), w.to(torch.int64)):
            raise AssertionError(f"{name} {what}: kernel differs from its "
                                 "plain version")


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
            if ev.device_type == torch.autograd.DeviceType.CUDA:
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


# K1 at the distributions the main path hands it, as (label, key dtype,
# distribution, k).  S1-S5: sort() of 1-byte keys (k = 256); S6-S8 and
# S9-S11: int32 and int16 keys of range in [16, 1024), count's adaptive
# branch (k = 1024).
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
SPREAD_RUNS = 3  # event_device_ms measurements of each shape


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


def k1_shape_timings(n: int, seed: int, reps: int, dev, hold) -> list:
    """K1's rows at K1_SHAPES, n rows each: the kernel's device ms
    (event_device_ms of bare launches into one output, SPREAD_RUNS times:
    median and runs), the wrapper's and the plain version's call ms,
    torch.bincount's ms on the same offsets (the library call), the bound
    (the carrier read once at the card's memory rate) and device/bound.
    The bare launches' output is held against the plain version through
    `hold`."""
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

        runs = [event_device_ms([bare]) for _ in range(SPREAD_RUNS)]
        out.zero_()
        bare()
        hold("histogram", (out,), (ch.histogram_plain(c, k, base),),
             f"{label} bare launch")
        device_ms = statistics.median(runs)
        bound = max(roofline.bound_ms(n * w, chip), n / PEAK_OPS * 1e3)
        rows.append({
            "name": "histogram", "shape": label, "n": n, "k": k,
            "device_ms": device_ms, "device_ms_runs": runs,
            "spread": max(runs) / min(runs),
            "ms": time_calls(lambda: ch.histogram(c, k, base), reps),
            "plain_ms": time_calls(
                lambda: ch.histogram_plain(c, k, base), reps),
            "library_ms": time_calls(
                lambda: torch.bincount(off, minlength=k), reps),
            "library_call": "bincount", "bound_ms": bound,
            "bound_by": "bytes", "device_over_bound": device_ms / bound,
            "top_bucket_share": int(out.max().item()) / n})
        del c, off, out
    return rows


# K2 and K3 where the count engine hands them its 2- and 4-byte keys: every
# call of those widths pays them before it picks a branch
K23_TYPES = ("int32", "int16")
K23_DISTRIBUTIONS = ("Uniform", "Gaussian", "Zero", "ZeroOne", "Sorted",
                     "ReverseSorted", "AlmostSorted", "AlmostReverseSorted")


def device_keys(dtype: str, dist: str, n: int, gen, dev):
    """int16 or int32 keys of one of the reference's eight distributions
    (utils/data.py's definitions), drawn on the card from `gen`: Uniform
    over the type, Gaussian (sigma 100, rounded, wrapped through int64),
    Zero, ZeroOne, and the sorted family (uniform keys sorted, reversed,
    with 2^log10(n) pairs swapped for the Almost ones)."""
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


def k23_shape_timings(n: int, seed: int, reps: int, dev, hold) -> list:
    """K2's and K3's rows: n keys of int32 and int16 at the eight
    distributions (device_keys) and at S6-S8's draws (k1_keys): each
    kernel's device ms (event_device_ms of bare launches, SPREAD_RUNS
    times: median and runs; K3 is K2's launch and its fill), the wrapper's
    call ms, the bound (K2 reads the keys once, K3 also writes them once,
    at the card's memory rate) and device/bound.  The bare launches'
    outputs are held against the plain versions through `hold`."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import _build, cuda_hist as ch

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
                        for _ in range(SPREAD_RUNS)]
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
                rows.append({
                    "name": name, "shape": f"{dtype} {shape}", "n": n,
                    "device_ms": device_ms, "device_ms_runs": runs,
                    "spread": max(runs) / min(runs),
                    "ms": time_calls(lambda: wrapper(x, flip), reps),
                    "bound_ms": bound, "bound_by": "bytes",
                    "device_over_bound": device_ms / bound})
            del x, stats, out
    return rows


# K7, the segmented scans, at Q1's shape at SF30 (its 1.76e8 selected rows,
# 4 groups, five float64 sums: one launch) and at 10^6 rows
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


def k7_timings(seed: int, reps: int, dev, chip) -> list:
    """K7 at K7_TIMED_ROWS: five float64 sums in 4 groups, Q1's scan.  The
    wrapper's ms (CUDA events), the kernels' device ms (event_device_ms of
    wrapper calls: they run nothing else on the card) and by function
    (profiler), the plain version's ms, torch.cumsum's over the same
    streams (unsegmented: a yardstick), and the bound: the flags read once
    and each stream read once and written once, 81 bytes a row.  Two calls
    must give the same bits (tests/test_torch_scan_card.py holds the
    kernel against its plain version at Q1's shape)."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import cuda_scan as cs

    rows = []
    ops = ["sum"] * 5
    for n in K7_TIMED_ROWS:
        starts, vals = k7_inputs(n, 5, "float64", 4, seed, dev)
        got = cs.segmented_scans(vals, starts, ops)
        again = cs.segmented_scans(vals, starts, ops)
        for a, b in zip(got, again):
            if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
                raise AssertionError(f"K7 n={n}: two calls differ")
        del got, again

        def kern():
            return cs.segmented_scans(vals, starts, ops)

        def plain():
            return cs.segmented_scans_plain(vals, starts, ops)

        def lib():
            return [torch.cumsum(v, 0) for v in vals]

        p1, k1 = time_calls(plain, reps), time_calls(kern, reps)
        k2, p2 = time_calls(kern, reps), time_calls(plain, reps)
        runs = [event_device_ms([kern]) for _ in range(SPREAD_RUNS)]
        _, per = profile_call(kern, ("segmented_scan",))
        nbytes = n * (1 + 5 * 16)
        bound = roofline.bound_ms(nbytes, chip)
        rows.append({
            "name": "segmented_scan",
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
            "device_over_bound": statistics.median(runs) / bound})
        del starts, vals
    return rows


# K8, the key bits of cub's pair sort, at 10^8 rows and at Q18's 6.0e8
# l_orderkey rows (SF100), int64 keys in [1, 6.0e8]: a window narrower than
# the key, so the whole stream is read
K8_TIMED_ROWS = (100_000_000, 600_000_000)
K8_KEY_MAX = 600_000_000
HOST_READS = 200  # reads a round of host_read_timings
HOST_READ_ROUNDS = 21


def k8_timings(seed: int, reps: int, dev, chip) -> list:
    """K8 at K8_TIMED_ROWS: the wrapper's call ms (CUDA events), the device
    ms of bare launches of its C entry (event_device_ms: both kernels), the
    plain version's ms on the card, torch.aminmax's (the library's nearest
    reduction) and the bound, n * 8 bytes read once.  The kernel's words
    are held against the plain version's."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import _build, cuda_sort as cs

    rows = []
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for n in K8_TIMED_ROWS:
        keys = torch.randint(1, K8_KEY_MAX + 1, (n,), generator=g,
                             device=dev, dtype=torch.int64)
        _held("key_bits", [cs.key_bits(keys)], [cs.key_bits_plain(keys)],
              f"int64 [1, {K8_KEY_MAX}] n={n}")
        words = torch.empty(2, dtype=torch.int64, device=dev)

        def bare():
            _build.launch("srs_key_bits", dev, keys.data_ptr(), 8, n,
                          words.data_ptr(), None)

        p1, k1 = (time_calls(lambda: cs.key_bits_plain(keys), reps),
                  time_calls(lambda: cs.key_bits(keys), reps))
        k2, p2 = (time_calls(lambda: cs.key_bits(keys), reps),
                  time_calls(lambda: cs.key_bits_plain(keys), reps))
        runs = [event_device_ms([bare]) for _ in range(SPREAD_RUNS)]
        bound = roofline.bound_ms(8 * n, chip)
        rows.append({
            "name": "key_bits", "shape": f"int64 in [1, {K8_KEY_MAX}] n={n}",
            "n": n, "ms": min(k1, k2), "ms_runs": [k1, k2],
            "device_ms": statistics.median(runs), "device_ms_runs": runs,
            "device_ms_from": "events", "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2],
            "library_ms": time_calls(lambda: torch.aminmax(keys), reps),
            "library_call": "aminmax", "bound_ms": bound,
            "bound_by": "bytes", "bytes": 8 * n,
            "device_over_bound": statistics.median(runs) / bound})
        del keys, words
    return rows


def host_read_timings(dev) -> dict:
    """One read of K8's word as cuda_sort.bit_window makes it (K8's two
    launches over one key, the 8-byte copy into pinned memory and the
    host's wait) on an otherwise idle card: host clock over HOST_READS
    reads a round, HOST_READ_ROUNDS rounds; the median us a read is what
    cuda_sort.HOST_READ_S holds."""
    import torch

    from simd_radix_sort_tpu_torch.ops import cuda_sort as cs

    keys = torch.zeros(1, dtype=torch.int64, device=dev)

    def read():
        return cs._wait_read(cs._queue_read(keys), dev)

    for _ in range(HOST_READS):
        read()
    runs = []
    for _ in range(HOST_READ_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(HOST_READS):
            read()
        runs.append((time.perf_counter() - t0) / HOST_READS * 1e6)
    return {"us": statistics.median(runs), "us_runs": runs,
            "reads_a_round": HOST_READS}


def kernel_rows(n: int, seed: int, reps: int, dev, hold) -> list:
    """The kernel table's rows of K2-K6 at n rows: each wrapper's call ms
    and its plain version's (timed plain, kernel, kernel, plain), one
    library call's ms, the bound (bytes at the card's memory rate, or
    operations at PEAK_OPS, whichever is longer), and the kernel's device
    ms: from CUDA events around bare launches for K4-K6, from the profiler
    for K2 and K3 (with the time of each CUDA function).  A K4 or K6 call
    must be one kernel on the card, and the bare launches' outputs are
    held against the plain versions through `hold`."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                               cuda_partition as cp)
    from simd_radix_sort_tpu_torch.workloads.common import signed

    chip = roofline.chip_for_name(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64)

    n4 = n - n % 4
    u8 = randint(0, 256, n).to(torch.uint8)
    i32 = randint(0, 2, n).to(torch.int32)
    h256 = ch.histogram(u8, 256, 0x80)
    h1024 = ch.histogram(randint(-500, 500, n).to(torch.int32), 1024,
                         (-500) & 0xFFFFFFFF)
    h256u = ch.histogram(u8[:n4], 256, 0)
    flip32 = 0x80000000
    part = [randint(-(2**62), 2**62, n) for _ in range(2)]
    part_mask = randint(0, 2, n) == 1
    u8_values = torch.arange(256, device=dev).to(torch.uint8)
    tile = ch.FILL_TILE_BYTES

    def fill_bare(hist, size, base, dtype):
        out = torch.empty(size, dtype=dtype or torch.uint8, device=dev)
        w = out.element_size()
        if dtype is None:
            args = ("srs_fill_runs_packed", dev, hist.data_ptr(),
                    hist.numel(), size, tile, out.data_ptr())
        else:
            args = ("srs_fill_runs", dev, hist.data_ptr(), hist.numel(),
                    size, base & ((1 << (8 * w)) - 1), w, tile,
                    out.data_ptr())
        return [lambda: _build.launch(*args)], [out]

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
    # operations, bare launches of K4-K6 and their outputs)
    shapes = [
        ("minmax_hist16", f"int32 ZeroOne n={n} (cases c-e)",
         lambda: ch.minmax_hist16(i32, flip32),
         lambda: ch.minmax_hist16_plain(i32, flip32),
         lambda: (torch.aminmax(i32), torch.bincount(i32 & 15,
                                                     minlength=16)),
         "aminmax + bincount", 4 * n + 18 * 4, n, None),
        ("tiny_sort16", f"int32 ZeroOne n={n} (case c)",
         lambda: ch.tiny_sort16(i32, flip32),
         lambda: ch.tiny_sort16_plain(i32, flip32),
         lambda: torch.sort(i32).values,
         "sort", 8 * n, 2 * n, None),
        ("fill_runs", f"int8 n={n} k=256 (case b)",
         lambda: ch.fill_runs(h256, n, 0x80, torch.int8),
         lambda: ch.fill_runs_plain(h256, n, 0x80, torch.int8),
         lambda: torch.repeat_interleave(
             torch.arange(256, device=dev).to(torch.int8),
             h256.to(torch.int64), output_size=n),
         "repeat_interleave", n + 257 * 8, n,
         lambda: fill_bare(h256, n, 0x80, torch.int8)),
        ("fill_runs", f"int32 n={n} k=1024 (case d)",
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
         f"2 x int64 streams n={n}, random mask (one pass of case g)",
         lambda: cp.partition_pass(part, part_mask),
         lambda: cp.partition_pass_plain(part, part_mask),
         lambda: [signed(s).index_select(0, torch.argsort(
             part_mask, stable=True)) for s in part],
         "argsort(mask, stable=True) + one index_select per stream",
         33 * n, n, lambda: k5_bare(part, part_mask)),
        ("fill_runs_packed", f"uint8 n={n4} k=256 (case j)",
         lambda: ch.fill_runs_packed(h256u, n4),
         lambda: ch.fill_runs_packed_plain(h256u, n4),
         lambda: torch.repeat_interleave(u8_values, h256u.to(torch.int64),
                                         output_size=n4),
         "repeat_interleave", n4 + 257 * 8, n4,
         lambda: fill_bare(h256u, n4, 0, None)),
    ]
    rows = []
    for name, shape, kern, plain, lib, lib_call, nbytes, ops, bare in shapes:
        p1, k1 = time_calls(plain, reps), time_calls(kern, reps)
        k2, p2 = time_calls(kern, reps), time_calls(plain, reps)
        lib_ms = time_calls(lib, reps)
        t_bytes, t_ops = roofline.bound_ms(nbytes, chip), ops / PEAK_OPS * 1e3
        _, per = profile_call(kern, (name,))
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
            want = plain()
            hold(name, outs, want if isinstance(want, list) else [want],
                 f"{shape} bare launches")
            del launches, outs, want
        device_ms = profiled if events is None else events
        bound = max(t_bytes, t_ops)
        rows.append({
            "name": name, "shape": shape, "n": n, "ms": min(k1, k2),
            "device_ms": device_ms,
            "device_ms_from": "profiler" if events is None else "events",
            "device_ms_profiler": profiled,
            "device_ms_by_function": {k[:80]: v for k, v in mine.items()},
            "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2], "library_ms": lib_ms,
            "library_call": lib_call, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "device_over_bound": (device_ms / bound if device_ms is not None
                                  else None)})
    return rows


def worker(n: int, seed: int, reps: int) -> dict:
    """One checkout's record; runs with that checkout on sys.path."""
    import torch

    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import _build

    dev = torch.device("cuda")
    _build.library()
    chip = roofline.chip_for_name(torch.cuda.get_device_name(0))
    k1 = k1_shape_timings(n, seed, reps, dev, _held)
    table = k1[:1] + kernel_rows(n, seed, reps, dev, _held)
    if importlib.util.find_spec("simd_radix_sort_tpu_torch.ops.cuda_scan"):
        table += k7_timings(seed, reps, dev, chip)
    host_read = None
    if hasattr(importlib.import_module(
            "simd_radix_sort_tpu_torch.ops.cuda_sort"), "key_bits"):
        table += k8_timings(seed, reps, dev, chip)
        host_read = host_read_timings(dev)
    return {"table": table, "k1": k1, "host_read": host_read,
            "k23": k23_shape_timings(n, seed, reps, dev, _held),
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()}


def summary(tree: str, recs: list) -> dict:
    """Medians over a tree's records of each row's device ms: the table's,
    K1's shapes' and K2's and K3's shapes'."""
    out = {"tree": tree, "cards": sorted({r["card"] for r in recs})}
    for part in ("table", "k1", "k23"):
        ms = {}
        for r in recs:
            for row in r[part]:
                ms.setdefault(f"{row['name']} {row['shape']}",
                              []).append(row["device_ms"])
        out[part] = {k: statistics.median(v) for k, v in ms.items()}
    return out


def _package(tree: str, alias: str):
    """The checkout's package, imported under `alias` (its imports are
    relative, so two checkouts' packages live side by side)."""
    root = Path(tree, "simd_radix_sort_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def calls_in_turns(trees: list, seed: int, reps: int) -> dict:
    """{tree: {"<wrapper> <dtype>": [call ms of each round]}}: each tree's
    own minmax_hist16 and tiny_sort16 wrappers (its package imported
    under an alias, its library as its child built it) at CALL_N Uniform
    int32 and int16 keys, the trees in turns for CALL_ROUNDS rounds, the
    order reversed every other round; each output held equal to the plain
    version's."""
    import torch

    hists = {}
    for i, tree in enumerate(trees):
        _package(tree, f"kernel_ab_tree{i}")
        hists[tree] = importlib.import_module(
            f"kernel_ab_tree{i}.ops.cuda_hist")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = {d: device_keys(d, "Uniform", CALL_N, gen, dev)
            for d in K23_TYPES}
    out = {tree: {} for tree in trees}
    for r in range(CALL_ROUNDS):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            ch = hists[tree]
            for d, x in keys.items():
                flip = 1 << (8 * x.element_size() - 1)
                for name in ("minmax_hist16", "tiny_sort16"):
                    fn = getattr(ch, name)
                    _held(name, fn(x, flip),
                          getattr(ch, name + "_plain")(x, flip),
                          f"{tree} {d}")
                    out[tree].setdefault(f"{name} {d}", []).append(
                        time_calls(lambda: fn(x, flip), 3 * reps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", required=True,
                    help="comma-separated checkout roots, timed in order")
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rec = worker(args.n, args.seed, args.reps)
        Path(args.out).write_text(json.dumps(rec))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in args.trees.split(",")]
    out = Path(args.out or "kernel_ab.json").resolve()
    records = []
    for i, tree in enumerate(trees):
        part = out.with_suffix(f".{i}.json")
        # -P: the checkout, not this file's directory, comes first on the
        # path, so the child imports that checkout's package
        env = {**os.environ, "PYTHONPATH": tree}
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-P", __file__, "--worker",
                        "--trees", tree, "--n", str(args.n), "--reps",
                        str(args.reps), "--seed", str(args.seed), "--out",
                        str(part)], cwd=tree, env=env, check=True)
        records.append({"tree": tree, **json.loads(part.read_text()),
                        "seconds": time.perf_counter() - t0})
        part.unlink()
        print(f"kernel_ab: {tree} done in {records[-1]['seconds']:.1f} s",
              flush=True)
    distinct = list(dict.fromkeys(trees))
    turns = calls_in_turns(distinct, args.seed, args.reps)
    summaries = [{**summary(t, [r for r in records if r["tree"] == t]),
                  "calls_in_turns": {k: statistics.median(v)
                                     for k, v in turns[t].items()}}
                 for t in distinct]
    out.write_text(json.dumps({"records": records, "summaries": summaries,
                               "calls_in_turns": turns}, indent=1))
    for r in records:
        print(f"kernel table of {r['tree']} ({r['card']}):")
        for row in r["table"]:
            print(json.dumps({k: row[k] for k in (
                "name", "shape", "ms", "device_ms", "bound_ms",
                "device_over_bound", "plain_ms", "library_ms")}))
    for s in summaries:
        print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
