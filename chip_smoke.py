#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simd_radix_sort_tpu_torch) on one card.

    python3 chip_smoke.py [--n ROWS] [--reps R] [--seed S] [--out FILE]

Phases, each raising on failure:
  1. device: the card's name and power limit; build the CUDA kernels.
  2. kernels: each of K1-K6 against its plain PyTorch version on the card,
     exactly (all are integer functions), at the main path's shapes and at
     ragged, misaligned and edge cases; K6 also against K4's uint8 output.
     K4 and K6 also where runs meet their tiles' edges
     (cuda_hist.tile_edge_cases), at the tile the wrappers launch with and
     at a 64-byte tile.
  3. main paths at --n rows (default 10^8), data made from --seed with the
     port's utils/data.py, each case driven with the launch counts set to 0
     just before it and read just after:
       (a)-(e) `sort(...)` with method="auto", checking the engine it
               resolves to and its output on the device;
       (f)     `sort(..., method="radix")`, u64 key + u64 payload;
       (g)     `radix.sort_arrays(..., engine="pallas")`, the same data:
               64 K5 launches;
       (h)     engine="pallas", int32 keys descending, uint16 payload;
       (i)     engine="scatter", int32 keys, int32 payload, 2^22 rows;
       (j)     uint8 keys through K1 and K6, the path of
               scripts/u8_attack.py's packed fill.
     (f)-(j) must equal the stable comparison sort of their input byte for
     byte; (a), (f) and (g) also pass bench.py's checksums.
  4. times: CUDA events, median of --reps after warm-up, for each kernel
     (kernel, plain version, one library call, bound) and each main-path
     case (rows/s and fraction of the roofline model); one further call of
     each under torch.profiler gives device time by kernel and the
     device's idle share of the call.  K4 and K6 are also timed at tiles
     of 4-64 KiB, and each of their calls must be one kernel on the card.

Prints one {"kernels": [...]} line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HIST_SOURCE = "simd_radix_sort_tpu_torch/csrc/hist_kernels.cu"
PARTITION_SOURCE = "simd_radix_sort_tpu_torch/csrc/partition_kernels.cu"
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
}
# the CUDA functions each wrapper launches, as the profiler names them
KERNEL_FUNCTIONS = {
    "histogram": ("histogram_kernel",),
    "minmax_hist16": ("minmax_hist16_kernel",),
    "tiny_sort16": ("minmax_hist16_kernel", "fill16_kernel"),
    "fill_runs": ("fill_runs_kernel",),
    "partition_pass": ("partition_count_kernel", "partition_scatter_kernel"),
    "fill_runs_packed": ("fill_runs_packed_kernel",),
}
# non-tensor-core int32/float32 peak of an H100 SXM (NVIDIA data sheet);
# every kernel here does a few integer operations per byte, far below it
PEAK_OPS = 67e12
MIX = 0x9E3779B97F4A7C15  # odd multiplier of bench.py's pair fingerprint


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import methods
    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                               cuda_partition as cp, radix)
    from simd_radix_sort_tpu_torch.utils import data as D, interop, transforms

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

    def signed(t):
        return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

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
    torch.cuda.synchronize()
    log(f"phase 2: kernels equal their plain versions "
        f"({json.dumps(checks)} comparisons) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3: main paths ------------------------------------------------
    def time_ms(fn, reps=args.reps, warmup=2):
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

    def device_profile(fn, kernels=()):
        """One call under torch.profiler after a warm-up: its wall time
        (CUDA events, profiler on) and the device time of every kernel,
        memset or copy it issued, by name.  The trace at times comes back
        without some device events, so it is taken again (at most three
        times) until every wrapper in `kernels` shows its CUDA functions;
        if none is complete, the device times are {}."""
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

    def count_launches(fn):
        ch.reset_launches()
        cp.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {**ch.LAUNCHES, **cp.LAUNCHES}

    def wrap64(x: int) -> int:
        return (int(x) + 2**63) % 2**64 - 2**63

    def xor_reduce(t) -> int:
        while t.numel() > 1:
            if t.numel() % 2:
                t = torch.cat([t, t.new_zeros(1)])
            h = t.numel() // 2
            t = t[:h] ^ t[h:]
        return int(t.item())

    def bench_checksums(keys, pay):
        """bench.py's gate on the host input: key sum and xor, and the sum
        and xor of the key-payload pair fingerprint, all mod 2^64."""
        with np.errstate(over="ignore"):
            pair_in = (keys * np.uint64(MIX)) ^ pay
            return (wrap64(keys.sum(dtype=np.uint64)),
                    wrap64(np.bitwise_xor.reduce(keys)),
                    wrap64(pair_in.sum(dtype=np.uint64)),
                    wrap64(np.bitwise_xor.reduce(pair_in)))

    def device_checksums(out):
        ko, po = (signed(t) for t in out)
        pair = (ko * wrap64(MIX)) ^ po
        return (int(ko.sum().item()), xor_reduce(ko),
                int(pair.sum().item()), xor_reduce(pair))

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
    sums64 = bench_checksums(keys, pay)
    k64, (p64,) = stage(keys, (pay,))
    del keys, pay

    def check_bench(label, out):
        if not sorted_carrier(out[0], True):
            raise AssertionError(f"{label}: not sorted")
        got = device_checksums(out)
        if got != sums64:
            raise AssertionError(f"{label}: checksums {got} != {sums64}")

    def auto_case(label, keys, pays, asc, engine, row_bytes):
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
        results.append(res)
        log(f"phase 3: {json.dumps(res)}")
    for case, bits in (("g", 64), ("h", 32)):  # one K5 pass per key bit
        r = next(r for r in results if r["case"].startswith(case + " "))
        if r["launches"].get("partition_pass") != bits:
            raise AssertionError(f"({case}) launched {r['launches']}, "
                                 f"expected {bits} K5 passes")
    main_launches = {name: sum(r["launches"].get(name, 0) for r in results)
                     for name in TPU_KERNELS}

    # ---- phase 4: kernel times at the main paths' shapes -------------------
    del cases, kh, ph, ki, pi, kj
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

    def bound(nbytes, ops):
        t_bytes = roofline.bound_ms(nbytes, chip)
        t_ops = ops / PEAK_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def argsort_gather():
        order = torch.argsort(part_mask, stable=True)
        return [s.index_select(0, order) for s in part]

    # (name, shape, kernel, plain, library call, its description, bytes,
    # operations)
    shapes = [
        ("histogram", "uint8 n=%d k=256 (case b)" % n,
         lambda: ch.histogram(u8, 256, 0x80),
         lambda: ch.histogram_plain(u8, 256, 0x80),
         lambda: torch.bincount(u8.view(torch.uint8), minlength=256),
         "bincount", n + 256 * 4, n),
        ("histogram", "int32 n=%d k=1024 (case d)" % n,
         lambda: ch.histogram(i32w, 1024, -500),
         lambda: ch.histogram_plain(i32w, 1024, (-500) & 0xFFFFFFFF),
         lambda: torch.bincount(i32w + 500, minlength=1024),
         "bincount", 4 * n + 1024 * 4, n),
        ("minmax_hist16", "int32 n=%d (cases c-e)" % n,
         lambda: ch.minmax_hist16(i32, flip32),
         lambda: ch.minmax_hist16_plain(i32, flip32),
         lambda: (torch.aminmax(i32), torch.bincount(i32 & 15,
                                                     minlength=16)),
         "aminmax + bincount", 4 * n + 18 * 4, n),
        ("tiny_sort16", "int32 ZeroOne n=%d (case c)" % n,
         lambda: ch.tiny_sort16(i32, flip32),
         lambda: ch.tiny_sort16_plain(i32, flip32),
         lambda: torch.sort(i32).values,
         "sort", 8 * n, 2 * n),
        ("fill_runs", "int8 n=%d k=256 (case b)" % n,
         lambda: ch.fill_runs(h256, n, 0x80, torch.int8),
         lambda: ch.fill_runs_plain(h256, n, 0x80, torch.int8),
         lambda: torch.repeat_interleave(
             torch.arange(256, device=dev).to(torch.int8),
             h256.to(torch.int64), output_size=n),
         "repeat_interleave", n + 257 * 8, n),
        ("fill_runs", "int32 n=%d k=1024 (case d)" % n,
         lambda: ch.fill_runs(h1024, n, -500, torch.int32),
         lambda: ch.fill_runs_plain(h1024, n, (-500) & 0xFFFFFFFF,
                                    torch.int32),
         lambda: torch.repeat_interleave(
             torch.arange(-500, 524, device=dev, dtype=torch.int32),
             h1024.to(torch.int64), output_size=n),
         "repeat_interleave", 4 * n + 1025 * 8, n),
        # the mask read once, two int64 streams read once and written once
        ("partition_pass",
         "2 x int64 streams n=%d, random mask (one pass of case g)" % n,
         lambda: cp.partition_pass(part, part_mask),
         lambda: cp.partition_pass_plain(part, part_mask),
         argsort_gather,
         "argsort(mask, stable=True) + one index_select per stream",
         33 * n, n),
        ("fill_runs_packed", "uint8 n=%d k=256 (case j)" % n4,
         lambda: ch.fill_runs_packed(h256u, n4),
         lambda: ch.fill_runs_packed_plain(h256u, n4),
         lambda: torch.repeat_interleave(u8_values, h256u.to(torch.int64),
                                         output_size=n4),
         "repeat_interleave", n4 + 257 * 8, n4),
    ]
    timings = []
    for name, shape, kern, plain, lib, lib_call, nbytes, ops in shapes:
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
        t = {"name": name, "shape": shape, "ms": min(k1, k2),
             "device_ms": sum(mine.values()) if per else None,
             "device_ms_by_function": {k[:80]: v for k, v in mine.items()},
             "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
             "plain_ms_runs": [p1, p2], "library_ms": lib_ms,
             "library_call": lib_call,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        timings.append(t)
        log(f"phase 4: {json.dumps(t)}")

    # K4 and K6 at tiles of 4-64 KiB, past the wrappers: the kernel's
    # device time in one call from the profiler (back-to-back launches
    # between events would time the host's launch rate), the tiles taken in
    # turn forwards and backwards, twice
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
            _, per = device_profile(
                lambda: fill_at_tile(hist, size, base, dtype, tile), (name,))
            tile_ms[(shape, tile)].append(sum(per.values()) if per else None)
    tile_sweep = [{"name": name, "shape": shape, "tile_bytes": tile,
                   "shipped": tile == ch.FILL_TILE_BYTES,
                   "device_ms_runs": tile_ms[(shape, tile)]}
                  for name, shape, *_ in fill_shapes for tile in tiles]
    for t in tile_sweep:
        log(f"phase 4: tile sweep {json.dumps(t)}")

    kernels = []
    for name, (replaces, source) in TPU_KERNELS.items():
        t = next(x for x in timings if x["name"] == name)
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
              "fill_tile_sweep": tile_sweep,
              "main_path": results,
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
