"""The measurement campaign that fills bench_out_h100/.

Runs the perf drivers' tiers, each as a child process with
SRS_TORCH_PERF_DIR pointing at --out and its output in
--out/logs/<command>.log, and the campaign's own sweeps and grids that set
the port's constants, and appends to --out/CARD.json what it ran: the
card (`nvidia-smi` name and power limit), torch, CUDA, the commit it was
given, a digest of the port's sources, and each command with its wall
time, exit code and the tables it wrote.  A part that reaches
--deadline-s is stopped; run the same parts again and each driver resumes
where it stopped (--resume; the campaign's own commands skip a table that
exists).

    python -m simd_radix_sort_tpu_torch.workloads.campaign --parts a,b,c,d
        [--out bench_out_h100] [--deadline-s 3000] [--commit SHA]

Parts:
  a  perf_suite --full --n 4194304: 11 combos x 8 distributions of method
     tables, sweeps, knobs, the quicksort study and speedups at 2^22 rows;
  b  perf_suite --tpe-breadth: sweeps 2^10..2^22 and the 10^8 anchors;
  c  knob_epoch at its default n;
  d  xla and count, 2^14..2^27 rows, keys-only, into <out>/large_n/ (the
     device gate from 2^24 rows up): uint8 Uniform, int32 Uniform, Zero
     and ZeroOne, and the 1-byte floor's evidence, uint8 Zero, Sorted and
     ReverseSorted and int8 Uniform;
  e  perf_suite at 2^18 (default and --full), --int8, --packed, and
     remeasure_noise;
  f  the evidence past the 2- and 4-byte crossover: xla and count sweeps
     of int16 and uint16 Uniform and Zero into <out>/large_n/, method
     tables of the device engines for int16, uint16, int32 and uint32
     keys-only at 2^22..2^26 rows (ADAPTIVE_TABLE_NS) over the 8
     distributions, and uint8's at 2^22 (part a's 1-byte table);
  g  the count engine's branch gates (SMALL_MIN_N, K_MAX_RANGE): its
     1024-bucket branch forced on and off against xla, 2^14..2^27 rows of
     int16, uint16, int32 and uint32 keys with a range in [16, 1024) in
     three shapes, and at spans 16..1023 at 2^24 and 2^27 rows, into
     <out>/large_n/gate-<type>-<shape>.dat;
  h  the quick engine's constants: method="quick" over a grid of
     MAX_BUCKETS, OVERSAMPLE, BLOCK and the target segment, four workloads
     at 2^20..2^26 rows, into <out>/quick_grid/grid.dat.

Every row of parts d, f and g runs its columns in turns in one process:
ROUNDS rounds, each timing every column's rep loop (perf.rep_counts) in
turn, the order reversed every other round; a cell is the median of its
rounds.  Calls move by up to 25% between epochs, which interleaving
cancels.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .. import perf
from ..utils import common
from ..utils import data as D
from ..utils.profiling import elapsed_seconds

PKG = Path(__file__).resolve().parent.parent
DRIVER = "simd_radix_sort_tpu_torch.workloads."

PARTS = {
    "a": [["perf_suite", "--full", "--n", "4194304", "--resume"]],
    "b": [["perf_suite", "--tpe-breadth", "--resume"]],
    "c": [["knob_epoch", "--resume"]],
    "d": [["campaign", "--sweep", "uint8-Uniform"],
          ["campaign", "--sweep", "int32-Uniform"],
          ["campaign", "--sweep", "int32-Zero"],
          ["campaign", "--sweep", "int32-ZeroOne"],
          ["campaign", "--sweep", "uint8-Zero"],
          ["campaign", "--sweep", "uint8-Sorted"],
          ["campaign", "--sweep", "uint8-ReverseSorted"],
          ["campaign", "--sweep", "int8-Uniform"]],
    "e": [["perf_suite", "--resume"],
          ["perf_suite", "--full", "--resume"],
          ["perf_suite", "--int8", "--resume"],
          ["perf_suite", "--packed", "--resume"],
          ["remeasure_noise"]],
    "f": [["campaign", "--sweep", "int16-Uniform"],
          ["campaign", "--sweep", "int16-Zero"],
          ["campaign", "--sweep", "uint16-Uniform"],
          ["campaign", "--sweep", "uint16-Zero"],
          ["campaign", "--tables", "int16"],
          ["campaign", "--tables", "uint16"],
          ["campaign", "--tables", "int32"],
          ["campaign", "--tables", "uint32"],
          ["campaign", "--tables", "uint8", "--n", "4194304"]],
    "g": [["campaign", "--gate", t]
          for t in ("int16", "uint16", "int32", "uint32")],
    "h": [["campaign", "--quick-grid"]],
}

# rounds of every column of a row, taken in turns (parts d, f, g)
ROUNDS = 5
# part d: the sweep's rows, and where its validation moves to the device
LARGE_N_DIR = "large_n"
LARGE_N_METHODS = ["xla", "count"]
LARGE_N_MIN = 1 << 14
LARGE_N_DEVICE_GATE = 1 << 24
LARGE_N_MAX = 1 << 27
# part f: the sizes and engines of the 2- and 4-byte keys-only tables
ADAPTIVE_TABLE_NS = tuple(1 << e for e in range(22, 27))
DEVICE_METHODS = ["xla", "radix", "count", "quick"]
# part g: key types, shapes (kernel_ab.k1_keys' three draws) and spans
GATE_TYPES = ("int16", "uint16", "int32", "uint32")
GATE_SHAPES = ("Uniform", "Zipf", "OneValue")
GATE_COLUMNS = ("branch", "fallback", "xla")
GATE_SPANS = (16, 64, 256, 1023)
GATE_SPAN_NS = (1 << 24, 1 << 27)
# part h: the grid (the target segment as BLOCK // divisor), workloads as
# (key type, payload types, distribution), sizes, and rows a timed loop
# sorts
QUICK_GRID = {"max_buckets": (1024, 4096, 16384),
              "oversample": (16, 32, 64),
              "block": (4096, 16384, 65536),
              "target_divisor": (8, 4)}
QUICK_WORKLOADS = (("uint64", ("uint64",), "Uniform"),
                   ("int32", (), "Uniform"),
                   ("double", (), "Gaussian"),
                   ("int32", (), "Zipf"))
QUICK_NS = (1 << 20, 1 << 22, 1 << 24, 1 << 26)
QUICK_STABLE_NS = (1 << 24,)
QUICK_LOOP_ROWS = 1 << 25
QUICK_ROUNDS = 2
QUICK_DIR = "quick_grid"
QUICK_HEADER = ("max_buckets oversample block target workload "
                "number_of_elements stable nanoseconds_per_element path")


def interleaved(columns, datasets, num: int, device):
    """Time `columns` (name -> fn(keys, payloads) -> output) in turns on
    the staged `datasets` ((keys, payloads) tensors): each column's
    warm-ups, then ROUNDS rounds, each timing every column's loop of
    perf.rep_counts(num) calls (cycling over the datasets) between CUDA
    events, the order reversed every other round.  Returns ({name: ns per
    element of each round}, {name: the last output})."""
    reps, warmups = perf.rep_counts(num)
    names = list(columns)
    for name in names:
        for w in range(warmups):
            columns[name](*datasets[w % len(datasets)])
    times = {name: [] for name in names}
    last = {}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn, out = columns[name], None

            def loop():
                nonlocal out
                for i in range(reps):
                    out = fn(*datasets[i % len(datasets)])

            s = elapsed_seconds(device, loop)
            times[name].append(s / reps / max(num, 1) * 1e9)
            last[name] = out
    return times, last


def _engine(name: str):
    from .. import methods
    m = methods.REGISTRY[name]
    return lambda k, p: m.run(k, p, ascending=True, stable=False,
                              block_threshold=None)


def _log_rounds(table: str, num: int, times: dict) -> None:
    print(json.dumps({"table": table, "n": num, "rounds": times}),
          flush=True)


def method_row(methods, num: int, key_dtype, payload_dtypes,
               distribution, device, validate: str) -> dict:
    """{method: median ns per element} of one workload, the methods in
    turns on min(reps, 8) datasets made as perf's protocol makes them;
    each method's last output checked by the host oracle or, with
    validate="device", the device gate."""
    from .. import methods as methods_mod
    kdt = np.dtype(key_dtype)
    pdts = tuple(np.dtype(p) for p in payload_dtypes)
    methods = [m for m in methods
               if methods_mod.REGISTRY[m].supports(kdt, pdts, num)]
    reps, _ = perf.rep_counts(num)
    host, staged = [], []
    for i in range(min(reps, 8)):
        keys = D.make_keys(num, kdt, distribution, 1 + i)
        pays = D.make_payloads(keys, pdts, "fast")
        host.append((keys, pays))
        staged.append(perf._stage(keys, pays, device))
    times, last = interleaved({m: _engine(m) for m in methods}, staged, num,
                              device)
    keys, pays = host[(reps - 1) % len(host)]
    for m in methods:
        perf.check_output(last[m], keys, pays, True, validate == "device",
                          f"{m} {common.type_name(kdt)} n={num}")
    _log_rounds(perf.table_name(kdt, pdts, distribution, num), num, times)
    return {m: statistics.median(t) for m, t in times.items()}


def large_n_sweep(key_dtype, distribution, device=None,
                  min_num: int = LARGE_N_MIN,
                  device_gate: int = LARGE_N_DEVICE_GATE,
                  max_num: int = LARGE_N_MAX) -> str:
    """One tpe table of xla and count, min_num..max_num rows, into
    perf.OUT_DIR under perf_test_num's name and header: each row the two
    engines in turns (method_row), checked by the host oracle below
    `device_gate` rows and by the device gate from there."""
    dev = common.resolve_device(device)
    rows, n = [], max(int(min_num), 1)
    while n <= max_num:
        med = method_row(LARGE_N_METHODS, n, key_dtype, (), distribution,
                         dev, "device" if n >= device_gate else "host")
        rows.append([n] + [f"{med[m]:.4f}" for m in LARGE_N_METHODS])
        n *= 2
    name = "tpe-" + perf._workload_tag(key_dtype, (),
                                       distribution.value) + ".dat"
    return perf._write_dat(name, "number_of_elements "
                           + " ".join(LARGE_N_METHODS), rows)


def method_table(key_dtype, distribution, num: int, device=None) -> str:
    """A keys-only method table of DEVICE_METHODS (perf_test's name and
    header), the engines in turns (method_row); the device gate from
    LARGE_N_DEVICE_GATE rows."""
    dev = common.resolve_device(device)
    med = method_row(DEVICE_METHODS, num, key_dtype, (), distribution, dev,
                     "device" if num >= LARGE_N_DEVICE_GATE else "host")
    return perf._write_dat(perf.table_name(key_dtype, (), distribution, num),
                           "sort_method nanoseconds_per_element",
                           [(m, f"{v:.4f}") for m, v in med.items()])


# ---------------------------------------------------------------------------
# part g: the count engine's branch gates
# ---------------------------------------------------------------------------

def gate_values(shape: str, unsigned: bool, n: int, seed: int) -> np.ndarray:
    """int64 keys of a part-g shape, all with a range in [16, 1024):
    "Uniform" in [-500, 500) (in [0, 1000) for unsigned keys), "Zipf"
    Zipf(1.1) ranks modulo 1000 less one, "OneValue" 99% zeros and 1%
    uniform in [0, 1000) at random rows; "Span<s>" uniform in [0, s] with
    both ends present."""
    from .config5_scale import zipf_ranks

    rng = np.random.default_rng(seed)
    if shape == "Uniform":
        lo = 0 if unsigned else -500
        return rng.integers(lo, lo + 1000, n)
    if shape == "Zipf":
        return zipf_ranks(n, 1.1, 1000, seed).astype(np.int64) - 1
    if shape == "OneValue":
        keys = np.zeros(n, np.int64)
        rare = rng.random(n) < 0.01
        keys[rare] = rng.integers(0, 1000, int(rare.sum()))
        return keys
    span = int(shape.removeprefix("Span"))
    keys = rng.integers(0, span + 1, n)
    keys[:2] = (0, span)
    return keys


def gate_columns() -> dict:
    """Part g's columns: count with its 1024-bucket branch forced on
    (counting.SMALL_MIN_N = 0) and off (past any n), and xla."""
    from ..ops import counting, xla_sort

    def count_with(min_n):
        def run(keys, pays):
            saved = counting.SMALL_MIN_N
            counting.SMALL_MIN_N = min_n
            try:
                return counting.sort_keys(keys)
            finally:
                counting.SMALL_MIN_N = saved
        return run

    return {"branch": count_with(0), "fallback": count_with(1 << 62),
            "xla": lambda k, p: xla_sort.sort_arrays(k, p)}


def gate_table(type_name: str, shape: str, sizes, device=None) -> str:
    """large_n/gate-<type>-<shape>.dat under perf.OUT_DIR: per size the
    median ns per element of GATE_COLUMNS in turns on the first n keys of
    one draw; every column's output must equal xla's, xla's must pass the
    host oracle (the device gate from LARGE_N_DEVICE_GATE rows), and the
    keys' range must be one the branch takes."""
    import torch

    from ..ops import counting

    dev = common.resolve_device(device)
    kdt = common.NAME_TO_DTYPE[type_name]
    draw = gate_values(shape, kdt.kind == "u", max(sizes), 1)
    columns = gate_columns()
    name = f"gate-{type_name}-{shape}.dat"
    rows = []
    for n in sizes:
        keys = draw[:n].astype(kdt)
        span = int(keys.max()) - int(keys.min())
        if not counting.K_TINY_RANGE <= span < counting.K_MAX_RANGE:
            raise AssertionError(f"{name} n={n}: range {span} misses the "
                                 "1024-bucket branch")
        staged = [perf._stage(keys, (), dev)]
        times, last = interleaved(columns, staged, n, dev)
        perf.check_output(last["xla"], keys, (), True,
                          n >= LARGE_N_DEVICE_GATE, f"xla {name} n={n}")
        want = common.as_signed(last["xla"][0])
        for col in GATE_COLUMNS:
            if not torch.equal(common.as_signed(last[col][0]), want):
                raise perf.WrongOutputError(f"{col} {name} n={n}: differs "
                                            "from xla")
        _log_rounds(name, n, times)
        rows.append([n] + [f"{statistics.median(times[c]):.4f}"
                           for c in GATE_COLUMNS])
        del staged, last
    return perf._write_dat(name, "number_of_elements "
                           + " ".join(GATE_COLUMNS), rows)


# ---------------------------------------------------------------------------
# part h: the quick engine's constants
# ---------------------------------------------------------------------------

def quick_points():
    """The grid's points as (MAX_BUCKETS, OVERSAMPLE, BLOCK, target)."""
    g = QUICK_GRID
    return [(mb, os_, b, b // d) for mb in g["max_buckets"]
            for os_ in g["oversample"] for b in g["block"]
            for d in g["target_divisor"]]


def quick_keys(type_name: str, dist: str, n: int, seed: int) -> np.ndarray:
    """A part-h workload's keys: the reference's distributions, or
    Zipf(1.1) ranks over the int32 range."""
    from .config5_scale import zipf_ranks

    kdt = common.NAME_TO_DTYPE[type_name]
    if dist == "Zipf":
        return zipf_ranks(n, 1.1, (1 << 31) - 1, seed).astype(kdt)
    return D.make_keys(n, kdt, D.Distribution(dist), seed)


def quick_grid(device=None) -> str:
    """quick_grid/grid.dat under perf.OUT_DIR: method="quick" at every
    grid point (quick_points) on every QUICK_WORKLOADS workload and
    QUICK_NS size, unstable, and also stable at QUICK_STABLE_NS; each cell
    the mean ns per element of QUICK_ROUNDS loops of
    max(1, QUICK_LOOP_ROWS // n) calls (the points in turns, forwards then
    backwards) and the path it took (quick_sort.PATHS).  Each point's
    output is held to xla's: keys exactly, payloads exactly when stable,
    else by the device gate."""
    from ..ops import quick_sort as Q
    from ..ops import xla_sort

    dev = common.resolve_device(device)
    points = quick_points()
    saved = (Q.MAX_BUCKETS, Q.OVERSAMPLE, Q.BLOCK, Q.SEGMENT_TARGET)
    rows = []
    try:
        for type_name, pay_names, dist in QUICK_WORKLOADS:
            draw = quick_keys(type_name, dist, max(QUICK_NS), 1)
            label = "-".join([type_name, *pay_names, dist])
            for n in QUICK_NS:
                keys = draw[:n]
                pays = D.make_payloads(
                    keys, [common.NAME_TO_DTYPE[p] for p in pay_names],
                    "fast")
                kd, pd = perf._stage(keys, pays, dev)
                for stable in ((False, True) if n in QUICK_STABLE_NS
                               else (False,)):
                    want = xla_sort.sort_arrays(kd, pd, stable=True)
                    cells = _quick_cells(points, kd, pd, n, stable, want,
                                         keys, pays, dev)
                    for p, (ns, path) in zip(points, cells):
                        rows.append([*p, label, n, int(stable),
                                     f"{ns:.4f}", path])
                    print(json.dumps({"table": "quick_grid", "workload":
                                      label, "n": n, "stable": stable}),
                          flush=True)
                    del want
                del kd, pd
    finally:
        Q.MAX_BUCKETS, Q.OVERSAMPLE, Q.BLOCK, Q.SEGMENT_TARGET = saved
    os.makedirs(os.path.join(perf.OUT_DIR, QUICK_DIR), exist_ok=True)
    return perf._write_dat(os.path.join(QUICK_DIR, "grid.dat"),
                           QUICK_HEADER, rows)


def _quick_cells(points, kd, pd, n, stable, want, keys, pays, dev):
    """[(mean ns per element, path)] of `points` on one workload."""
    from ..ops import quick_sort as Q

    reps = max(1, QUICK_LOOP_ROWS // n)
    ns = {p: [] for p in points}
    paths = {}
    for r in range(QUICK_ROUNDS):
        for p in (points if r % 2 == 0 else points[::-1]):
            Q.MAX_BUCKETS, Q.OVERSAMPLE, Q.BLOCK, Q.SEGMENT_TARGET = p
            out = None

            def loop():
                nonlocal out
                for _ in range(reps):
                    out = Q.sort_arrays(kd, pd, stable=stable)

            if r == 0:  # a warm-up, and the output and path checked
                Q.reset_paths()
                out = Q.sort_arrays(kd, pd, stable=stable)
                taken = [k for k, v in Q.PATHS.items() if v]
                paths[p] = taken[0] if len(taken) == 1 else "+".join(taken)
                _check_quick(out, want, stable, keys, pays, p, n)
            ns[p].append(elapsed_seconds(dev, loop) / reps / n * 1e9)
            del out
    return [(statistics.fmean(ns[p]), paths[p]) for p in points]


def _check_quick(out, want, stable, keys, pays, point, n) -> None:
    import torch

    what = f"quick {point} n={n} stable={stable}"
    if not torch.equal(common.as_signed(out[0]), common.as_signed(want[0])):
        raise perf.WrongOutputError(f"{what}: keys differ from xla's")
    if stable:
        if not all(torch.equal(common.as_signed(g), common.as_signed(w))
                   for g, w in zip(out[1], want[1])):
            raise perf.WrongOutputError(f"{what}: payloads differ from the "
                                        "stable xla sort's")
    else:
        perf.check_output(out, keys, pays, True, True, what)


def sources_digest() -> str:
    """sha256 over the port's Python and CUDA sources, in path order."""
    h = hashlib.sha256()
    for p in sorted(PKG.rglob("*")):
        if p.suffix in (".py", ".cu") and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(PKG)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _tables(out: Path) -> dict:
    return {str(p.relative_to(out)): p.stat().st_mtime
            for p in out.rglob("*.dat")}


def run_command(argv, out: Path, timeout_s: float, device=None) -> dict:
    """One driver as a child process writing into `out`, its output into
    `out`/logs/; returns its record (stopped, not raised, at the
    timeout)."""
    cmd = [sys.executable, "-m", DRIVER + argv[0], *argv[1:]]
    if device is not None:
        cmd += ["--device", str(device)]
    env = {**os.environ, "SRS_TORCH_PERF_DIR": str(out)}
    log = out / "logs" / (re.sub(r"[^A-Za-z0-9]+", "-",
                                 " ".join(argv)).strip("-") + ".out")
    log.parent.mkdir(exist_ok=True)
    before = _tables(out)
    t0 = time.perf_counter()
    with open(log, "a") as f:
        try:
            rc = subprocess.run(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=max(timeout_s, 1)).returncode
            cut = False
        except subprocess.TimeoutExpired:
            rc, cut = None, True
    after = _tables(out)
    return {"command": " ".join(["python", *cmd[1:]]),
            "env": {"SRS_TORCH_PERF_DIR": str(out)},
            "log": str(log.relative_to(out)),
            "seconds": time.perf_counter() - t0, "rc": rc,
            "cut_at_deadline": cut,
            "tables": sorted(k for k, v in after.items()
                             if before.get(k) != v)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="a,b,c,d")
    ap.add_argument("--out", default="bench_out_h100")
    ap.add_argument("--deadline-s", type=float, default=3000.0)
    ap.add_argument("--commit", default=None,
                    help="the commit the sources were checked out from")
    ap.add_argument("--sweep", default=None,
                    help="run one part-d sweep, <key type>-<distribution>, "
                         "into $SRS_TORCH_PERF_DIR/large_n")
    ap.add_argument("--tables", default=None,
                    help="run one part-f key type's method tables into "
                         "$SRS_TORCH_PERF_DIR")
    ap.add_argument("--n", type=int, default=None,
                    help="--tables at this size only (default: "
                         "ADAPTIVE_TABLE_NS)")
    ap.add_argument("--gate", default=None,
                    help="run one part-g key type's gate tables into "
                         "$SRS_TORCH_PERF_DIR/large_n")
    ap.add_argument("--quick-grid", action="store_true",
                    help="run part h's grid into "
                         "$SRS_TORCH_PERF_DIR/quick_grid")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)

    def skip(name):
        if os.path.exists(os.path.join(perf.OUT_DIR, name)):
            print("skip", name, flush=True)
            return True
        return False

    if args.tables:
        kdt = common.NAME_TO_DTYPE[args.tables]
        dev = common.resolve_device(args.device)
        for n in ADAPTIVE_TABLE_NS if args.n is None else (args.n,):
            for dist in D.ALL_DISTRIBUTIONS:
                if not skip(perf.table_name(kdt, (), dist, n)):
                    print("wrote", method_table(kdt, dist, n, dev),
                          flush=True)
        return 0

    if args.sweep or args.gate:
        dev = common.resolve_device(args.device)
        top, perf.OUT_DIR = perf.OUT_DIR, os.path.join(perf.OUT_DIR,
                                                       LARGE_N_DIR)
        try:
            if args.sweep:
                type_name, dist = args.sweep.split("-")
                if not skip(f"tpe-{args.sweep}.dat"):
                    print("wrote", large_n_sweep(
                        common.NAME_TO_DTYPE[type_name],
                        D.Distribution(dist), dev), flush=True)
                return 0
            sizes = [1 << e for e in range(LARGE_N_MIN.bit_length() - 1,
                                           LARGE_N_MAX.bit_length())]
            for shape, ns in ([(s, sizes) for s in GATE_SHAPES]
                              + [(f"Span{s}", GATE_SPAN_NS)
                                 for s in GATE_SPANS]):
                if not skip(f"gate-{args.gate}-{shape}.dat"):
                    print("wrote", gate_table(args.gate, shape, ns, dev),
                          flush=True)
            return 0
        finally:
            perf.OUT_DIR = top

    if args.quick_grid:
        dev = common.resolve_device(args.device)
        if not skip(os.path.join(QUICK_DIR, "grid.dat")):
            print("wrote", quick_grid(dev), flush=True)
        return 0

    import torch
    dev = common.resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card_path = out / "CARD.json"
    card = (json.loads(card_path.read_text()) if card_path.exists()
            else {"calls": []})
    call = {"card": _card() if dev.type == "cuda" else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "commit": args.commit, "sources_sha256": sources_digest(),
            "started": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
            "commands": []}
    card["calls"].append(call)
    deadline = time.perf_counter() + args.deadline_s
    failed = False
    for part in args.parts.split(","):
        for cmd in PARTS[part]:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            rec = run_command(cmd, out, left,
                              None if dev.type == "cuda" else "cpu")
            rec["part"] = part
            call["commands"].append(rec)
            failed |= rec["rc"] not in (0, None)
            print("campaign:", json.dumps(rec), flush=True)
            card_path.write_text(json.dumps(card, indent=1) + "\n")
    card_path.write_text(json.dumps(card, indent=1) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
