"""Thesis-style benchmark suite driver on the card.

Counterpart of scripts/perf_suite.py, which mirrors the C++ reference's
perf-thesis.cpp experiment entries (perf-thesis.cpp:45-226) and the
quicksort study of perf-paper.cpp:22-115: per-distribution method tables
across all 8 input distributions, n-scaling sweeps, tuning-knob sweeps
(radix digit width, quicksort threshold), pairwise payload-factor
speedups and small-n tables where the rank block sorter takes part.  The
same grids, tiers, table names and order as the JAX script, through the
port's perf.py; tables go to perf.OUT_DIR ($SRS_TORCH_PERF_DIR, default
bench_out_torch/).

    python -m simd_radix_sort_tpu_torch.workloads.perf_suite [--full]
        [--n 262144] [--resume] [--int8] [--tpe-breadth] [--packed]
        [--device cpu]

Scaled-down defaults; --full runs the complete grid.  Keep the card
otherwise idle while it measures.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import perf
from ..utils import common
from ..utils import data as D

# device engines + host baselines (seq/torch play the STLSort/IPP role,
# sort_methods.hpp:246-347).  rank is size-capped and appears in the
# small-n tables below.
METHODS = ["xla", "radix", "count", "quick", "seq", "torch", "cpp"]

TYPE_COMBOS = [
    (np.int32, ()),
    (np.int32, (np.int32,)),
    (np.uint64, (np.uint64,)),
    (np.float32, ()),
    (np.float32, (np.int32,)),
    (np.float64, (np.float64,)),
    (np.uint8, ()),
    (np.int16, ()),
    (np.float64, ()),
    (np.uint64, ()),
    (np.uint32, ()),
]

# the reference's 4 core distributions ...
DISTS = [D.Distribution.UNIFORM, D.Distribution.GAUSSIAN,
         D.Distribution.ZERO, D.Distribution.ZERO_ONE]
# ... plus the sorted families (data.hpp:64-73; --full only)
DISTS_SORTED = [D.Distribution.SORTED, D.Distribution.REVERSE_SORTED,
                D.Distribution.ALMOST_SORTED,
                D.Distribution.ALMOST_REVERSE_SORTED]

# quicksort-focused study (perf-paper.cpp:22-115): quick engine vs its
# host differential model vs the general engines
QUICK_METHODS = ["quick", "quickseq", "xla", "torch"]
QUICK_COMBOS = [(np.int32, ()), (np.int32, (np.int32,)),
                (np.float64, (np.float64,))]

# tpe-breadth tier: the reference's 8 published tpe type combos
# (src/perf.hpp:368-416) at the three distributions that anchor the
# crossover claims.  Engines per combo: xla everywhere, count where it
# applies (the count-vs-xla crossover), quick on int32+int32, and the
# native cpp baseline.  Ordered as the JAX script orders them, so that a
# --resume'd partial run keeps the same tables first.
TPE_BREADTH = [
    ((np.int32, ()), ["xla", "count", "cpp"]),
    ((np.int32, (np.int32,)), ["xla", "quick", "cpp"]),
    ((np.float32, ()), ["xla", "cpp"]),
    ((np.float64, ()), ["xla", "cpp"]),
    ((np.int64, ()), ["xla", "cpp"]),
    ((np.float32, (np.int32,)), ["xla", "cpp"]),
    ((np.int64, (np.int64,)), ["xla", "cpp"]),
    ((np.float64, (np.int64,)), ["xla", "cpp"]),
]
TPE_BREADTH_DISTS = [D.Distribution.UNIFORM, D.Distribution.SORTED,
                     D.Distribution.ZERO]

# packed-path engine tables (sort_packed through the method facade), each
# combo at the reference n and at a large n.  The large row counts are the
# JAX script's workloads, kept so that the tables carry the same names;
# they are not a memory limit of the card.
PACKED_COMBOS = [
    (np.int32, (np.int32,), 10**8),       # 8-byte rows
    (np.uint64, (np.uint64,), 6 * 10**7),   # 16-byte headline shape
    (np.uint64, (np.uint64, np.uint64), 4 * 10**7),  # 24-byte config 3
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 18)  # reference n = 2^18
    ap.add_argument("--resume", action="store_true",
                    help="skip tables whose .dat already exists")
    ap.add_argument("--int8", action="store_true",
                    help="tier: int8 x all 8 distributions at --n")
    ap.add_argument("--tpe-breadth", action="store_true",
                    help="tier: tpe scaling sweeps for the reference's 8 "
                         "published tpe combos x {Uniform,Sorted,Zero}, "
                         "n=2^10..2^22, plus 1e8 anchor cells (device-gate "
                         "validated)")
    ap.add_argument("--packed", action="store_true",
                    help="tier: combined-layout engine tables "
                         "(sort_packed through the method facade)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    on = {"device": common.resolve_device(args.device)}
    tag = perf._workload_tag  # the harness's own table names

    combos = TYPE_COMBOS if args.full else TYPE_COMBOS[:4]
    dists = (DISTS + DISTS_SORTED) if args.full else DISTS[:2]

    def done(name):
        return args.resume and os.path.exists(os.path.join(perf.OUT_DIR, name))

    if args.int8 or args.tpe_breadth or args.packed:
        if args.int8:
            for dist in DISTS + DISTS_SORTED:
                name = perf.table_name(np.int8, (), dist, args.n)
                if done(name):
                    print("skip", name, flush=True)
                    continue
                path = perf.perf_test(METHODS, args.n, np.int8, (), dist,
                                      reps=None, warmups=1, **on)
                print("wrote", path, flush=True)
        if args.tpe_breadth:
            for (k, ps), meths in TPE_BREADTH:
                base = tag(k, ps)
                for dist in TPE_BREADTH_DISTS:
                    nm = f"tpe-{base}-{dist.value}.dat"
                    if done(nm):
                        print("skip", nm, flush=True)
                        continue
                    path = perf.perf_test_num(meths, k, ps, dist,
                                              min_num=1 << 10,
                                              max_num=1 << 22,
                                              reps=None, warmups=1, **on)
                    print("wrote", path, flush=True)
                # 1e8 anchor cell, validated on the device: the host oracle
                # would dwarf the measurement
                nm = f"tpe-anchor-{base}-Uniform-100000000.dat"
                if done(nm):
                    print("skip", nm, flush=True)
                    continue
                anchor_meths = [m for m in meths if m not in ("cpp",)]
                path = perf.perf_test(anchor_meths, 10**8, k, ps,
                                      D.Distribution.UNIFORM, out_name=nm,
                                      reps=3, warmups=1, validate="device",
                                      **on)
                print("wrote", path, flush=True)
        if args.packed:
            for k, ps, big_n in PACKED_COMBOS:
                for num in (args.n, big_n):
                    nm = f"packed-{tag(k, ps)}-Uniform-{num}.dat"
                    if done(nm):
                        print("skip", nm, flush=True)
                        continue
                    # radix is the differential engine; at large n its
                    # digit-pass intermediates add memory for no policy
                    # information (the reference-n cells already place it)
                    big = num >= 4 * 10**7
                    meths = ("xla", "quick") if big \
                        else ("xla", "radix", "quick")
                    path = perf.perf_test_packed(
                        num, k, ps, methods=meths,
                        reps=3 if big else None, validate=not big, **on)
                    print("wrote", path, flush=True)
        return 0

    # ---- per-distribution method tables (perf-thesis.cpp:120-222) -------
    for k, ps in combos:
        for dist in dists:
            name = perf.table_name(k, ps, dist, args.n)
            if done(name):
                print("skip", name, flush=True)
                continue
            path = perf.perf_test(METHODS, args.n, k, ps, dist,
                                  reps=None if args.full else 3,
                                  warmups=1, **on)
            print("wrote", path, flush=True)

    # ---- small-n tables with the rank block sorter ----------------------
    for k, ps in ([(np.int32, (np.int32,)), (np.uint64, (np.uint64,))]
                  if args.full else [(np.int32, (np.int32,))]):
        name = perf.table_name(k, ps, D.Distribution.UNIFORM, 4096)
        if not done(name):
            path = perf.perf_test(METHODS + ["rank"], 4096, k, ps,
                                  D.Distribution.UNIFORM, reps=64, warmups=2,
                                  **on)
            print("wrote", path, flush=True)

    # ---- scaling sweeps (perfTestNum family) ----------------------------
    sweeps = [(np.int32, (np.int32,)), (np.uint64, (np.uint64,)),
              (np.uint8, ())] if args.full else [(np.int32, (np.int32,))]
    for k, ps in sweeps:
        nm = f"tpe-{tag(k, ps, D.Distribution.UNIFORM.value)}.dat"
        if done(nm):
            print("skip", nm, flush=True)
            continue
        meths = [m for m in METHODS if m not in ("seq", "torch")] \
            if args.full else METHODS
        # --full uses the pipelined protocol (reps=None): at a fixed small
        # rep count the launch floor dominates the small cells
        path = perf.perf_test_num(meths, k, ps,
                                  max_num=1 << (22 if args.full else 18),
                                  reps=None if args.full else 3,
                                  warmups=1, **on)
        print("wrote", path, flush=True)

    # ---- tuning-knob sweeps ---------------------------------------------
    for k, ps in ([(np.int32, (np.int32,)), (np.uint64, (np.uint64,)),
                   (np.uint8, ())] if args.full
                  else [(np.int32, (np.int32,))]):
        nm = f"digits-{tag(k, ps, D.Distribution.UNIFORM.value, args.n)}.dat"
        if done(nm):
            print("skip", nm, flush=True)
        else:
            path = perf.perf_test_block(args.n, k, ps, **on)
            print("wrote", path, flush=True)

    # quicksort threshold sweep (perfTestThresh / perf-paper.cpp role)
    for k, ps in (QUICK_COMBOS if args.full
                  else [(np.int32, (np.int32,))]):
        nm = ("thresh-quick-"
              f"{tag(k, ps, D.Distribution.UNIFORM.value, args.n)}.dat")
        if done(nm):
            print("skip", nm, flush=True)
        else:
            path = perf.perf_test_thresh(args.n, k, ps, **on)
            print("wrote", path, flush=True)

    # ---- quicksort study (perf-paper.cpp:22-115) ------------------------
    if args.full:
        for k, ps in QUICK_COMBOS:
            for dist in DISTS:
                name = "quickstudy-" + perf.table_name(k, ps, dist, args.n)
                if done(name):
                    print("skip", name, flush=True)
                    continue
                path = perf.perf_test(QUICK_METHODS, args.n, k, ps, dist,
                                      reps=None, warmups=1, out_name=name,
                                      **on)
                print("wrote", path, flush=True)

    # ---- pairwise speedup across payload-size factors -------------------
    if not done(f"speedup-xla-vs-radix-Uniform-{args.n}.dat"):
        path = perf.perf_test_speedup("xla", "radix", args.n,
                                      reps=None if args.full else 3,
                                      warmups=1, **on)
        print("wrote", path, flush=True)
    if args.full and not done(f"speedup-quick-vs-radix-Uniform-{args.n}.dat"):
        path = perf.perf_test_speedup("quick", "radix", args.n,
                                      reps=None, warmups=1, **on)
        print("wrote", path, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
