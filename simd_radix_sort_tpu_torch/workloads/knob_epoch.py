"""One knob-sweep epoch at perf-thesis breadth, on the card.

Counterpart of scripts/knob_epoch.py.  The reference commits
cmpSortThreshold sweeps for its 12 key/payload combos x 4 distributions
(perf-thesis.cpp:45-222, perf.hpp:159-212).  This drives the port's
engines' equivalent knobs over the same grid in one epoch:

  * thresh-quick-*: the device quicksort's block_threshold (target
    segment size of the sampled-splitter partition), the same pass-count
    vs base-case-cost trade the reference's threshold controls.
    12 combos x 4 distributions = 48 tables.
  * digits-*: the LSD radix engine's digit width (pass count vs per-pass
    cost), 12 combos x Uniform = 12 tables.

Type combos mirror perf-thesis.cpp:45-57 exactly:
  (float,i64) (i8,i64) (i16,i64) (i32,i64) (float,) (float,i32)
  (double,) (double,i64) (i8,) (i16,) (i32,) (i64,)

    python -m simd_radix_sort_tpu_torch.workloads.knob_epoch [--n 262144]
        [--resume] [--device cpu]

Writes perf.OUT_DIR/*.dat and prints one line per table; a table that
fails is reported with its traceback, the epoch goes on, and the exit code
is 1.  --resume skips tables that already exist.  Keep the card otherwise
idle while it measures.
"""

from __future__ import annotations

import argparse
import os
import time
import traceback

import numpy as np

from .. import perf
from ..utils import common
from ..utils import data as D

# perf-thesis.cpp:45-57's 12 combos, in its order
COMBOS = [
    (np.float32, (np.int64,)),
    (np.int8, (np.int64,)),
    (np.int16, (np.int64,)),
    (np.int32, (np.int64,)),
    (np.float32, ()),
    (np.float32, (np.int32,)),
    (np.float64, ()),
    (np.float64, (np.int64,)),
    (np.int8, ()),
    (np.int16, ()),
    (np.int32, ()),
    (np.int64, ()),
]
DISTS = [D.Distribution.UNIFORM, D.Distribution.GAUSSIAN,
         D.Distribution.ZERO, D.Distribution.ZERO_ONE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    tag = perf._workload_tag  # the harness's own table names

    failures = []
    t0 = time.time()

    def run(fn, name):
        if args.resume and os.path.exists(os.path.join(perf.OUT_DIR, name)):
            print(f"skip {name}", flush=True)
            return
        t = time.time()
        try:
            path = fn()
            print(f"wrote {path} ({time.time() - t:.1f} s)", flush=True)
        except Exception:  # the JAX script's protocol: report, go on, exit 1
            failures.append(name)
            print(f"FAILED {name}\n{traceback.format_exc()}", flush=True)

    for k, ps in COMBOS:
        for dist in DISTS:
            run(lambda k=k, ps=ps, dist=dist: perf.perf_test_thresh(
                args.n, k, ps, distribution=dist, device=dev),
                f"thresh-quick-{tag(k, ps, dist.value, args.n)}.dat")
    for k, ps in COMBOS:
        run(lambda k=k, ps=ps: perf.perf_test_block(args.n, k, ps,
                                                    device=dev),
            f"digits-{tag(k, ps, D.Distribution.UNIFORM.value, args.n)}.dat")

    print(f"knob epoch done in {(time.time() - t0) / 60:.1f} min; "
          f"{len(failures)} failures", flush=True)
    if failures:
        print("failed tables:", *failures, sep="\n  ")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
