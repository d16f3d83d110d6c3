"""Measure again, in one epoch, the cells that the JAX package's tables
flagged as probable noise on the TPU.

Counterpart of scripts/remeasure_noise.py: the same four tables, under the
same names and protocol, so that the card's values of those cells stand
beside their neighbours measured in another epoch:
  * int32+int32 Sorted at 2^18 rows;
  * uint64 Sorted at 2^18 rows;
  * int32+int32 and uint64+uint64 at 4096 rows with the rank engine,
    small cells where the launch floor dominates.

    python -m simd_radix_sort_tpu_torch.workloads.remeasure_noise
        [--device cpu]

Keep the card otherwise idle while it measures.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import perf
from ..utils import common
from ..utils import data as D

METHODS = ["xla", "radix", "count", "quick", "seq", "torch", "cpp"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    on = {"device": common.resolve_device(args.device)}
    t0 = time.time()
    jobs = [
        lambda: perf.perf_test(METHODS, 1 << 18, np.int32, (np.int32,),
                               D.Distribution.SORTED, **on),
        lambda: perf.perf_test(METHODS, 1 << 18, np.uint64, (),
                               D.Distribution.SORTED, **on),
        lambda: perf.perf_test(METHODS + ["rank"], 4096, np.int32,
                               (np.int32,), D.Distribution.UNIFORM,
                               reps=64, warmups=2, **on),
        lambda: perf.perf_test(METHODS + ["rank"], 4096, np.uint64,
                               (np.uint64,), D.Distribution.UNIFORM,
                               reps=64, warmups=2, **on),
    ]
    for job in jobs:
        path = job()
        print("wrote", path, flush=True)
    print(f"noise re-measure epoch done in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
