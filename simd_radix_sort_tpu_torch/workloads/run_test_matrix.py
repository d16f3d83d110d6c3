"""Reference-style test driver over the port's registry.

Counterpart of scripts/run_test_matrix.py, itself the twin of the
reference's test binary (src/test.cpp:181-224): sweeps sizes 1, 10, 100,
... maxNum across sort methods x layouts x directions x key types x
payload shapes x distributions, validates every cell with the
payload-regeneration oracle (utils/data.check_data), prints a
passed/FAILED line per cell and ALL PASSED or SOME FAILED, and exits 0 or
1.  An exception in a cell is that cell's FAILED line, as in the
reference's protocol.

    python -m simd_radix_sort_tpu_torch.workloads.run_test_matrix
        [maxNum] [seed] [--device cpu]

Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import methods
from ..ops import sort as sort_ops
from ..utils import common, interop
from ..utils import data as D

KEY_TYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
             np.int8, np.int16, np.int32, np.int64,
             np.float32, np.float64]

# payload shapes mirroring test.cpp:100-153 (including multi-stream combos)
PAYLOADS = [
    (),
    (np.uint8,), (np.uint16,), (np.uint32,), (np.uint64,),
    (np.uint64, np.uint64),
    (np.uint64, np.uint8),
    (np.uint64, np.uint64, np.uint64),
    (np.uint8,) * 3,
]

METHODS = ["xla", "radix", "count", "rank", "quick", "quickseq", "torch",
           "seq", "cpp"]


def cells(max_num: int):
    """Every (method, combined, up, key dtype, payload dtypes,
    distribution, n) of the sweep, in the order it runs, before the
    capability gate."""
    num = 1
    while num <= max_num:
        for method in METHODS:
            for combined in (False, True):
                if combined and method not in ("xla",):
                    continue  # the packed layout goes through the xla engine
                for up in (True, False):
                    for kdt in KEY_TYPES:
                        for pdts in PAYLOADS:
                            for dist in D.ALL_DISTRIBUTIONS:
                                yield (method, combined, up, kdt, pdts, dist,
                                       num)
        num *= 10


def supported(method, kdt, pdts, num) -> bool:
    """The capability gate (the reference's isSupported, test.cpp:80)."""
    return methods.REGISTRY[method].supports(
        np.dtype(kdt), tuple(np.dtype(p) for p in pdts), num)


def run_cell(method, combined, up, kdt, pdts, dist, num, seed, device=None):
    """One cell: None when the method does not support it, else whether it
    passed (its line printed)."""
    if not supported(method, kdt, pdts, num):
        return None
    dev = common.resolve_device(device)
    # (unlike the reference, the combined layout has no power-of-two row
    # restriction here: other row counts are tested too)
    keys = D.make_keys(num, kdt, dist, seed)
    pays = D.make_payloads(keys, pdts, "fast")
    label = (f"{method:6s} {'comb' if combined else 'sep '} "
             f"{'asc' if up else 'dsc'} {common.type_name(kdt):7s} "
             f"[{','.join(common.type_name(p) for p in pdts):23s}] "
             f"{dist.value:13s} n={num}")
    try:
        if combined:
            packed = sort_ops.pack_rows(keys, pays)
            out = sort_ops.sort_packed(packed, kdt, ascending=up, device=dev)
            ko, po = sort_ops.unpack_rows(interop.to_numpy(out), kdt,
                                          list(pdts))
        else:
            res = sort_ops.sort(keys, *pays, ascending=up, method=method,
                                device=dev)
            if pdts:
                ko = interop.to_numpy(res[0])
                po = tuple(interop.to_numpy(p) for p in res[1:])
            else:
                ko, po = interop.to_numpy(res), ()
        err = D.check_data(ko, tuple(po), keys, up)
    except Exception as e:  # noqa: BLE001 - the reference's FAILED line
        err = f"exception: {e}"
    if err:
        print(f"FAILED  {label}: {err}")
        return False
    print(f"passed  {label}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("max_num", nargs="?", type=int, default=10_000)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    ok = True
    for cell in cells(args.max_num):
        ok &= run_cell(*cell, args.seed, dev) is not False
    print("ALL PASSED" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
