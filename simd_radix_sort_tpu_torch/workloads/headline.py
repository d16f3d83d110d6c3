"""The headline benchmark: u64 key + u64 payload sort, rows/s per card.

Counterpart of bench.py.  The metric is BASELINE.json's "radix sort
rows/s/chip (u64 key + u64 payload, 1e8 rows)"; vs_baseline is relative to
the reference's closest published anchor, RadixSIMD int32+int32 at 89
Mrows/s on one 5 GHz x86 core (BASELINE.md).

Data is `default_rng(42)` keys and payloads made on the host and staged
once; the sort is `methods.resolve(method, ...)` ("auto" resolves to
"xla"), timed with a wait after every call; the output is gated on the
device (sorted, key sum and xor, pair fingerprint sum and xor against
NumPy's on the host input).

    python -m simd_radix_sort_tpu_torch.workloads.headline [--n N]
        [--reps R] [--method M] [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import methods
from ..models import roofline
from ..utils import common as ucommon
from ..utils import interop, transforms
from . import common

BASELINE_ROWS_PER_S = 89e6  # reference RadixSIMD int32+int32 (BASELINE.md)


def make_data(n: int, seed: int = 42):
    """bench.py's host arrays: uniform uint64 keys and payloads."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    payload = rng.integers(0, 2**64, n, dtype=np.uint64)
    return keys, payload


def gate(out, sums) -> None:
    """Raise unless `out` = (keys, payload) is sorted and carries the input's
    key and pair fingerprints `sums` (common.host_checksums)."""
    (c,) = transforms.key_operands(out[0], True)
    if not bool((c[1:] >= c[:-1]).all()):
        raise AssertionError("headline: output not sorted")
    got = common.device_checksums(out)
    if got[:2] != sums[:2]:
        raise AssertionError("headline: key multiset checksum mismatch")
    if got[2:] != sums[2:]:
        raise AssertionError("headline: key<->payload pairing broken")


def case(keys: np.ndarray, payload: np.ndarray, method: str = "auto",
         device=None):
    """Stage the host arrays once.  Returns (the engine's name, the sort
    call, its gate)."""
    dev = ucommon.resolve_device(device)
    kd, pd = interop.from_numpy(keys, dev), interop.from_numpy(payload, dev)
    m = methods.resolve(method, np.uint64, (np.uint64,), keys.shape[0],
                        device=dev)
    sums = common.host_checksums(keys, payload)

    def call():
        ko, (po,) = m.run(kd, (pd,), ascending=True, stable=False,
                          block_threshold=None, digit_bits=None)
        return ko, po

    return m.name, call, lambda out: gate(out, sums)


def run(keys: np.ndarray, payload: np.ndarray, method: str = "auto",
        reps: int = 3, device=None):
    """Sort `reps` times (a wait after each, as bench.py fetches a row) and
    gate.  Returns (the JSON record, the last sorted (keys, payload))."""
    dev = ucommon.resolve_device(device)
    name, call, check = case(keys, payload, method, dev)
    dt = common.timeit(call, reps=reps, warmup=1, per_rep_fence=True,
                       device=dev)
    out = call()
    check(out)
    n = keys.shape[0]
    rows_per_s = n / dt
    card = common.device_name(dev)
    roof = (roofline.radix_sort_roofline_rows_per_s(
        row_bytes=16, key_bits=64, chip=roofline.chip_for_name(card))
        if dev.type == "cuda" else None)
    record = {
        "metric": "u64+u64 sort rows/s/chip",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
        "n": n,
        "method": name,
        "seconds_per_sort": round(dt, 4),
        "hbm_roofline_rows_per_s": None if roof is None else round(roof),
        "roofline_frac": None if roof is None else round(rows_per_s / roof,
                                                         4),
        "device": card,
    }
    return record, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=float, default=1e8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    keys, payload = make_data(int(args.n))
    record, _ = run(keys, payload, args.method, args.reps, args.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
