"""North-star configuration 3: 10^8 combined-layout rows of 24 bytes.

Counterpart of scripts/combined_1e8.py.  BASELINE.json config 3: "100M-row
sort with multi-payload tuples (DataElement<K,Ps...> combined layout) on
one host, HBM-roofline comparison"; each row is a u64 key and two u64
payloads (the reference's DataElement<K,Ps...>, src/data.hpp:25-53),
sorted by `sort_packed`.

The 2.4 GB table is made on the device (splitmix64 of the row index), and
the gate runs there too: key order recomputed from each row's leading 8
bytes, and an order-independent fingerprint of every whole row (each row's
24 bytes mixed into one 64-bit value; its sum and xor over the rows), which
catches a dropped, duplicated or torn row and binds the payload bytes to
their key.

    python -m simd_radix_sort_tpu_torch.workloads.combined_1e8 [--n N]
        [--reps R] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import roofline
from ..ops import sort as sort_ops
from ..utils import common as ucommon
from ..utils import transforms
from . import common

ESIZE = 24  # u64 key + u64 + u64 payloads


def gen_packed(n: int, device=None) -> torch.Tensor:
    """(n, 24) uint8 combined rows, made on the device from the row index:
    row i holds splitmix64(i ^ s·M3) for s = 0, 1, 2, little-endian, byte
    for byte the JAX script's `gen_packed`."""
    dev = ucommon.resolve_device(device)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    cols = [common.splitmix64(i ^ common.wrap64(s * common.M3))
            for s in range(3)]
    return torch.stack(cols, dim=1).view(torch.uint8)


def key_of(packed: torch.Tensor) -> torch.Tensor:
    """Each row's u64 key, from its leading 8 bytes."""
    n = packed.shape[0]
    return packed[:, :8].contiguous().view(torch.uint64).reshape(n)


def row_fingerprint(packed: torch.Tensor) -> tuple:
    """Order-independent (sum, xor), as signed ints, of a per-row 64-bit
    mix of all 24 bytes: h = (h ^ w_j)·(M2 + 2j) over the row's six
    little-endian 32-bit words."""
    n = packed.shape[0]
    words = packed.contiguous().view(torch.int32).view(n, ESIZE // 4)
    h = torch.zeros(n, dtype=torch.int64, device=packed.device)
    for j in range(ESIZE // 4):
        w = words[:, j].to(torch.int64) & 0xFFFFFFFF
        h = (h ^ w) * common.wrap64(common.M2 + 2 * j)
    return int(h.sum().item()), common.xor_reduce(h)


def gate(inp: torch.Tensor, out: torch.Tensor) -> None:
    """Raise unless `out` is `inp`'s rows ordered by their keys."""
    (c,) = transforms.key_operands(key_of(out), True)
    if not bool((c[1:] >= c[:-1]).all()):
        raise AssertionError("combined output not key-sorted")
    if row_fingerprint(inp) != row_fingerprint(out):
        raise AssertionError("row multiset fingerprint mismatch")


def sort(packed: torch.Tensor) -> torch.Tensor:
    return sort_ops.sort_packed(packed, np.uint64, device=packed.device)


def case(n: int, device=None):
    """Make the table.  Returns (the sort call, its gate)."""
    packed = gen_packed(n, device)
    return (lambda: sort(packed)), (lambda out: gate(packed, out))


def run(n: int, reps: int = 3, device=None) -> dict:
    """Time `reps` sorts (a wait after each: every result is 2.4 GB at
    10^8 rows), gate one and return the JSON record."""
    dev = ucommon.resolve_device(device)
    call, check = case(n, dev)
    sec = common.timeit(call, reps=reps, warmup=1, per_rep_fence=True,
                        device=dev)
    check(call())
    rows_per_s = n / sec
    name = common.device_name(dev)
    roof = (roofline.radix_sort_roofline_rows_per_s(
        row_bytes=ESIZE, key_bits=64, chip=roofline.chip_for_name(name))
        if dev.type == "cuda" else None)
    return {
        "metric": "combined u64+2xu64 (24B rows) sort rows/s/chip",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "n": n, "seconds_per_sort": round(sec, 4),
        "hbm_roofline_rows_per_s": None if roof is None else round(roof),
        "roofline_frac": None if roof is None else round(rows_per_s / roof,
                                                         4),
        "device": name,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=float, default=1e8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(run(int(args.n), args.reps, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
