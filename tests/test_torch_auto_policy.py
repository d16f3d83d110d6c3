"""The port's `auto` policy against the tables measured on the card.

Counterpart of tests/test_auto_policy.py, with the same rule, read from
bench_out_h100/ (written by `workloads/campaign.py` on an H100; CARD.json
there names the card, its power limit and each command), never from
bench_out/, which holds the TPU's tables.  Per (dtype, payloads, n)
workload across its distribution tables:
  * the median ratio of auto's pick to the best recorded device engine is
    <= 1.35, and no single cell exceeds 2.5;
  * tables below MIN_N rows are left out: they rank the launch path, not
    engines.

MIN_N = 2^20: in part b's sweeps (bench_out_h100/tpe-*.dat, H100 80GB
HBM3 at 700 W), `xla`'s ns/element still falls about as fast as n grows
up to 2^19 rows, the time of a call nearly constant (a launch floor), and
from 2^20 on it changes by less than the rows do.
"""

import json
import math
import os
import re

import numpy as np
import pytest

from simd_radix_sort_tpu_torch import methods
from simd_radix_sort_tpu_torch.ops import counting

BENCH_DIR = os.path.join(os.path.dirname(__file__), "..", "bench_out_h100")
LARGE_N_DIR = os.path.join(BENCH_DIR, "large_n")

_DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32,
           "uint64": np.uint64, "int8": np.int8, "int16": np.int16,
           "int32": np.int32, "int64": np.int64, "float": np.float32,
           "double": np.float64}

# method tables: <key>[-<payload>...]-<Distribution>-<n>.dat
_NAME = re.compile(
    r"^((?:%(t)s)(?:-(?:%(t)s))*)-([A-Za-z]+)-(\d+)\.dat$"
    % {"t": "|".join(_DTYPES)})

MIN_N = 1 << 20

# the JAX package's crossover, measured on a TPU: kept unless the card's
# tables fail the rule with it
TPU_COUNT_CROSSOVER_N_1BYTE = 1 << 17


def _method_tables():
    for fname in sorted(os.listdir(BENCH_DIR)):
        m = _NAME.match(fname)
        if not m:
            continue
        types = m.group(1).split("-")
        n = int(m.group(3))
        with open(os.path.join(BENCH_DIR, fname)) as f:
            header = f.readline().split()
            if header[:1] != ["sort_method"]:
                continue
            rows = dict(line.split() for line in f if line.strip())
        yield (fname, _DTYPES[types[0]], [_DTYPES[t] for t in types[1:]], n,
               m.group(2), {k: float(v) for k, v in rows.items()})


def test_auto_within_tolerance_of_best_recorded():
    by_workload = {}
    for fname, kdt, pdts, n, dist, rows in _method_tables():
        if n < MIN_N:
            continue
        device_rows = {k: v for k, v in rows.items()
                       if k in methods.REGISTRY and methods.REGISTRY[k].device}
        if not device_rows:
            continue
        pick = methods.resolve("auto", kdt, pdts, n).name
        assert pick in rows, f"{fname}: no row for auto's pick {pick}"
        best = min(device_rows.values())
        ratio = rows[pick] / best
        assert ratio <= 2.5, (
            f"{fname}: auto picked {pick} ({rows[pick]} ns/elem) but best "
            f"recorded is {best} ns/elem ({min(device_rows, key=rows.get)})")
        key = (np.dtype(kdt).name, tuple(np.dtype(p).name for p in pdts), n)
        by_workload.setdefault(key, []).append((dist, ratio))
    assert len(by_workload) >= 10, f"only {len(by_workload)} workloads"
    for key, entries in by_workload.items():
        ratios = sorted(r for _, r in entries)
        med = ratios[len(ratios) // 2]
        assert med <= 1.35, (
            f"workload {key}: auto is systematically off — median ratio "
            f"{med:.2f} across {entries}")


FLOORS = {1: methods.COUNT_CROSSOVER_N_1BYTE,
          2: methods.COUNT_MIN_N_ADAPTIVE_2BYTE,
          4: methods.COUNT_MIN_N_ADAPTIVE}


def test_auto_crossover_direction():
    """Below the crossover auto uses the comparison sort; above, counting."""
    for kdt in (np.uint8, np.int8, np.int16, np.uint16, np.int32,
                np.uint32):
        c = FLOORS[np.dtype(kdt).itemsize]
        assert methods.resolve("auto", kdt, (), c - 1).name == "xla"
        assert methods.resolve("auto", kdt, (), c).name == "count"
    # payloads exclude counting at any size
    assert methods.resolve("auto", np.uint8, (np.uint32,),
                           1 << 28).name == "xla"
    # 64-bit keys and floats are never count-eligible
    for kdt in (np.uint64, np.int64, np.float32, np.float64):
        assert methods.resolve("auto", kdt, (), 1 << 28).name == "xla"


def _count_over_xla(path):
    """(n, count/xla) of every row of a large-n sweep."""
    with open(path) as f:
        header = f.readline().split()
        assert header[0] == "number_of_elements"
        cols = header[1:]
        out = []
        for line in f:
            vals = line.split()
            row = dict(zip(cols, map(float, vals[1:])))
            out.append((int(vals[0]), row["count"] / row["xla"]))
    return out


def _gmean(xs):
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def test_scaling_tables_support_large_n_count_pick():
    """The uint8 sweep must justify the count crossover: count wins the
    geometric mean over the rows at and past it (single rows jitter)."""
    ratios = [r for n, r in _count_over_xla(
        os.path.join(LARGE_N_DIR, "tpe-uint8-Uniform.dat"))
        if n >= methods.COUNT_CROSSOVER_N_1BYTE]
    assert ratios, "sweep has no rows past the crossover"
    gmean = _gmean(ratios)
    assert gmean <= 1.05, (gmean, ratios)


def test_1byte_crossover_moved_only_as_far_as_the_tables_require():
    """The TPU's value stays if it passes the rule above; otherwise the
    crossover is the smallest swept n from which the gmean passes."""
    rows = _count_over_xla(os.path.join(LARGE_N_DIR,
                                        "tpe-uint8-Uniform.dat"))
    assert rows[-1][0] >= 1 << 27, "the sweep must reach 2^27 rows"
    passing = [n for n, _ in rows
               if _gmean([r for m, r in rows if m >= n]) <= 1.05]
    if TPU_COUNT_CROSSOVER_N_1BYTE in passing:
        assert methods.COUNT_CROSSOVER_N_1BYTE == TPU_COUNT_CROSSOVER_N_1BYTE
    elif passing:
        assert methods.COUNT_CROSSOVER_N_1BYTE == min(passing), (passing,
                                                                 rows)
    else:  # count wins at no swept size: every uint8 sort goes to xla
        assert methods.COUNT_CROSSOVER_N_1BYTE > rows[-1][0]


def _count_medians(width):
    """{n: [median over distributions of count/best device engine, per
    `width`-byte keys-only integer workload]} from the method tables."""
    by_workload = {}
    for _, kdt, pdts, n, dist, rows in _method_tables():
        if (n < MIN_N or pdts or np.dtype(kdt).itemsize != width
                or np.dtype(kdt).kind not in "ui" or "count" not in rows):
            continue
        best = min(v for k, v in rows.items()
                   if k in methods.REGISTRY and methods.REGISTRY[k].device)
        by_workload.setdefault((np.dtype(kdt).name, n), []).append(
            rows["count"] / best)
    out = {}
    for (_, n), ratios in by_workload.items():
        out.setdefault(n, []).append(sorted(ratios)[len(ratios) // 2])
    return out


@pytest.mark.parametrize("width", [2, 4])
def test_adaptive_crossover_moved_only_as_far_as_the_tables_require(width):
    """The TPU's 2^21 (counting.SMALL_MIN_N) stays unless a workload of
    that key width has a count median that fails the rule at or past it;
    then the crossover is the next power of two past the largest such n."""
    medians = _count_medians(width)
    assert medians, f"no keys-only {width}-byte method tables"
    failing = [n for n, meds in medians.items()
               if n >= counting.SMALL_MIN_N and max(meds) > 1.35]
    want = (1 << max(failing).bit_length() if failing
            else counting.SMALL_MIN_N)
    assert FLOORS[width] == want, medians


def test_adaptive_crossover_matches_engine_gate():
    """auto must never route to count in a band where the engine's
    1024-bucket branch is skipped."""
    assert FLOORS[2] >= counting.SMALL_MIN_N
    assert FLOORS[4] >= counting.SMALL_MIN_N


def test_tables_name_the_card():
    with open(os.path.join(BENCH_DIR, "CARD.json")) as f:
        card = json.load(f)
    assert card["calls"]
    for call in card["calls"]:
        assert call["card"].startswith("NVIDIA H100"), call["card"]
        assert call["commands"]
