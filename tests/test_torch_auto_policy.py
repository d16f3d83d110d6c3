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

The floors themselves (methods.py):
  * 1-byte keys: the smallest swept n from which `count` is <= 1.05x
    `xla` at every row of every 1-byte large-n sweep (campaign part d,
    uint8 Uniform, Zero, Sorted, ReverseSorted and int8 Uniform, to 2^27
    rows; each row the two engines in turns, median of the rounds), so
    every 1-byte key goes through K1 and K4 only where that pays whatever
    its distribution; the geometric mean rule holds past it too;
  * 2- and 4-byte keys, per key type: the rule above, from the larger of
    the TPU's 2^21 and the engine's own branch gate counting.SMALL_MIN_N
    (a floor below the gate would send keys to count where its
    1024-bucket branch is skipped): the next power of two past the
    largest table size at which that key type has a count median above
    1.35.
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

# the JAX package's adaptive floor, measured on a TPU: the base of the 2-
# and 4-byte rule
TPU_COUNT_MIN_N_ADAPTIVE = 1 << 21
# the 1-byte large-n sweeps (campaign part d) and the sizes the
# 2- and 4-byte method tables must cover (campaign part f)
ONE_BYTE_SWEEPS = ("uint8-Uniform", "uint8-Zero", "uint8-Sorted",
                   "uint8-ReverseSorted", "int8-Uniform")
SWEEP_MAX_N = 1 << 27
ADAPTIVE_TABLE_NS = tuple(1 << e for e in range(22, 27))


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


COUNT_TYPES = {1: ("uint8", "int8"), 2: ("int16", "uint16"),
               4: ("int32", "uint32")}
FLOORS = {name: methods.count_floor(name)
          for names in COUNT_TYPES.values() for name in names}


def test_auto_crossover_direction():
    """Below the crossover auto uses the comparison sort; above, counting."""
    for kdt in (np.uint8, np.int8, np.int16, np.uint16, np.int32,
                np.uint32):
        c = FLOORS[np.dtype(kdt).name]
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


def one_byte_floor():
    """The 1-byte rule's floor: the smallest swept n from which count is
    <= 1.05x xla at every row of every ONE_BYTE_SWEEPS sweep; past the
    largest swept n when count loses some row at the top."""
    sweeps = [_count_over_xla(os.path.join(LARGE_N_DIR, f"tpe-{s}.dat"))
              for s in ONE_BYTE_SWEEPS]
    ns = sorted({n for rows in sweeps for n, _ in rows})
    for n0 in ns:
        if all(r <= 1.05 for rows in sweeps for n, r in rows if n >= n0):
            return n0
    return 2 * ns[-1]


def test_1byte_crossover_moved_only_as_far_as_the_tables_require():
    """The floor is the smallest swept n from which both rules hold on the
    1-byte sweeps: count <= 1.05x xla at every row (one_byte_floor), and
    the geometric mean of the uint8 Uniform rows past it <= 1.05."""
    rows = _count_over_xla(os.path.join(LARGE_N_DIR,
                                        "tpe-uint8-Uniform.dat"))
    assert rows[-1][0] >= SWEEP_MAX_N, "the sweep must reach 2^27 rows"
    assert methods.COUNT_CROSSOVER_N_1BYTE == one_byte_floor()
    assert FLOORS["uint8"] == FLOORS["int8"] == one_byte_floor()
    past = [r for n, r in rows if n >= methods.COUNT_CROSSOVER_N_1BYTE]
    assert not past or _gmean(past) <= 1.05, past


@pytest.mark.parametrize("sweep", ONE_BYTE_SWEEPS)
def test_1byte_floor_count_within_5_percent_of_xla_on_every_row(sweep):
    """Every row of every 1-byte sweep from the floor to 2^27: count's
    median is <= 1.05x xla's (the rows measured in turns)."""
    rows = _count_over_xla(os.path.join(LARGE_N_DIR, f"tpe-{sweep}.dat"))
    assert rows[0][0] <= 1 << 14 and rows[-1][0] >= SWEEP_MAX_N
    late = [(n, r) for n, r in rows if n >= methods.COUNT_CROSSOVER_N_1BYTE]
    assert all(r <= 1.05 for _, r in late), late


def _count_medians(width):
    """{key type: {n: median over distributions of count/best device
    engine}} of the `width`-byte keys-only integer method tables."""
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
    for (name, n), ratios in by_workload.items():
        out.setdefault(name, {})[n] = sorted(ratios)[len(ratios) // 2]
    return out


def adaptive_floor(medians) -> int:
    """The policy rule for one key type's {n: median}: from the larger of the
    TPU's 2^21 and counting.SMALL_MIN_N, the next power of two past the
    largest n whose median is above 1.35."""
    base = max(TPU_COUNT_MIN_N_ADAPTIVE, counting.SMALL_MIN_N)
    failing = [n for n, med in medians.items() if n >= base and med > 1.35]
    return 1 << max(failing).bit_length() if failing else base


@pytest.mark.parametrize("width", [2, 4])
def test_adaptive_crossover_moved_only_as_far_as_the_tables_require(width):
    """For each key type of that width, the base (the larger of the TPU's
    2^21 and counting.SMALL_MIN_N) stays unless a count median fails the
    rule at or past it; then the crossover is the next power of two past
    the largest such n."""
    medians = _count_medians(width)
    assert set(medians) == set(COUNT_TYPES[width]), medians
    for name, meds in medians.items():
        assert FLOORS[name] == adaptive_floor(meds), (name, meds)


@pytest.mark.parametrize("type_name", ["int16", "uint16", "int32",
                                       "uint32"])
def test_adaptive_tables_cover_every_size_and_distribution(type_name):
    """Campaign part f: a keys-only method table of the device engines
    for each of the 8 distributions at every size from 2^22 to 2^26."""
    have = {(n, dist) for _, kdt, pdts, n, dist, rows in _method_tables()
            if np.dtype(kdt).name == type_name and not pdts
            and {"xla", "radix", "count", "quick"} <= set(rows)}
    want = {(n, d) for n in ADAPTIVE_TABLE_NS
            for d in ("Uniform", "Gaussian", "Zero", "ZeroOne", "Sorted",
                      "ReverseSorted", "AlmostSorted",
                      "AlmostReverseSorted")}
    assert want <= have, sorted(want - have)


def test_adaptive_crossover_matches_engine_gate():
    """auto must never route to count in a band where the engine's
    1024-bucket branch is skipped."""
    for width in (2, 4):
        for name in COUNT_TYPES[width]:
            assert FLOORS[name] >= counting.SMALL_MIN_N, name


def test_tables_name_the_card():
    with open(os.path.join(BENCH_DIR, "CARD.json")) as f:
        card = json.load(f)
    assert card["calls"]
    for call in card["calls"]:
        assert call["card"].startswith("NVIDIA H100"), call["card"]
        assert call["commands"]


# the commit of the campaign's first calls, before K1's redesign
PRE_K1_REDESIGN = "3bb2b58"


def test_count_tables_measured_after_the_k1_redesign():
    """Every table the floors read was last written by a call that did
    not run the parent of K1's redesign."""
    with open(os.path.join(BENCH_DIR, "CARD.json")) as f:
        calls = json.load(f)["calls"]
    last = {}
    for call in calls:
        for cmd in call["commands"]:
            for table in cmd["tables"]:
                last[table] = call["commit"]
    read = ([f"large_n/tpe-{s}.dat" for s in ONE_BYTE_SWEEPS]
            + [fname for fname, kdt, pdts, n, *_ in _method_tables()
               if not pdts and np.dtype(kdt).kind in "ui"
               and np.dtype(kdt).itemsize <= 4 and n >= MIN_N])
    stale = [t for t in read
             if not last.get(t) or last[t].startswith(PRE_K1_REDESIGN)]
    assert not stale, stale
