"""The full-table ORDER BY of TPC-H lineitem through the port's
`sort_multi` (benchmark/configs/tpch_sf30_lineitem.py) against the plain
reference (benchmark/reference/tpch_sf30_lineitem.py), on the CPU at SF
0.001-0.01: the sorted table at the cell's directions and at others, the
reference's order by hand, the generator's column rules, planted faults
that the cell's comparison must catch, the byte counts, and the cell run
end to end."""

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calls, harness
from simd_radix_sort_tpu_torch.ops import sort as sort_ops

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CTX = harness.Context(CPU)
SEEDS = (3, 2**33 + 17, 2**31 + 11)
LIMITS = {"limits": {"keys_differing": 0, "rows_differing": 0}}
# orders and dbgen's lineitem counts at SF 0.001 and 0.01
SIZES = {0.001: (1500, 6005), 0.01: (15000, 60175)}
conf = harness.load_file_module("configs", "tpch_sf30_lineitem")
ref = harness.load_file_module("reference", "tpch_sf30_lineitem")
sf30 = harness.load_file_module("configs", "tpch_sf30")
work = harness.load_file_module("work", "orderby")
_, _entry = harness.cell_of(harness.load_benchmark(), "tpch_sf30_orderby")
BASE = json.loads((REPO / _entry["file"]).read_text())
MIX = {"calls": [{"op": "orderby", "shape": [],
                  "params": {"copy": {"int": [0, 1]}}}]}
_STATES = {}


def cfg_of(sf):
    orders, lines = SIZES[sf]
    return dict(BASE, scale_factor=sf, orders=orders, lineitems=lines)


def state_of(seed, sf=0.01):
    if (seed, sf) not in _STATES:
        _STATES[seed, sf] = conf.setup(cfg_of(sf), MIX, seed, CTX)
    return _STATES[seed, sf]


def checked(state, answers):
    """(keys differing, rows differing, answers wrong) of (copy, answer)
    pairs, by the cell's own comparison."""
    recs = [harness.Record(calls.Call(i, "orderby", {"copy": c}), answer=a)
            for i, (c, a) in enumerate(answers)]
    checks, wrong = conf.compare(state, recs, ref, CTX, LIMITS)
    return (checks["keys_differing"]["value"],
            checks["rows_differing"]["value"], wrong)


def sorted_by(state, copy, ascending, keys=conf.KEYS):
    """`sort_multi` of one table by `keys` in the given directions, every
    column carried, as the cell's answer on the host."""
    t = state.tables[copy]
    rest = [c for c in conf.COLUMNS if c not in keys]
    ks, ps = sort_ops.sort_multi(tuple(t[k] for k in keys),
                                 *(t[c] for c in rest), ascending=ascending,
                                 device="cpu")
    return {n: c.numpy() for n, c in zip(tuple(keys) + tuple(rest), ks + ps)}


def expected(state, copy, ascending):
    t = state.tables[copy]
    perm = ref.order([t[k].numpy() for k in conf.KEYS], ascending)
    return {c: ref.column(t[c].numpy(), perm) for c in conf.COLUMNS}


def assert_same(got, want):
    assert set(got) == set(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert np.array_equal(got[c].view(np.uint8),
                              want[c].view(np.uint8)), c


@pytest.mark.parametrize("ascending", [(True, False, True),
                                       (False, True, False),
                                       (True, True, True),
                                       (False, False, False)])
@pytest.mark.parametrize("sf", [0.001, 0.01])
@pytest.mark.parametrize("seed", SEEDS)
def test_sort_multi_equals_the_reference(seed, sf, ascending):
    state = state_of(seed, sf)
    for copy in (0, 1):
        got = sorted_by(state, copy, ascending)
        assert_same(got, expected(state, copy, ascending))
        if ascending == conf.ASCENDING:
            assert checked(state, [(copy, got)]) == (0, 0, 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_orderby_op_equals_the_reference(seed):
    state = state_of(seed, 0.001)
    n = SIZES[0.001][1]
    for copy in (0, 1):
        out, facts = conf.orderby(state, {"copy": copy}, CTX)
        got = conf.capture(state, None, out)
        assert_same(got, expected(state, copy, conf.ASCENDING))
        assert facts == {"rows": n, "orderby": [{"n": n, "row_bytes": 84}]}
    assert checked(state, [(0, got), (1, got)])[2] == 1


def _lexicographic(keys, ascending):
    """The order by Python's sort of row tuples, the plainest form."""
    rows = list(zip(*(k.tolist() for k in keys)))
    return sorted(range(len(rows)), key=lambda i: tuple(
        v if up else -v for v, up in zip(rows[i], ascending)))


@pytest.mark.parametrize("ascending", list(itertools.product((True, False),
                                                             repeat=3)))
@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_reference_order_by_hand(n, ascending):
    rng = np.random.default_rng(n + 17)
    keys = [rng.integers(-40, 40, n).astype(np.int32),
            rng.integers(0, 2**62, n, dtype=np.int64) % 9,
            rng.integers(0, 255, n).astype(np.uint8)]
    got = ref.order(keys, ascending)
    assert got.dtype == np.int64
    assert got.tolist() == _lexicographic(keys, ascending)


def test_reference_refuses_float_keys():
    with pytest.raises(TypeError):
        ref.order([np.zeros(3)], (True,))


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_follows_the_column_rules(seed):
    cfg = cfg_of(0.01)
    orders, n = SIZES[0.01]
    state = state_of(seed)
    tseed = calls.derive(seed, "lineitem", 0)
    t = state.tables[0]
    assert tuple(t) == conf.COLUMNS
    assert sum(c.element_size() for c in t.values()) == 84
    assert all(c.shape == (n,) for c in t.values())
    # the 11 columns tpch_sf30 makes, as it makes them
    base = sf30.make_tables(cfg, tseed, CPU)
    for c in base:
        if c.startswith("l_"):
            assert torch.equal(t[c], base[c]), c
    # (l_orderkey, l_linenumber) unique; lines 1..k in each order's run
    okey, line = t["l_orderkey"], t["l_linenumber"].to(torch.int64)
    assert t["l_linenumber"].dtype == torch.int32
    assert torch.unique(okey * 8 + line).numel() == n
    assert int(line.min()) == 1 and int(line.max()) == 7
    _, per = torch.unique_consecutive(okey, return_counts=True)
    assert per.numel() == orders
    assert torch.equal(line, torch.cat([torch.arange(1, k + 1)
                                        for k in per.tolist()]))
    # l_partkey: tpch_sf30's own draw, the part that priced the line
    g = torch.Generator().manual_seed(calls.derive(tseed, "tpch",
                                                   "l_partkey"))
    part = torch.randint(1, int(0.01 * 200_000) + 1, (n,), generator=g)
    assert torch.equal(t["l_partkey"], part)
    cents = 90_000 + (part // 10) % 20_001 + 100 * (part % 1000)
    qty = t["l_quantity"].to(torch.int64)
    assert torch.equal(t["l_extendedprice"], (qty * cents).double() / 100)
    # l_suppkey: one of the part's four suppliers by PS_SUPPKEY
    s = int(0.01 * 10_000)
    sup = [(p + i * (s // 4 + (p - 1) // s)) % s + 1
           for p in part.tolist()[:2000] for i in range(4)]
    for r, k in enumerate(t["l_suppkey"].tolist()[:2000]):
        assert k in sup[4 * r:4 * r + 4]
    assert 1 <= int(t["l_suppkey"].min()) and int(t["l_suppkey"].max()) <= s
    assert len(set(t["l_suppkey"].tolist())) > s // 2
    # l_shipinstruct 0-3; l_comment the offsets of comments of 10-43 chars
    assert set(t["l_shipinstruct"].tolist()) == set(range(4))
    com = t["l_comment"]
    assert int(com[0]) == 0
    step = com[1:] - com[:-1]
    assert int(step.min()) >= 10 and int(step.max()) <= 43
    # each table from its own seed tag
    assert not torch.equal(t["l_shipdate"], state.tables[1]["l_shipdate"])


def _fault(kind, state, copy):
    """The cell's answer for one table with one fault planted."""
    if kind == "control":
        out, _ = conf.CONTROL["orderby"](state, {"copy": copy}, CTX)
        return conf.capture(state, None, out)
    if kind == "orderkey_ascending":
        return sorted_by(state, copy, (True, True, True))
    if kind == "ties_reversed":  # the tie-break dropped, ties reversed
        return sorted_by(state, copy, (True, False, False))
    got = sorted_by(state, copy, conf.ASCENDING)
    if kind == "shifted_payload":  # l_comment gathered by a shifted index
        got["l_comment"] = np.roll(got["l_comment"], 1)
    elif kind == "float32_price":
        got["l_extendedprice"] = got["l_extendedprice"].astype(
            np.float32).astype(np.float64)
    elif kind == "dropped_row":
        got = {c: v[:-1] for c, v in got.items()}
    elif kind == "int32_comment":
        got["l_comment"] = got["l_comment"].astype(np.int32)
    elif kind == "missing_column":
        del got["l_tax"]
    return got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", [
    "control", "orderkey_ascending", "ties_reversed", "shifted_payload",
    "float32_price", "dropped_row", "int32_comment", "missing_column"])
def test_planted_faults_are_caught(fault, seed):
    state = state_of(seed)
    n = state.n
    bad_keys, bad_rows, wrong = checked(state, [(1, _fault(fault, state, 1))])
    assert wrong == 1 and bad_rows > 0
    if fault in ("shifted_payload", "float32_price"):
        assert bad_keys == 0
    else:
        assert bad_keys > 0
    if fault in ("shifted_payload", "dropped_row", "int32_comment",
                 "missing_column"):
        assert bad_rows == n
    if fault in ("control", "ties_reversed"):
        # only the lines of one order shipped on one day move
        assert bad_keys == bad_rows < n // 10


def test_a_right_answer_beside_a_wrong_one():
    state = state_of(SEEDS[0])
    good = sorted_by(state, 0, conf.ASCENDING)
    bad = _fault("ties_reversed", state, 1)
    bad_keys, bad_rows, wrong = checked(state, [(0, good), (1, bad)])
    assert wrong == 1 and 0 < bad_keys == bad_rows


@pytest.mark.parametrize("n,widths,want", [
    # the index narrowed (12n), the column gathered straight (4n + 2 x 8n)
    (10, [8], 10 * (12 + 20)),
    # narrowed, one group packed (13n + 16n) and gathered (4n + 16n + 13n)
    (1000, [4, 8, 1], 1000 * (12 + 29 + 33)),
    (0, [8, 8], 0),
    # past cub's MAX_ITEMS the int64 index is read as it is: one group
    # packed (12n + 16n) and gathered (8n + 16n + 12n)
    (2**31, [8, 4], 2**31 * 64),
    # the cell: 16 lineitem columns of 84 bytes in 4 groups, 364n, 65.5 GB
    (179_998_372, [8, 8, 8, 4, 8, 8, 8, 8, 1, 1, 4, 4, 4, 1, 1, 8],
     65_519_407_408),
])
def test_gather_bytes_by_hand(n, widths, want):
    assert sort_ops.multi_gather_bytes(n, widths) == want


@pytest.mark.parametrize("n,row_bytes,want", [(10, 84, 1680), (3, 24, 144),
                                              (179_998_372, 84,
                                               30_239_726_496)])
def test_bytes_needed_by_hand(n, row_bytes, want):
    assert work.bytes_needed({"n": n, "row_bytes": row_bytes}) == want


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(traced):
    from simd_radix_sort_tpu_torch.utils import profiling
    profiling.reset_counters()
    n = SIZES[0.001][1]
    res, checks = harness.run_cell(
        "tpch_sf30_orderby", 2**40 + 9, 0.4, traced, CPU,
        time.perf_counter(), config_override=cfg_of(0.001),
        mix_override={"check": {"share": 1.0, "max": 4}}, log=lambda m: None)
    profiling.reset_counters()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert checks == {"keys_differing": {"value": 0, "limit": 0},
                      "rows_differing": {"value": 0, "limit": 0}}
    if traced:
        # no device events on the CPU: the counter alone has a reading
        got = res["metrics"]["operators.orderby_gb"]["value"]
        assert got == pytest.approx(364 * n / 1e9)
    else:
        assert set(res["metrics"]) >= {"rows_per_s", "p95_ms", "setup_s"}


def test_control_through_the_cell_is_not_correct():
    res, checks = harness.run_cell(
        "tpch_sf30_orderby", 2**40 + 9, 0.2, False, CPU,
        time.perf_counter(), config_override=cfg_of(0.001),
        ops=conf.CONTROL, log=lambda m: None)
    assert not res["correct"]
    assert checks["keys_differing"]["value"] > 0


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; from benchmark import harness; "
            "harness.load_file_module('reference', 'tpch_sf30_lineitem'); "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"simd_radix_sort_tpu_torch", "simd_radix_sort_tpu",
                         "jax", "torch"}
