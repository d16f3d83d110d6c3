"""The plain references against second formulations on tiny inputs: the
TPC-H queries against row-by-row Python over NumPy arrays, the sort and
its payload rule against Python's own sort and the configuration's torch
copy of the rule."""

import numpy as np
import pytest
import torch

from benchmark import harness

TINY = {"orders": 2000, "lineitems": 8000, "scale_factor": 0.01}


@pytest.fixture(scope="module")
def tpch():
    conf = harness.load_file_module("configs", "tpch_sf30")
    ref = harness.load_file_module("reference", "tpch_sf30")
    t = conf.make_tables(TINY, seed=2**31 + 99, device=torch.device("cpu"))
    rows = {k: v.numpy() for k, v in t.items()}
    return conf, ref, t, rows


def ints(a, scale):
    return [int(round(x * scale)) for x in a]


def test_tables_follow_the_column_rules(tpch):
    conf, _, t, r = tpch
    assert len(r["l_orderkey"]) == TINY["lineitems"]
    assert set(np.unique(r["l_quantity"])) <= set(range(1, 51))
    assert set(ints(np.unique(r["l_discount"]), 100)) <= set(range(11))
    assert set(ints(np.unique(r["l_tax"]), 100)) <= set(range(9))
    assert (r["l_receiptdate"] - r["l_shipdate"]).min() >= 1
    assert (r["l_receiptdate"] - r["l_shipdate"]).max() <= 30
    n = r["l_returnflag"] == 1
    assert np.array_equal(n, r["l_receiptdate"] > conf.CURRENTDATE)
    assert np.array_equal(r["l_linestatus"] == 1,
                          r["l_shipdate"] > conf.CURRENTDATE)
    assert set(np.unique(r["o_orderkey"] % 32)) <= set(range(1, 9))


def test_q1_against_row_by_row(tpch):
    conf, ref, t, r = tpch
    cutoff = conf.Q1_BASE - 90
    want = {}
    qty, cents = ints(r["l_quantity"], 1), ints(r["l_extendedprice"], 100)
    disc, tax = ints(r["l_discount"], 100), ints(r["l_tax"], 100)
    for i in range(len(qty)):
        if r["l_shipdate"][i] <= cutoff:
            k = int(r["l_returnflag"][i]) * 2 + int(r["l_linestatus"][i])
            a = want.setdefault(k, [0] * 6)
            dp = cents[i] * (100 - disc[i])
            for j, v in enumerate((1, qty[i], cents[i], dp,
                                   dp * (100 + tax[i]), disc[i])):
                a[j] += v
    assert ref.q1(t, cutoff) == want


def test_q6_against_row_by_row(tpch):
    conf, ref, t, r = tpch
    d0, d1 = conf.day(1994), conf.day(1995)
    want = 0
    for i in range(len(r["l_shipdate"])):
        d = int(round(r["l_discount"][i] * 100))
        if d0 <= r["l_shipdate"][i] < d1 and 5 <= d <= 7 \
                and r["l_quantity"][i] < 24:
            want += int(round(r["l_extendedprice"][i] * 100)) * d
    assert ref.q6(t, d0, d1, 5, 7, 24) == want


def test_q12_against_row_by_row(tpch):
    conf, ref, t, r = tpch
    prio = dict(zip(r["o_orderkey"].tolist(), r["o_orderpriority"].tolist()))
    d0, d1 = conf.day(1995), conf.day(1996)
    want = {}
    for i in range(len(r["l_shipdate"])):
        m = int(r["l_shipmode"][i])
        if m in (2, 5) and r["l_commitdate"][i] < r["l_receiptdate"][i] \
                and r["l_shipdate"][i] < r["l_commitdate"][i] \
                and d0 <= r["l_receiptdate"][i] < d1:
            hi, lo = want.get(m, (0, 0))
            urgent = prio[int(r["l_orderkey"][i])] <= 1
            want[m] = (hi + urgent, lo + (not urgent))
    assert ref.q12(t, [2, 5], d0, d1, {}) == want


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint32",
                                   "uint64"])
def test_sort_reference_and_payload_rule(dtype):
    conf = harness.load_file_module("configs", "sort_thesis")
    ref = harness.load_file_module("reference", "sort_thesis")
    keys = conf.make_keys(getattr(torch, dtype), "Uniform", 3000, 5,
                          torch.device("cpu"))
    host = conf.to_host(keys)
    assert list(ref.sort_keys(host, True)) == sorted(host.tolist())
    assert list(ref.sort_keys(host, False)) == sorted(host.tolist(),
                                                      reverse=True)
    # the configuration's torch copy of the payload rule is the
    # reference's, bit for bit
    assert np.array_equal(conf.to_host(conf.payload(keys, 1)),
                          ref.payload(host, 1))


@pytest.mark.parametrize("dist", ["Gaussian", "Zero", "ZeroOne", "Sorted",
                                  "ReverseSorted", "AlmostSorted",
                                  "AlmostReverseSorted"])
def test_distributions(dist):
    conf = harness.load_file_module("configs", "sort_thesis")
    n = 10_000
    k = conf.to_host(conf.make_keys(torch.int16, dist, n, 3,
                                    torch.device("cpu"))).astype(np.int64)
    if dist == "Zero":
        assert not k.any()
    elif dist == "ZeroOne":
        assert set(np.unique(k)) == {0, 1}
    elif dist == "Gaussian":
        assert abs(k.std() - 100) < 5
    elif dist in ("Sorted", "ReverseSorted"):
        d = np.diff(k)
        assert (d >= 0).all() if dist == "Sorted" else (d <= 0).all()
    else:  # floor(2^log10(n)) = 16 swaps leave at most 64 pairs out of order
        d = np.diff(k if dist == "AlmostSorted" else -k)
        assert 0 < (d < 0).sum() <= 64
