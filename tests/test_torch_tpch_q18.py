"""TPC-H Q18 through the port's operators (benchmark/configs/tpch_sf100.py)
against the plain reference (benchmark/reference/tpch_sf100.py), on the
CPU at a tiny scale: the plan's answers, planted faults that the cell's
comparison must catch, and the configuration's column rules.

At SF 0.002 (3,000 orders) no order holds more than QUANTITY = 312-315
units, as the cell sends, so the plan runs at 150-250, where tens to
hundreds of orders qualify."""

import time

import numpy as np
import pytest
import torch

from benchmark import calls, harness

TINY = {"orders": 3000, "lineitems": 12003, "customers": 300,
        "scale_factor": 0.002}
SEEDS = (3, 2**33 + 17)
CPU = torch.device("cpu")
conf = harness.load_file_module("configs", "tpch_sf100")
ref = harness.load_file_module("reference", "tpch_sf100")
work = harness.load_file_module("work", "q18")
CTX = harness.Context(CPU)
_TABLES = {}


def tables(seed, lines=False):
    if (seed, lines) not in _TABLES:
        _TABLES[seed, lines] = conf.make_tables(TINY, seed, CPU, lines=lines)
    return _TABLES[seed, lines]


def shuffled_with_ties(seed):
    """The tables with lineitem and orders in a seeded random row order
    (the plan may assume neither), and ten of the orders that qualify at
    QUANTITY 150 given one price and one date: ties that only o_orderkey
    breaks."""
    t = dict(tables(seed))
    g = torch.Generator().manual_seed(seed)
    pl = torch.randperm(t["l_orderkey"].numel(), generator=g)
    po = torch.randperm(t["o_orderkey"].numel(), generator=g)
    for k in ("l_orderkey", "l_quantity"):
        t[k] = t[k][pl]
    for k in ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"):
        t[k] = t[k][po].clone()
    units = ref.units_by_key(t)[t["o_orderkey"]]
    tied = torch.nonzero(units > 150).squeeze(1)[:10]
    t["o_totalprice"][tied] = t["o_totalprice"].max() + 1
    t["o_orderdate"][tied] = 9000
    return t


def answer(t, quantity):
    state = conf.State(t, t["l_orderkey"].numel())
    call = calls.Call(0, "q18", {"quantity": quantity})
    out, facts = conf.q18(state, call.params, CTX)
    return state, call, conf.capture(state, call, out), facts


def checked(state, call, got):
    """(exact_mismatches, answers wrong) of one answer, by the cell's own
    comparison."""
    rec = harness.Record(call, answer=got)
    checks, wrong = conf.compare(state, [rec], ref, CTX,
                                 {"limits": {"exact_mismatches": 0}})
    return checks["exact_mismatches"]["value"], wrong


@pytest.mark.parametrize("quantity", [150, 200, 250])
@pytest.mark.parametrize("seed", SEEDS)
def test_q18_equals_the_reference(seed, quantity):
    t = tables(seed)
    state, call, got, facts = answer(t, quantity)
    want = ref.q18(t, quantity, {})
    assert len(want) > 0
    assert got == want[:conf.LIMIT]
    assert len(got) == min(len(want), conf.LIMIT)
    assert checked(state, call, got) == (0, 0)
    # the HAVING keeps the orders of more units, the semi-join all of them
    having, joined = facts["filter_rows"]
    assert having["n"] == TINY["orders"]
    assert having["selected"] == joined["n"] == len(want)
    assert facts["query"][0]["answer"] == len(got)


@pytest.mark.parametrize("seed", SEEDS)
def test_q18_on_shuffled_tables_with_ties(seed):
    t = shuffled_with_ties(seed)
    state, call, got, _ = answer(t, 150)
    want = ref.q18(t, 150, {})[:conf.LIMIT]
    assert got == want
    assert [r[4] for r in got[:10]] == [got[0][4]] * 10  # the planted tie
    assert [r[2] for r in got[:10]] == sorted(r[2] for r in got[:10])
    assert checked(state, call, got) == (0, 0)


def _at_least_once(t):
    """A QUANTITY that some order holds exactly, with at most LIMIT orders
    holding that many units or more."""
    units = ref.units_by_key(t)[t["o_orderkey"]]
    for q in sorted(set(units.tolist()), reverse=True):
        if int((units >= q).sum()) > 40:
            assert int((units >= q).sum()) <= conf.LIMIT
            return q
    raise AssertionError("no such QUANTITY")


def _sort_multi_fault(kind):
    sort_multi = conf.srs.sort_multi

    def faulty(keys, *pays, ascending, device):
        if kind == "price_ascending":
            return sort_multi(keys, *pays, ascending=(True, True, True),
                              device=device)
        # no o_orderkey tie-break: the key rides as a payload
        ks, ps = sort_multi(keys[:2], keys[2], *pays,
                            ascending=ascending[:2], device=device)
        return ks + ps[:1], ps[1:]
    return faulty


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["at_least", "price_ascending",
                                   "no_tie_break", "limit_101",
                                   "limit_99"])
def test_planted_faults_are_caught(seed, fault, monkeypatch):
    t = shuffled_with_ties(seed)
    q = _at_least_once(t) if fault == "at_least" else 150
    state = conf.State(t, t["l_orderkey"].numel())
    call = calls.Call(0, "q18", {"quantity": q})
    with monkeypatch.context() as m:
        params = dict(call.params)
        if fault == "at_least":  # >= QUANTITY: the same rows as > Q - 1
            params["quantity"] = q - 1
        elif fault.startswith("limit"):
            m.setattr(conf, "LIMIT", int(fault.split("_")[1]))
        else:
            m.setattr(conf.srs, "sort_multi", _sort_multi_fault(fault))
        out, _ = conf.q18(state, params, CTX)
    got = conf.capture(state, call, out)
    mismatches, wrong = checked(state, call, got)
    assert mismatches > 0 and wrong == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_follows_the_column_rules(seed):
    t = tables(seed, lines=True)
    r = {k: v.numpy() for k, v in t.items()}
    n_c = TINY["customers"]
    assert len(r["l_orderkey"]) == TINY["lineitems"]
    assert len(r["o_orderkey"]) == TINY["orders"]
    assert np.array_equal(r["c_custkey"], np.arange(1, n_c + 1))
    cust = r["o_custkey"]
    assert cust.min() >= 1 and cust.max() <= n_c and not (cust % 3 == 0).any()
    assert set(np.unique(r["o_orderkey"] % 32)) <= set(range(1, 9))
    assert set(np.unique(r["l_quantity"])) <= set(range(1, 51))
    # lineitem grouped by order, 1-7 lines an order, in the orders' order
    keys, per = np.unique(r["l_orderkey"], return_counts=True)
    assert (np.diff(r["l_orderkey"]) >= 0).all()
    assert np.array_equal(keys, r["o_orderkey"])
    assert per.min() >= 1 and per.max() <= 7
    # dbgen's mk_order, line by line in whole cents
    total = {}
    for k, ep, d, tx in zip(r["l_orderkey"].tolist(),
                            r["l_extendedprice"].tolist(),
                            r["l_discount"].tolist(), r["l_tax"].tolist()):
        cents = round(ep * 100) * (100 - round(d * 100)) // 100
        total[k] = total.get(k, 0) + cents * (100 + round(tx * 100)) // 100
    want = [total[k] / 100 for k in r["o_orderkey"].tolist()]
    assert r["o_totalprice"].tolist() == want
    # the resident columns do not depend on whether the lines are kept
    for k, v in tables(seed).items():
        assert torch.equal(v, t[k]), k


def test_bytes_needed_by_hand():
    f = {"op": "q18", "lineitems": 10, "orders": 3, "customers": 2,
         "answer": 1}
    assert work.bytes_needed(f) == 16 * 10 + 28 * 3 + 8 * 2 + 44


def test_cell_runs_on_the_cpu():
    mix = {"calls": [{"op": "q18", "shape": [],
                      "params": {"quantity": {"int": [150, 250]}}}]}
    res, checks = harness.run_cell(
        "tpch_sf100_q18", 2**33 + 5, 0.3, False, CPU, time.perf_counter(),
        config_override=TINY, mix_override=mix, log=lambda m: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert checks == {"exact_mismatches": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) >= {"rows_per_s", "p95_ms", "setup_s"}
