"""The `tpch_sf30` configuration: TPC-H (specification v3) at scale factor
30, the columns that Q1, Q6 and Q12 read, resident on the card.

The tables are made on the card from the seed by the column rules of the
specification's section 4.2.3 (not dbgen's own random stream), from the
pattern of `chip_smoke.tpch_tables`, extended to those columns: a frozen
copy, so that the data does not change with the program.  Dates are day
numbers since 1970-01-01; flags, statuses, modes and priorities are int8
codes in the order of their names, so ORDER BY on a code is ORDER BY on the
name.  Each column draws from its own generator, so a column is the same
whatever else a cell makes.

The operations are the queries' plans over the port's public operators:
the predicate in plain torch, then `filter_rows` (one K5 compaction), then
`group_aggregate` (Q1, Q12), a sum (Q6) or `lookup_join` into `orders`
(Q12).
"""

from __future__ import annotations

import dataclasses
import datetime
from fractions import Fraction

import torch

from benchmark import calls
from simd_radix_sort_tpu_torch.ops import filter as filt
from simd_radix_sort_tpu_torch.ops import hashagg, hashjoin

SPANS = ("query", "filter_rows", "group_aggregate", "lookup_join")

# codes: l_returnflag A 0, N 1, R 2; l_linestatus F 0, O 1;
# o_orderpriority 1-URGENT 0, 2-HIGH 1, 3-MEDIUM 2, 4-NOT SPECIFIED 3,
# 5-LOW 4; l_shipmode the index in SHIPMODES
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")


def day(y: int, m: int = 1, d: int = 1) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


STARTDATE, ENDDATE = day(1992), day(1998, 12, 31)
CURRENTDATE = day(1995, 6, 17)
Q1_BASE = day(1998, 12, 1)  # Q1: l_shipdate <= 1998-12-01 - DELTA days

# bytes a row of each column the queries read
WIDTH = {"l_orderkey": 8, "l_quantity": 8, "l_extendedprice": 8,
         "l_discount": 8, "l_tax": 8, "l_shipdate": 4, "l_commitdate": 4,
         "l_receiptdate": 4, "l_returnflag": 1, "l_linestatus": 1,
         "l_shipmode": 1, "o_orderkey": 8, "o_orderpriority": 1}


@dataclasses.dataclass
class State:
    t: dict
    n: int
    cache: dict = dataclasses.field(default_factory=dict)


def make_tables(cfg: dict, seed: int, device) -> dict:
    n_o, n_l = int(cfg["orders"]), int(cfg["lineitems"])
    sf = cfg["scale_factor"]

    def draw(column, lo, hi, size, dtype=torch.int64):
        g = torch.Generator(device=device)
        g.manual_seed(calls.derive(seed, "tpch", column))
        return torch.randint(lo, hi + 1, (size,), generator=g, device=device,
                             dtype=dtype)

    t = {}
    i = torch.arange(n_o, device=device)
    t["o_orderkey"] = (i // 8) * 32 + i % 8 + 1  # 8 of every 32 keys
    del i
    t["o_orderpriority"] = draw("o_orderpriority", 0, 4, n_o, torch.int8)
    o_orderdate = draw("o_orderdate", STARTDATE, ENDDATE - 151, n_o,
                       torch.int32)
    # 1-7 lines an order, nudged to the scale factor's lineitem count
    per = draw("o_lines", 1, 7, n_o)
    diff = n_l - int(per.sum())
    room = torch.nonzero(per < 7 if diff > 0 else per > 1).squeeze(1)
    if room.numel() < abs(diff):
        raise ValueError("cannot reach the lineitem count")
    per[room[:abs(diff)]] += 1 if diff > 0 else -1
    t["l_orderkey"] = torch.repeat_interleave(t["o_orderkey"], per,
                                              output_size=n_l)
    orderdate = torch.repeat_interleave(o_orderdate, per, output_size=n_l)
    del per, room, o_orderdate
    qty = draw("l_quantity", 1, 50, n_l)
    t["l_quantity"] = qty.double()
    part = draw("l_partkey", 1, int(sf * 200_000), n_l)
    # P_RETAILPRICE (4.2.3) in cents, then L_EXTENDEDPRICE = qty x price
    cents = 90_000 + (part // 10) % 20_001 + 100 * (part % 1000)
    del part
    t["l_extendedprice"] = (qty * cents).double() / 100
    del qty, cents
    t["l_discount"] = draw("l_discount", 0, 10, n_l).double() / 100
    t["l_tax"] = draw("l_tax", 0, 8, n_l).double() / 100
    t["l_shipdate"] = orderdate + draw("l_shipdate", 1, 121, n_l,
                                       torch.int32)
    t["l_commitdate"] = orderdate + draw("l_commitdate", 30, 90, n_l,
                                         torch.int32)
    del orderdate
    t["l_receiptdate"] = t["l_shipdate"] + draw("l_receiptdate", 1, 30, n_l,
                                                torch.int32)
    # R or A once received by CURRENTDATE, else N; O once shipped after it
    ra = draw("l_returnflag", 0, 1, n_l, torch.int8) * 2  # A 0, R 2
    t["l_returnflag"] = torch.where(t["l_receiptdate"] <= CURRENTDATE, ra,
                                    torch.ones_like(ra))
    del ra
    t["l_linestatus"] = (t["l_shipdate"] > CURRENTDATE).to(torch.int8)
    t["l_shipmode"] = draw("l_shipmode", 0, 6, n_l, torch.int8)
    return t


def setup(cfg: dict, mix: dict, seed: int, ctx) -> State:
    t = make_tables(cfg, seed, ctx.device)
    return State(t, t["l_shipdate"].numel())


def _filter_facts(n, c, cols):
    return {"n": n, "selected": c, "stream_bytes": [WIDTH[k] for k in cols]}


Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax")


def q1(state: State, p: dict, ctx):
    """Pricing summary report: by (returnflag, linestatus), over the rows
    shipped by 1998-12-01 less DELTA days."""
    t = state.t
    with ctx.span("query"):
        mask = t["l_shipdate"] <= Q1_BASE - p["delta"]
        with ctx.span("filter_rows"):
            cnt, rf, ls, qty, price, disc, tax = filt.filter_rows(
                mask, *(t[k] for k in Q1_COLUMNS))
        c = int(cnt)
        key = rf[:c] * 2 + ls[:c]  # A/F 0, N/F 2, N/O 3, R/F 4
        price, disc = price[:c], disc[:c]
        disc_price = price * (1 - disc)
        charge = disc_price * (1 + tax[:c])
        with ctx.span("group_aggregate"):
            out = hashagg.group_aggregate(
                key, (qty[:c], price, disc_price, charge, disc),
                aggs=("sum", "mean", "count"),
                agg_streams=((0, 1, 2, 3), (0, 1, 4), ()), max_groups=6)
    n = state.n
    return out, {"rows": n, "query": [{"op": "q1", "n": n, "selected": c}],
                 "filter_rows": [_filter_facts(n, c, Q1_COLUMNS)]}


def q6(state: State, p: dict, ctx):
    """Forecasting revenue change: sum(extendedprice * discount) over a
    year's shipments with discount DISCOUNT +- 0.01 and quantity below
    QUANTITY.  The discounts are whole hundredths, so the bounds are put
    half a hundredth out, where no value lies."""
    t = state.t
    d = p["discount"]
    with ctx.span("query"):
        mask = ((t["l_shipdate"] >= day(p["year"]))
                & (t["l_shipdate"] < day(p["year"] + 1))
                & (t["l_discount"] > (d - 1.5) / 100)
                & (t["l_discount"] < (d + 1.5) / 100)
                & (t["l_quantity"] < p["quantity"]))
        with ctx.span("filter_rows"):
            cnt, price, disc = filt.filter_rows(
                mask, t["l_extendedprice"], t["l_discount"])
        c = int(cnt)
        revenue = (price[:c] * disc[:c]).sum()
    n = state.n
    return revenue, {
        "rows": n, "query": [{"op": "q6", "n": n, "selected": c}],
        "filter_rows": [_filter_facts(n, c, ("l_extendedprice",
                                             "l_discount"))]}


def q12(state: State, p: dict, ctx):
    """Shipping modes and order priority: lines of two ship modes received
    in a year after their commit date, committed after shipping, counted
    by the priority of their order (1-URGENT, 2-HIGH against the rest)."""
    t = state.t
    m1, m2 = (SHIPMODES.index(m) for m in p["shipmodes"])
    with ctx.span("query"):
        mode = t["l_shipmode"]
        mask = (((mode == m1) | (mode == m2))
                & (t["l_commitdate"] < t["l_receiptdate"])
                & (t["l_shipdate"] < t["l_commitdate"])
                & (t["l_receiptdate"] >= day(p["year"]))
                & (t["l_receiptdate"] < day(p["year"] + 1)))
        with ctx.span("filter_rows"):
            cnt, okey, mode = filt.filter_rows(mask, t["l_orderkey"], mode)
        c = int(cnt)
        with ctx.span("lookup_join"):
            found, _, (prio,) = hashjoin.lookup_join(
                okey[:c], t["o_orderkey"], (t["o_orderpriority"],))
        high = (found & (prio <= 1)).to(torch.int64)
        low = (found & (prio > 1)).to(torch.int64)
        with ctx.span("group_aggregate"):
            out = hashagg.group_aggregate(mode[:c], (high, low),
                                          aggs=("sum",), max_groups=7)
    n = state.n
    return out, {"rows": n, "query": [{"op": "q12", "n": n, "selected": c,
                                       "orders": t["o_orderkey"].numel()}],
                 "filter_rows": [_filter_facts(n, c, ("l_orderkey",
                                                      "l_shipmode"))]}


OPS = {"q1": q1, "q6": q6, "q12": q12}


def capture(state: State, call, out):
    """A query's answer on the host: Q6 a float; Q1 and Q12 a list of
    rows (group key, value, ...) with the group's values in the SELECT's
    order."""
    if call.op == "q6":
        return float(out)
    ng, keys, results = out
    g = int(ng)
    cols = [keys[:g]] + [x[:g] for r in results
                         for x in (r if isinstance(r, tuple) else (r,))]
    cols = [c.cpu().tolist() for c in cols]
    return [tuple(row) for row in zip(*cols)]


def _expected(state: State, call, ref, ctx):
    """The reference's exact answer: Q1 and Q12 rows of (key, Fraction or
    int, ...), Q6 a Fraction; cached by parameters."""
    k = call.key()
    if k in state.cache:
        return state.cache[k]
    p, t = call.params, state.t
    if call.op == "q1":
        groups = ref.q1(t, Q1_BASE - p["delta"])
        want = []
        for key in sorted(groups):
            cnt, qty, cents, dp, ch, disc = groups[key]
            want.append((key, Fraction(qty), Fraction(cents, 100),
                         Fraction(dp, 10**4), Fraction(ch, 10**6),
                         Fraction(qty, cnt), Fraction(cents, 100 * cnt),
                         Fraction(disc, 100 * cnt), cnt))
    elif call.op == "q6":
        want = Fraction(ref.q6(t, day(p["year"]), day(p["year"] + 1),
                               p["discount"] - 1, p["discount"] + 1,
                               p["quantity"]), 10**4)
    else:
        counts = ref.q12(t, [SHIPMODES.index(m) for m in p["shipmodes"]],
                         day(p["year"]), day(p["year"] + 1), state.cache)
        want = [(m, hi, lo) for m, (hi, lo) in sorted(counts.items())]
    state.cache[k] = want
    return want


def _rel(got, want: Fraction) -> float:
    if want == 0:
        return abs(float(got))
    return abs(float(Fraction(got) - want) / want)


def compare(state: State, kept, ref, ctx, cfg: dict):
    """Every kept answer against the reference's exact one.  Integers
    (group keys, counts, the number of groups) must be equal; each float
    aggregate is held to a relative error.  Returns (checks, the answers
    that differ)."""
    limits = cfg["limits"]
    worst, exact_bad, wrong, floats = 0.0, 0, 0, False
    for rec in kept:
        want, got = _expected(state, rec.call, ref, ctx), rec.answer
        bad, err = 0, 0.0
        if rec.call.op == "q6":
            floats = True
            err = _rel(got, want)
        elif len(got) != len(want):
            bad = 1 + abs(len(got) - len(want))
        else:
            for g_row, w_row in zip(got, want):
                for g, w in zip(g_row, w_row):
                    if isinstance(w, Fraction):
                        floats = True
                        err = max(err, _rel(g, w))
                    else:
                        bad += int(g) != w
        worst = max(worst, err)
        exact_bad += bad
        wrong += bool(bad) or err > limits.get("agg_rel_err", 0.0)
    checks = {"exact_mismatches": {"value": exact_bad,
                                   "limit": limits["exact_mismatches"]}}
    if floats:
        checks["agg_rel_err"] = {"value": worst,
                                 "limit": limits["agg_rel_err"]}
    return checks, wrong
