"""The `tpch_sf100` configuration: TPC-H (specification v3) at scale factor
100, the seven columns Q18 reads, resident on the card.

The tables are made on the card from the seed by the column rules of the
specification's section 4.2.3, with `tpch_sf30`'s conventions: the order
keys are 8 of every 32, an order has 1-7 lines nudged to dbgen's lineitem
count, lineitem stays grouped by its order key as dbgen writes it,
decimals are float64, dates int32 day numbers, keys int64, and each column
draws from its own generator.  `o_totalprice` is made as dbgen's
`mk_order` adds it, line by line in whole cents, from extended prices,
discounts and taxes that are drawn for it and dropped.  `c_name` is
"Customer#" and the key, so the join into `customer` reads the key itself
as the name's code.

The one operation, `q18`, is the query's plan over the port's public
operators: `group_aggregate` of the lineitems by order key (the HAVING
subquery), `filter_rows` for the HAVING, `semi_join` of the orders against
the keys it keeps, two `lookup_join`s (the sums; the customer), and
`sort_multi` for the ORDER BY, then the first 100 rows.
"""

from __future__ import annotations

import dataclasses

import torch

import simd_radix_sort_tpu_torch as srs
from benchmark import calls, harness
from simd_radix_sort_tpu_torch.ops import filter as filt
from simd_radix_sort_tpu_torch.ops import hashagg, hashjoin

SPANS = ("query", "group_aggregate", "filter_rows", "semi_join",
         "lookup_join", "order_by")
LIMIT = 100

_sf30 = harness.load_file_module("configs", "tpch_sf30")
STARTDATE, ENDDATE = _sf30.STARTDATE, _sf30.ENDDATE


@dataclasses.dataclass
class State:
    t: dict
    n: int
    cache: dict = dataclasses.field(default_factory=dict)


def make_tables(cfg: dict, seed: int, device, lines: bool = False) -> dict:
    """The seven resident columns; with `lines`, also the lines' extended
    price, discount and tax (float64, as `tpch_sf30` holds them), which
    `o_totalprice` is made from."""
    n_o, n_l = int(cfg["orders"]), int(cfg["lineitems"])
    n_c = int(cfg["customers"])
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
    # dbgen: a multiple of 3 steps up one key, or down one from the top
    cust = draw("o_custkey", 1, n_c, n_o)
    cust += cust % 3 == 0
    t["o_custkey"] = torch.where(cust > n_c, n_c - 1, cust)
    del cust
    t["o_orderdate"] = draw("o_orderdate", STARTDATE, ENDDATE - 151, n_o,
                            torch.int32)
    # 1-7 lines an order, nudged to the scale factor's lineitem count
    per = draw("o_lines", 1, 7, n_o)
    diff = n_l - int(per.sum())
    room = torch.nonzero(per < 7 if diff > 0 else per > 1).squeeze(1)
    if room.numel() < abs(diff):
        raise ValueError("cannot reach the lineitem count")
    per[room[:abs(diff)]] += 1 if diff > 0 else -1
    del room
    t["l_orderkey"] = torch.repeat_interleave(t["o_orderkey"], per,
                                              output_size=n_l)
    qty = draw("l_quantity", 1, 50, n_l)
    t["l_quantity"] = qty.double()
    # P_RETAILPRICE (4.2.3) in cents, then L_EXTENDEDPRICE = qty x price
    part = draw("l_partkey", 1, int(sf * 200_000), n_l)
    cents = part.div(10, rounding_mode="floor").remainder_(20_001)
    cents += 90_000
    cents += part.remainder_(1000).mul_(100)
    del part
    cents *= qty
    del qty
    if lines:
        t["l_extendedprice"] = cents.double() / 100
    # dbgen's mk_order: totalprice += eprice * (100 - disc) / 100
    # * (100 + tax) / 100, in whole cents, each division truncated
    for column, hi, sign in (("l_discount", 10, -1), ("l_tax", 8, 1)):
        d = draw(column, 0, hi, n_l)
        if lines:
            t[column] = d.double() / 100
        cents *= d.mul_(sign).add_(100)
        del d
        cents.div_(100, rounding_mode="floor")
    cents.cumsum_(0)
    tot = cents[per.cumsum_(0).sub_(1)]
    del cents, per
    t["o_totalprice"] = torch.diff(tot, prepend=tot.new_zeros(1)).double() \
        / 100
    del tot
    t["c_custkey"] = torch.arange(1, n_c + 1, device=device)
    return t


def setup(cfg: dict, mix: dict, seed: int, ctx) -> State:
    t = make_tables(cfg, seed, ctx.device)
    return State(t, t["l_orderkey"].numel())


def q18(state: State, p: dict, ctx):
    """Large volume customer: the orders whose lines hold more than
    QUANTITY units, with their customer, date, price and units, the 100
    largest by price (then oldest, then by key)."""
    t = state.t
    with ctx.span("query"):
        with ctx.span("group_aggregate"):
            ng, okey, ((units,),) = hashagg.group_aggregate(
                t["l_orderkey"], t["l_quantity"], aggs=("sum",))
        g = int(ng)
        big = units[:g] > p["quantity"]
        with ctx.span("filter_rows"):
            cnt, keys, sums = filt.filter_rows(big, okey[:g], units[:g])
        b = int(cnt)
        keys, sums = keys[:b], sums[:b]
        with ctx.span("semi_join"):
            cnt, *cols = hashjoin.semi_join(
                t["o_orderkey"], (t["o_custkey"], t["o_orderdate"],
                                  t["o_totalprice"]), keys)
        m = int(cnt)
        o_key, o_cust, o_date, o_price = (c[:m] for c in cols)
        with ctx.span("lookup_join"):
            _, _, (o_units,) = hashjoin.lookup_join(o_key, keys, (sums,))
            found, _, (name,) = hashjoin.lookup_join(
                o_cust, t["c_custkey"], (t["c_custkey"],))
        with ctx.span("filter_rows"):  # the inner join drops no customer
            cnt, *rows = filt.filter_rows(found, o_price, o_date, o_key,
                                          name, o_cust, o_units)
        k = int(cnt)
        with ctx.span("order_by"):
            (price, date, key), (name, cust, units) = srs.sort_multi(
                [r[:k] for r in rows[:3]], *(r[:k] for r in rows[3:]),
                ascending=(False, True, True), device=ctx.device)
        out = tuple(c[:LIMIT] for c in (name, cust, key, date, price, units))
    n = state.n
    return out, {
        "rows": n,
        "query": [{"op": "q18", "lineitems": n,
                   "orders": t["o_orderkey"].numel(),
                   "customers": t["c_custkey"].numel(),
                   "answer": min(k, LIMIT)}],
        "filter_rows": [{"n": g, "selected": b, "stream_bytes": [8, 8]},
                        {"n": m, "selected": k,
                         "stream_bytes": [8, 4, 8, 8, 8, 8]}]}


OPS = {"q18": q18}


def capture(state: State, call, out):
    """The answer on the host: rows (c_name code, c_custkey, o_orderkey,
    o_orderdate, o_totalprice, sum(l_quantity)) in the answer's order."""
    return [tuple(row) for row in zip(*(c.cpu().tolist() for c in out))]


def _expected(state: State, call, ref):
    """The reference's answer, cached by QUANTITY."""
    k = call.key()
    if k not in state.cache:
        state.cache[k] = ref.q18(state.t, call.params["quantity"],
                                 state.cache)[:LIMIT]
    return state.cache[k]


def compare(state: State, kept, ref, ctx, cfg: dict):
    """Every kept answer against the reference's: each field of each row
    in the order given must equal it (float64 fields bit for bit), and a
    row missing or extra counts all of its fields.  Returns (checks, the
    answers that differ)."""
    bad_total, wrong = 0, 0
    for rec in kept:
        want, got = _expected(state, rec.call, ref), rec.answer
        bad = 6 * abs(len(got) - len(want))
        for g_row, w_row in zip(got, want):
            bad += sum(g != w for g, w in zip(g_row, w_row))
        bad_total += bad
        wrong += bool(bad)
    return {"exact_mismatches": {"value": bad_total,
                                 "limit": cfg["limits"]["exact_mismatches"]}
            }, wrong
