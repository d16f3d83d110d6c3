"""The `tpch_sf30_lineitem` configuration: TPC-H (specification v3) at
scale factor 30, the whole `lineitem` table, all 16 columns, resident on
the card, fully sorted by ORDER BY l_shipdate, l_orderkey DESC,
l_linenumber.

A table is `tpch_sf30.make_tables`'s 11 lineitem columns (its two orders
columns are dropped) and the five it does not make, each from its own
generator:
  * l_partkey: `tpch_sf30`'s own draw under its "l_partkey" tag, so it is
    the part that priced l_extendedprice;
  * l_suppkey: 4.2.3's PS_SUPPKEY rule, (partkey + i * (S/4 +
    (partkey - 1)/S)) mod S + 1, with i drawn 0-3 and S = SF x 10,000;
  * l_linenumber: 1..k within each order's run of l_orderkey, which the
    generator writes grouped by order in key order, as dbgen does;
  * l_shipinstruct: an int8 code drawn 0-3 (names in SHIPINSTRUCT's order);
  * l_comment: an int64 reference into a string heap, the offset of the
    row's comment, each comment's length drawn 10-43; the text is not made.
(l_orderkey, l_linenumber) is lineitem's primary key, so the three keys
order the rows totally and the sorted table has one right answer.

A mix keeps several tables resident (parameter "copy"), each made from its
own seed tag.  The one operation, "orderby", calls the port's public
`sort_multi` with the three key columns and the other 13 as payloads.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

import simd_radix_sort_tpu_torch as srs
from benchmark import calls, harness

sf30 = harness.load_file_module("configs", "tpch_sf30")

SPANS = ("orderby",)

# 4.2.3's order of the columns
COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
           "l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
           "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment")
KEYS = ("l_shipdate", "l_orderkey", "l_linenumber")
ASCENDING = (True, False, True)
PAYLOADS = tuple(c for c in COLUMNS if c not in KEYS)
SHIPINSTRUCT = ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN")


@dataclasses.dataclass
class State:
    tables: dict                  # copy -> {column: (n,) tensor}
    n: int
    cache: dict = dataclasses.field(default_factory=dict)


def draw(seed: int, column: str, lo: int, hi: int, n: int, device,
         dtype=torch.int64) -> torch.Tensor:
    """`tpch_sf30`'s draw of a column: n integers in [lo, hi] from the
    column's own generator, seeded from the table's seed and its name."""
    g = torch.Generator(device=device)
    g.manual_seed(calls.derive(seed, "tpch", column))
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=dtype)


def suppkey(part: torch.Tensor, i: torch.Tensor, s: int) -> torch.Tensor:
    """PS_SUPPKEY (4.2.3): the i-th of the part's four suppliers, i in
    0-3, among S = SF x 10,000."""
    return (part + i * (s // 4 + (part - 1) // s)) % s + 1


def make_table(cfg: dict, seed: int, device) -> dict:
    """The 16 columns of one lineitem table, in COLUMNS' order."""
    t = sf30.make_tables(cfg, seed, device)
    del t["o_orderkey"], t["o_orderpriority"]
    n = t["l_orderkey"].numel()
    sf = cfg["scale_factor"]
    t["l_partkey"] = draw(seed, "l_partkey", 1, int(sf * 200_000), n, device)
    t["l_suppkey"] = suppkey(t["l_partkey"],
                             draw(seed, "l_suppkey", 0, 3, n, device),
                             int(sf * 10_000))
    okey = t["l_orderkey"]
    # the first row of each order's run, l_orderkey being ascending
    first = torch.searchsorted(okey, okey)
    t["l_linenumber"] = (torch.arange(n, device=device) - first + 1).to(
        torch.int32)
    del first
    t["l_shipinstruct"] = draw(seed, "l_shipinstruct", 0,
                               len(SHIPINSTRUCT) - 1, n, device, torch.int8)
    length = draw(seed, "l_comment", 10, 43, n, device)
    t["l_comment"] = torch.cumsum(length, 0) - length
    return {c: t[c] for c in COLUMNS}


def setup(cfg: dict, mix: dict, seed: int, ctx) -> State:
    copies = sorted({p.get("copy", 0) for t in mix["calls"]
                     for p in calls.grid(t.get("params", {}))})
    tables = {}
    for c in copies:  # one table at a time: little beside them
        tables[c] = make_table(cfg, calls.derive(seed, "lineitem", c),
                               ctx.device)
    return State(tables, int(cfg["lineitems"]))


def _facts(state: State, table: dict) -> dict:
    n = state.n
    return {"rows": n, "orderby": [{"n": n, "row_bytes": sum(
        table[c].element_size() for c in COLUMNS)}]}


def orderby(state: State, params: dict, ctx):
    t = state.tables[params.get("copy", 0)]
    with ctx.span("orderby"):
        out = srs.sort_multi(tuple(t[k] for k in KEYS),
                             *(t[c] for c in PAYLOADS), ascending=ASCENDING,
                             device=ctx.device)
    return out, _facts(state, t)


OPS = {"orderby": orderby}


def orderby_control(state: State, params: dict, ctx):
    """The control: the rows ordered by (l_shipdate, l_orderkey DESC)
    alone, the lines of one order shipped on one day in a seeded random
    order (an unstable sort without the tie-break), every column carried;
    plain torch, which the comparison has to find not correct.  Run it in
    the program's place with `harness.run_cell(..., ops=CONTROL)`."""
    t = state.tables[params.get("copy", 0)]
    g = torch.Generator(device=ctx.device)
    g.manual_seed(calls.derive(params.get("copy", 0), "control"))
    perm = torch.randperm(state.n, generator=g, device=ctx.device)
    for name, up in (("l_orderkey", False), ("l_shipdate", True)):
        c = t[name].index_select(0, perm).to(torch.int64)
        perm = perm.index_select(0, torch.argsort(c if up else -c,
                                                  stable=True))
    out = (tuple(t[k].index_select(0, perm) for k in KEYS),
           tuple(t[c].index_select(0, perm) for c in PAYLOADS))
    return out, _facts(state, t)


CONTROL = {"orderby": orderby_control}


def capture(state: State, call, out):
    """The 16 sorted columns on the host, by name."""
    keys, pays = out
    return {name: col.cpu().numpy()
            for name, col in zip(KEYS + PAYLOADS, keys + pays)}


def _host_dtype(col: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=col.dtype).numpy().dtype


def _well_formed(got, table: dict, n: int) -> bool:
    return (isinstance(got, dict) and set(got) == set(COLUMNS)
            and all(isinstance(got[c], np.ndarray) and got[c].shape == (n,)
                    and got[c].dtype == _host_dtype(table[c])
                    for c in COLUMNS))


def _differs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Where two arrays of one dtype differ bit for bit."""
    u = np.dtype(f"u{want.dtype.itemsize}")
    return got.view(u) != want.view(u)


def _table_order(state: State, copy: int, ref) -> np.ndarray:
    """The reference's order of one resident table, from its key columns
    on the host; cached by table."""
    key = ("order", copy)
    if key not in state.cache:
        t = state.tables[copy]
        state.cache[key] = ref.order([t[k].cpu().numpy() for k in KEYS],
                                     ASCENDING)
    return state.cache[key]


def compare(state: State, kept, ref, ctx, cfg: dict):
    """Every kept answer against the reference's sort of the same table:
    the positions where any key column differs from the reference's
    (`keys_differing`), and the rows where any of the 16 fields differs
    bitwise (`rows_differing`); every row where an answer is not 16
    columns of the table's length and dtypes.  The reference's sorted
    table is worked out a column at a time, columns in parallel threads
    (NumPy's sorts and takes release the GIL).  Returns (checks, the
    answers that differ)."""
    n = state.n
    bad_keys, bad_rows, wrong = 0, 0, 0
    by_copy = {}
    for rec in kept:
        got, rec.answer = rec.answer, None
        copy = rec.call.params.get("copy", 0)
        if not _well_formed(got, state.tables[copy], n):
            bad_keys, bad_rows, wrong = bad_keys + n, bad_rows + n, wrong + 1
            continue
        by_copy.setdefault(copy, []).append(got)
    workers = max(1, min(8, os.cpu_count() or 1))
    for copy, answers in by_copy.items():
        perm = _table_order(state, copy, ref)
        t = state.tables[copy]

        def differs(name):
            want = ref.column(t[name].cpu().numpy(), perm)
            return [_differs(a[name], want) for a in answers]

        key_bad = [np.zeros(n, dtype=bool) for _ in answers]
        row_bad = [np.zeros(n, dtype=bool) for _ in answers]
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            for name, found in zip(COLUMNS, pool.map(differs, COLUMNS)):
                for i, d in enumerate(found):
                    row_bad[i] |= d
                    if name in KEYS:
                        key_bad[i] |= d
        for kb, rb in zip(key_bad, row_bad):
            r = int(np.count_nonzero(rb))
            bad_keys += int(np.count_nonzero(kb))
            bad_rows, wrong = bad_rows + r, wrong + bool(r)
    limits = cfg["limits"]
    checks = {"keys_differing": {"value": bad_keys,
                                 "limit": limits["keys_differing"]},
              "rows_differing": {"value": bad_rows,
                                 "limit": limits["rows_differing"]}}
    return checks, wrong
