"""Plain reference of the `tpch_sf30` configuration: plain torch, exact.

It imports nothing of the port.  It reads the benchmark's own tables and
recovers every decimal column as an exact integer (quantity in units,
prices in cents, discount and tax in hundredths: each float64 column holds
such an integer over a power of ten, rounded once), so every aggregate is
an exact integer, summed in blocks of rows small enough that no int64 sum
can wrap and added up in Python integers.  It computes the queries
straightforwardly, by other means than the program: Q1 as masked sums per
group, Q12's join as a direct-address table of the order keys.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25  # rows: 2^25 x the largest charge (1.2e11) stays below 2^63


def _int(col: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.round(col * scale).to(torch.int64)


def _blocks(n: int):
    for s in range(0, n, BLOCK):
        yield slice(s, min(n, s + BLOCK))


def q1(t: dict, cutoff: int) -> dict:
    """{group key: [count, sum qty, sum cents, sum cents x (100 - disc),
    sum cents x (100 - disc) x (100 + tax), sum disc]} over the rows
    shipped on or before `cutoff`; the key is returnflag * 2 + linestatus."""
    acc = {}
    for b in _blocks(t["l_shipdate"].numel()):
        m = t["l_shipdate"][b] <= cutoff
        key = (t["l_returnflag"][b].to(torch.int64) * 2
               + t["l_linestatus"][b].to(torch.int64))
        qty = _int(t["l_quantity"][b], 1)
        cents = _int(t["l_extendedprice"][b], 100)
        disc = _int(t["l_discount"][b], 100)
        tax = _int(t["l_tax"][b], 100)
        dp = cents * (100 - disc)
        ch = dp * (100 + tax)
        for g in range(6):
            mg = (m & (key == g)).to(torch.int64)
            sums = [int(mg.sum())] + [int((x * mg).sum())
                                      for x in (qty, cents, dp, ch, disc)]
            if sums[0]:
                old = acc.setdefault(g, [0] * 6)
                acc[g] = [a + s for a, s in zip(old, sums)]
    return acc


def q6(t: dict, d0: int, d1: int, disc_lo: int, disc_hi: int,
       qty_below: int) -> int:
    """sum(cents x discount hundredths) over shipments in [d0, d1) with
    discount in [disc_lo, disc_hi] hundredths and quantity < qty_below."""
    total = 0
    for b in _blocks(t["l_shipdate"].numel()):
        disc = _int(t["l_discount"][b], 100)
        m = ((t["l_shipdate"][b] >= d0) & (t["l_shipdate"][b] < d1)
             & (disc >= disc_lo) & (disc <= disc_hi)
             & (_int(t["l_quantity"][b], 1) < qty_below))
        total += int((_int(t["l_extendedprice"][b], 100) * disc
                      * m.to(torch.int64)).sum())
    return total


def priority_by_key(t: dict) -> torch.Tensor:
    """Direct-address table: the priority code of each order key, -1 where
    no order has the key."""
    keys = t["o_orderkey"]
    table = torch.full((int(keys.max()) + 1,), -1, dtype=torch.int8,
                       device=keys.device)
    table[keys] = t["o_orderpriority"]
    return table


def q12(t: dict, modes, d0: int, d1: int, cache: dict) -> dict:
    """{mode: (lines of 1-URGENT or 2-HIGH orders, lines of the others)}
    for the lines of `modes` received in [d0, d1), received after their
    commit date and committed after shipping."""
    if "priority_by_key" not in cache:
        cache["priority_by_key"] = priority_by_key(t)
    table = cache["priority_by_key"]
    high = torch.zeros(7, dtype=torch.int64, device=table.device)
    low = torch.zeros_like(high)
    for b in _blocks(t["l_shipdate"].numel()):
        mode = t["l_shipmode"][b].to(torch.int64)
        rec, com = t["l_receiptdate"][b], t["l_commitdate"][b]
        m = ((mode == modes[0]) | (mode == modes[1])) & (com < rec) \
            & (t["l_shipdate"][b] < com) & (rec >= d0) & (rec < d1)
        key = t["l_orderkey"][b][m]
        pr = table[key.clamp(0, table.numel() - 1)]
        pr = torch.where((key >= 0) & (key < table.numel()), pr, -1)
        mo = mode[m]
        high += torch.bincount(mo[(pr >= 0) & (pr <= 1)], minlength=7)
        low += torch.bincount(mo[pr >= 2], minlength=7)
    return {m: (int(high[m]), int(low[m])) for m in range(7)
            if int(high[m]) + int(low[m]) > 0}
