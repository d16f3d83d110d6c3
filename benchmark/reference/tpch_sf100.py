"""Plain reference of the `tpch_sf100` configuration: plain torch, exact.

It imports nothing of the port and uses no sort of it.  It reads the
benchmark's own tables and computes Q18 straightforwardly, by other means
than the program: the units of each order as a direct-address table over
the order keys (integer `index_add_` in blocks), the HAVING and both joins
by direct address, and the ORDER BY and LIMIT in Python over the few
hundred orders that qualify.  Every quantity is a whole number, so every
sum is exact; prices and dates are the tables' own values.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25  # rows of lineitem a block


def units_by_key(t: dict) -> torch.Tensor:
    """Direct-address table: the units (sum of l_quantity) of each order
    key, 0 where no line has the key."""
    keys, qty = t["l_orderkey"], t["l_quantity"]
    table = torch.zeros(int(keys.max()) + 1, dtype=torch.int32,
                        device=keys.device)
    for s in range(0, keys.numel(), BLOCK):
        b = slice(s, s + BLOCK)
        table.index_add_(0, keys[b], torch.round(qty[b]).to(torch.int32))
    return table


def name_by_key(t: dict) -> torch.Tensor:
    """Direct-address table: the c_name code of each customer key (the
    key itself), -1 where no customer has the key."""
    keys = t["c_custkey"]
    table = torch.full((int(keys.max()) + 1,), -1, dtype=torch.int64,
                       device=keys.device)
    table[keys] = keys
    return table


def _at(table: torch.Tensor, keys: torch.Tensor, missing):
    """table[keys], `missing` where a key lies outside the table."""
    inside = (keys >= 0) & (keys < table.numel())
    return torch.where(inside, table[keys.clamp(0, table.numel() - 1)],
                       missing)


def q18(t: dict, quantity: int, cache: dict) -> list:
    """Every row of Q18's answer before its LIMIT, in its order: (c_name
    code, c_custkey, o_orderkey, o_orderdate, o_totalprice, units) of each
    order whose lines hold more than `quantity` units, by o_totalprice
    descending, then o_orderdate, then o_orderkey."""
    if "units_by_key" not in cache:
        cache["units_by_key"] = units_by_key(t)
        cache["name_by_key"] = name_by_key(t)
    units, names = cache["units_by_key"], cache["name_by_key"]
    okey = t["o_orderkey"]
    o_units = _at(units, okey, 0)
    pick = torch.nonzero(o_units > quantity).squeeze(1)
    name = _at(names, t["o_custkey"][pick], -1)
    cols = [name, t["o_custkey"][pick], okey[pick], t["o_orderdate"][pick],
            t["o_totalprice"][pick], o_units[pick]]
    rows = [r for r in zip(*(c.cpu().tolist() for c in cols)) if r[0] >= 0]
    rows.sort(key=lambda r: (-r[4], r[3], r[2]))
    return rows
