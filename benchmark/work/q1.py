"""Bytes TPC-H Q1 needs: its predicate column (l_shipdate, 4 bytes) over
every row; returnflag, linestatus (1 byte each), quantity, extendedprice,
discount and tax (8 each) over the rows it selects; its answer once (at
most 6 groups of a key and 8 aggregates)."""


def bytes_needed(f: dict) -> int:
    return 4 * f["n"] + (1 + 1 + 4 * 8) * f["selected"] + 6 * 9 * 8
