"""Bytes TPC-H Q12 needs: its predicate columns (l_shipmode 1 byte,
l_commitdate, l_receiptdate, l_shipdate 4 each) over every row;
l_orderkey (8) over the rows it selects; the build side of the join,
o_orderkey (8) and o_orderpriority (1), read once; its answer once (at most
7 modes of a key and two counts)."""


def bytes_needed(f: dict) -> int:
    return (1 + 4 + 4 + 4) * f["n"] + 8 * f["selected"] + 9 * f["orders"] \
        + 7 * 3 * 8
