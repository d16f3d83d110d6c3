"""Bytes TPC-H Q6 needs: its predicate columns (l_shipdate 4 bytes,
l_discount and l_quantity 8 each) over every row; l_extendedprice (8) over
the rows it selects; its answer (one float64) once."""


def bytes_needed(f: dict) -> int:
    return (4 + 8 + 8) * f["n"] + 8 * f["selected"] + 8
