"""Bytes TPC-H Q18 needs: l_orderkey and l_quantity (8 bytes each) over
every lineitem, once; o_orderkey, o_custkey, o_totalprice (8 each) and
o_orderdate (4) over every order, once; c_custkey (8) over every customer,
once; its answer once (at most 100 rows of five 8-byte fields and a
4-byte date)."""


def bytes_needed(f: dict) -> int:
    return 16 * f["lineitems"] + 28 * f["orders"] + 8 * f["customers"] \
        + 44 * f["answer"]
