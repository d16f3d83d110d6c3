"""Bytes `sort_packed`'s own copies read and write, in GB (10^9) per
traced sort call, as the port counts them (`packed.*`: the key column, the
row index, the row gather and the assembly, by the rule of
`ops/sort.packed_copy_bytes`)."""

from benchmark import program_spans as ps


def read(run):
    b = ps.counted("packed.")
    return ps.per_call(run, "sort", b / 1e9 if b else None)
