"""Bytes the ORDER BY's output gathers read and write, in GB (10^9) per
traced call, as the port counts them (`sort_multi.gather_bytes`: the sorted
index read once a column, each column read and written once, by the rule
of `ops/sort.multi_gather_bytes`)."""

from benchmark import program_spans as ps


def read(run):
    b = ps.counted("sort_multi.gather_bytes")
    return ps.per_call(run, "orderby", b / 1e9 if b else None)
