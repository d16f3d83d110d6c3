"""Bytes the compactions read and write, in GB (10^9) per traced query, as
the port counts them (`compaction.*`): K5's launches, the widening of 1-
and 2-byte streams to words and back, and the fill of the rows past the
count, each by the rule its counting function states."""

from benchmark import program_spans as ps


def read(run):
    b = ps.counted("compaction.")
    return ps.per_call(run, "query", None if b is None else b / 1e9)
