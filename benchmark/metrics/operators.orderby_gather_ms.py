"""Device time of the ORDER BY's output gathers, in ms per traced call: the
busy time of work launched inside the port's `srs.sort_multi.gather` spans
(each key column and each payload gathered by the sorted permutation)."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.sort_multi.gather", "orderby")
