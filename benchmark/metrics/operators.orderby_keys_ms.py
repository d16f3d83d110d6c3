"""Device time of the ORDER BY's key passes, in ms per traced call: the
busy time of work launched inside the port's `srs.sort_multi.keys` spans
(for each key column its carrier, its reorder by the permutation so far,
its stable argsort and the permutation's composition)."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.sort_multi.keys", "orderby")
