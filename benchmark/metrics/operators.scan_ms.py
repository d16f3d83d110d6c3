"""Device time of group_aggregate's segmented scans, in ms per traced
query: the busy time of work launched inside the port's `srs.hashagg.scan`
spans (the doubling passes), apart from the aggregate's sort and
compaction.  Queries that aggregate no float stream run no scan and count
with 0."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.hashagg.scan", "query")
