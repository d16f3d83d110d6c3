"""Device time of group_aggregate's compaction at the group ends, in ms per
traced query: the busy time of work launched inside the port's
`srs.hashagg.compact` spans (one K5 over the group keys and every per-row
scan, with its widening and fill), apart from the aggregate's sort and
scan.  Queries that aggregate nothing count with 0."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.hashagg.compact", "query")
