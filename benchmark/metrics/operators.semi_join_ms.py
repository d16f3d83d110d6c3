"""Device time of the semi-joins, in ms per traced query: the busy time of
work launched inside the port's `srs.join.semi` spans (the build side's
sort, the probe's searches over every probe row, and the K5 compaction of
the probe rows that match)."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.join.semi", "query")
