"""Device time of the join's build side, in ms per traced query: the busy
time of work launched inside the port's `srs.join.build` spans (the sort
of the build keys with their payloads, and the carrier of the sorted
keys), apart from the probe."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.join.build", "query")
