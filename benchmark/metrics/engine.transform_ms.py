"""Device time of the carrier transforms, in ms per traced sort call: the
busy time of work launched inside the port's `srs.transform` spans
(`to_sortable` and `from_sortable`, in and out of every engine)."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.transform", "sort")
