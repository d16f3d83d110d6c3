"""Device time of the payload gathers, in ms per traced sort call: the
busy time of work launched inside the port's `srs.xla.gather` spans (the
`index_select` of each payload by the sort's permutation)."""

from benchmark import program_spans as ps


def read(run):
    return ps.busy_ms_per_call(run, "srs.xla.gather", "sort")
