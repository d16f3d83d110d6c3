"""Host syncs per traced query, as the port counts them at each site
where the host waits for a value of the card (`host_syncs.*`: each flag
read of the aggregate's doubling scan, each scalar `_fill` sends).  The
benchmark's own reads are not among them (`operators.host_waits` counts
those too)."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_call(run, "query", ps.counted("host_syncs."))
