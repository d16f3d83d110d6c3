"""Host syncs per traced sort call, as the port counts them at each site
where the host waits for a value of the card (`host_syncs.*`: in a sort,
`count`'s min/max read of a 2- or 4-byte call)."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_call(run, "sort", ps.counted("host_syncs."))
