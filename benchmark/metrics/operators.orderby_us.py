"""Time of the multi-column ORDER BY, in microseconds per traced query:
the device's busy time from work launched inside the port's
`srs.sort_multi` spans, plus the device's idle time while the host is
inside them.  On a few thousand rows its launches are short, so the host
sets its pace, and the idle part says by how much."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy, idle = ps.busy_s(tr, "srs.sort_multi"), ps.idle_s(
        tr, "srs.sort_multi")
    if busy is None or idle is None:
        return None
    return ps.per_call(run, "query", (busy + idle) * 1e6)
