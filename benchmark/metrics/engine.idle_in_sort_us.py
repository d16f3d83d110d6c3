"""Device idle time while the host is inside the port's `srs.sort` span,
in microseconds per traced sort call: the library's own host time that
leaves the card waiting (staging, resolve, the engine's host steps, the
min/max read), apart from the benchmark's call boundary."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    idle = None if tr is None else ps.idle_s(tr, "srs.sort")
    return ps.per_call(run, "sort", None if idle is None else idle * 1e6)
