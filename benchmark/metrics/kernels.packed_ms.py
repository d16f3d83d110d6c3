"""Device time of `sort_packed`'s own copies, in ms per traced sort call:
the busy time of work launched inside the port's `srs.packed.keys` spans
(the key column's copy out of the rows, the row index) plus that inside
its `srs.packed.rows` spans (the row gather by the sorted index, the
output's assembly)."""

from benchmark import program_spans as ps


def read(run):
    parts = [ps.busy_ms_per_call(run, name, "sort")
             for name in ("srs.packed.keys", "srs.packed.rows")]
    if None in parts:
        return None
    return sum(parts)
