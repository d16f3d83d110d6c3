"""The full-table ORDER BY against the card's memory roofline, in %: the
bytes it needs (work/orderby.py: every row read once and written once) at
the published 3.35 TB/s, over the device's busy time inside the port's
`srs.sort_multi` spans."""

from benchmark import peaks
from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need = sum(run.work("orderby").bytes_needed(f)
               for r in run.traced for f in r.facts.get("orderby", ()))
    busy = ps.busy_s(tr, "srs.sort_multi")
    if need == 0 or busy is None or busy <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / busy
