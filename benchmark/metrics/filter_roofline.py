"""The `filter_rows` calls' share of the card's memory roofline, in %: the
bytes they need (work/filter_rows.py) at the published 3.35 TB/s, over the
device's busy time inside their `filter_rows` spans (K5's two launches and
the stream widening around them)."""

from benchmark import peaks


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need = sum(run.work("filter_rows").bytes_needed(f)
               for r in run.traced for f in r.facts.get("filter_rows", ()))
    busy = tr.busy_s("filter_rows")
    if need == 0 or busy <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / busy
