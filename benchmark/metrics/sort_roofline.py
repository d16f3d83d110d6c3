"""The sort calls' share of the card's memory roofline, in %: the bytes the
sorts of the profiled stretch need (work/sort.py) at the published 3.35
TB/s, over the device's busy time inside their `sort` spans."""

from benchmark import peaks


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need = sum(run.work("sort").bytes_needed(f)
               for r in run.traced for f in r.facts.get("sort", ()))
    busy = tr.busy_s("sort")
    if need == 0 or busy <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / busy
