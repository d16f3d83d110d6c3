"""The queries' share of the card's memory roofline, in %: the bytes each
query needs (work/<query>.py) at the published 3.35 TB/s, over the
device's busy time inside their `query` spans."""

from benchmark import peaks


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need = sum(run.work(f["op"]).bytes_needed(f)
               for r in run.traced for f in r.facts.get("query", ()))
    busy = tr.busy_s("query")
    if need == 0 or busy <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / busy
