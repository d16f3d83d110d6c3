"""The combined-layout sorts' copies against the card's memory roofline, in
%: the bytes the layout needs (work/packed.py: every row read once and
written once) at the published 3.35 TB/s, over the device's busy time
inside the port's `srs.packed.keys` and `srs.packed.rows` spans."""

from benchmark import peaks
from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    need = sum(run.work("packed").bytes_needed(f)
               for r in run.traced for f in r.facts.get("packed", ()))
    parts = [ps.busy_s(tr, name)
             for name in ("srs.packed.keys", "srs.packed.rows")]
    if need == 0 or None in parts or sum(parts) <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / sum(parts)
