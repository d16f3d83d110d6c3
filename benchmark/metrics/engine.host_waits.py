"""Host waits per sort call: the times a call made the host wait for the
card (torch's sync debug mode around each call after the profiled
stretch of a traced run)."""


def read(run):
    w = [r.waits for r in run.done if "sort" in r.facts and r.waits is not None]
    return sum(w) / len(w) if w else None
