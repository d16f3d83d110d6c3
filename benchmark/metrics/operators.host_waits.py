"""Host waits per query: the times a query made the host wait for the
card (torch's sync debug mode around each query after the profiled
stretch of a traced run)."""


def read(run):
    w = [r.waits for r in run.done if "query" in r.facts
         and r.waits is not None]
    return sum(w) / len(w) if w else None
