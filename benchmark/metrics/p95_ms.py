"""95th percentile of the latency of every call of the window, each from
CUDA events around the call (from its start to the end of its last work
on the card, host gaps included)."""

import statistics


def read(run):
    lat = [r.latency_ms for r in run.done]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
