"""Reading the program's own spans and counters out of a traced run.

The port marks the parts of a call with `record_function` spans named
`srs.*` and counts host syncs and bytes in `COUNTERS`, both only while a
profiler records (`simd_radix_sort_tpu_torch/utils/profiling.py`).  In the
trace a program span is an op like any other: this module reads
`trace.ops`, `trace.device` and `trace.window` alone, so that the
benchmark's spans and the metrics built on them read what they read
without it.  Each function returns None where the run holds nothing to
read: no trace, no span or counter of that name (a program without them),
no call of that kind.  Times are seconds, as the trace's are microseconds.
"""

from __future__ import annotations

import bisect


def _merge(ivs):
    merged = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, name: str):
    """The host intervals of the program spans of one name, merged."""
    return _merge((e.start, e.end) for e in trace.ops if e.name == name)


def busy_s(trace, name: str):
    """Seconds in which the device ran work launched from inside the
    program spans of one name."""
    ivs = spans(trace, name)
    if not ivs or not trace.device:
        return None
    starts = [s for s, _ in ivs]

    def inside(t):
        if t is None:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ivs[i][1] >= t

    run = _merge((s, e) for s, e, _, host in trace.device if inside(host))
    return sum(e - s for s, e in run) / 1e6


def idle_s(trace, name: str):
    """Seconds of the profiled window in which the device ran nothing
    while the host was inside the program spans of one name."""
    ivs = spans(trace, name)
    if not ivs or not trace.device:
        return None
    lo, hi = trace.window
    busy = _merge((max(s, lo), min(e, hi)) for s, e, _, _ in trace.device)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [[s, e] for s, e in zip(edges[::2], edges[1::2]) if e > s]
    return _overlap(gaps, ivs) / 1e6


def counted(prefix: str):
    """The sum of the program's counters whose names start with `prefix`
    (they count only while a profiler records: over the traced stretch)."""
    from simd_radix_sort_tpu_torch.utils import profiling

    counters = getattr(profiling, "COUNTERS", None)
    if counters is None:
        return None
    return sum(v for k, v in counters.items() if k.startswith(prefix))


def per_call(run, kind: str, value):
    """`value` over the traced calls of one kind ("sort" or "query"), or
    None."""
    n = sum(kind in r.facts for r in run.traced)
    if run.trace is None or value is None or not n:
        return None
    return value / n


def busy_ms_per_call(run, name: str, kind: str):
    """`busy_s` of the spans of one name in ms per traced call of a kind."""
    busy = None if run.trace is None else busy_s(run.trace, name)
    return per_call(run, kind, None if busy is None else busy * 1e3)
