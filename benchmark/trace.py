"""Reading a profiled stretch of a run: device activity, the benchmark's
spans, busy time, idle gaps.

`torch.profiler` gives host events (the port's torch operations, the CUDA
runtime calls that launch work, and the benchmark's own spans, each a
`record_function`) and device events (kernels, copies, memsets) on one
clock.  A device event belongs to a span when the host call that launched
it (the runtime call with the same correlation id, else the operation it
is linked to) started inside that span.  Times are microseconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"  # the span around the profiled stretch
CALL = "bench.call"      # the span around one call


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str          # "device", "runtime" or "op" (an op or a span)
    start: float
    end: float
    id: int = 0        # correlation id
    linked: int = 0    # the correlation id of the op a device event is linked to


def from_profiler(prof, span_names) -> "Trace":
    """The Trace of a finished `torch.profiler.profile`."""
    import torch

    spans = set(span_names) | {WINDOW, CALL}
    events = []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ev.name in spans:
                continue  # a span drawn on the device's timeline
            events.append(Event(ev.name, "device", start, end, ev.id,
                                getattr(ev, "linked_correlation_id", 0)))
        elif ev.name.startswith("cu"):
            events.append(Event(ev.name, "runtime", start, end, ev.id))
        else:
            events.append(Event(ev.name, "op", start, end, ev.id))
    return Trace(events, spans)


class Trace:
    def __init__(self, events, span_names):
        self.span_names = set(span_names) | {WINDOW, CALL}
        runtime = {e.id: e.start for e in events if e.kind == "runtime"}
        ops = [e for e in events if e.kind == "op"]
        op_start = {e.id: e.start for e in ops}
        self.ops = sorted(ops, key=lambda e: e.start)
        self._op_starts = [e.start for e in self.ops]
        self.spans = collections.defaultdict(list)
        for e in self.ops:
            if e.name in self.span_names:
                self.spans[e.name].append((e.start, e.end))
        for ivs in self.spans.values():
            ivs.sort()
        windows = self.spans.get(WINDOW)
        if not windows:
            raise ValueError("the trace holds no window span")
        self.window = (windows[0][0], windows[-1][1])
        # (start, end, name, host time of the launch or None)
        self.device = sorted(
            (e.start, e.end, e.name,
             runtime.get(e.id, op_start.get(e.linked)))
            for e in events if e.kind == "device")

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _inside(self, span: str, t) -> bool:
        """Whether host time t lies in a span of that name (the spans of
        one name are disjoint: each is one call's)."""
        if t is None:
            return False
        ivs = self.spans.get(span, [])
        i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
        return i >= 0 and ivs[i][1] >= t

    def _merged(self, span=None):
        lo, hi = self.window
        ivs = []
        for s, e, _, host in self.device:
            if span is not None and not self._inside(span, host):
                continue
            if span is None:
                s, e = max(s, lo), min(e, hi)
            if e > s:
                ivs.append((s, e))
        merged = []
        for s, e in sorted(ivs):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self, span: str | None = None) -> float:
        """Seconds in which the device ran anything: over the window, or
        launched from inside the spans of one name."""
        return sum(e - s for s, e in self._merged(span)) / 1e6

    def device_ops(self, k: int = 10):
        """The k device operations that took most time in the window, as
        [name, seconds]."""
        lo, hi = self.window
        per = collections.Counter()
        for s, e, name, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                per[name] += (e - s) / 1e6
        return [[n[:200], v] for n, v in per.most_common(k)]

    def _label(self, t: float) -> str:
        """What the host was doing at time t: the innermost of the
        benchmark's spans and the innermost op, each containing t."""
        span, latest = None, None
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if name != WINDOW and i >= 0 and ivs[i][1] >= t and (
                    latest is None or ivs[i][0] > latest):
                span, latest = name, ivs[i][0]
        op = None
        i = bisect.bisect_right(self._op_starts, t) - 1
        for j in range(i, max(i - 200, -1), -1):
            e = self.ops[j]
            if e.end >= t and e.name not in self.span_names:
                op = e.name
                break
        where = "harness" if span is None else span
        return where if op is None else f"{where}: {op}"

    def longest_gaps(self, k: int = 5):
        """The k longest single idle gaps, as [label, start offset in the
        window, seconds]."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self._merged() for x in iv] + [hi]
        gaps = sorted(((e - s, s) for s, e in zip(edges[::2], edges[1::2])
                       if e > s), reverse=True)[:k]
        return [[self._label(s + d / 2), (s - lo) / 1e6, d / 1e6]
                for d, s in gaps]

    def idle_gaps(self, k: int = 10):
        """Idle time of the device in the window by what the host was doing
        (the k largest totals), as [label, seconds]."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self._merged() for x in iv] + [hi]
        per = collections.Counter()
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                per[self._label((s + e) / 2)[:200]] += (e - s) / 1e6
        return [[n, v] for n, v in per.most_common(k)]
