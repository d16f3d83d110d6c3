"""Tracing, timing and roofline reports.

Counterpart of simd_radix_sort_tpu/utils/profiling.py.  The C++ reference's
only instrumentation is CLOCK_PROCESS_CPUTIME_ID around the sort call
(perf.hpp:33-47); here `trace` records a
`torch.profiler` trace (host and, on a card, CUDA kernels) and `measure`
reports a call's throughput against the H100 roofline.  A time taken on the
CPU is reported as the CPU's: its roofline fields stay None.

The port traces itself at the boundaries of its layers: `span(name)` marks
a part of a call and `count(name, k)` adds to a counter, each only while a
torch profiler is recording (`trace` here, or any `torch.profiler.profile`
of the caller's).  A span is then a record function of the profiler, an op
of its host timeline on the clock of the device's events; otherwise it is
a shared null context and a counter is left alone, so that tracing off
costs one check of the profiler's state.  Every name is listed in SPANS or
COUNTER_NAMES.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time

import torch

from ..models import roofline
from . import common

TRACE_FILE = "trace.json"  # what `trace` writes into its log_dir

# The port's spans.  Each name starts with "srs." (never "cu", which a
# trace reader takes for a CUDA runtime call), so that none is a name the
# benchmark gives its own spans.
SPANS = (
    "srs.sort",                    # ops/sort.sort and sort_packed, whole
    "srs.sort.stage",              # the inputs moved to the device
    "srs.sort.resolve",            # methods.resolve: the engine picked
    # the engine's run, named by the method resolved
    "srs.engine.xla", "srs.engine.radix", "srs.engine.rank",
    "srs.engine.count", "srs.engine.quick", "srs.engine.quickseq",
    "srs.engine.torch", "srs.engine.seq", "srs.engine.cpp",
    "srs.transform",               # utils/transforms to_ and from_sortable
    "srs.count.u8",                # counting.sort_keys: 1-byte keys
    "srs.count.tiny",              # 2-, 4-byte keys: the tiny-range sort
    "srs.count.range",             # its min and max read by the host
    "srs.count.k1024",             # range < K_MAX_RANGE: K1 and K4
    "srs.count.fallback",          # wider: the comparison sort
    "srs.xla.sort",                # xla_sort.sort_arrays: torch.sort
    "srs.xla.gather",              # its payload gathers
    "srs.xla.pairs",               # its one-payload calls: cub's pair sort
    "srs.xla.bits",                # their K8 launches and the window's read
    "srs.compact",                 # ops/filter.compact, whole
    "srs.k5",                      # cuda_partition.partition_pass
    "srs.widen",                   # cuda_partition.to_words, from_words
    "srs.fill",                    # compact(fill=...): the mask and _fill
    "srs.hashagg",                 # ops/hashagg.group_aggregate, whole
    "srs.hashagg.sort",            # its sort by key
    "srs.hashagg.scan",            # its segmented scans
    "srs.hashagg.compact",         # its compaction at the group ends
    "srs.join",                    # ops/hashjoin.lookup_join, whole
    "srs.join.build",              # hashjoin.build_index
    "srs.join.probe",              # lookup_join's searches and gathers
    "srs.join.semi",               # hashjoin.semi_join, whole
    "srs.sort_multi",              # ops/sort.sort_multi, whole
)
# The port's counters, in COUNTERS.  host_syncs.*: each time the host
# waits for a value of the device at that site; compaction.*: bytes read
# and written, by the rule in the docstring of the function that counts
# (K5 and the widening count on every path, the radix engine's too);
# hashagg.scan.*: K7's launches on the card and their bytes;
# xla.pairs_*: the xla engine's calls that take cub's pair sort, the 8-bit
# passes cub is given and the sorts given fewer than their key's width.
COUNTER_NAMES = (
    "host_syncs.count.range",      # counting.sort_keys's min/max read
    "host_syncs.filter.fill",      # each scalar _fill sends to the device
    "host_syncs.xla.bits",         # cuda_sort.bit_window's read of K8's word
    "compaction.k5_bytes",         # cuda_partition.partition_pass
    "compaction.widen_bytes",      # cuda_partition.to_words, from_words
    "compaction.fill_bytes",       # filter.compact(fill=...)
    "hashagg.scan.k7_launches",    # cuda_scan.segmented_scans on the card
    "hashagg.scan.k7_bytes",       # the same launches' k7_bytes
    "xla.pairs_calls",             # xla_sort.sort_arrays with one payload
    "xla.pairs_passes",            # cub's passes over their bit windows
    "xla.pairs_narrowed",          # those given fewer than the key's width
)
COUNTERS: collections.Counter = collections.Counter()

recording = torch.autograd._profiler_enabled  # a profiler is recording
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one part of a call: a record function of
    the profiler named `name` while a profiler records, else a shared null
    context.  It is the profiler's fast record function, which torch's own
    generated code uses: an op of that name on the host timeline, as
    `torch.profiler.record_function` records, and nothing on the device's,
    at a tenth of its cost while recording (1.3 against 10-11 us a span on
    an H100 machine's host), so that the spans of a short call do not fill
    the device idle they are read against."""
    if recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def count(name: str, k: int = 1) -> None:
    """Add k to COUNTERS[name] while a profiler records."""
    if recording():
        COUNTERS[name] += k


def reset_counters() -> None:
    COUNTERS.clear()


def elapsed_seconds(device: torch.device, loop) -> float:
    """Seconds `loop()` takes: between two CUDA events recorded on the
    current stream of a CUDA `device` (after a synchronize, and
    synchronized after), so queued work is charged in full; on the host
    clock for the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        loop()
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def device_name(device: torch.device) -> str:
    """The card's name as CUDA reports it, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Record a torch.profiler trace of the enclosed block (host activity,
    and CUDA kernels and copies when `device` is a card; None means
    "cuda") and export it as a Chrome trace, log_dir/trace.json (view with
    chrome://tracing or Perfetto).  The trace carries the port's `srs.*`
    spans (SPANS) around the parts of each call, and COUNTERS counts while
    it records, and only then.  Yields the profiler.  Usage:

        with profiling.trace("build/trace"):
            out = srs.sort(keys, pay)
    """
    dev = common.resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"[srs] profiler trace written to {path}")


@dataclasses.dataclass
class Report:
    name: str
    rows: int
    seconds: float
    rows_per_s: float
    ns_per_row: float
    roofline_rows_per_s: float | None  # None: not measured on a card
    roofline_frac: float | None
    device: str

    def line(self) -> str:
        head = (f"{self.name} on {self.device}: "
                f"{self.rows_per_s/1e6:.1f} Mrows/s "
                f"({self.ns_per_row:.3f} ns/row), ")
        if self.roofline_rows_per_s is None:
            return head + "roofline not measured (cpu)"
        return head + (f"{100*self.roofline_frac:.1f}% of HBM roofline "
                       f"({self.roofline_rows_per_s/1e6:.0f} Mrows/s)")


def measure(fn, *args, name: str = "workload", rows: int | None = None,
            row_bytes: int = 16, key_bits: int = 64, reps: int = 3,
            device=None) -> Report:
    """Time `fn(*args)` (tensors out, on `device`; None means "cuda") and
    normalize against the roofline of the card it ran on: one warm-up call,
    then `reps` calls between CUDA events (host clock on the CPU)."""
    dev = common.resolve_device(device)
    out = fn(*args)
    first = out[0] if isinstance(out, (tuple, list)) else out

    def loop():
        for _ in range(reps):
            fn(*args)

    dt = elapsed_seconds(dev, loop) / reps
    n = rows if rows is not None else int(first.shape[0])
    rps = n / dt if dt else float("inf")
    roof = frac = None
    if dev.type == "cuda":
        chip = roofline.chip_for_name(device_name(dev))
        roof = roofline.radix_sort_roofline_rows_per_s(row_bytes, key_bits,
                                                       chip=chip)
        frac = rps / roof
    return Report(name, n, dt, rps, dt / max(n, 1) * 1e9, roof, frac,
                  device_name(dev))
