"""Tracing, timing and roofline reports.

Counterpart of simd_radix_sort_tpu/utils/profiling.py.  The C++ reference's
only instrumentation is CLOCK_PROCESS_CPUTIME_ID around the sort call
(perf.hpp:33-47); here `trace` records a
`torch.profiler` trace (host and, on a card, CUDA kernels) and `measure`
reports a call's throughput against the H100 roofline.  A time taken on the
CPU is reported as the CPU's: its roofline fields stay None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from ..models import roofline
from . import common

TRACE_FILE = "trace.json"  # what `trace` writes into its log_dir


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
    chrome://tracing or Perfetto).  Yields the profiler.  Usage:

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
