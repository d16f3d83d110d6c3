"""The compactions' host side, in microseconds per traced query: the
device's idle time while the host is inside the port's `srs.compact`
spans (the fill's scalar copy, the allocations, the launches' host steps).
None for a program whose `srs.compact` leaves the cut and pad out (one
without the device counter `compact.needed_bytes`, which came with the
span's whole extent)."""

from benchmark import program_spans as ps


def read(run):
    from simd_radix_sort_tpu_torch.utils import profiling

    if run.trace is None or "compact.needed_bytes" not in getattr(
            profiling, "DEVICE_COUNTER_NAMES", ()):
        return None
    idle = ps.idle_s(run.trace, "srs.compact")
    return ps.per_call(run, "query", None if idle is None else idle * 1e6)
