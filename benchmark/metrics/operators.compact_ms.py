"""Device time of every compaction, in ms per traced query: the busy time
of work launched inside the port's `srs.compact` spans (K5's launches, the
widening, the fill, and `compact_bounded`'s cut and pad), whichever
operator called it: the filters, the aggregate's group ends, Q18's HAVING
and the semi-join.  None for a program whose `srs.compact` leaves the cut
and pad out (one without the device counter `compact.needed_bytes`, which
came with the span's whole extent)."""

from benchmark import program_spans as ps


def read(run):
    from simd_radix_sort_tpu_torch.utils import profiling

    if "compact.needed_bytes" not in getattr(
            profiling, "DEVICE_COUNTER_NAMES", ()):
        return None
    return ps.busy_ms_per_call(run, "srs.compact", "query")
