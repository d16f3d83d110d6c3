"""The share of the compactions' bytes that their callers need, in %: the
port's device counter `compact.needed_bytes` (each compaction's mask read
once, and its kept rows read once and written once in every stream at the
stream's own width, capped at `max_out` where bounded: the rule of
work/filter_rows.py, for every compaction) over the bytes the port counts
them moving (`compaction.*`: K5, the widening and the fill, what
`operators.compaction_gb` reads), both over the traced stretch.  None for
a program without the device counter."""

from benchmark import program_spans as ps


def read(run):
    from simd_radix_sort_tpu_torch.utils import profiling

    needed = getattr(profiling, "device_counted", None)
    if needed is None or ps.per_call(run, "query", 1.0) is None:
        return None
    need, moved = needed("compact.needed_bytes"), ps.counted("compaction.")
    if not need or not moved:
        return None
    return 100.0 * need / moved
