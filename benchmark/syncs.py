"""Host waits of a call, as torch's sync debug mode reports them.

A frozen copy of `simd_radix_sort_tpu_torch/workloads/common.host_syncs`,
kept here so that the yardstick does not change with the program.
"""

from __future__ import annotations

import warnings

import torch


def host_syncs(fn):
    """(fn(), where it made the host wait for the card: one "file:line" of
    the Python call for each wait).  CUDA only; `torch.cuda.synchronize`
    itself is not reported."""
    # the mode is switched outside the recording, so that what switching
    # it may report is not counted against the call
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
