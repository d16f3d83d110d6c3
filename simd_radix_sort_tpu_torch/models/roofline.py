"""Performance models: device-memory roofline for sort and streaming passes.

Counterpart of simd_radix_sort_tpu/models/roofline.py with NVIDIA entries.
The figures are NVIDIA's published peaks at the full power limit; a card
set below it runs slower, so every measured fraction is reported beside
the card's power limit.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    bf16_tflops: float       # dense tensor-core peak
    smem_kb: float           # shared memory one block can use


# NVIDIA data sheets (dense rates, no sparsity).
CHIPS = {
    "h100-sxm": ChipSpec("h100-sxm", 3350.0, 989.0, 227.0),
    "h100-pcie": ChipSpec("h100-pcie", 2000.0, 756.0, 227.0),
}


def chip_for_name(device_name: str) -> ChipSpec:
    """The H100 entry for a CUDA device name: PCIe parts say so in their
    name, anything else is taken as SXM."""
    if "pcie" in device_name.lower():
        return CHIPS["h100-pcie"]
    return CHIPS["h100-sxm"]


def current_chip() -> ChipSpec:
    return chip_for_name(torch.cuda.get_device_name())


def radix_sort_roofline_rows_per_s(row_bytes: int, key_bits: int,
                                   digit_bits: int = 8,
                                   chip: ChipSpec | None = None) -> float:
    """Rows/s upper bound for an LSD radix sort that streams every row
    read+write once per digit pass."""
    chip = chip or current_chip()
    passes = (key_bits + digit_bits - 1) // digit_bits
    bytes_per_row = passes * row_bytes * 2  # read + write per pass
    return chip.hbm_gbps * 1e9 / bytes_per_row


def stream_roofline_rows_per_s(row_bytes: int, num_passes: float = 1.0,
                               chip: ChipSpec | None = None) -> float:
    """Rows/s bound for an operator that streams rows num_passes times
    (one pass = one read and one write of each row)."""
    chip = chip or current_chip()
    return chip.hbm_gbps * 1e9 / (row_bytes * 2 * num_passes)


def bound_ms(bytes_moved: float, chip: ChipSpec | None = None) -> float:
    """Least time the card could take to move `bytes_moved` bytes."""
    chip = chip or current_chip()
    return bytes_moved / (chip.hbm_gbps * 1e9) * 1e3
