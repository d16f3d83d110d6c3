"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80GB (data sheet): 3.35 TB/s of HBM3 bandwidth at the
full 700 W power limit.  Every roofline share is taken against it; the run
prints the card's power limit beside the shares (`device.power_limit_w`).
"""

HBM_BYTES_PER_S = 3.35e12
