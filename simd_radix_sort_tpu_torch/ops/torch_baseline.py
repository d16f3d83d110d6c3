"""External comparison baseline: torch.sort on the host (registry name
"torch").

Counterpart of simd_radix_sort_tpu/ops/torch_baseline.py: an engine the
package does not write, driven through the same method interface so the
harness can produce comparison rows, as the reference suite drives its
third-party sorts (STL, IPP, Bramas, Blacher).  It is a host baseline
(device=False in the registry), like `seq` and `quickseq`: the keys come to
the CPU, torch.sort orders them there, and the results go back.  On the
card the comparison engine is `xla`.

Keys go through the order-preserving transform to an unsigned carrier and
are bit-flipped to the signed dtype of the same width (the sign-bit XOR
keeps the order), which torch.sort orders on the CPU; payloads follow the
returned permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import transforms

_SIGNED = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def sort_np(keys: np.ndarray, *payloads: np.ndarray, ascending: bool = True):
    """Sort with torch.sort on the host, in the reference's key order."""
    keys = np.asarray(keys)
    u = transforms.to_sortable_np(keys, ascending)
    sign = u.dtype.type(1 << (u.dtype.itemsize * 8 - 1))
    vals, idx = torch.sort(torch.from_numpy((u ^ sign).view(
        _SIGNED[u.dtype.itemsize])), stable=False)
    keys_out = transforms.from_sortable_np(
        vals.numpy().view(u.dtype) ^ sign, keys.dtype, ascending)
    perm = idx.numpy()
    return (keys_out, *[np.asarray(p)[perm] for p in payloads])
