"""Carrying data and configuration across from the JAX package.

The sort engine has no weights: its state is the data streams and the
`SortConfig`.  These helpers move both between the JAX package's world
(NumPy arrays, a JAX `SortConfig`'s fields) and the port's (torch tensors,
the port's `SortConfig`) bit-exactly, without importing the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import common


def from_numpy(arr, device=None) -> torch.Tensor:
    """NumPy array -> tensor of the torch counterpart dtype on `device`
    (None means "cuda").  Every bit is kept, NaN payloads and -0.0
    included; the copy travels as a signed view, which every torch build
    can move."""
    arr = np.ascontiguousarray(np.asarray(arr))
    dt = common.np_dtype(arr.dtype)
    if dt not in common.TORCH_OF:
        raise TypeError(f"unsupported dtype {dt}")
    dev = common.resolve_device(device)
    signed = np.dtype(f"i{dt.itemsize}")
    t = torch.from_numpy(arr.view(signed)).to(dev)
    return t.view(common.TORCH_OF[dt])


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """Tensor -> NumPy array with the same bits, viewed as `dtype`
    (default: the NumPy counterpart of the tensor's dtype)."""
    dt = common.NUMPY_OF[t.dtype] if dtype is None else np.dtype(dtype)
    host = common.as_signed(t.detach()).cpu().contiguous()
    return host.numpy().view(dt)


def config_from_jax(fields: dict):
    """The port's SortConfig from a JAX SortConfig's fields
    (`dataclasses.asdict(jax_config)`).  Unknown fields raise."""
    from ..config import SortConfig

    known = {f.name for f in dataclasses.fields(SortConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"SortConfig has no fields {sorted(unknown)}")
    return SortConfig(**fields)
