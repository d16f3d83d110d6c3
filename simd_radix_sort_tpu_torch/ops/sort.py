"""Public sort API: separate key/payload datastreams and combined layout.

Counterpart of simd_radix_sort_tpu/ops/sort.py.  Every entry point takes
NumPy arrays or torch tensors and a `device` (None means "cuda"; a machine
without CUDA raises unless the caller passes device="cpu").  Inputs are
moved to that device and outputs are torch tensors there, in the torch
counterpart of the input dtype (unsigned keys come back as
`torch.uint16/32/64` views).  float64 is native on the card, so the JAX
package's f64-as-bits protocol has no counterpart; outputs are
byte-identical all the same.

The sort is NOT stable by default, matching the reference; pass
stable=True for a stable variant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import common, interop, profiling, transforms
from . import xla_sort


def _stage(x, device: torch.device) -> torch.Tensor:
    """Host array or tensor -> tensor on `device`, bits preserved."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in common.NUMPY_OF:
            raise TypeError(f"unsupported dtype {x.dtype}")
        return common.as_signed(x).to(device).view(x.dtype)
    return interop.from_numpy(np.asarray(x), device)


def sort(keys, *payloads, ascending: bool | None = None,
         method: str | None = None, stable: bool | None = None,
         block_threshold: int | None = None, digit_bits: int | None = None,
         config=None, device=None):
    """Sort keys with any number of payload streams kept in lock-step.

    Returns sorted_keys when there are no payloads, else
    (sorted_keys,) + sorted payloads.  `config` (a SortConfig) supplies
    defaults for every knob; explicit keyword arguments override it."""
    from .. import methods
    from ..config import SortConfig

    cfg = config if config is not None else SortConfig()
    ascending = cfg.ascending if ascending is None else ascending
    method = cfg.method if method is None else method
    stable = cfg.stable if stable is None else stable
    block_threshold = (cfg.block_threshold if block_threshold is None
                       else block_threshold)
    digit_bits = cfg.digit_bits if digit_bits is None else digit_bits

    with profiling.span("srs.sort"):
        dev = common.resolve_device(device)
        with profiling.span("srs.sort.stage"):
            keys = _stage(keys, dev)
            payloads = tuple(_stage(p, dev) for p in payloads)
        if keys.ndim != 1:
            raise ValueError("keys must be 1-D")
        for p in payloads:
            if p.shape != keys.shape:
                raise ValueError("payload streams must match keys shape")

        with profiling.span("srs.sort.resolve"):
            m = methods.resolve(method, keys.dtype,
                                tuple(p.dtype for p in payloads),
                                keys.shape[0], device=dev)
        with profiling.span("srs.engine." + m.name):
            keys_out, payloads_out = m.run(
                keys, payloads, ascending=ascending, stable=stable,
                block_threshold=block_threshold, digit_bits=digit_bits)
    if not payloads:
        return keys_out
    return (keys_out,) + tuple(payloads_out)


def sort_with_payloads(keys, payloads, **kw):
    """Like `sort` but always returns (keys, tuple_of_payloads)."""
    out = sort(keys, *payloads, **kw)
    if not payloads:
        return out, ()
    return out[0], tuple(out[1:])


# ---------------------------------------------------------------------------
# Combined (AoS) layout — DataElement<K, Ps...> equivalent
# ---------------------------------------------------------------------------


def pack_rows(keys: np.ndarray, payloads) -> np.ndarray:
    """convertToSingleArray equivalent (src/data.hpp:332-346): pack key +
    payload streams into an (n, element_size) uint8 AoS matrix, key bytes
    first (little-endian), payloads in declaration order."""
    keys = np.asarray(keys)
    cols = [np.ascontiguousarray(keys).view(np.uint8)
            .reshape(len(keys), keys.dtype.itemsize)]
    for p in payloads:
        p = np.ascontiguousarray(np.asarray(p))
        cols.append(p.view(np.uint8).reshape(len(p), p.dtype.itemsize))
    return np.concatenate(cols, axis=1)


def unpack_rows(packed: np.ndarray, key_dtype, payload_dtypes):
    """setFromSingleArray equivalent (src/data.hpp:348-361)."""
    packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
    key_dtype = np.dtype(key_dtype)
    out = []
    off = 0
    for dtype in (key_dtype,) + tuple(np.dtype(d) for d in payload_dtypes):
        w = dtype.itemsize
        col = np.ascontiguousarray(packed[:, off:off + w])
        out.append(col.reshape(-1).view(dtype))
        off += w
    if off != packed.shape[1]:
        raise ValueError("element size mismatch")
    return out[0], tuple(out[1:])


def sort_packed(packed, key_dtype, ascending: bool = True,
                stable: bool = False, method: str | None = None,
                block_threshold: int | None = None,
                digit_bits: int | None = None, config=None, device=None):
    """Sort an (n, element_size) uint8 combined-layout matrix by the key in
    each row's leading bytes; returns the sorted (n, element_size) uint8
    tensor.  `method`/`config` select the engine as in `sort()`.

    The key is a view of the leading bytes.  When the rows carry payload
    bytes, the engine sorts the keys with their row index as the one
    payload, and the payload bytes follow in one row gather."""
    from .. import methods
    from ..config import SortConfig

    cfg = config if config is not None else SortConfig()
    method = cfg.method if method is None else method
    block_threshold = (cfg.block_threshold if block_threshold is None
                       else block_threshold)
    digit_bits = cfg.digit_bits if digit_bits is None else digit_bits

    key_dtype = np.dtype(key_dtype)
    with profiling.span("srs.sort"):
        dev = common.resolve_device(device)
        with profiling.span("srs.sort.stage"):
            if not isinstance(packed, torch.Tensor):
                packed = np.asarray(packed, dtype=np.uint8)
            packed = _stage(packed, dev)
        if packed.dtype != torch.uint8 or packed.ndim != 2:
            raise ValueError("expected an (n, element_size) uint8 matrix")
        n, esize = packed.shape
        ksize = key_dtype.itemsize
        if esize < ksize:
            raise ValueError("element size smaller than key size")

        keys = packed[:, :ksize].reshape(-1).view(
            common.torch_dtype(key_dtype))
        rest = packed[:, ksize:]
        kw = dict(ascending=ascending, stable=stable,
                  block_threshold=block_threshold, digit_bits=digit_bits)
        pays = () if esize == ksize else (
            torch.arange(n, dtype=torch.int64, device=dev),)
        with profiling.span("srs.sort.resolve"):
            m = methods.resolve(method, key_dtype,
                                tuple(p.dtype for p in pays), n, device=dev)
        with profiling.span("srs.engine." + m.name):
            keys_out, pays_out = m.run(keys, pays, **kw)
        if pays:
            rest = rest.index_select(0, pays_out[0])
        key_bytes = keys_out.contiguous().view(torch.uint8).reshape(n, ksize)
        return torch.cat([key_bytes, rest], dim=1)


def argsort(keys, ascending: bool = True, stable: bool = True, device=None):
    """Permutation that sorts `keys`, as int32 indices."""
    keys = _stage(keys, common.resolve_device(device))
    return xla_sort.argsort_keys(keys, ascending=ascending, stable=stable)


def sort_multi(keys_columns, *payloads, ascending=True, stable: bool = False,
               device=None):
    """Composite (multi-column) lexicographic sort: order rows by the first
    key column, ties by the second, and so on — ORDER BY.

    `keys_columns` is a tuple of 1-D arrays (any mix of key dtypes);
    `ascending` is one bool or a per-column tuple.  Returns
    (sorted_key_columns_tuple, sorted_payloads_tuple).  torch has no
    variadic sort, so the permutation comes from stable sorts of the
    columns' carriers from the last column to the first; the result is
    therefore always stable, which `stable=False` permits."""
    keys_columns = tuple(keys_columns)
    if not keys_columns:
        raise ValueError("sort_multi needs at least one key column")
    if isinstance(ascending, bool):
        ascending = (ascending,) * len(keys_columns)
    if len(ascending) != len(keys_columns):
        raise ValueError("one ascending flag per key column")

    with profiling.span("srs.sort_multi"):
        dev = common.resolve_device(device)
        cols = [_stage(k, dev) for k in keys_columns]
        pays = [_stage(p, dev) for p in payloads]
        n = cols[0].shape[0]
        if any(t.ndim != 1 or t.shape[0] != n for t in cols + pays):
            raise ValueError(
                "key columns and payloads must be 1-D of one length")

        perm = None
        for col, up in zip(reversed(cols), reversed(ascending)):
            c = transforms.to_sortable(col, up)
            if perm is not None:
                c = c.index_select(0, perm)
            order = torch.argsort(c, stable=True)
            perm = order if perm is None else perm.index_select(0, order)
        return (tuple(xla_sort.gather(col, perm) for col in cols),
                tuple(xla_sort.gather(p, perm) for p in pays))


def sort_batched(keys, *payloads, ascending: bool = True,
                 stable: bool = False, device=None):
    """Sort each ROW of 2-D arrays independently (keys and payloads in
    lock-step along axis 1)."""
    dev = common.resolve_device(device)
    keys = _stage(keys, dev)
    if keys.ndim != 2:
        raise ValueError("sort_batched expects 2-D keys")
    pays = tuple(_stage(p, dev) for p in payloads)
    c = transforms.to_sortable(keys, ascending)
    vals, idx = torch.sort(c, dim=1, stable=stable)
    keys_out = transforms.from_sortable(vals, keys.dtype, ascending)
    if not payloads:
        return keys_out
    return (keys_out,) + tuple(xla_sort.gather(p, idx, dim=1) for p in pays)
