"""K9's plain version and wrapper on the CPU (`ops/cuda_rows.py`): whole
rows by an index against NumPy's fancy indexing, the vector width the
wrapper picks from the row size and the base addresses, the checks that
raise, and `sort_packed`'s premise that every engine returns a row's key
bits as the row holds them, so gathering whole rows by the sorted index
gives the sorted keys' bytes."""

import numpy as np
import pytest
import torch

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu_torch import methods
from simd_radix_sort_tpu_torch.ops import cuda_rows
from simd_radix_sort_tpu_torch.utils import common


def table(n, row_bytes, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, row_bytes), dtype=np.uint8)


@pytest.mark.parametrize("index", ["permutation", "repeats", "reversed"])
@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
@pytest.mark.parametrize("row_bytes", [64, 24, 16, 12, 9, 1])
def test_plain_equals_numpy_fancy_indexing(row_bytes, n, index):
    rows = table(max(n, 1), row_bytes, seed=row_bytes)
    rng = np.random.default_rng(n)
    idx = {"permutation": rng.permutation(n),
           "repeats": rng.integers(0, max(n, 1), n),
           "reversed": np.arange(n)[::-1].copy()}[index]
    t_rows, t_idx = torch.from_numpy(rows), torch.from_numpy(idx)
    want = rows[idx]
    for fn in (cuda_rows.row_gather_plain, cuda_rows.row_gather):
        got = fn(t_rows, t_idx)
        assert got.dtype == torch.uint8 and got.shape == (n, row_bytes)
        assert np.array_equal(got.numpy(), want)


def test_plain_on_a_view_off_the_alignment():
    flat = torch.from_numpy(table(1, 7 * 1001 + 3).reshape(-1))
    rows = flat[3:].view(1001, 7)  # contiguous, the base 3 bytes in
    idx = torch.from_numpy(np.random.default_rng(1).permutation(1001))
    got = cuda_rows.row_gather(rows, idx)
    assert np.array_equal(got.numpy(), rows.numpy()[idx.numpy()])


@pytest.mark.parametrize("row_bytes,src_off,want", [
    (64, 0, 16), (64, 8, 8), (64, 4, 4), (64, 2, 2), (64, 1, 1),
    (24, 0, 8), (16, 0, 16), (12, 0, 4), (9, 0, 1), (8, 0, 8), (6, 0, 2),
    (56, 0, 8), (128, 0, 16), (128, 48, 16), (1, 0, 1), (24, 16, 8),
])
def test_vector_width_from_row_size_and_addresses(row_bytes, src_off, want):
    base = 1 << 21  # an allocation's alignment
    assert cuda_rows.vector_width(row_bytes, base + src_off, base) == want
    # the output's address narrows it the same way
    assert cuda_rows.vector_width(row_bytes, base, base + src_off) == want


@pytest.mark.parametrize("fault", ["dtype", "ndim", "index_dtype",
                                   "index_ndim", "strided", "no_bytes"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    rows = torch.zeros((10, 8), dtype=torch.uint8)
    idx = torch.arange(10)
    bad = {"dtype": (rows.view(torch.int64), idx),
           "ndim": (rows.reshape(-1), idx),
           "index_dtype": (rows, idx.to(torch.int32)),
           "index_ndim": (rows, idx.reshape(2, 5)),
           "strided": (torch.zeros((10, 16), dtype=torch.uint8)[:, :8], idx),
           "no_bytes": (rows[:, :0], idx)}[fault]
    with pytest.raises((TypeError, ValueError)):
        cuda_rows.row_gather(*bad)


def _keyed_rows(kd, n, seed):
    """n rows of a key of dtype kd and 5 payload bytes; float keys hold NaN
    of either sign and with other payload bits, both zeros and both
    infinities."""
    rng = np.random.default_rng(seed)
    w = np.dtype(kd).itemsize
    keys = rng.integers(0, 256, n * w, dtype=np.uint8).view(kd).copy()
    if keys.dtype.kind == "f":
        keys[:600] = np.repeat(np.array(
            [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=kd), 100)
        bits = keys.view(np.dtype(f"u{w}"))
        bits[600:700] |= np.array(0x7FF8 << (8 * w - 16), dtype=bits.dtype)
        bits[650:700] ^= np.array(0x5, dtype=bits.dtype)
    fields = tuple(rng.integers(0, 256, n * size, dtype=np.uint8).view(d)
                   for d, size in ((np.uint32, 4), (np.uint8, 1)))
    return keys, tsrs.pack_rows(keys, fields)


def _canonical(rows):
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("method", sorted(methods.REGISTRY))
@pytest.mark.parametrize("kd", [np.float32, np.float64, np.int16,
                                np.uint64], ids=lambda d: np.dtype(d).name)
def test_every_engine_keeps_the_key_bits_of_its_rows(kd, method, stable):
    n = 3001
    keys, packed = _keyed_rows(kd, n, seed=n)
    m = methods.REGISTRY[method]
    if not m.supports(np.dtype(kd), (np.dtype(np.int64),), n):
        with pytest.raises(ValueError):
            tsrs.sort_packed(packed, kd, method=method, device="cpu")
        return
    k = torch.from_numpy(keys.view(f"i{keys.itemsize}")).view(
        common.torch_dtype(kd))
    for asc in (True, False):
        ko, (idx,) = m.run(k, (torch.arange(n),), ascending=asc,
                           stable=stable, block_threshold=64, digit_bits=8)
        # the engine's sorted keys are the key bytes of the rows it names
        assert np.array_equal(common.as_signed(ko).numpy().view(np.uint8),
                              packed[idx.numpy(), :keys.itemsize].reshape(-1))
        got = tsrs.sort_packed(packed, kd, ascending=asc, stable=stable,
                               method=method, block_threshold=64,
                               digit_bits=8, device="cpu").numpy()
        if stable:
            assert np.array_equal(got, packed[idx.numpy()])
        # every output row is an input row, and the keys are in order
        assert np.array_equal(_canonical(got), _canonical(packed))
        out_keys = common.as_signed(torch.from_numpy(
            np.ascontiguousarray(got[:, :keys.itemsize]).reshape(-1)
            .view(f"i{keys.itemsize}"))).view(common.torch_dtype(kd))
        assert np.array_equal(
            common.as_signed(ko).numpy(), common.as_signed(out_keys).numpy())
