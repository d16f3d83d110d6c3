"""The port's order-preserving transforms against the JAX package's.

Same NumPy inputs through simd_radix_sort_tpu.utils.transforms (JAX, on the
CPU) and simd_radix_sort_tpu_torch.utils.transforms (torch, on the CPU):
the port's signed carrier, read back as unsigned and with its sign bit
flipped, must equal the JAX transform's unsigned value bit for bit, and
every round trip must return the input bits.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.utils import transforms as jt
from simd_radix_sort_tpu_torch.utils import common, interop
from simd_radix_sort_tpu_torch.utils import transforms as tt

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
          np.int32, np.int64, np.float32, np.float64]


def _edge_keys(dtype, n_random=997, seed=0):
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if dtype.kind == "f":
        edges = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
                          np.finfo(dtype).max, np.finfo(dtype).min,
                          np.finfo(dtype).tiny, -np.finfo(dtype).tiny],
                         dtype=dtype)
        # NaNs with payload bits and both signs
        ubits = np.array([0x7FC00001, 0xFFC00002] if dtype.itemsize == 4
                         else [0x7FF8000000000001, 0xFFF8000000000002],
                         dtype=common.unsigned_of(dtype))
        rand = rng.normal(0, 1e3, n_random).astype(dtype)
        return np.concatenate([edges, ubits.view(dtype), rand])
    info = np.iinfo(dtype)
    edges = np.array([info.min, info.max, 0, 1, info.max - 1], dtype=dtype)
    if dtype.kind == "i":
        edges = np.concatenate([edges, np.array([-1, info.min + 1], dtype)])
    rand = rng.integers(info.min, info.max, n_random, dtype=dtype,
                        endpoint=True)
    return np.concatenate([edges, rand])


def _carrier_as_unsigned(c: torch.Tensor, dtype) -> np.ndarray:
    """The port's signed carrier -> the JAX transform's unsigned value."""
    udt = common.unsigned_of(dtype)
    sign = udt.type(1 << (8 * udt.itemsize - 1))
    return interop.to_numpy(c, udt) ^ sign


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_to_sortable_matches_jax_and_round_trips(dtype, ascending):
    keys = _edge_keys(dtype)
    want = np.asarray(jt.to_sortable(jnp.asarray(keys), ascending))
    t = interop.from_numpy(keys, "cpu")
    c = tt.to_sortable(t, ascending)
    assert c.dtype == common.signed_of(dtype)
    got = _carrier_as_unsigned(c, dtype)
    assert np.array_equal(got, want)
    back = interop.to_numpy(tt.from_sortable(c, dtype, ascending))
    assert back.dtype == np.dtype(dtype)
    assert np.array_equal(back.view(np.uint8), keys.view(np.uint8))
    # signed order of the carrier == unsigned order of the JAX value
    order = torch.argsort(c, stable=True).numpy()
    assert np.array_equal(order, np.argsort(want, kind="stable"))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bits_protocol_and_operands_match_jax(dtype, ascending):
    keys = _edge_keys(dtype, n_random=257, seed=1)
    udt = common.unsigned_of(dtype)
    bits = keys.view(udt)
    want = np.asarray(jt.sortable_from_bits(jnp.asarray(bits), dtype,
                                            ascending))
    c = tt.sortable_from_bits(interop.from_numpy(bits, "cpu"), dtype,
                              ascending)
    assert np.array_equal(_carrier_as_unsigned(c, dtype), want)
    raw = tt.bits_from_sortable(c, dtype, ascending)
    assert raw.dtype == common.torch_dtype(udt)
    assert np.array_equal(interop.to_numpy(raw), bits)
    ops = tt.key_operands(interop.from_numpy(keys, "cpu"), ascending)
    assert len(ops) == 1
    out = tt.keys_from_operands(ops, dtype, ascending)
    assert np.array_equal(interop.to_numpy(out).view(np.uint8),
                          keys.view(np.uint8))
    out_bits = tt.keys_from_operands(ops, dtype, ascending, as_bits=True)
    assert np.array_equal(interop.to_numpy(out_bits), bits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_numpy_host_versions_match_jax(dtype):
    keys = _edge_keys(dtype, n_random=101, seed=2)
    for asc in (True, False):
        u = tt.to_sortable_np(keys, asc)
        assert np.array_equal(u, jt.to_sortable_np(keys, asc))
        back = tt.from_sortable_np(u, dtype, asc)
        assert np.array_equal(back.view(np.uint8), keys.view(np.uint8))
        for a, b in zip(tt.sort_np(keys, keys[::-1].copy(), ascending=asc),
                        jt.sort_np(keys, keys[::-1].copy(), ascending=asc)):
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
