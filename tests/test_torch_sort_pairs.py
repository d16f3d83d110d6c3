"""The xla engine's one-payload route (cub's pair sort on the card,
ops/cuda_sort.py; its plain version here) against the JAX package's
`xla_sort.sort_arrays`, on the CPU, and which calls take the route.

Stable: keys and payloads bit for bit.  Not stable: keys bit for bit and
every (key, payload) row kept.  Every key dtype, payload widths 1/2/4/8,
both directions, n = 0, 1, 2 and a ragged 2^16 + 3; float keys carry +-0.0,
NaNs of both signs and +-inf; keys are drawn from n / 16 values, so most
tie.  The inputs are `pair_inputs` of the card's tests.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu.ops import xla_sort as jxla
from simd_radix_sort_tpu_torch.ops import cuda_sort, hashagg, hashjoin
from simd_radix_sort_tpu_torch.ops import xla_sort as txla
from simd_radix_sort_tpu_torch.utils import common, interop, profiling
from test_torch_sort_pairs_card import (KEY_DTYPES, RAGGED, SIZES,
                                        VALUE_DTYPES, pair_inputs)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(common.unsigned_of(a.dtype))


def _rows(k, v) -> np.ndarray:
    """(key bits, value bits) rows in one order, for a comparison of sets."""
    kb, vb = _bits(k).astype(np.uint64), _bits(v).astype(np.uint64)
    order = np.lexsort((vb, kb))
    return np.stack([kb[order], vb[order]])


def _check(key_dtype, width, n, ascending, stable, seed):
    k, v = pair_inputs(key_dtype, width, n, seed)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tk, (tv,) = txla.sort_arrays(interop.from_numpy(k, "cpu"),
                                     (interop.from_numpy(v, "cpu"),),
                                     ascending=ascending, stable=stable)
    assert profiling.COUNTERS["xla.pairs_calls"] == 1
    jk, (jv,) = jxla.sort_arrays(jnp.asarray(k), (jnp.asarray(v),),
                                 ascending=ascending, stable=stable)
    tk, tv = interop.to_numpy(tk), interop.to_numpy(tv)
    jk, jv = np.asarray(jk), np.asarray(jv)
    assert tk.dtype == jk.dtype == k.dtype and tv.dtype == jv.dtype == v.dtype
    assert np.array_equal(_bits(tk), _bits(jk))
    if stable:
        assert np.array_equal(_bits(tv), _bits(jv))
    else:
        assert np.array_equal(_rows(tk, tv), _rows(jk, jv))
    assert np.array_equal(_rows(tk, tv), _rows(k, v))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("width", sorted(VALUE_DTYPES))
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_ragged_matches_jax(key_dtype, width, ascending, stable):
    _check(key_dtype, width, RAGGED, ascending, stable, seed=width)


@pytest.mark.parametrize("n", [s for s in SIZES if s < RAGGED])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_tiny_matches_jax(key_dtype, ascending, n):
    for width in sorted(VALUE_DTYPES):
        _check(key_dtype, width, n, ascending, True, seed=n)


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_signed_zeros_and_nans_keep_their_total_order(dtype, ascending):
    """cub's own float path would sort -0.0 and +0.0 as one key; the
    carrier keeps IEEE totalOrder: -NaN < -inf < -0.0 < +0.0 < +inf < NaN,
    and ties in input order."""
    keys = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                     0.0, -0.0], dtype)
    pay = np.arange(len(keys), dtype=np.int32)
    tk, (tp,) = txla.sort_arrays(interop.from_numpy(keys, "cpu"),
                                 (interop.from_numpy(pay, "cpu"),),
                                 ascending=ascending)
    order = [5, 3, 1, 7, 0, 6, 2, 4]  # -NaN, -inf, -0.0 x2, +0.0 x2, ...
    if not ascending:
        order = [4, 2, 0, 6, 1, 7, 3, 5]
    assert interop.to_numpy(tp).tolist() == order
    assert _bits(interop.to_numpy(tk)).tolist() == \
        _bits(keys[order]).tolist()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("srs.xla."))


@pytest.mark.parametrize("streams", [0, 1, 2, 5])
def test_only_one_payload_takes_the_pair_sort(streams):
    g = torch.Generator().manual_seed(streams)
    keys = torch.randint(0, 50, (999,), generator=g).to(torch.uint32)
    pays = tuple(torch.randint(0, 1 << 30, (999,), generator=g)
                 for _ in range(streams))
    spans = _traced(lambda: txla.sort_arrays(keys, pays, ascending=False))
    if streams == 1:
        assert profiling.COUNTERS["xla.pairs_calls"] == 1
        assert spans == {"srs.xla.pairs": 1}
    else:
        assert "xla.pairs_calls" not in profiling.COUNTERS
        assert spans["srs.xla.sort"] == 1 and "srs.xla.pairs" not in spans
        assert spans["srs.xla.gather"] == (1 if streams else 0)


def test_over_max_items_keeps_torch_sort(monkeypatch):
    monkeypatch.setattr(cuda_sort, "MAX_ITEMS", 10)
    keys = torch.arange(11, 0, -1)
    spans = _traced(lambda: txla.sort_arrays(keys, (keys * 2,)))
    assert "xla.pairs_calls" not in profiling.COUNTERS
    assert "srs.xla.pairs" not in spans and spans["srs.xla.sort"] == 1
    with pytest.raises(ValueError, match="at most 10 pairs"):
        cuda_sort.sort_pairs(keys, keys)


def test_operators_route_their_one_payload_sorts():
    """sort() on xla, group_aggregate of one stream and a lookup join of one
    payload each take the pair sort once; argsort never."""
    g = torch.Generator().manual_seed(1)
    keys = torch.randint(0, 1 << 40, (3000,), generator=g)

    def calls():
        tsrs.sort(keys, torch.arange(3000), method="xla", device="cpu")
        hashagg.group_aggregate(keys % 5, torch.rand(3000, generator=g,
                                                     dtype=torch.float64),
                                aggs=("sum",))
        hashjoin.lookup_join(keys % 900, torch.arange(1000),
                             (torch.arange(1000, dtype=torch.int8),))
        tsrs.argsort(keys, device="cpu")
    spans = _traced(calls)
    assert profiling.COUNTERS["xla.pairs_calls"] == 3
    assert spans == {"srs.xla.pairs": 3}


@pytest.mark.parametrize("bad,err", [
    (lambda: (torch.zeros(4, dtype=torch.bool), torch.zeros(4)), TypeError),
    (lambda: (torch.zeros(4, dtype=torch.float32), torch.zeros(4)),
     TypeError),
    (lambda: (torch.zeros(4, dtype=torch.int32),
              torch.zeros(4, dtype=torch.complex128)), TypeError),
    (lambda: (torch.zeros(4, dtype=torch.int32), torch.zeros(5)),
     ValueError),
    (lambda: (torch.zeros((4, 2), dtype=torch.int32),
              torch.zeros((4, 2))), ValueError),
    (lambda: (torch.zeros(8, dtype=torch.int32)[::2], torch.zeros(4)),
     ValueError)])
def test_wrapper_refuses_what_cub_does_not_take(bad, err):
    with pytest.raises(err):
        cuda_sort.sort_pairs(*bad())


def test_plain_leaves_inputs_and_keeps_ties_in_order():
    keys = torch.tensor([3, 1, 3, 2, 1, 3], dtype=torch.int16)
    vals = torch.arange(6, dtype=torch.float64)
    for desc, order in ((False, [1, 4, 3, 0, 2, 5]),
                        (True, [0, 2, 5, 3, 1, 4])):
        k, v = cuda_sort.sort_pairs(keys, vals, desc)
        assert v.tolist() == order and k.tolist() == keys[order].tolist()
    assert keys.tolist() == [3, 1, 3, 2, 1, 3]
