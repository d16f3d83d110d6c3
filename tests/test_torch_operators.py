"""The port's filter (ops/filter) and group-by aggregate (ops/hashagg)
against the JAX package's, on the CPU (joins and top-k/unique:
test_torch_joins_topk.py).

The same seeded NumPy inputs go through the JAX function and its port; the
port runs on CPU tensors, where every compaction runs K5's plain version
(tests/test_torch_kernels_card.py holds K5 against that on the card).

Tolerances: keys, indices, counts, integer aggregates and min/max are
compared exactly (bytes, or values with NaN equal to NaN).  Float sums and
means add in another order in the two packages (the JAX package's
associative-scan tree, the port's doubling scan on the CPU), so they are
held to rtol = 1e-5 for float32 (and float16 inputs, summed in float32)
and rtol = 1e-12 for float64, relative to the group's sum of magnitudes,
the scale of either order's rounding error.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.ops import filter as jfilter
from simd_radix_sort_tpu.ops import hashagg as jhashagg
from simd_radix_sort_tpu.utils import transforms as jtransforms
from simd_radix_sort_tpu_torch.ops import cuda_partition, cuda_scan
from simd_radix_sort_tpu_torch.ops import filter as tfilter
from simd_radix_sort_tpu_torch.ops import hashagg as thashagg
from simd_radix_sort_tpu_torch.utils import interop

RTOL = {np.dtype(np.float16): 1e-5, np.dtype(np.float32): 1e-5,
        np.dtype(np.float64): 1e-12}
STREAM_DTYPES = [np.int32, np.uint64, np.float64, np.uint8, np.int16,
                 np.bool_, np.float16]


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype in (np.bool_, np.float16):
        return torch.from_numpy(a.copy())
    return interop.from_numpy(a, "cpu")


def _np(t):
    if t.dtype in (torch.bool, torch.float16, torch.float32, torch.float64):
        return t.numpy()
    return interop.to_numpy(t)


def _same(got, want):
    """Equal dtype and bytes."""
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _values(rng, n, dtype):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.integers(0, 2, n) == 1
    if dtype.kind == "f":
        return rng.normal(0, 100, n).astype(dtype)
    return rng.integers(0, 256, n * dtype.itemsize,
                        dtype=np.uint8).view(dtype)


def _jit(fn, **static):
    """The JAX function compiled once, its keyword arguments static: the
    eager form compiles every primitive of a scan on its own."""
    return jax.jit(functools.partial(fn, **static))


def _mask(kind, n, rng):
    i = np.arange(n)
    return {"random": rng.integers(0, 2, n) == 1, "all False": i < 0,
            "all True": i >= 0, "sparse": rng.random(n) < 0.02}[kind]


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", [None, 0, 7])
@pytest.mark.parametrize("kind", ["random", "all False", "all True"])
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_compact_matches_jax(n, kind, fill):
    rng = np.random.default_rng(n)
    mask = _mask(kind, n, rng)
    streams = [_values(rng, n, d) for d in STREAM_DTYPES]
    want = jfilter.compact(jnp.asarray(mask),
                           *(jnp.asarray(s) for s in streams), fill=fill)
    got = tfilter.compact(_t(mask), *(_t(s) for s in streams), fill=fill)
    assert got[0].dtype == torch.int32 and got[0].dim() == 0
    assert int(got[0]) == int(want[0]) == int(mask.sum())
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)


def test_compact_is_one_partition_pass(monkeypatch):
    """Every stream rides one K5 call, however many there are."""
    calls = []
    real = cuda_partition.partition_pass

    def spy(streams, mask, **kw):
        calls.append(len(streams))
        return real(streams, mask, **kw)

    monkeypatch.setattr(cuda_partition, "partition_pass", spy)
    rng = np.random.default_rng(1)
    streams = [_t(_values(rng, 50, np.int64)) for _ in range(11)]
    tfilter.compact(_t(_mask("random", 50, rng)), *streams)
    assert calls == [11]
    with pytest.raises(TypeError, match="boolean"):
        tfilter.compact(torch.ones(50, dtype=torch.int32), *streams)


@pytest.mark.parametrize("n,max_out,density", [
    (0, 5, 0.5), (100, 10, 0.5), (100, 300, 0.5), (20000, 50, 0.3),
    (20000, 15000, 0.3), (30000, 40000, 0.9), (20000, 64, 0.001)])
def test_compact_bounded_matches_jax(n, max_out, density):
    rng = np.random.default_rng(n + max_out)
    mask = rng.random(n) < density
    streams = [_values(rng, n, d) for d in (np.int64, np.uint32, np.float32,
                                            np.int8)]
    want = _jit(jfilter.compact_bounded, max_out=max_out)(
        jnp.asarray(mask), *(jnp.asarray(s) for s in streams))
    got = tfilter.compact_bounded(_t(mask), *(_t(s) for s in streams),
                                  max_out=max_out)
    assert int(got[0]) == int(want[0]) == int(mask.sum())
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)


def test_filter_rows_matches_jax():
    rng = np.random.default_rng(2)
    keys = rng.integers(-50, 50, 3000).astype(np.int32)
    pay = rng.normal(size=3000)
    want = jfilter.filter_rows(lambda k: k % 3 == 0, jnp.asarray(keys),
                               jnp.asarray(pay))
    got = tfilter.filter_rows(lambda k: k % 3 == 0, _t(keys), _t(pay))
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)
    got = tfilter.filter_rows(_t(keys > 10), _t(keys))
    want = jfilter.filter_rows(jnp.asarray(keys > 10), jnp.asarray(keys))
    assert int(got[0]) == int(want[0])
    _same(got[1], want[1])


# ---------------------------------------------------------------------------
# group_aggregate
# ---------------------------------------------------------------------------

ALL_AGGS = ("sum", "count", "min", "max", "mean")
VALUE_DTYPES = [np.uint8, np.int16, np.int32, np.uint64, np.float16,
                np.float32, np.float64]


def _abs_group_sums(keys, vals, ng):
    """Per group (ascending key), the sum of |value| in float64."""
    order = np.argsort(jtransforms.to_sortable_np(keys), kind="stable")
    k = jtransforms.to_sortable_np(keys)[order]
    v = np.abs(vals[order].astype(np.float64))
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    sums = np.add.reduceat(v, starts) if len(v) else np.zeros(0)
    counts = np.diff(np.r_[starts, len(k)])
    assert len(sums) == ng
    return sums, counts


def _check_agg(agg, got, want, absum, cnt, ng):
    got, want = _np(got)[:ng], np.asarray(want)[:ng]
    assert got.dtype == want.dtype, (agg, got.dtype, want.dtype)
    if got.dtype.kind != "f" or agg in ("min", "max", "count"):
        if got.dtype.kind == "f":
            assert np.array_equal(got, want, equal_nan=True), agg
        else:
            assert np.array_equal(got, want), agg
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), agg
    rtol = RTOL[got.dtype]
    scale = (absum if agg == "sum" else absum / cnt)[~nan]
    err = np.abs(got[~nan].astype(np.float64) - want[~nan])
    assert np.all(err <= rtol * (scale + 1e-30)), (agg, err.max())


def _group_parity(keys, vals, aggs=ALL_AGGS, **kw):
    jvals = tuple(jnp.asarray(v) for v in vals)
    tvals = tuple(_t(v) for v in vals)
    jng, jgk, jres = _jit(jhashagg.group_aggregate, aggs=aggs, **kw)(
        jnp.asarray(keys), jvals)
    tng, tgk, tres = thashagg.group_aggregate(_t(keys), tvals, aggs=aggs,
                                              **kw)
    assert tng.dtype == torch.int32 and int(tng) == int(jng)
    ng = min(int(tng), kw.get("max_groups") or len(keys))
    _same(tgk[:ng], np.asarray(jgk)[:ng])
    assert len(tgk) == len(jgk)
    streams = kw.get("agg_streams") or [range(len(vals))] * len(aggs)
    for agg, sel, g, w in zip(aggs, streams, tres, jres):
        if agg == "count":
            _same(g[:ng], np.asarray(w)[:ng])
            continue
        for i, gs, ws in zip(sel, g, w):
            assert len(gs) == len(ws)
            absum, cnt = _abs_group_sums(keys, vals[i], int(tng))
            _check_agg(agg, gs, ws, absum[:ng], cnt[:ng], ng)
    return int(tng)


@pytest.mark.parametrize("key_dtype", [np.int32, np.uint64],
                         ids=lambda d: np.dtype(d).name)
def test_group_aggregate_matches_jax(key_dtype):
    """Every aggregate over a stream of every value dtype, in one call;
    full-range integers, so sums and means wrap in the value's dtype."""
    rng = np.random.default_rng(7)
    n = 3000
    keys = rng.integers(0, 97, n).astype(key_dtype)
    if key_dtype == np.uint64:
        keys = keys << np.uint64(57)  # groups that differ in the top bits
    vals = [_values(rng, n, d) for d in VALUE_DTYPES]
    assert _group_parity(keys, vals) == 97


def test_group_aggregate_wraps_like_jax():
    """uint8 [7, 2, 200] sums to 209 and [250, 9] to 3 (259 mod 256), mean
    3 // 2 = 1; uint64 means of values >= 2^63 divide unsigned; counts that
    wrap in the value's dtype (int8 200 -> -56, uint8 256 -> 0) divide as
    the JAX package divides."""
    keys = np.array([0, 0, 0, 1, 1], np.int32)
    vals = np.array([7, 2, 200, 250, 9], np.uint8)
    _, _, (s, m) = thashagg.group_aggregate(_t(keys), _t(vals),
                                            aggs=("sum", "mean"))
    assert _np(s[0])[:2].tolist() == [209, 3]
    assert _np(m[0])[:2].tolist() == [69, 1]
    rng = np.random.default_rng(9)
    keys = np.repeat(np.arange(6, dtype=np.int16), [3, 200, 256, 1, 300, 7])
    big = rng.integers(2**63, 2**64 - 1, len(keys), dtype=np.uint64)
    small = rng.integers(-128, 128, len(keys)).astype(np.int8)
    u8 = rng.integers(0, 256, len(keys)).astype(np.uint8)
    i64 = rng.integers(-2**62, 2**62, len(keys))
    _group_parity(keys, [big, small, u8, i64], aggs=("sum", "mean", "count"))


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_group_aggregate_nan_propagates(dtype):
    keys = np.array([1, 1, 1, 2, 2, 3, 3, 3, 3], np.int32)
    vals = np.array([4, np.nan, -1, 5, 6, 2, 9, np.nan, -3], dtype)
    _group_parity(keys, [vals], aggs=("min", "max", "sum"))
    _, _, (mins, maxs) = thashagg.group_aggregate(_t(keys), _t(vals),
                                                  aggs=("min", "max"))
    assert np.isnan(_np(mins[0])[[0, 2]]).all()
    assert np.isnan(_np(maxs[0])[[0, 2]]).all()
    assert _np(mins[0])[1] == 5 and _np(maxs[0])[1] == 6


def test_group_aggregate_agg_streams_and_presorted():
    rng = np.random.default_rng(11)
    n = 2000
    keys = np.sort(rng.integers(0, 40, n)).astype(np.int64)
    vals = [rng.normal(size=n), rng.integers(0, 1000, n).astype(np.uint32),
            rng.integers(0, 2, n).astype(np.int32)]
    for presorted in (False, True):
        _group_parity(keys, vals, aggs=("sum", "max", "count", "mean"),
                      agg_streams=((0, 1), (2,), (), (1, 0)),
                      presorted=presorted)


@pytest.mark.parametrize("max_groups", [4, 41, 1000])
def test_group_aggregate_max_groups_matches_jax(max_groups):
    """A bound under the true group count (the first max_groups groups
    exact, num_groups still true) and over it."""
    rng = np.random.default_rng(12)
    n = 10000
    keys = rng.integers(0, 41, n).astype(np.int32)
    vals = [rng.normal(size=n).astype(np.float32),
            rng.integers(-1000, 1000, n).astype(np.int32)]
    assert _group_parity(keys, vals, max_groups=max_groups) == 41


def test_group_aggregate_single_group_and_empty():
    for n in (0, 1, 64):
        keys = np.zeros(n, np.int32)
        vals = np.arange(n, dtype=np.float64)
        _group_parity(keys, [vals, vals.astype(np.int32)])


def test_segmented_scans_stop_at_the_longest_group():
    starts = torch.tensor([True, False, False, True, False, True, True])
    vals = torch.tensor([1., 2., 3., 4., 5., 6., 7.])
    (s,) = cuda_scan.segmented_scans([vals], starts, ["sum"])
    assert s.tolist() == [1., 3., 6., 4., 9., 6., 7.]
    ints = torch.tensor([5, 1, 7, 2, 0, 3, 3])
    mn, mx = cuda_scan.segmented_scans([ints, ints], starts, ["min", "max"])
    assert mn.tolist() == [5, 1, 1, 2, 0, 3, 3]
    assert mx.tolist() == [5, 5, 7, 2, 2, 3, 3]
