"""The port's rank and quick engines (ops/rank_sort, ops/quick_sort) and
their registry names against the JAX package's, on the CPU.

Same seeded NumPy inputs through both packages; the port runs on CPU
tensors, where `quick_sort.partition` runs K5's plain version.  Every
output is compared exactly: keys byte for byte; payloads byte for byte
where the sort is stable, else with the key-seeded payload oracle
(`utils/data.check_payloads`).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import simd_radix_sort_tpu as jsrs
import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu.ops import quick_sort as jquick
from simd_radix_sort_tpu.utils import data as jdata
from simd_radix_sort_tpu_torch import methods as tmethods
from simd_radix_sort_tpu_torch.ops import quick_sort as tquick
from simd_radix_sort_tpu_torch.ops import rank_sort
from simd_radix_sort_tpu_torch.utils import data as tdata
from simd_radix_sort_tpu_torch.utils import interop

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
          np.int32, np.int64, np.float32, np.float64]


def _t(a):
    return interop.from_numpy(a, "cpu")


def _np(t):
    return interop.to_numpy(t)


def _same(got, want):
    got, want = _np(got).reshape(-1), np.asarray(want).reshape(-1)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _keys(n, dtype, dist="UNIFORM", seed=3):
    keys = tdata.make_keys(n, dtype, tdata.Distribution[dist], seed=seed)
    assert np.array_equal(
        keys.view(np.uint8),
        jdata.make_keys(n, dtype, jdata.Distribution[dist], seed=seed)
        .view(np.uint8))
    return keys


# ---------------------------------------------------------------------------
# rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_rank_sort_matches_jax(dtype, ascending):
    """Stable, so keys and payloads equal the JAX package's byte for byte;
    Gaussian keys bring ties."""
    keys = _keys(1000, dtype, "GAUSSIAN")
    pays = tdata.make_payloads(keys, [np.uint32, np.float64])
    want = jsrs.sort(keys, *pays, method="rank", ascending=ascending)
    got = tsrs.sort(keys, *pays, method="rank", ascending=ascending,
                    device="cpu")
    for g, w in zip(got, want):
        _same(g, w)


def test_rank_sort_limits_and_inverse():
    n = rank_sort.MAX_RANK_SORT_N
    keys = _keys(n, np.int32)
    _same(tsrs.sort(keys, method="rank", device="cpu"),
          jsrs.sort(keys, method="rank"))
    with pytest.raises(ValueError, match="does not support"):
        tsrs.sort(_keys(n + 1, np.int32), method="rank", device="cpu")
    with pytest.raises(ValueError, match="limited"):
        rank_sort.sort_arrays(_t(_keys(n + 1, np.int32)), ())
    empty = np.zeros(0, np.float32)
    assert tsrs.sort(empty, method="rank", device="cpu").shape == (0,)
    rank = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    src = rank_sort.inverse_perm_matmul(rank)
    assert src.dtype == torch.int32 and src.tolist() == [1, 3, 0, 2]


# ---------------------------------------------------------------------------
# quick_sort.partition (K5)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_partition_matches_jax(dtype, ascending):
    keys = _keys(4096, dtype, seed=2)
    (pay,) = tdata.make_payloads(keys, [np.uint32])
    for pivot in (keys[17], keys.min(), keys.max()):
        want = jquick.partition(jnp.asarray(keys), (jnp.asarray(pay),),
                                pivot, ascending=ascending)
        got = tquick.partition(_t(keys), (_t(pay),), pivot,
                               ascending=ascending)
        _same(got[0], want[0])
        _same(got[1][0], want[1][0])
        assert got[2].dtype == torch.int32
        assert int(got[2]) == int(want[2])
        _same(got[3], want[3])
        _same(got[4], want[4])
    # a pivot given as a 0-d tensor
    got = tquick.partition(_t(keys), (), _t(keys[17:18])[0],
                           ascending=ascending)
    _same(got[0], jquick.partition(jnp.asarray(keys), (), keys[17],
                                   ascending=ascending)[0])
    with pytest.raises(ValueError, match="at least one row"):
        tquick.partition(_t(keys[:0]), (), keys[0])


# ---------------------------------------------------------------------------
# the quick engine
# ---------------------------------------------------------------------------


def _quick(keys, pays, path, **kw):
    tquick.reset_paths()
    out = tsrs.sort(keys, *pays, method="quick", device="cpu", **kw)
    assert tquick.PATHS[path] == 1, tquick.PATHS
    return (out,) if not pays else tuple(out)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dtype,ascending", [
    (np.uint64, True), (np.int32, False), (np.float32, True),
    (np.int16, True), (np.float64, False)],
    ids=lambda p: str(p) if isinstance(p, bool) else np.dtype(p).name)
def test_quick_blocked_path_matches_jax(dtype, ascending, stable):
    """n = 2^17: 32 buckets, inside the blocked-cleanup range.  stable=True
    equals the JAX engine byte for byte; stable=False equals it in keys,
    and every payload still belongs to its key."""
    n = 1 << 17
    dist = "GAUSSIAN" if np.dtype(dtype).itemsize <= 2 else "UNIFORM"
    keys = _keys(n, dtype, dist)
    pays = tdata.make_payloads(keys, [np.uint64, np.int16])
    got = _quick(keys, pays, "blocked", ascending=ascending, stable=stable)
    want = jsrs.sort(keys, *pays, method="quick", ascending=ascending,
                     stable=stable)
    _same(got[0], want[0])
    if stable:
        for g, w in zip(got[1:], want[1:]):
            _same(g, w)
        ref = tsrs.sort(keys, *pays, method="xla", stable=True,
                        ascending=ascending, device="cpu")
        for g, w in zip(got, ref):
            _same(g, w)
    else:
        assert tdata.check_data(_np(got[0]), [_np(p) for p in got[1:]],
                                keys, ascending=ascending) == ""


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dist", ["ZERO", "ZERO_ONE", "SORTED"])
def test_quick_fallback_on_skewed_data(dist, stable):
    """Duplicates put a segment over BLOCK/2 rows: the anti-skew fallback.
    A sorted input splits evenly and stays blocked."""
    n = 1 << 17
    keys = _keys(n, np.uint32, dist)
    pays = tdata.make_payloads(keys, [np.uint32])
    path = "blocked" if dist == "SORTED" else "fallback"
    got = _quick(keys, pays, path, stable=stable)
    want = jsrs.sort(keys, *pays, method="quick", stable=stable)
    _same(got[0], want[0])
    if stable:
        _same(got[1], want[1])
    assert tdata.check_data(_np(got[0]), [_np(got[1])], keys) == ""


@pytest.mark.parametrize("n", [0, 1, 2, 4096, 4097])
def test_quick_one_sort_below_the_threshold(n):
    keys = _keys(n, np.int64)
    pays = tdata.make_payloads(keys, [np.uint8])
    path = "one_sort" if n <= 4096 else "blocked"
    got = _quick(keys, pays, path, stable=True)
    want = jsrs.sort(keys, *pays, method="quick", stable=True)
    for g, w in zip(got, want):
        _same(g, w)


def test_quick_block_threshold_and_range(monkeypatch):
    """block_threshold sets the target segment; past C * BLOCK/2 rows the
    engine is one sort (no wasted partition)."""
    keys = _keys(5000, np.uint32)
    got = _quick(keys, (), "blocked", block_threshold=64)
    _same(got[0], jsrs.sort(keys, method="quick", block_threshold=64))
    monkeypatch.setattr(tquick, "MAX_BUCKETS", 4)
    monkeypatch.setattr(tquick, "BLOCK", 256)
    keys = _keys(1000, np.uint32)
    _same(_quick(keys, (), "one_sort", block_threshold=64)[0], np.sort(keys))
    keys = _keys(400, np.uint32)
    _same(_quick(keys, (), "blocked", block_threshold=64)[0], np.sort(keys))


def test_bucket_ids_count_splitters_at_or_below():
    c = torch.tensor([-5, 0, 3, 3, 9, 100], dtype=torch.int32)
    spl = torch.tensor([0, 3, 50], dtype=torch.int32)
    b = tquick._bucket_ids(c, spl)
    assert b.dtype == torch.int16
    assert b.tolist() == [int((spl <= v).sum()) for v in c]


# ---------------------------------------------------------------------------
# quickseq, the host model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32,
                                   np.uint64, np.float64])
@pytest.mark.parametrize("dist", ["UNIFORM", "ZERO_ONE", "REVERSE_SORTED"])
def test_quickseq_matches_jax_sort_np(dtype, dist):
    keys = _keys(2000, dtype, dist)
    pays = tdata.make_payloads(keys, [np.uint32])
    for asc, thr in ((True, None), (False, 4)):
        kw = {} if thr is None else {"block_threshold": thr}
        got = tsrs.sort(keys, *pays, method="quickseq", ascending=asc,
                        device="cpu", **kw)
        want = jsrs.sort(keys, *pays, method="quickseq", ascending=asc, **kw)
        for g, w in zip(got, want):
            _same(g, w)
    want = jquick.sort_np(keys, *pays, threshold=7)
    got = tquick.sort_np(keys, *pays, threshold=7)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert tquick._median_of_9(keys.view(np.uint8), 3, 900) == \
        jquick._median_of_9(keys.view(np.uint8), 3, 900)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_resolve_new_methods_like_jax():
    from simd_radix_sort_tpu import methods as jmethods
    for name in ("rank", "quick", "quickseq"):
        t = tmethods.resolve(name, np.uint64, (np.uint64,), 4096)
        j = jmethods.resolve(name, np.uint64, (np.uint64,), 4096)
        assert t is tmethods.REGISTRY[name]
        assert (t.name, t.has_threshold, t.device) == \
            (j.name, j.has_threshold, j.device)
        assert name not in tmethods.NOT_YET_PORTED
    for n in (None, 0, 4096, 4097):
        assert tmethods._rank_supports(np.int32, (), n) == \
            jmethods._rank_supports(np.int32, (), n)
