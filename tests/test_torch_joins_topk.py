"""The port's joins (ops/hashjoin) and top-k/unique (ops/topk) against the
JAX package's, on the CPU.

The same seeded NumPy inputs go through the JAX function and its port; the
port runs on CPU tensors, where semi_join's and unique's compactions run
K5's plain version (tests/test_torch_kernels_card.py holds K5 against that
on the card).
Every output here is an integer, a key or a moved payload, so all are
compared exactly.  Where the JAX package's own order rests on an unstable
sort (which of several equal build keys comes first), the rows are
compared as sets.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.ops import hashjoin as jhashjoin
from simd_radix_sort_tpu.ops import topk as jtopk
from simd_radix_sort_tpu.utils import transforms as jtransforms
from simd_radix_sort_tpu_torch.ops import hashjoin as thashjoin
from simd_radix_sort_tpu_torch.ops import topk as ttopk
from simd_radix_sort_tpu_torch.utils import interop, transforms


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy())
    return interop.from_numpy(a, "cpu")


def _np(t):
    if t.dtype in (torch.bool, torch.float32, torch.float64):
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
    if dtype.kind == "f":
        return rng.normal(0, 100, n).astype(dtype)
    return rng.integers(0, 256, n * dtype.itemsize,
                        dtype=np.uint8).view(dtype)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.uint64, np.float64])
def test_lookup_join_matches_jax(dtype):
    rng = np.random.default_rng(13)
    build = np.unique(rng.integers(0, 5000, 700)).astype(dtype)
    rng.shuffle(build)
    pay = [rng.integers(0, 2**32, len(build)).astype(np.uint32),
           rng.normal(size=len(build))]
    probe = rng.integers(0, 5000, 3000).astype(dtype)
    want = jhashjoin.lookup_join(jnp.asarray(probe), jnp.asarray(build),
                                 tuple(jnp.asarray(p) for p in pay))
    got = thashjoin.lookup_join(_t(probe), _t(build),
                                tuple(_t(p) for p in pay))
    _same(got[0], want[0])
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    hit = np.asarray(want[0])
    for g, w in zip(got[2], want[2]):
        assert np.array_equal(_np(g)[hit], np.asarray(w)[hit])
    # probes given as carriers
    got = thashjoin.lookup_join(transforms.to_sortable(_t(probe)),
                                _t(build), probe_is_transformed=True)
    _same(got[0], want[0])


def test_lookup_join_duplicate_build_keys():
    rng = np.random.default_rng(14)
    build = rng.integers(0, 50, 400).astype(np.int32)
    bpay = np.arange(400, dtype=np.int32)
    probe = rng.integers(0, 60, 900).astype(np.int32)
    want = jhashjoin.lookup_join(jnp.asarray(probe), jnp.asarray(build))
    found, counts, (first,) = thashjoin.lookup_join(_t(probe), _t(build),
                                                    (_t(bpay),))
    _same(found, want[0])
    assert np.array_equal(_np(counts), np.asarray(want[1]))
    hit = _np(found)
    # which duplicate is first rests on an unstable sort: check its key
    assert np.array_equal(build[_np(first)[hit]], probe[hit])


def _expand_rows(out, live):
    _, pidx, pk, pps, bps = out
    cols = [np.asarray(_np(c) if isinstance(c, torch.Tensor) else c)[:live]
            for c in (pidx, pk, *pps, *bps)]
    return sorted(zip(*(c.tolist() for c in cols)))


@pytest.mark.parametrize("capacity", [16, 400, 5000])
def test_inner_join_expand_matches_jax(capacity):
    rng = np.random.default_rng(15)
    probe = rng.integers(0, 40, 300).astype(np.int64)
    ppay = rng.integers(0, 2**31, 300).astype(np.int32)
    build = rng.integers(0, 50, 200).astype(np.int64)
    bpay = np.arange(200, dtype=np.uint32) * 3
    want = jhashjoin.inner_join_expand(
        jnp.asarray(probe), (jnp.asarray(ppay),), jnp.asarray(build),
        (jnp.asarray(bpay),), capacity)
    got = thashjoin.inner_join_expand(_t(probe), (_t(ppay),), _t(build),
                                      (_t(bpay),), capacity)
    assert got[0].dtype == torch.int32
    assert int(got[0]) == int(want[0]) == sum(
        int((build == k).sum()) for k in probe)
    # the probe side is fully determined (truncation included); the build
    # rows of one key come in the order of an unstable sort, so the output
    # rows are compared as a set
    for g, w in zip((got[1], got[2], got[3][0]),
                    (want[1], want[2], want[3][0])):
        assert np.array_equal(_np(g), np.asarray(w))
    live = min(int(got[0]), capacity)
    assert _expand_rows(got, live) == _expand_rows(want, live)


def test_inner_join_expand_empty_sides():
    """An empty side gives no matches (the JAX package's take refuses an
    empty build side, so there is nothing to compare with)."""
    k = np.array([1, 2], np.int32)
    e = np.zeros(0, np.int32)
    for probe, build in ((k, e), (e, k)):
        out = thashjoin.inner_join_expand(_t(probe), (), _t(build),
                                          (_t(build),), 4)
        assert int(out[0]) == 0
        assert [t.shape for t in (out[1], out[2], out[4][0])] == [(4,)] * 3


@pytest.mark.parametrize("anti", [False, True])
def test_semi_join_matches_jax(anti):
    rng = np.random.default_rng(16)
    probe = rng.integers(0, 1000, 2500).astype(np.uint32)
    pays = [rng.normal(size=2500), rng.integers(0, 9, 2500).astype(np.int8)]
    build = rng.integers(0, 1000, 600).astype(np.uint32)
    want = jhashjoin.semi_join(jnp.asarray(probe),
                               tuple(jnp.asarray(p) for p in pays),
                               jnp.asarray(build), anti=anti)
    got = thashjoin.semi_join(_t(probe), tuple(_t(p) for p in pays),
                              _t(build), anti=anti)
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)


def _jops(arr):
    """The JAX package's operands: u32 words of the unsigned sortable."""
    u = jtransforms.to_sortable_np(arr, True)
    if u.dtype == np.uint64:
        return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
                jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    return (jnp.asarray(u),)


def _tops(arr):
    """The port's operands: one signed carrier word."""
    return (transforms.to_sortable(_t(arr)),)


def _merge_parity(pk, pv, bk, bv, cap, mask=False):
    """merge_join_indices in both packages (the JAX one compiled once, as
    its eager form compiles every primitive on its own); all three
    outputs equal, padding slots included."""
    jp, jb = (jnp.asarray(pv), jnp.asarray(bv)) if mask else (pv, bv)
    tp, tb = (_t(pv), _t(bv)) if mask else (pv, bv)
    want = jax.jit(functools.partial(jhashjoin.merge_join_indices,
                                     capacity=cap))(_jops(pk), jp,
                                                    _jops(bk), jb)
    got = thashjoin.merge_join_indices(_tops(pk), tp, _tops(bk), tb, cap)
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)
    return int(got[0])


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int64,
                                   np.float64])
def test_merge_join_indices_matches_jax(dtype):
    rng = np.random.default_rng(50)
    pk = rng.integers(0, 40, 344).astype(dtype)
    bk = rng.integers(0, 40, 256).astype(dtype)
    if dtype == np.uint64:  # keys that differ only in the high word
        pk, bk = pk << np.uint64(40), bk << np.uint64(40)
    total = _merge_parity(pk, 300, bk, 200, 8192)
    assert total == sum(int((bk[:200] == k).sum()) for k in pk[:300])


def test_merge_join_indices_bool_masks_and_int_mask():
    rng = np.random.default_rng(51)
    pk = rng.integers(0, 30, 256).astype(np.uint64)
    bk = rng.integers(0, 30, 128).astype(np.uint64)
    pm = rng.integers(0, 2, 256) == 1
    bm = rng.integers(0, 3, 128) > 0
    _merge_parity(pk, pm, bk, bm, 4096, mask=True)
    ops = _tops(np.zeros(4, np.uint32))
    with pytest.raises(TypeError, match="boolean"):
        thashjoin.merge_join_indices(ops, torch.ones(4, dtype=torch.int32),
                                     ops, torch.ones(4, dtype=torch.int32),
                                     8)


def test_merge_join_indices_empty_and_truncated():
    e = np.zeros(0, np.uint32)
    got = thashjoin.merge_join_indices(_tops(e), 0, _tops(e), 0, 8)
    assert int(got[0]) == 0 and got[1].shape == (8,)
    assert not got[1].any() and not got[2].any()
    z = np.zeros(64, np.uint32)
    assert _merge_parity(z, 64, z, 64, 100) == 64 * 64
    assert _merge_parity(z, 64, e, 0, 10) == 0
    assert _merge_parity(e, 0, z, 64, 10) == 0


def test_saturating_cumsum_matches_jax():
    for c in (np.array([0, 3, 1, 0, 7, 2], np.int32),
              np.array([5, 2**30, 2**30, 3], np.int32),
              np.array([2**31 - 1, 0, 1], np.int32)):
        with jax.enable_x64(False):
            want = np.asarray(jhashjoin._saturating_cumsum(jnp.asarray(c)))
        got = thashjoin._saturating_cumsum(_t(c))
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), want)
    assert thashjoin._SAT32 == jhashjoin._SAT32


# ---------------------------------------------------------------------------
# top_k and unique
# ---------------------------------------------------------------------------


def _topk_parity(keys, pays, k, largest):
    want = jtopk.top_k(jnp.asarray(keys), *(jnp.asarray(p) for p in pays),
                       k=k, largest=largest)
    got = ttopk.top_k(_t(keys), *(_t(p) for p in pays), k=k,
                      largest=largest)
    for g, w in zip(got, want):
        _same(g, w)
    return got


def test_top_k_ties_by_position():
    keys = np.array([5, 5, 1, 5, 1], np.int32)
    pos = np.arange(5, dtype=np.int32)
    _, idx = _topk_parity(keys, [pos], 3, True)
    assert _np(idx).tolist() == [0, 1, 3]
    _, idx = _topk_parity(keys, [pos], 3, False)
    assert _np(idx).tolist() == [2, 4, 0]


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [np.int8, np.uint16, np.int32,
                                   np.float32])
def test_top_k_narrow_keys_match_jax(dtype, largest):
    rng = np.random.default_rng(21)
    keys = _values(rng, 5000, dtype)
    keys[::7] = keys[3]  # many ties
    pos = np.arange(5000, dtype=np.int32)
    for k in (1, 17, 500, 5000):
        _topk_parity(keys, [pos], k, largest)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_top_k_64bit_keys_match_jax(dtype, largest):
    """n > 8192 with small k is the JAX package's blocked selection; 2k >=
    the block is its single-sort fallback.  Ties straddle its blocks."""
    rng = np.random.default_rng(23)
    n = 20000
    hi = rng.integers(0, 64, n, dtype=np.uint64) << np.uint64(32)
    keys = (hi | rng.integers(0, 16, n, dtype=np.uint64)).view(dtype)
    pay = rng.integers(0, 2**63, n, dtype=np.uint64)
    for k in (1, 33, 9000):
        _topk_parity(keys, [pay], k, largest)
    with pytest.raises(ValueError):
        ttopk.top_k(_t(keys[:3]), k=5)


@pytest.mark.parametrize("dtype", [np.int32, np.uint64, np.float64,
                                   np.uint8])
def test_unique_matches_jax(dtype):
    rng = np.random.default_rng(31)
    keys = _values(rng, 3000, dtype)
    keys[::3] = keys[1]
    if dtype == np.float64:
        keys[5], keys[6] = 0.0, -0.0
    pays = [np.arange(3000, dtype=np.uint32),
            rng.normal(size=3000).astype(np.float32)]
    want = jtopk.unique(jnp.asarray(keys), *(jnp.asarray(p) for p in pays))
    got = ttopk.unique(_t(keys), *(_t(p) for p in pays))
    assert got[0].dtype == torch.int32
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)


def test_unique_all_same_and_empty():
    keys = np.full(100, 7, dtype=np.uint8)
    count, ku, mult = ttopk.unique(_t(keys))
    want = jtopk.unique(jnp.asarray(keys))
    assert int(count) == 1 and _np(ku)[0] == 7 and _np(mult)[0] == 100
    _same(mult, want[2])
    count, ku, mult = ttopk.unique(_t(np.zeros(0, np.int32)))
    assert int(count) == 0 and ku.shape == (0,) and mult.shape == (0,)
