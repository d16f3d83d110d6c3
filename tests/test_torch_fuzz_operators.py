"""Randomized differential fuzz of the port's operators against the JAX
package's: group_aggregate, inner_join_expand, top_k and unique.

Counterpart of tests/test_fuzz_operators.py, with its seeds (7000+, 8000+,
9000+), trial counts (12, 8, 8), dtypes and shapes: each trial draws its
workload exactly as the JAX file does, and the same NumPy inputs go
through the JAX function (under `jax.jit`: eager, its scans compile every
primitive apart) and through the port on CPU tensors.  Each trial runs
twice: as drawn ("seeded"), and with about one key in eight replaced by the
key dtype's special values ("special": NaN of either sign, -0.0, +0.0,
-inf, +inf for floats; `iinfo.min` and `iinfo.max` for integers), drawn
from a second generator so that the seeded draws stay the JAX file's
(test_torch_fuzz_distributed.with_specials).

What must match: every key, index, count, min/max and integer aggregate
byte for byte.  Float sums and means add in another order in the two
packages (the JAX associative-scan tree, the port's doubling scan); the
trials' float values are float32, so they are held to 1e-5 of the group's
sum of magnitudes (float32's rounding scale, as test_torch_operators.py
holds them).  Where the JAX package's order rests on an unstable sort
(which of a key's build rows comes first), join rows are compared as a
multiset.  Both packages are also held to the JAX file's NumPy models,
taken over the keys' IEEE-754 totalOrder image
(test_torch_fuzz_distributed.order_image): that is the JAX package's
documented grouping and order, so -0.0 groups apart from +0.0 and each NaN
by its sign (a plain `np.unique` would merge both pairs).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.ops import hashagg as jhashagg
from simd_radix_sort_tpu.ops import hashjoin as jhashjoin
from simd_radix_sort_tpu.ops import topk as jtopk
from simd_radix_sort_tpu_torch.ops import hashagg as thashagg
from simd_radix_sort_tpu_torch.ops import hashjoin as thashjoin
from simd_radix_sort_tpu_torch.ops import topk as ttopk
from simd_radix_sort_tpu_torch.utils import interop

from test_torch_fuzz_distributed import order_image, with_specials

KEY_DTYPES = [np.int8, np.uint16, np.int32, np.uint32, np.int64, np.uint64,
              np.float32, np.float64]
VAL_DTYPES = [np.int32, np.uint32, np.int64, np.float32]
AGG_SETS = [("sum",), ("count",), ("min", "max"), ("sum", "count", "mean"),
            ("max", "sum", "min", "count", "mean")]
VARIANTS = ("seeded", "special")
FLOAT_RTOL = 1e-5  # float32 sums, relative to the group's magnitude sum


def _rand_keys(rng, dtype, n, card):
    base = rng.integers(0, card, n)
    if np.dtype(dtype).kind == "f":
        return ((base - card // 2) * 0.5).astype(dtype)
    info = np.iinfo(dtype)
    lo = max(info.min, -(card // 2)) if info.min < 0 else 0
    return (base + lo).astype(dtype)


def _t(a):
    return interop.from_numpy(np.ascontiguousarray(a), "cpu")


def _np(t):
    if t.dtype in (torch.bool, torch.float32, torch.float64):
        return t.numpy()
    return interop.to_numpy(t)


def _same(got, want):
    """Equal dtype, shape and bytes."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _variant_keys(keys, variant, seed):
    return keys if variant == "seeded" else with_specials(keys, seed)


# ---------------------------------------------------------------------------
# group_aggregate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("trial", range(12))
def test_group_aggregate_fuzz(trial, variant):
    rng = np.random.default_rng(7000 + trial)
    kdt = KEY_DTYPES[rng.integers(len(KEY_DTYPES))]
    vdt = VAL_DTYPES[rng.integers(len(VAL_DTYPES))]
    aggs = AGG_SETS[rng.integers(len(AGG_SETS))]
    n = int(rng.integers(1, 5000))
    card = int(rng.integers(1, 300))
    keys = _rand_keys(rng, kdt, n, card)
    if np.dtype(vdt).kind == "f":
        vals = rng.normal(0, 100, n).astype(vdt)
    else:
        vals = rng.integers(1, 1000, n).astype(vdt)
    keys = _variant_keys(keys, variant, [7000 + trial, 1])

    jng, jgk, jres = _jit(jhashagg.group_aggregate, aggs=aggs)(
        jnp.asarray(keys), jnp.asarray(vals))
    tng, tgk, tres = thashagg.group_aggregate(_t(keys), _t(vals), aggs=aggs)
    ng = int(jng)
    assert int(tng) == ng, (trial, variant, kdt, aggs)
    _same(_np(tgk)[:ng], np.asarray(jgk)[:ng])

    # the NumPy model, on the totalOrder image of the keys
    img = order_image(keys)
    order = np.argsort(img, kind="stable")
    uniq, starts = np.unique(img[order], return_index=True)
    assert ng == len(uniq), (trial, variant, kdt, aggs)
    assert np.array_equal(order_image(np.asarray(jgk)[:ng]), uniq)
    groups = np.split(vals[order], starts[1:])
    absum = np.array([np.abs(g.astype(np.float64)).sum() for g in groups])

    for agg, t, j in zip(aggs, tres, jres):
        if agg == "count":
            _same(_np(t)[:ng], np.asarray(j)[:ng])
            assert np.array_equal(np.asarray(j)[:ng],
                                  [len(g) for g in groups]), (trial, agg)
            continue
        got, want = _np(t[0])[:ng], np.asarray(j[0])[:ng]
        if agg in ("sum", "mean") and np.dtype(vdt).kind == "f":
            assert got.dtype == want.dtype
            scale = absum / (np.array([len(g) for g in groups])
                             if agg == "mean" else 1)
            err = np.abs(got.astype(np.float64) - want.astype(np.float64))
            assert np.all(err <= FLOAT_RTOL * (scale + 1e-30)), (
                trial, variant, agg, err.max())
            model = [g.astype(np.float64).sum() if agg == "sum"
                     else g.astype(np.float64).mean() for g in groups]
            np.testing.assert_allclose(want, model, rtol=1e-4)
            continue
        _same(got, want)
        if agg == "sum":
            assert np.array_equal(want, np.array([g.sum() for g in groups])
                                  .astype(vdt)), (trial, agg)
        elif agg == "mean":
            assert np.array_equal(
                want.astype(np.int64),
                [int(g.astype(np.int64).sum()) // len(g) for g in groups])
        else:
            op = np.min if agg == "min" else np.max
            assert np.array_equal(want, [op(g) for g in groups]), (trial, agg)


# ---------------------------------------------------------------------------
# inner_join_expand
# ---------------------------------------------------------------------------


def _join_rows(out, live):
    """(probe key bits, probe payload, build payload) rows, sorted."""
    _, _, pk, (pv,), (bv,) = out
    cols = [np.asarray(_np(c) if isinstance(c, torch.Tensor) else c)[:live]
            for c in (pk, pv, bv)]
    cols[0] = order_image(cols[0])
    return sorted(zip(*(c.tolist() for c in cols)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("trial", range(8))
def test_inner_join_fuzz(trial, variant):
    rng = np.random.default_rng(8000 + trial)
    kdt = [np.int32, np.uint64, np.int64][rng.integers(3)]
    np_ = int(rng.integers(1, 2000))
    nb = int(rng.integers(1, 800))
    card = int(rng.integers(1, 200))
    probe_k = _rand_keys(rng, kdt, np_, card)
    build_k = _rand_keys(rng, kdt, nb, card)
    probe_v = rng.integers(0, 2**31, np_).astype(np.int32)
    build_v = rng.integers(0, 2**31, nb).astype(np.int32)
    probe_k = _variant_keys(probe_k, variant, [8000 + trial, 1])
    build_k = _variant_keys(build_k, variant, [8000 + trial, 2])

    pi, bi = order_image(probe_k), order_image(build_k)
    want = sorted((int(a), int(pv), int(bv))
                  for a, pv in zip(pi, probe_v)
                  for b, bv in zip(bi, build_v) if a == b)
    cap = max(len(want), 1)
    jout = _jit(jhashjoin.inner_join_expand, capacity=cap)(
        jnp.asarray(probe_k), (jnp.asarray(probe_v),),
        jnp.asarray(build_k), (jnp.asarray(build_v),))
    tout = thashjoin.inner_join_expand(_t(probe_k), (_t(probe_v),),
                                       _t(build_k), (_t(build_v),), cap)
    total = int(jout[0])
    assert int(tout[0]) == total == len(want), (trial, variant, kdt, card)
    # the probe side is determined; a key's build rows follow an unstable
    # sort in both packages
    for g, w in zip((tout[1], tout[2], tout[3][0]),
                    (jout[1], jout[2], jout[3][0])):
        _same(_np(g)[:total], np.asarray(w)[:total])
    assert _join_rows(tout, total) == _join_rows(jout, total) == want


# ---------------------------------------------------------------------------
# top_k and unique
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("trial", range(8))
def test_topk_unique_fuzz(trial, variant):
    rng = np.random.default_rng(9000 + trial)
    kdt = [np.int16, np.uint32, np.int64, np.float32][rng.integers(4)]
    n = int(rng.integers(1, 30_000))
    card = int(rng.integers(1, 500))
    keys = _rand_keys(rng, kdt, n, card)
    pay = rng.integers(0, 2**31, n).astype(np.uint32)
    k = int(rng.integers(1, n + 1))
    largest = bool(rng.integers(2))
    keys = _variant_keys(keys, variant, [9000 + trial, 1])

    jk, jp = _jit(jtopk.top_k, k=k, largest=largest)(jnp.asarray(keys),
                                                      jnp.asarray(pay))
    tk, tp = ttopk.top_k(_t(keys), _t(pay), k=k, largest=largest)
    _same(tk, jk)
    _same(tp, jp)
    # model: best-first by the totalOrder image, ties by position
    img = order_image(keys)
    idx = np.lexsort((np.arange(n), ~img if largest else img))[:k]
    _same(jk, keys[idx])
    _same(jp, pay[idx])

    jc, jku, jm = _jit(jtopk.unique)(jnp.asarray(keys))
    tc, tku, tm = ttopk.unique(_t(keys))
    c = int(jc)
    assert int(tc) == c, (trial, variant)
    _same(tku, jku)
    _same(tm, jm)
    uniq, counts = np.unique(img, return_counts=True)
    assert c == len(uniq)
    assert np.array_equal(order_image(np.asarray(jku)[:c]), uniq)
    assert np.array_equal(np.asarray(jm)[:c], counts)
