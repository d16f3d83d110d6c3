"""Randomized differential fuzz of the port's distributed tier against the
JAX package's: distributed_sort, distributed_group_aggregate (a tuple of
aggregates) and distributed_join.

Counterpart of tests/test_fuzz_distributed.py, with its seeds (4000+,
4100+, 4200+), trial counts (6, 4, 3), dtypes and N = 8 x 512 rows.  One
spawn of four Gloo ranks runs every trial through the port on CPU tensors,
on the pair subgroup (P = 2) and on the world (P = 4)
(test_torch_dist_sort.run_ranks); each test holds one trial's results
against the JAX entry on a P-device mesh of conftest's virtual CPU
devices.  Each trial runs as drawn ("seeded") and with about one key in
eight replaced by the key dtype's special values ("special": NaN of either
sign, ±0.0, ±inf; `iinfo.min`, `iinfo.max`), drawn from a second generator
(`with_specials`, which test_torch_fuzz_operators.py shares; this module
imports no jax, since the ranks import it).

What must match, exactly: each rank's counts and overflow flag, its valid
key prefix byte for byte, the gathered keys, every aggregate (int64 sums,
counts and minima) and group key.  Both packages' local sorts are
unstable, so payloads are held by the key/payload pairing as a multiset,
and join rows as a multiset per rank.  Both are also held to the JAX
file's NumPy models over the keys' IEEE-754 totalOrder image
(`order_image`), the JAX package's order.
"""

import numpy as np
import pytest
import torch.distributed as dist

from simd_radix_sort_tpu_torch import parallel as tpar

from test_torch_dist_sort import SIZES, run_ranks, same_bytes, to_np

N = 8 * 512
KEY_DTYPES = [np.int32, np.uint32, np.int64, np.uint64, np.float32]
VARIANTS = ("seeded", "special")
SORT_TRIALS, AGG_TRIALS, JOIN_TRIALS = range(6), range(4), range(3)


def special_values(dtype) -> np.ndarray:
    """NaN of either sign, ±0.0 and ±inf for a float dtype; the extremes of
    an integer one."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        u = np.dtype(f"u{dt.itemsize}")
        top = 8 * dt.itemsize - 1
        nans = np.array([0x7FC << (top - 11), 0xFFC << (top - 11)] if
                        dt.itemsize == 4 else
                        [0x7FF8 << (top - 15), 0xFFF8 << (top - 15)],
                        dtype=u).view(dt)
        return np.concatenate([nans, np.array([0.0, -0.0, np.inf, -np.inf],
                                              dt)])
    info = np.iinfo(dt)
    return np.array([info.min, info.max], dt)


def with_specials(keys: np.ndarray, seed) -> np.ndarray:
    """A copy of `keys` with about one row in eight (at least one) set to
    one of the dtype's special values, drawn from its own generator."""
    rng = np.random.default_rng(seed)
    out = keys.copy()
    if out.size:
        sp = special_values(out.dtype)
        at = rng.choice(out.size, max(1, out.size // 8), replace=False)
        out[at] = sp[rng.integers(0, sp.size, at.size)]
    return out


def order_image(keys: np.ndarray) -> np.ndarray:
    """The keys' IEEE-754 totalOrder (integers: value order) as unsigned
    integers of the same width: equal images are one group, and their
    order is the sort's."""
    dt = keys.dtype
    u = np.dtype(f"u{dt.itemsize}")
    bits = keys.view(u)
    sign = u.type(1 << (8 * dt.itemsize - 1))
    if dt.kind == "u":
        return bits.copy()
    if dt.kind == "i":
        return bits ^ sign
    return np.where(bits & sign, ~bits, bits | sign)


def _keys(rng, dtype, n, card):
    base = rng.integers(0, card, n)
    if np.dtype(dtype).kind == "f":
        return ((base - card // 2) * 0.25).astype(dtype)
    lo = -(card // 2) if np.dtype(dtype).kind == "i" else 0
    return (base + lo).astype(dtype)


def _vary(keys, variant, seed):
    return keys if variant == "seeded" else with_specials(keys, seed)


def sort_data(trial, variant):
    rng = np.random.default_rng(4000 + trial)
    kdt = KEY_DTYPES[rng.integers(len(KEY_DTYPES))]
    card = int(rng.integers(2, 3 * N))
    ascending = bool(rng.integers(2))
    keys = _keys(rng, kdt, N, card)
    pay = rng.integers(0, 2**63, N).astype(np.uint64)
    return _vary(keys, variant, [4000 + trial, 1]), pay, ascending


def agg_data(trial, variant):
    rng = np.random.default_rng(4100 + trial)
    kdt = [np.int32, np.uint64][rng.integers(2)]
    card = int(rng.integers(2, 500))
    keys = _keys(rng, kdt, N, card)
    vals = rng.integers(1, 10_000, N).astype(np.int64)
    return _vary(keys, variant, [4100 + trial, 1]), vals


def join_data(trial, variant, size):
    rng = np.random.default_rng(4200 + trial)
    kdt = [np.int32, np.int64][rng.integers(2)]
    card = int(rng.integers(8, 300))
    n_p, n_b = 8 * 256, 8 * 64
    probe_k = _keys(rng, kdt, n_p, card)
    build_k = _keys(rng, kdt, n_b, card)
    probe_v = rng.integers(0, 2**31, n_p).astype(np.uint32)
    build_v = rng.integers(0, 2**31, n_b).astype(np.uint32)
    probe_k = _vary(probe_k, variant, [4200 + trial, 1])
    build_k = _vary(build_k, variant, [4200 + trial, 2])
    pi, bi = order_image(probe_k), order_image(build_k)
    want = sorted((int(a), int(pv), int(bv))
                  for a, pv in zip(pi, probe_v)
                  for b, bv in zip(bi, build_v) if a == b)
    # the JAX file's output capacity, its 8 devices now `size` ranks
    out_rows = max(64, 4 * (len(want) // size + 1))
    return probe_k, probe_v, build_k, build_v, out_rows, want


def port_cases(group):
    """Every trial through the port on this rank (runs in the ranks)."""
    res = {}
    kw = {"group": group, "device": "cpu"}
    for variant in VARIANTS:
        for trial in SORT_TRIALS:
            keys, pay, asc = sort_data(trial, variant)
            k, p, c, ov = tpar.distributed_sort(keys, pay, ascending=asc,
                                                **kw)
            gk, gp = tpar.gather_result(k, p, c, group)
            res["sort", trial, variant] = to_np((k, p, c, ov, gk, gp))
        for trial in AGG_TRIALS:
            keys, vals = agg_data(trial, variant)
            ng, gk, out = tpar.distributed_group_aggregate(
                keys, vals, agg=("sum", "count", "min"), **kw)
            res["agg", trial, variant] = (ng, to_np(gk), to_np(out))
        for trial in JOIN_TRIALS:
            pk, pv, bk, bv, out_rows, _ = join_data(
                trial, variant, dist.get_world_size(group))
            jc, jk, jp, jb, ov = tpar.distributed_join(
                pk, (pv,), bk, (bv,), capacity_factor=4.0,
                out_rows_per_device=out_rows, **kw)
            res["join", trial, variant] = to_np(
                (jc, jk, jp, jb, ov)
                + tpar.gather_joined(jc, jk, jp, jb, group))
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(port_cases, tmp_path_factory.mktemp("fuzz_dist"))


def _mesh(size):
    from simd_radix_sort_tpu.parallel import dist_sort as jds

    return jds.make_mesh(size)


def _slice(arr, r, size):
    arr = np.asarray(arr)
    per = arr.shape[0] // size
    return arr[r * per:(r + 1) * per]


def _pairs(k, p):
    """(key bits, payload) rows as a sorted multiset."""
    rows = np.stack([order_image(k).astype(np.uint64), p.astype(np.uint64)])
    return rows[:, np.lexsort(rows[::-1])]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("trial", SORT_TRIALS)
def test_distributed_sort_fuzz(port, trial, size, variant):
    from simd_radix_sort_tpu.parallel import dist_sort as jds

    keys, pay, asc = sort_data(trial, variant)
    jk, jp, jc, jov, meta = jds.distributed_sort(keys, pay, ascending=asc,
                                                 mesh=_mesh(size))
    jgk, (jgp,) = jds.gather_result(jk, jp, jc, meta)
    jc, jov = np.asarray(jc), np.asarray(jov)
    assert not jov.any(), (trial, variant)
    for r in range(size):
        k, (p,), c, ov, gk, (gp,) = port[size, r]["sort", trial, variant]
        assert np.array_equal(c, _slice(jc, r, size)), (r, c)
        assert int(ov[0]) == int(jov[r])
        n = int(c[0])
        same_bytes(k[:n], _slice(jk, r, size)[:n])
        assert np.array_equal(_pairs(k[:n], p[:n]),
                              _pairs(k[:n], _slice(jp[0], r, size)[:n]))
        same_bytes(gk, jgk)
        assert np.array_equal(_pairs(gk, gp), _pairs(jgk, jgp))
    # the JAX file's model, in totalOrder
    want = np.sort(order_image(keys))
    assert np.array_equal(order_image(jgk), want if asc else want[::-1])
    assert np.array_equal(_pairs(jgk, jgp), _pairs(keys, pay))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("trial", AGG_TRIALS)
def test_distributed_aggregate_fuzz(port, trial, size, variant):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    keys, vals = agg_data(trial, variant)
    jng, jgk, jres = jops.distributed_group_aggregate(
        keys, vals, agg=("sum", "count", "min"), mesh=_mesh(size))
    for r in range(size):
        ng, gk, res = port[size, r]["agg", trial, variant]
        assert ng == int(jng)
        same_bytes(gk, np.asarray(jgk))
        for g, w in zip(res, jres):
            same_bytes(g, np.asarray(w))
    img = order_image(keys)
    uniq = np.unique(img)
    assert int(jng) == len(uniq), (trial, variant)
    assert np.array_equal(order_image(np.asarray(jgk)), uniq)
    groups = [vals[img == u] for u in uniq]
    s, c, mn = (np.asarray(x) for x in jres)
    assert np.array_equal(s, [g.sum() for g in groups])
    assert np.array_equal(c, [len(g) for g in groups])
    assert np.array_equal(mn, [g.min() for g in groups])


def _join_rows(k, pv, bv, n):
    rows = np.stack([order_image(np.asarray(k)[:n]).astype(np.uint64),
                     np.asarray(pv)[:n].astype(np.uint64),
                     np.asarray(bv)[:n].astype(np.uint64)])
    return rows[:, np.lexsort(rows[::-1])]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("trial", JOIN_TRIALS)
def test_distributed_join_fuzz(port, trial, size, variant):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    pk, pv, bk, bv, out_rows, want = join_data(trial, variant, size)
    jc, jk, (ja,), (jb,), jov, _ = jops.distributed_join(
        pk, (pv,), bk, (bv,), mesh=_mesh(size), capacity_factor=4.0,
        out_rows_per_device=out_rows)
    jc, jov = np.asarray(jc), np.asarray(jov)
    assert not jov.any(), (trial, variant, len(want))
    for r in range(size):
        c, k, (a,), (b,), ov, gk, (ga,), (gb,) = \
            port[size, r]["join", trial, variant]
        n = int(c[0])
        assert n == int(jc[r]) and int(ov[0]) == int(jov[r])
        assert np.array_equal(
            _join_rows(k, a, b, n),
            _join_rows(_slice(jk, r, size), _slice(ja, r, size),
                       _slice(jb, r, size), n))
        assert np.array_equal(_join_rows(gk, ga, gb, gk.shape[0]),
                              np.array(want, np.uint64).reshape(-1, 3).T)
    jgk, (jga,), (jgb,) = jops.gather_joined(jc, jk, (ja,), (jb,))
    assert np.array_equal(_join_rows(jgk, jga, jgb, len(want)),
                          np.array(want, np.uint64).reshape(-1, 3).T)
