"""The port's distributed operators (simd_radix_sort_tpu_torch/parallel/
dist_ops.py) against the JAX package's, for P = 2 and P = 4 ranks.

The harness is test_torch_dist_sort.py's: one spawn of four Gloo ranks per
module runs every case through the port on CPU tensors (P = 2 on ranks 0-1,
then P = 4), and each parametrised test holds one case's results against
the JAX package's same entry on `make_mesh(P)` of the virtual CPU mesh.

What must match: filter counts and packed rows exactly per rank (the
compaction is stable); aggregates on every rank: the group count and keys
byte for byte, integers and min/max exactly, float sums and means to
RTOL = 1e-12 relative to the group's sum (or mean) of magnitudes (the two
packages add in another order: an associative-scan tree against a doubling
scan); joins per rank: count and overflow exactly, the output rows as a
multiset, the hot statistics exactly; top_k and unique exactly.
"""

import numpy as np
import pytest

from simd_radix_sort_tpu_torch import parallel as tpar

from test_torch_dist_sort import SIZES, run_ranks, same_bytes, to_np

RTOL = 1e-12
N = 8192


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# cases: name -> inputs (made from a seed, the same in the ranks and here)
# ---------------------------------------------------------------------------

# name -> (keys, payload dtypes, predicate, whether the port is given the
# predicate's global mask instead of the callable; the JAX package always
# gets the callable)
FILTER_CASES = {
    "int32 k%3==0 +float64,uint16": (
        lambda: _rng(1).integers(-1000, 1000, N).astype(np.int32),
        (np.float64, np.uint16), lambda k: k % 3 == 0, False),
    "float32 k>0.25 +int64": (
        lambda: _rng(2).uniform(-1, 1, N).astype(np.float32), (np.int64,),
        lambda k: k > 0.25, False),
    "int32 global mask k%3==0 +float64,uint16": (
        lambda: _rng(1).integers(-1000, 1000, N).astype(np.int32),
        (np.float64, np.uint16), lambda k: k % 3 == 0, True),
}


def _filter_data(name):
    make, pdts, pred, _ = FILTER_CASES[name]
    keys = make()
    rng = _rng(3)
    pays = tuple(rng.integers(0, 1 << 15, N).astype(d) for d in pdts)
    return keys, pays, pred


def _agg_data(name):
    rng = _rng(10)
    if name == "int32 keys float64 sum,mean,count":
        return (rng.integers(0, 100, N).astype(np.int32),
                rng.normal(0, 10, N), ("sum", "mean", "count"))
    if name == "int32 keys int64 min,max":
        return (rng.integers(0, 300, N).astype(np.int32),
                rng.integers(-2**40, 2**40, N), ("min", "max"))
    if name == "float64 keys -0.0 float32 min,max,count":
        vals = np.array([1.5, -0.0, 0.0, -2.25, 7.0, np.inf, -np.inf])
        return (rng.choice(vals, N), rng.normal(0, 1, N).astype(np.float32),
                ("min", "max", "count"))
    if name == "uint64 keys int64 sum":
        keys = rng.integers(0, 2**64, 50, dtype=np.uint64)[
            rng.integers(0, 50, N)]
        return keys, rng.integers(-2**62, 2**62, N), "sum"
    if name == "uint32 keys uint32 sum,mean":
        return (rng.integers(0, N // 2, N).astype(np.uint32),
                rng.integers(0, 2**32, N, dtype=np.uint32), ("sum", "mean"))
    if name == "one key float64 mean":
        # every partial lands on one rank: the others receive nothing
        return np.full(N, 5, np.int16), rng.normal(0, 1, N), "mean"
    raise KeyError(name)


AGG_CASES = ("int32 keys float64 sum,mean,count", "int32 keys int64 min,max",
             "float64 keys -0.0 float32 min,max,count",
             "uint64 keys int64 sum", "uint32 keys uint32 sum,mean",
             "one key float64 mean")


def _join_data(name):
    rng = _rng(20)
    nb = 2048
    if name == "uniform int32":
        pk = rng.integers(0, nb, N).astype(np.int32)
        bk = rng.permutation(nb).astype(np.int32)
        opts = {}
    elif name == "hot key on 60% int64":
        pk = rng.integers(0, nb, N)
        pk[rng.random(N) < 0.6] = 77
        bk = rng.permutation(nb)
        opts = {"return_hot_stats": True}
    elif name == "hot key on a quarter, min count 16":
        pk = rng.integers(0, nb, N).astype(np.int32)
        pk[rng.random(N) < 0.25] = 1234
        bk = rng.permutation(nb).astype(np.int32)
        opts = {"return_hot_stats": True, "hot_min_count": 16}
    elif name == "many-to-many uint64, no hot path":
        keys = rng.integers(0, 2**64, 300, dtype=np.uint64)
        pk = keys[rng.integers(0, 300, N)]
        bk = keys[rng.integers(0, 300, nb)]
        opts = {"hot_keys": 0, "out_rows_per_device": 16 * N}
    else:
        raise KeyError(name)
    pp = (np.arange(N, dtype=np.int64), rng.normal(0, 1, N))
    bp = (np.arange(nb, dtype=np.uint16),)
    return pk, pp, bk, bp, opts


JOIN_CASES = ("uniform int32", "hot key on 60% int64",
              "hot key on a quarter, min count 16",
              "many-to-many uint64, no hot path")


def _topk_data(name):
    rng = _rng(30)
    if name == "int32 ties largest k=37":
        return rng.integers(0, 50, N).astype(np.int32), 37, True
    if name == "int32 ties smallest k=50":
        return rng.integers(0, 50, N).astype(np.int32), 50, False
    if name == "float64 k=20":
        return rng.normal(0, 1, N), 20, True
    if name == "uint64 smallest k=20":
        return rng.integers(0, 2**64, N, dtype=np.uint64), 20, False
    raise KeyError(name)


TOPK_CASES = ("int32 ties largest k=37", "int32 ties smallest k=50",
              "float64 k=20", "uint64 smallest k=20")


def _unique_data(name):
    rng = _rng(40)
    if name == "int32":
        return rng.integers(0, 700, N).astype(np.int32)
    return rng.choice(np.array([0.0, -0.0, 1.0, -1.0, 2.5], np.float32), N)


UNIQUE_CASES = ("int32", "float32 -0.0")


def port_cases(group):
    """Every case through the port on this rank (runs in the ranks)."""
    res = {}
    for name in FILTER_CASES:
        keys, pays, pred = _filter_data(name)
        if FILTER_CASES[name][3]:
            pred = pred(keys)
        c, k, p = tpar.distributed_filter(pred, keys, *pays, group=group,
                                          device="cpu")
        res["filter", name] = to_np((c, k, p)
                                    + tpar.gather_filtered(c, k, p, group))
    for name in AGG_CASES:
        keys, vals, agg = _agg_data(name)
        ng, gk, out = tpar.distributed_group_aggregate(
            keys, vals, agg, group=group, device="cpu")
        res["agg", name] = (ng, to_np(gk), to_np(out))
    for name in JOIN_CASES:
        pk, pp, bk, bp, opts = _join_data(name)
        out = tpar.distributed_join(pk, pp, bk, bp, group=group, device="cpu",
                                    **opts)
        gathered = tpar.gather_joined(out[0], out[1], out[2], out[3], group)
        res["join", name] = to_np(out + gathered)
    for name in TOPK_CASES:
        keys, k, largest = _topk_data(name)
        res["topk", name] = to_np(tpar.distributed_top_k(
            keys, np.arange(N, dtype=np.int32), k=k, largest=largest,
            group=group, device="cpu"))
    for name in UNIQUE_CASES:
        ng, gk, cnt = tpar.distributed_unique(_unique_data(name), group=group,
                                              device="cpu")
        res["unique", name] = (ng, to_np(gk), to_np(cnt))
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(port_cases, tmp_path_factory.mktemp("dist_ops"))


def _mesh(size):
    from simd_radix_sort_tpu.parallel import dist_sort as jds
    return jds.make_mesh(size)


def _slice(arr, r, size):
    per = np.asarray(arr).shape[0] // size
    return np.asarray(arr)[r * per:(r + 1) * per]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_distributed_filter_matches_jax(port, name, size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    keys, pays, pred = _filter_data(name)
    jc, jk, jp = jops.distributed_filter(pred, keys, *pays, mesh=_mesh(size))
    jgk, jgp = jops.gather_filtered(jc, jk, jp)
    for r in range(size):
        c, k, p, gk, gp = port[size, r]["filter", name]
        n = int(c[0])
        assert n == int(np.asarray(jc)[r])
        same_bytes(k[:n], _slice(jk, r, size)[:n])
        for a, b in zip(p, jp):
            same_bytes(a[:n], _slice(b, r, size)[:n])
        same_bytes(gk, jgk)
        for a, b in zip(gp, jgp):
            same_bytes(a, b)


def _group_scale(keys, vals, gk, mean):
    """Each group's sum (or mean) of magnitudes, in group-key order."""
    order = {k: i for i, k in enumerate(gk.view(f"u{gk.dtype.itemsize}"))}
    idx = np.array([order[k] for k in keys.view(f"u{keys.dtype.itemsize}")])
    mag = np.zeros(len(gk))
    np.add.at(mag, idx, np.abs(vals.astype(np.float64)))
    if mean:
        mag /= np.bincount(idx, minlength=len(gk))
    return mag


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", AGG_CASES)
def test_distributed_group_aggregate_matches_jax(port, name, size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    keys, vals, agg = _agg_data(name)
    jng, jgk, jout = jops.distributed_group_aggregate(keys, vals, agg,
                                                      mesh=_mesh(size))
    aggs = (agg,) if isinstance(agg, str) else agg
    jout = (jout,) if isinstance(agg, str) else jout
    for r in range(size):
        ng, gk, out = port[size, r]["agg", name]
        out = (out,) if isinstance(agg, str) else out
        assert ng == jng
        same_bytes(gk, jgk)
        for a, got, want in zip(aggs, out, jout):
            want = np.asarray(want)
            if got.dtype.kind == "f" and a in ("sum", "mean"):
                assert got.dtype == want.dtype
                scale = _group_scale(keys, vals, gk, a == "mean")
                assert np.all(np.abs(got - want) <= RTOL * scale), a
            else:
                same_bytes(got, want)


def _join_rows(k, pp, bp, n):
    cols = [k[:n]] + [x[:n] for x in pp] + [x[:n] for x in bp]
    mat = np.stack([x.view(f"u{x.dtype.itemsize}").astype(np.uint64)
                    for x in cols], 1)
    return mat[np.lexsort(mat.T[::-1])]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", JOIN_CASES)
def test_distributed_join_matches_jax(port, name, size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    pk, pp, bk, bp, opts = _join_data(name)
    jout = jops.distributed_join(pk, pp, bk, bp, mesh=_mesh(size), **opts)
    jc, jk, jpp, jbp, jov = jout[:5]
    jg = jops.gather_joined(jc, jk, jpp, jbp)
    for r in range(size):
        got = port[size, r]["join", name]
        c, k, p_out, b_out, ov = got[:5]
        n = int(c[0])
        assert n == int(np.asarray(jc)[r])
        assert int(ov[0]) == int(np.asarray(jov)[r])
        assert np.array_equal(
            _join_rows(k, p_out, b_out, n),
            _join_rows(_slice(jk, r, size), [_slice(x, r, size) for x in jpp],
                       [_slice(x, r, size) for x in jbp], n))
        gk, gpp, gbp = got[-3:]
        assert np.array_equal(_join_rows(gk, gpp, gbp, gk.shape[0]),
                              _join_rows(jg[0], jg[1], jg[2], jg[0].shape[0]))
        if opts.get("return_hot_stats"):
            stats = got[5]
            for key, want in jout[5].items():
                assert np.array_equal(stats[key][0], _slice(want, r, size)[0])
    if name.startswith("hot key"):
        assert int(np.asarray(jout[5]["hot_key_slots_flagged"])[0]) >= 1
    assert int(np.asarray(jov).max()) == 0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", TOPK_CASES)
def test_distributed_top_k_matches_jax(port, name, size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    keys, k, largest = _topk_data(name)
    want = jops.distributed_top_k(keys, np.arange(N, dtype=np.int32), k=k,
                                  largest=largest, mesh=_mesh(size))
    for r in range(size):
        for got, w in zip(port[size, r]["topk", name], want):
            same_bytes(got, w)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", UNIQUE_CASES)
def test_distributed_unique_matches_jax(port, name, size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    jng, jgk, jcnt = jops.distributed_unique(_unique_data(name),
                                             mesh=_mesh(size))
    for r in range(size):
        ng, gk, cnt = port[size, r]["unique", name]
        assert ng == jng
        same_bytes(gk, jgk)
        same_bytes(cnt, jcnt)
