"""The port's distributed sort (simd_radix_sort_tpu_torch/parallel/
dist_sort.py) against the JAX package's, for P = 2 and P = 4 ranks.

One spawn of four Gloo ranks per module (a file store, the spawn start
method) runs every case through the port on CPU tensors: P = 2 on the
subgroup of ranks 0-1, then P = 4 on the world.  Each rank writes its
results to a file; each parametrised test then holds one case's results
against the JAX package's same entry on `make_mesh(P)` of conftest's 8
virtual CPU devices.  The ranks never import jax: this module imports it
only inside the reference helpers, which run in the test process.

What must match (no tolerance: every value here is exact): each rank's
counts and overflow flag equal the JAX device's; each rank's valid key
prefix byte for byte; payloads by the key-seeded oracle
(`utils/data.check_payloads`), since both packages' local sorts are
unstable; the gathered table's keys equal the JAX `gather_result`'s byte
for byte.  `distributed_sort_multi` carries a row-number payload, so its
rows are compared as a multiset per rank.
"""

import datetime
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from simd_radix_sort_tpu_torch import parallel as tpar
from simd_radix_sort_tpu_torch.utils import data as D
from simd_radix_sort_tpu_torch.utils import interop

WORLD = 4
SIZES = (2, 4)


# ---------------------------------------------------------------------------
# the spawn harness (test_torch_dist_ops.py uses it too)
# ---------------------------------------------------------------------------


def _rank_main(rank, store, out_dir, cases_fn):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        pair = dist.new_group([0, 1])
        for size, group in ((2, pair), (4, dist.group.WORLD)):
            if rank < size:
                res = cases_fn(group)
                with open(f"{out_dir}/P{size}_r{rank}.pkl", "wb") as f:
                    pickle.dump(res, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(cases_fn, tmp_dir):
    """Run `cases_fn(group) -> {case: result}` (a module-level function) on
    P = 2 and P = 4 Gloo ranks.  Returns {(P, rank): {case: result}}."""
    mp.start_processes(_rank_main,
                       args=(str(tmp_dir / "store"), str(tmp_dir), cases_fn),
                       nprocs=WORLD, join=True, start_method="spawn")
    out = {}
    for size in SIZES:
        for r in range(size):
            with open(tmp_dir / f"P{size}_r{r}.pkl", "rb") as f:
                out[size, r] = pickle.load(f)
    return out


def to_np(t):
    """A tensor (or a nested tuple of them) as NumPy, bits kept."""
    if isinstance(t, (tuple, list)):
        return tuple(to_np(x) for x in t)
    if isinstance(t, dict):
        return {k: to_np(v) for k, v in t.items()}
    if t.dtype == torch.bool:
        return t.numpy()
    return interop.to_numpy(t)


def same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

U = D.Distribution
# name -> (key dtype, payload dtypes, distribution, n, options)
SORT_CASES = {
    "uint32+uint32": (np.uint32, (np.uint32,), U.UNIFORM, 8192, {}),
    "int32": (np.int32, (), U.UNIFORM, 8192, {}),
    "float32+uint64 gaussian": (np.float32, (np.uint64,), U.GAUSSIAN, 8192,
                                {}),
    "uint64+uint64": (np.uint64, (np.uint64,), U.UNIFORM, 16384, {}),
    "float64+float64": (np.float64, (np.float64,), U.UNIFORM, 8192, {}),
    "int64 desc+uint64,uint8": (np.int64, (np.uint64, np.uint8), U.GAUSSIAN,
                                8192, {"ascending": False}),
    "int32 Zero+uint64": (np.int32, (np.uint64,), U.ZERO, 8192,
                          {"capacity_factor": 1.5}),
    "int32 ZeroOne+uint16": (np.int32, (np.uint16,), U.ZERO_ONE, 8192,
                             {"capacity_factor": 1.5}),
    "int64 Sorted": (np.int64, (), U.SORTED, 8192, {"capacity_factor": 1.5}),
    "uint8+uint32": (np.uint8, (np.uint32,), U.UNIFORM, 8192, {}),
    "uint16 desc+float32": (np.uint16, (np.float32,), U.UNIFORM, 8192,
                            {"ascending": False}),
    # a factor far below need and no retry: truncated and flagged
    "overflow": (np.uint64, (), U.ZERO, 8192,
                 {"capacity_factor": 0.25, "max_retries": 0}),
    # the same undersized factor, widened by the elastic retry
    "elastic retry": (np.uint32, (np.uint32,), U.UNIFORM, 8192,
                      {"capacity_factor": 0.25, "max_retries": 3}),
    "blocked uint64+uint64": (np.uint64, (np.uint64,), U.UNIFORM, 16384,
                              {"final_mode": "blocked",
                               "segments_per_device": 4}),
    "blocked int32 ZeroOne": (np.int32, (np.uint32,), U.ZERO_ONE, 8192,
                              {"final_mode": "blocked",
                               "segments_per_device": 8}),
    "blocked uint32 desc": (np.uint32, (), U.GAUSSIAN, 8192,
                            {"final_mode": "blocked", "ascending": False,
                             "segments_per_device": 2}),
}


def _multi_data(name):
    rng = np.random.default_rng(80)
    n = 4096
    if name == "multi int32,float64 desc":
        cols = (rng.integers(0, 30, n).astype(np.int32), rng.normal(0, 1, n))
        return cols, (np.arange(n, dtype=np.uint64),), {
            "ascending": (True, False)}
    if name == "multi uint8 Zero,float64 ties":
        vals = np.array([1.5, -2.25, 0.0, 3e200, -0.0], np.float64)
        cols = (np.zeros(n, np.uint8), rng.choice(vals, n))
        return cols, (np.arange(n, dtype=np.int32),), {}
    # 3/4 of the rows share one (c1, c2) prefix: the retry must absorb it
    c1 = np.where(rng.random(n) < 0.75, 7, rng.integers(0, 100, n))
    cols = (c1.astype(np.int32), rng.integers(0, 3, n).astype(np.uint8))
    return cols, (np.arange(n, dtype=np.int64),), {
        "capacity_factor": 1.05, "max_retries": 3}


MULTI_CASES = ("multi int32,float64 desc", "multi uint8 Zero,float64 ties",
               "multi elastic retry")


def _sort_data(name):
    kdt, pdts, distribution, n, opts = SORT_CASES[name]
    keys = D.make_keys(n, kdt, distribution, seed=77)
    return keys, D.make_payloads(keys, pdts), opts


def port_cases(group):
    """Every case through the port on this rank (runs in the ranks)."""
    res = {}
    for name in SORT_CASES:
        keys, pays, opts = _sort_data(name)
        k, p, c, ov = tpar.distributed_sort(keys, *pays, group=group,
                                            device="cpu", **opts)
        gk, gp = tpar.gather_result(k, p, c, group)
        res[name] = to_np((k, p, c, ov, gk, gp))
    for name in MULTI_CASES:
        cols, pays, opts = _multi_data(name)
        kc, p, c, ov = tpar.distributed_sort_multi(cols, *pays, group=group,
                                                   device="cpu", **opts)
        gc, gp = tpar.gather_result_multi(kc, p, c, group)
        res[name] = to_np((kc, p, c, ov, gc, gp))
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(port_cases, tmp_path_factory.mktemp("dist_sort"))


# ---------------------------------------------------------------------------
# the JAX references (test process only)
# ---------------------------------------------------------------------------


def _jax_sort(name, size):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from simd_radix_sort_tpu.parallel import dist_sort as jds

    keys, pays, opts = _sort_data(name)
    mesh = jds.make_mesh(size)
    if opts.get("final_mode") != "blocked":
        k, p, c, ov, _ = jds.distributed_sort(keys, *pays, mesh=mesh, **opts)
    else:  # the sharded form: the host entry has no final_mode
        sh = NamedSharding(mesh, PartitionSpec("x"))
        kw = {k: v for k, v in opts.items() if k != "max_retries"}
        k, p, c, ov = jax.jit(lambda kk, pp: jds.distributed_sort_sharded(
            kk, pp, mesh=mesh, **kw))(
            jax.device_put(jnp.asarray(keys), sh),
            tuple(jax.device_put(jnp.asarray(x), sh) for x in pays))
    gk, gp = jds.gather_result(k, p, c)
    return (np.asarray(k), tuple(np.asarray(x) for x in p), np.asarray(c),
            np.asarray(ov), gk, gp)


def _jax_multi(name, size):
    from simd_radix_sort_tpu.parallel import dist_sort as jds

    cols, pays, opts = _multi_data(name)
    kc, p, c, ov, meta = jds.distributed_sort_multi(
        cols, *pays, mesh=jds.make_mesh(size), **opts)
    gc, gp = jds.gather_result_multi(kc, p, c, meta)
    return (tuple(np.asarray(x) for x in kc), tuple(np.asarray(x) for x in p),
            np.asarray(c), np.asarray(ov), gc, gp)


def _prefixes(stream, counts, nbuf):
    """Valid prefixes of one rank's buffers, concatenated."""
    per = stream.shape[0] // nbuf
    return np.concatenate([stream[b * per: b * per + int(c)]
                           for b, c in enumerate(counts)])


def _device_slice(arr, r, size):
    per = arr.shape[0] // size
    return arr[r * per:(r + 1) * per]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(SORT_CASES))
def test_distributed_sort_matches_jax(port, name, size):
    jk, jp, jc, jov, jgk, jgp = _jax_sort(name, size)
    keys, _, opts = _sort_data(name)
    nbuf = opts.get("segments_per_device", 1) \
        if opts.get("final_mode") == "blocked" else 1
    asc = opts.get("ascending", True)
    for r in range(size):
        k, p, c, ov, gk, gp = port[size, r][name]
        want_c = _device_slice(jc, r, size)
        assert np.array_equal(c, want_c), (r, c, want_c)
        assert int(ov[0]) == int(jov[r])
        assert k.shape == _device_slice(jk, r, size).shape
        kv = _prefixes(k, c, nbuf)
        same_bytes(kv, _prefixes(_device_slice(jk, r, size), c, nbuf))
        assert D.check_payloads(kv, [_prefixes(x, c, nbuf) for x in p])
        # the gathered table, on every rank
        same_bytes(gk, jgk)
        assert D.check_payloads(gk, gp)
        for a, b in zip(gp, jgp):
            assert a.dtype == b.dtype and a.shape == b.shape
    if not int(jov.max()):
        assert D.check_data(jgk, jgp, keys, asc) == ""


def _rows(cols, pays):
    """Rows as a sorted multiset of byte tuples."""
    mat = np.stack([x.view(f"u{x.dtype.itemsize}").astype(np.uint64)
                    for x in cols + pays], 1)
    return mat[np.lexsort(mat.T[::-1])]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", MULTI_CASES)
def test_distributed_sort_multi_matches_jax(port, name, size):
    jkc, jp, jc, jov, jgc, jgp = _jax_multi(name, size)
    cols, _, _ = _multi_data(name)
    for r in range(size):
        kc, p, c, ov, gc, gp = port[size, r][name]
        assert int(c[0]) == int(jc[r]) and int(ov[0]) == int(jov[r])
        n = int(c[0])
        for a, b, col in zip(kc, jkc, cols):
            same_bytes(a[:n], _device_slice(b, r, size)[:n])
            # the payload is the input row: which of a tie's rows a rank
            # gets follows the unstable local sorts, but each must be whole
            same_bytes(a[:n], col[p[0][:n]])
        for a, b in zip(gc, jgc):
            same_bytes(a, b)
        assert np.array_equal(_rows(gc, gp), _rows(jgc, jgp))
    assert not int(jov.max())
