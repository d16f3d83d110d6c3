"""The port's hierarchical tier (simd_radix_sort_tpu_torch/parallel/
multihost.py) against the JAX package's, on S x C meshes of P = 2 and 4.

The harness is test_torch_dist_sort.py's: one spawn of four Gloo ranks per
module runs every case through the port on CPU tensors, P = 2 on ranks 0-1
((S, C) = (2, 1) and (1, 2)), then P = 4 on the world ((2, 2), (4, 1) and
(1, 4)).  The JAX reference is the same entry on
`Mesh(np.array(jax.devices()[:P]).reshape(S, C), ("slice", "x"))` of
conftest's virtual CPU devices; the aggregate is compared per rank through
both packages' sharded forms, at the capacity their host entries' first
attempt uses.

What must match: each rank's count and overflow flag exactly; each rank's
valid key prefix byte for byte; payloads by the key-seeded oracle
(`utils/data.check_payloads`: both packages' local sorts are unstable); the
gathered table's keys byte for byte; aggregates' group keys and integer
results exactly, float64 sums and means to RTOL = 1e-12 relative to the
group's sum (or mean) of magnitudes (the two packages add in another
order).  An undersized capacity must be truncated and flagged alike, and
the aggregate's host entry must raise as the JAX package's does.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simd_radix_sort_tpu_torch import parallel as tpar
from simd_radix_sort_tpu_torch.parallel import dist_ops as tops
from simd_radix_sort_tpu_torch.parallel import multihost as tmh
from simd_radix_sort_tpu_torch.utils import data as D

from test_torch_dist_sort import run_ranks, same_bytes, to_np

RTOL = 1e-12
N = 4096
MESHES = ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
U = D.Distribution

# name -> (key dtype, payload dtypes, distribution, options, meshes)
SORT_CASES = {
    "uint32+uint64": (np.uint32, (np.uint64,), U.UNIFORM, {}, MESHES),
    "uint64+uint64": (np.uint64, (np.uint64,), U.UNIFORM, {}, MESHES),
    # one distinct key: the position tie-break keeps the slices balanced
    "int32 Zero+uint64": (np.int32, (np.uint64,), U.ZERO, {},
                          ((2, 2), (2, 1))),
    "uint32 presorted desc": (np.uint32, (), U.SORTED, {"ascending": False},
                              ((2, 2), (1, 4))),
    "int64+uint32 chunks=1": (np.int64, (np.uint32,), U.UNIFORM,
                              {"exchange_chunks": 1}, ((2, 2),)),
    "int64+uint32 chunks=2": (np.int64, (np.uint32,), U.UNIFORM,
                              {"exchange_chunks": 2}, ((2, 2),)),
    "int64+uint32 chunks=4": (np.int64, (np.uint32,), U.UNIFORM,
                              {"exchange_chunks": 4}, ((2, 2), (4, 1))),
    "float64 Gaussian+float64": (np.float64, (np.float64,), U.GAUSSIAN, {},
                                 ((2, 2), (1, 2))),
    "uint32 0..999+uint64 equals flat": (np.uint32, (np.uint64,), "0..999",
                                         {}, ((2, 2), (4, 1))),
    # half the capacity needed, and no retry: truncated and flagged (the
    # flag sums the chunks' flags, so it can exceed 1)
    "overflow uint64+uint64 factor 0.5": (
        np.uint64, (np.uint64,), U.UNIFORM, {"capacity_factor": 0.5},
        ((2, 2), (2, 1), (1, 4))),
}

# name -> meshes; data in _agg_data
AGG_CASES = {
    "int32 keys int64 sum,count,mean": MESHES,
    "int32 keys float64 sum,mean": ((2, 2), (1, 2)),
    "float64 keys -0.0 int64 max": ((2, 2), (2, 1)),
    "one hot uint64 key int64 sum": ((2, 2), (4, 1)),
    "one slice uint32 keys int32 sum,min": ((1, 4),),
    "overflow int64 keys factor 0.25": ((2, 2), (2, 1)),
}


def _sort_data(name):
    kdt, pdts, distribution, opts, _ = SORT_CASES[name]
    if distribution == "0..999":
        keys = np.random.default_rng(62).integers(0, 1000, N).astype(kdt)
    else:
        keys = D.make_keys(N, kdt, distribution, seed=60)
    return keys, D.make_payloads(keys, pdts), opts


def _agg_data(name):
    rng = np.random.default_rng(64)
    if name == "int32 keys int64 sum,count,mean":
        return (rng.integers(-30, 30, N).astype(np.int32),
                rng.integers(1, 1000, N), ("sum", "count", "mean"), {})
    if name == "int32 keys float64 sum,mean":
        return (rng.integers(0, 500, N).astype(np.int32),
                rng.normal(0, 10, N), ("sum", "mean"), {})
    if name == "float64 keys -0.0 int64 max":
        vals = np.array([-2.5, -0.0, 0.0, 1.25, 3e200], np.float64)
        return rng.choice(vals, N), rng.integers(1, 100, N), "max", {}
    if name == "one hot uint64 key int64 sum":
        return np.full(N, 7, np.uint64), np.arange(N, dtype=np.int64), \
            "sum", {}
    if name == "one slice uint32 keys int32 sum,min":
        return (rng.integers(0, 100, N).astype(np.uint32),
                rng.integers(1, 50, N).astype(np.int32), ("sum", "min"), {})
    if name == "overflow int64 keys factor 0.25":
        return (rng.integers(0, 10**9, N), rng.integers(0, 9, N), "sum",
                {"capacity_factor": 0.25, "max_retries": 0})
    raise KeyError(name)


def _group_checks(group):
    """make_hierarchical_groups' rules, with this rank's host name faked
    (socket.gethostname) to lay out the hosts; and init_distributed, a
    no-op once a group exists."""
    rank = dist.get_rank(group)
    out = {}
    real = tmh.socket.gethostname
    for label, hosts in (("two hosts", "aabb"), ("one host", "aaaa"),
                         ("uneven", "aaab"), ("not consecutive", "abab"),
                         ("num_slices=3", None), ("num_slices=0", None)):
        tmh.socket.gethostname = lambda: hosts[rank]
        try:
            m = tmh.make_hierarchical_groups(
                int(label[-1]) if hosts is None else None, group)
            out[label] = ("ok", tuple(m[:4]) + (m.dcn.ranks, m.ici.ranks))
        except ValueError as e:
            out[label] = ("error", str(e))
        finally:
            tmh.socket.gethostname = real
    tmh.init_distributed(device="cpu")
    out["init_distributed"] = (dist.get_world_size(), dist.get_backend())
    return out


def port_cases(group):
    """Every case through the port on this rank (runs in the ranks)."""
    size = dist.get_world_size(group)
    res = {}
    for name, (*_, meshes) in SORT_CASES.items():
        for S, C in meshes:
            if S * C != size:
                continue
            keys, pays, opts = _sort_data(name)
            k, p, c, ov = tpar.hierarchical_sort(
                keys, *pays, group=group, num_slices=S, device="cpu", **opts)
            res["sort", name, S, C] = to_np(
                (k, p, c, ov) + tpar.gather_result(k, p, c, group))
            if name.endswith("equals flat"):
                flat = tpar.distributed_sort(keys, *pays, group=group,
                                             device="cpu")
                multi = tmh.distributed_sort_multihost(
                    keys, *pays, group=group, device="cpu")
                res["flat", name, S, C] = [
                    to_np(tpar.gather_result(*out[:3], group))
                    for out in (flat, multi)]
    for name, meshes in AGG_CASES.items():
        for S, C in meshes:
            if S * C != size:
                continue
            keys, vals, agg, opts = _agg_data(name)
            mesh = tmh.make_hierarchical_groups(S, group)
            aggs_req, k_l, v_l = tops.stage_aggregate_inputs(
                keys, vals, agg, "test", group, "cpu")
            cap = max(int(opts.get("capacity_factor", 2.0) * k_l.shape[0]),
                      1)
            out = tmh.hierarchical_group_aggregate_sharded(
                k_l, v_l, mesh, aggs_req, cap1=cap, cap2=cap)
            n = int(out[0][0])
            shard = (n, to_np(out[1][:n]), [to_np(t[:n]) for t in out[2:-1]],
                     int(out[-1][0]))
            try:
                ng, gk, r = tpar.hierarchical_group_aggregate(
                    keys, vals, agg, group=group, num_slices=S, device="cpu",
                    **opts)
                host = (ng, to_np(gk), to_np(r))
            except ValueError as e:
                host = str(e)
            res["agg", name, S, C] = (shard, host)
    if size == 4:
        res["groups"] = _group_checks(group)
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(port_cases, tmp_path_factory.mktemp("multihost"))


# ---------------------------------------------------------------------------
# the JAX references (test process only)
# ---------------------------------------------------------------------------


def _jax_mesh(S, C):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:S * C]).reshape(S, C),
                ("slice", "x"))


def _slice(arr, r, size):
    arr = np.asarray(arr)
    per = arr.shape[0] // size
    return arr[r * per:(r + 1) * per]


def same_bits(got, want):
    """The same shape and bytes (the JAX package's float64 keys leave its
    sharded forms as uint64 bits)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.itemsize == want.dtype.itemsize
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _jax_sort(name, S, C):
    from simd_radix_sort_tpu.parallel import dist_sort as jds
    from simd_radix_sort_tpu.parallel import multihost as jmh

    keys, pays, opts = _sort_data(name)
    k, p, c, ov, meta = jmh.hierarchical_sort(keys, *pays,
                                              mesh=_jax_mesh(S, C), **opts)
    gk, gp = jds.gather_result(k, p, c, meta)
    return np.asarray(k), np.asarray(c), np.asarray(ov), gk, gp


def _jax_aggregate(name, S, C):
    """Per device (count, group keys, partial totals, overflow) of the
    sharded form at the host entry's first capacity, and the host entry's
    result (or its error message)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from simd_radix_sort_tpu.parallel import dist_ops as jops
    from simd_radix_sort_tpu.parallel import multihost as jmh

    keys, vals, agg, opts = _agg_data(name)
    size = S * C
    mesh = _jax_mesh(S, C)
    aggs_req, kb, key_f64, v = jops.stage_aggregate_inputs(keys, vals, agg,
                                                           "test")
    cap = max(int(opts.get("capacity_factor", 2.0) * (N // size)), 1)
    sh = NamedSharding(mesh, PartitionSpec(("slice", "x")))
    out = jax.jit(functools.partial(
        jmh.hierarchical_group_aggregate_sharded, mesh=mesh,
        aggs_req=aggs_req, cap1=cap, cap2=cap, key_dtype=key_f64))(
        jax.device_put(jnp.asarray(kb), sh), jax.device_put(jnp.asarray(v),
                                                              sh))
    cnt, ov = np.asarray(out[0]), np.asarray(out[-1])
    shard = [(int(cnt[r]), _slice(out[1], r, size)[:int(cnt[r])],
              [_slice(t, r, size)[:int(cnt[r])] for t in out[2:-1]],
              int(ov[r])) for r in range(size)]
    if not ov.any():
        # the host entry's first attempt is this step: its result
        return shard, jops.assemble_aggregate_result(
            out, agg, aggs_req, jops.partial_streams_for(aggs_req), key_f64)
    try:
        host = jmh.hierarchical_group_aggregate(keys, vals, agg, mesh=mesh,
                                                **opts)
    except ValueError as e:
        host = str(e)
    return shard, host


def _scale(keys, vals, gk, mean):
    """Each group's sum (or mean) of magnitudes, for group keys `gk`."""
    kb = keys.view(f"u{keys.dtype.itemsize}")
    mag = np.array([np.abs(vals[kb == g].astype(np.float64)).sum()
                    for g in gk.view(f"u{gk.dtype.itemsize}")])
    if mean:
        mag /= np.array([(kb == g).sum()
                         for g in gk.view(f"u{gk.dtype.itemsize}")])
    return mag


def _same_results(aggs, got, want, keys, vals, gk):
    for a, g, w in zip(aggs, got, want, strict=True):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind == "f" and a in ("sum", "mean"):
            assert g.dtype == w.dtype and g.shape == w.shape
            scale = _scale(keys, vals, gk, a == "mean")
            assert np.all(np.abs(g - w) <= RTOL * scale), a
        else:
            same_bytes(g, w)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,S,C", [(n, S, C) for n, case in
                                      SORT_CASES.items()
                                      for S, C in case[-1]])
def test_hierarchical_sort_matches_jax(port, name, S, C):
    jk, jc, jov, jgk, jgp = _jax_sort(name, S, C)
    keys, _, opts = _sort_data(name)
    size = S * C
    for r in range(size):
        k, p, c, ov, gk, gp = port[size, r]["sort", name, S, C]
        assert int(c[0]) == int(jc[r]), (r, c, jc)
        assert int(ov[0]) == int(jov[r]), (r, ov, jov)
        n = int(c[0])
        assert k.shape == _slice(jk, r, size).shape
        same_bits(k[:n], _slice(jk, r, size)[:n])
        assert D.check_payloads(k[:n], [x[:n] for x in p])
        same_bytes(gk, jgk)
        assert D.check_payloads(gk, gp)
        for a, b in zip(gp, jgp, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
    if name.startswith("overflow"):
        assert int(jov.max()) >= 1 and jgk.shape[0] < N
    else:
        assert int(jov.max()) == 0
        assert D.check_data(jgk, jgp, keys, opts.get("ascending", True)) == ""


@pytest.mark.parametrize("S,C", SORT_CASES["uint32 0..999+uint64 equals "
                                           "flat"][-1])
def test_hierarchical_sort_equals_the_flat_sort(port, S, C):
    name = "uint32 0..999+uint64 equals flat"
    for r in range(S * C):
        gk, (gp,) = port[S * C, r]["sort", name, S, C][4:]
        for fk, (fp,) in port[S * C, r]["flat", name, S, C]:
            same_bytes(gk, fk)
            # ties may carry their payloads in another order
            same_bytes(np.sort(gp), np.sort(fp))


@pytest.mark.parametrize("name,S,C", [(n, S, C) for n, meshes in
                                      AGG_CASES.items() for S, C in meshes])
def test_hierarchical_group_aggregate_matches_jax(port, name, S, C):
    from simd_radix_sort_tpu.parallel import dist_ops as jops

    jshard, jhost = _jax_aggregate(name, S, C)
    keys, vals, agg, _ = _agg_data(name)
    aggs = (agg,) if isinstance(agg, str) else agg
    partial_aggs = jops.partial_streams_for(aggs)
    for r in range(S * C):
        (n, gk, tots, ov), host = port[S * C, r]["agg", name, S, C]
        jn, jgk, jtots, jov = jshard[r]
        assert (n, ov) == (jn, jov), (r, n, ov, jn, jov)
        same_bits(gk, jgk)
        _same_results(partial_aggs, tots, jtots, keys, vals, gk)
        if isinstance(jhost, str):
            assert isinstance(host, str) and "exceed receive capacity" in host
            continue
        ng, hgk, res = host
        assert ng == jhost[0]
        same_bytes(hgk, jhost[1])
        _same_results(aggs, (res,) if isinstance(agg, str) else res,
                      (jhost[2],) if isinstance(agg, str) else jhost[2],
                      keys, vals, hgk)
    if name.startswith("overflow"):
        assert max(s[3] for s in jshard) >= 1 and isinstance(jhost, str)
    else:
        assert max(s[3] for s in jshard) == 0


def test_make_hierarchical_groups_rules(port):
    for r in range(4):
        got = port[4, r]["groups"]
        s, c = divmod(r, 2)
        assert got["two hosts"] == ("ok", (2, 2, s, c, (c, c + 2),
                                           (2 * s, 2 * s + 1)))
        assert got["one host"] == ("ok", (1, 4, 0, r, (r,), (0, 1, 2, 3)))
        assert got["uneven"][0] == "error"
        assert "uneven ranks per host" in got["uneven"][1]
        assert "not consecutive" in got["not consecutive"][1]
        for k in ("num_slices=3", "num_slices=0"):
            assert got[k][0] == "error" and "not divisible" in got[k][1]
        assert got["init_distributed"] == (4, "gloo")


def test_init_distributed(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    tmh.init_distributed("node0:29500", 4, 2, device="cpu")
    tmh.init_distributed(device="cpu")
    assert calls == [(("gloo",), {"init_method": "tcp://node0:29500",
                                  "world_size": 4, "rank": 2}),
                     (("gloo",), {"init_method": "env://"})]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.init_distributed()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    tmh.init_distributed()  # a group exists: nothing to do
    assert len(calls) == 2


def test_the_groups_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        tmh.make_hierarchical_groups(2)
