"""The port's examples (simd_radix_sort_tpu_torch/examples/) against the
same steps through the JAX package on the same inputs, on the CPU.

The JAX examples print and return nothing, and run eagerly (the query
example takes ~25 s on the CPU that way), so the tests run their steps
here: the query example's under `jax.jit`, the distributed example's on
`make_mesh(2)` of conftest's virtual devices.  Integers must be equal,
float32 sums within 1e-5 relative (the two packages add in different
orders).  The port's distributed example runs on two spawned Gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_radix_sort_tpu_torch.examples import (distributed_pipeline,
                                                query_pipeline)


@pytest.fixture(scope="module")
def query_run():
    lines = []
    return query_pipeline.main("cpu", say=lines.append), lines


@pytest.fixture(scope="module")
def query_want():
    import simd_radix_sort_tpu as srs
    from simd_radix_sort_tpu.ops import filter as f_op
    from simd_radix_sort_tpu.ops import hashagg, hashjoin, topk

    cust, amount, dim_cust, dim_region = query_pipeline.make_tables()
    count, amt_f, cust_f = jax.jit(lambda a, c: f_op.filter_rows(
        lambda x: x > 100.0, a, c))(amount, cust)
    k = int(count)
    ng, gk, (sums,) = jax.jit(lambda c, a: hashagg.group_aggregate(
        c, a, aggs=("sum",)))(cust_f[:k], amt_f[:k])
    g = int(ng)
    found, _, (regions,) = jax.jit(hashjoin.lookup_join)(
        gk[:g], jnp.asarray(dim_cust), (jnp.asarray(dim_region),))
    assert bool(jnp.all(found[:g]))
    top_s, top_c, top_r = jax.jit(lambda s, c, r: topk.top_k(
        s, c, r, k=10))(sums[0][:g], gk[:g], regions[:g])
    c_sorted, a_sorted = srs.sort(cust, amount)
    return {"n": cust.shape[0], "filtered": k, "customers": g,
            "group_keys": gk[:g], "sums": sums[0][:g],
            "regions": regions[:g], "top_sums": top_s,
            "top_customers": top_c, "top_regions": top_r,
            "sorted_keys": c_sorted, "sorted_amounts": a_sorted}


@pytest.mark.parametrize("key", ["filtered", "customers", "group_keys",
                                 "regions", "top_customers", "top_regions",
                                 "sorted_keys"])
def test_query_integers_equal_jax(query_run, query_want, key):
    got, want = np.asarray(query_run[0][key]), np.asarray(query_want[key])
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("key", ["sums", "top_sums"])
def test_query_float_sums_equal_jax(query_run, query_want, key):
    got, want = query_run[0][key], np.asarray(query_want[key])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_query_sorted_listing_keeps_its_pairs(query_run, query_want):
    got, want = query_run[0], query_want
    keys = np.asarray(want["sorted_keys"])
    pairs = [a[np.lexsort((a, keys))] for a in (
        got["sorted_amounts"], np.asarray(want["sorted_amounts"]))]
    assert np.array_equal(*pairs)


def test_query_prints_what_the_jax_example_prints(query_run, query_want):
    lines, w = query_run[1], query_want
    assert lines[:3] == [f"filter: {w['filtered']} of {w['n']} rows pass",
                         f"aggregate: {w['customers']} customers",
                         "top spenders:"]
    assert lines[-1] == f"sorted listing ready: ({w['n']},)"
    rows = lines[3:-1]
    assert len(rows) == 10
    for line, s, c, r in zip(rows, *(np.asarray(w[k]) for k in (
            "top_sums", "top_customers", "top_regions"))):
        head, total = line.split("total")
        assert head == f"  customer {int(c):5d}  region {int(r)}  "
        assert float(total) == pytest.approx(float(s), rel=1e-5)


@pytest.fixture(scope="module")
def distributed_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dpipe")
    return distributed_pipeline.spawn(2, "cpu", str(tmp / "out.json"),
                                      init=f"file://{tmp}/store")


@pytest.fixture(scope="module")
def distributed_want():
    from jax.sharding import Mesh

    from simd_radix_sort_tpu.parallel import dist_ops, dist_sort, multihost

    p = 2
    mesh = dist_sort.make_mesh(p)
    cust, amount, dim_id, dim_region = distributed_pipeline.make_tables(p)
    counts, ck, (ca,) = dist_ops.distributed_filter(
        lambda a: a > 25_000, amount, cust, mesh=mesh)
    amt_f, (cust_f,) = dist_ops.gather_filtered(counts, ck, (ca,))
    m = len(cust_f) // p * p
    jc, jk, (ja,), (jr,), ov, _ = dist_ops.distributed_join(
        cust_f[:m], (amt_f[:m],), dim_id, (dim_region,), mesh=mesh,
        capacity_factor=4.0, out_rows_per_device=4 * (m + len(dim_id)))
    assert not np.asarray(ov).any()
    k_j, (amt_j,), (reg_j,) = dist_ops.gather_joined(jc, jk, (ja,), (jr,))
    m = len(reg_j) // p * p
    ng, regions, (revenue, orders, mean) = \
        dist_ops.distributed_group_aggregate(
            reg_j[:m], amt_j[:m].astype(np.int64),
            agg=("sum", "count", "mean"), mesh=mesh)
    hmesh = Mesh(np.array(jax.devices()[:p]).reshape(2, 1), ("slice", "x"))
    hng, hreg, hrev = multihost.hierarchical_group_aggregate(
        reg_j[:m], amt_j[:m].astype(np.int64), agg="sum", mesh=hmesh)
    out_k, out_p, counts_s, ov_s, meta = dist_sort.distributed_sort(
        amt_j[:m], k_j[:m], mesh=mesh, ascending=False)
    assert not np.asarray(ov_s).any()
    top_amt, (top_cust,) = dist_sort.gather_result(out_k, out_p, counts_s,
                                                   meta)
    top5 = dist_ops.distributed_top_k(amt_j[:m], k_j[:m], k=5, mesh=mesh)
    return {"rows": cust.shape[0], "filtered": len(amt_f),
            "joined": len(k_j), "num_groups": ng, "regions": regions,
            "revenue": revenue, "orders": orders, "mean": mean,
            "hierarchical": (hng, hreg, hrev),
            "sorted_amounts": top_amt, "sorted_customers": top_cust,
            "top5": np.asarray(top5[0])}


@pytest.mark.parametrize("key", ["rows", "filtered", "joined", "num_groups",
                                 "regions", "revenue", "orders",
                                 "sorted_amounts", "top5"])
def test_distributed_integers_equal_jax(distributed_run, distributed_want,
                                        key):
    assert distributed_run["ranks"] == 2
    assert np.array_equal(np.asarray(distributed_run[key]),
                          np.asarray(distributed_want[key]))


def test_distributed_means_and_hierarchy_equal_jax(distributed_run,
                                                   distributed_want):
    got, want = distributed_run, distributed_want
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-12)
    hng, hreg, hrev = want["hierarchical"]
    assert got["hierarchical_matches"] is True
    assert hng == got["num_groups"]
    assert np.array_equal(hreg, got["regions"])
    assert np.array_equal(hrev, got["revenue"])


def test_distributed_sort_keeps_its_pairs(distributed_run, distributed_want):
    pairs = [sorted(zip(np.asarray(r["sorted_amounts"]).tolist(),
                        np.asarray(r["sorted_customers"]).tolist()))
             for r in (distributed_run, distributed_want)]
    assert pairs[0] == pairs[1]


def test_examples_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (query_pipeline.main, distributed_pipeline.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
