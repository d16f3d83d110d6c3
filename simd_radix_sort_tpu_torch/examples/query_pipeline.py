"""End-to-end query pipeline on one card.

Counterpart of examples/query_pipeline.py: the operator set composed into
the north-star shape, filter -> group aggregate -> join -> top-k -> sort,
over a fact table of 2^20 purchases (customer id, amount) and a dimension
table of 5000 customers (id, region), made from default_rng(7).

    python -m simd_radix_sort_tpu_torch.examples.query_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import sort
from ..ops import filter as f_op
from ..ops import hashagg, hashjoin, topk
from ..utils import common, interop

N_ROWS = 1 << 20
N_CUSTOMERS = 5000


def make_tables(n: int = N_ROWS):
    """(customer ids int32, amounts float32, dimension ids int32, regions
    uint8), the JAX example's arrays."""
    rng = np.random.default_rng(7)
    cust = rng.integers(0, N_CUSTOMERS, n, dtype=np.int32)
    amount = rng.gamma(2.0, 50.0, n).astype(np.float32)
    dim_cust = np.arange(N_CUSTOMERS, dtype=np.int32)
    dim_region = (dim_cust % 7).astype(np.uint8)
    return cust, amount, dim_cust, dim_region


def main(device=None, say=print) -> dict:
    """Run the pipeline, print what the JAX example prints and return its
    values (host arrays and ints)."""
    dev = common.resolve_device(device)
    cust, amount, dim_cust, dim_region = make_tables()
    n = cust.shape[0]
    cust_t, amount_t = (interop.from_numpy(a, dev) for a in (cust, amount))

    # 1. filter: purchases over 100 (amount drives the predicate; customer
    # ids ride along in lock-step)
    count, amt_f, cust_f = f_op.filter_rows(lambda a: a > 100.0, amount_t,
                                            cust_t)
    k = int(count)
    say(f"filter: {k} of {n} rows pass")

    # 2. group aggregate: total spend per customer (on the valid prefix)
    ng, gk, (sums,) = hashagg.group_aggregate(cust_f[:k], amt_f[:k],
                                              aggs=("sum",))
    g = int(ng)
    say(f"aggregate: {g} customers")

    # 3. join each customer's total with its region
    found, _, (regions,) = hashjoin.lookup_join(
        gk[:g], interop.from_numpy(dim_cust, dev),
        (interop.from_numpy(dim_region, dev),))
    if not bool(found[:g].all()):
        raise AssertionError("a customer has no region")

    # 4. top-10 customers by total spend, with region carried along
    top_s, top_c, top_r = (interop.to_numpy(t) for t in topk.top_k(
        sums[0][:g], gk[:g], regions[:g], k=10))
    say("top spenders:")
    for s, c, r in zip(top_s, top_c, top_r):
        say(f"  customer {int(c):5d}  region {int(r)}  total {float(s):10.2f}")

    # 5. full sorted listing (key + payload lock-step)
    c_sorted, a_sorted = sort(cust_t, amount_t, device=dev)
    if not bool((c_sorted[1:] >= c_sorted[:-1]).all()):
        raise AssertionError("listing not sorted")
    say(f"sorted listing ready: {tuple(c_sorted.shape)}")
    return {"filtered": k, "customers": g,
            "group_keys": interop.to_numpy(gk[:g]),
            "sums": interop.to_numpy(sums[0][:g]),
            "regions": interop.to_numpy(regions[:g]),
            "top_sums": top_s, "top_customers": top_c, "top_regions": top_r,
            "sorted_keys": interop.to_numpy(c_sorted),
            "sorted_amounts": interop.to_numpy(a_sorted)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    main(ap.parse_args().device)
