"""Distributed query pipeline over the ranks of a process group.

Counterpart of examples/distributed_pipeline.py, the scale-out companion
of query_pipeline.py: a fact table and a dimension table, every rank
holding a block of rows, processed with the distributed operators:
filter -> join -> aggregate (and the hierarchical aggregate when the rank
count is even) -> descending sort -> top-k.  One process per rank: NCCL
ranks on cards, Gloo processes on the CPU.

    python -m simd_radix_sort_tpu_torch.examples.distributed_pipeline \
        [--ranks P] [--device cpu]

P defaults to the number of cards, or 2 processes on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from ..ops import cuda_partition
from ..parallel import dist_ops, dist_sort, multihost
from ..utils import common as ucommon
from ..utils import interop
from ..workloads import common


def make_tables(n_ranks: int):
    """(customer ids, amounts in cents, dimension ids, regions), all int32,
    the JAX example's arrays for `n_ranks` devices."""
    rng = np.random.default_rng(11)
    n = n_ranks * (1 << 14)
    cust = rng.integers(0, 4096, n, dtype=np.int32)
    amount = rng.integers(1, 50_000, n, dtype=np.int32)
    dim_id = np.arange(0, n_ranks * 512, dtype=np.int32) % 4096
    dim_region = (dim_id % 7).astype(np.int32)
    return cust, amount, dim_id, dim_region


def _trim(t: torch.Tensor, p: int) -> torch.Tensor:
    """The longest prefix whose length the rank count divides."""
    return t[:t.shape[0] // p * p]


def run(group=None, device=None, say=print) -> dict:
    """The pipeline on every rank of `group` (an initialised process
    group; None is the default one).  Every rank returns the same
    results."""
    dev = dist_sort.rank_device(device)
    n_dev = dist.get_world_size(group)
    cust, amount, dim_id, dim_region = make_tables(n_dev)
    n = cust.shape[0]
    kw = {"group": group, "device": dev}
    k5_before = cuda_partition.LAUNCHES["partition_pass"]

    # 1. distributed filter: big purchases only
    counts, ck, (ca,) = dist_ops.distributed_filter(
        lambda a: a > 25_000, amount, cust, **kw)
    amt_f, (cust_f,) = dist_ops.gather_filtered(counts, ck, (ca,), group)
    filtered = amt_f.shape[0]
    say(f"filter: {filtered} of {n} rows pass on {n_dev} ranks")

    # 2. distributed join: attach each purchase's region (tables must be
    # divisible by the rank count: trim the filtered ragged tail)
    cust_f, amt_f = _trim(cust_f, n_dev), _trim(amt_f, n_dev)
    m = cust_f.shape[0]
    jc, jk, (ja,), (jr,), ov = dist_ops.distributed_join(
        cust_f, (amt_f,), dim_id, (dim_region,), capacity_factor=4.0,
        out_rows_per_device=4 * (m + len(dim_id)), **kw)
    if bool(ov.any()):
        raise AssertionError("join overflowed")
    k_j, (amt_j,), (reg_j,) = dist_ops.gather_joined(jc, jk, (ja,), (jr,),
                                                     group)
    say(f"join: {k_j.shape[0]} matched purchase rows")

    # 3. distributed aggregate: revenue, order count and mean ticket per
    # region, all three in one exchange
    reg_t, amt64 = _trim(reg_j, n_dev), _trim(amt_j, n_dev).to(torch.int64)
    ngroups, regions, (revenue, orders, mean_amt) = \
        dist_ops.distributed_group_aggregate(
            reg_t, amt64, agg=("sum", "count", "mean"), **kw)
    regions, revenue, orders, mean_amt = (
        interop.to_numpy(t) for t in (regions, revenue, orders, mean_amt))
    for r, v, c, mu in zip(regions, revenue, orders, mean_amt):
        say(f"  region {r}: revenue {int(v)} over {int(c)} orders "
            f"(mean {mu:.0f})")

    # 3b. the same aggregate over two slices of the ranks: the partials
    # cross between slices once
    hierarchical = None
    if n_dev % 2 == 0:
        hng, hreg, hrev = multihost.hierarchical_group_aggregate(
            reg_t, amt64, agg="sum", num_slices=2, **kw)
        hierarchical = (hng == ngroups
                        and np.array_equal(interop.to_numpy(hreg), regions)
                        and np.array_equal(interop.to_numpy(hrev), revenue))
        if not hierarchical:
            raise AssertionError("hierarchical aggregate differs from flat")
        say(f"hierarchical aggregate (2 slices): matches flat "
            f"({hng} regions)")

    # 4. distributed sort of the joined table by amount, descending
    amt_s, k_s = _trim(amt_j, n_dev), _trim(k_j, n_dev)
    out_k, out_p, counts_s, ov_s = dist_sort.distributed_sort(
        amt_s, k_s, ascending=False, **kw)
    if bool(ov_s.any()):
        raise AssertionError("sort overflowed")
    top_amt, (top_cust,) = dist_sort.gather_result(out_k, out_p, counts_s,
                                                   group)
    top_amt, top_cust = interop.to_numpy(top_amt), interop.to_numpy(top_cust)
    say(f"sort: top purchase {top_amt[0]} by customer {top_cust[0]}")

    # 5. distributed top-k without the full sort
    top5 = interop.to_numpy(dist_ops.distributed_top_k(amt_s, k_s, k=5,
                                                        **kw)[0])
    say(f"top-5 purchases: {top5.tolist()}")
    if not np.array_equal(top5, top_amt[:5]):
        raise AssertionError("top-k differs from the sort's head")
    say("distributed pipeline: OK")
    return {"ranks": n_dev, "rows": n, "filtered": filtered,
            "joined": int(k_j.shape[0]), "num_groups": int(ngroups),
            "regions": regions.tolist(), "revenue": revenue.tolist(),
            "orders": orders.tolist(), "mean": mean_amt.tolist(),
            "hierarchical_matches": hierarchical,
            "sorted_amounts": top_amt.tolist(),
            "sorted_customers": top_cust.tolist(), "top5": top5.tolist(),
            "k5_launches": (cuda_partition.LAUNCHES["partition_pass"]
                            - k5_before)}


def rank_main(rank: int, world: int, init: str, device: str,
              out_path: str) -> None:
    """One spawned rank: NCCL on card `rank`, or Gloo for device="cpu";
    rank 0 writes the results to `out_path` as JSON."""
    if device == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, rank=rank,
                                world_size=world, device_id=dev)
    try:
        res = run(device=dev, say=print if rank == 0 else (lambda m: None))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, device, out_path: str, init=None) -> dict:
    """Run the pipeline on `world` spawned ranks; rank 0's results."""
    dev = ucommon.resolve_device(device)
    init = init or f"tcp://localhost:{common.free_port()}"
    torch.multiprocessing.start_processes(
        rank_main, nprocs=world, start_method="spawn",
        args=(world, init, dev.type, out_path))
    with open(out_path) as f:
        return json.load(f)


def main(device=None, ranks=None) -> dict:
    """The pipeline on `ranks` ranks (default: the cards, or two processes
    on the CPU): in this process on a group of one (or on the group already
    initialised) for one rank, else spawned, their results passed through
    build/srs_torch/distributed_pipeline.json."""
    from ..ops import _build

    dev = ucommon.resolve_device(device)
    if ranks is None:
        ranks = torch.cuda.device_count() if dev.type == "cuda" else 2
    if ranks == 1 or dist.is_initialized():
        with common.one_rank_group(dev):
            return run(device=dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return spawn(ranks, dev,
                 str(_build.BUILD_DIR / "distributed_pipeline.json"))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs Gloo processes (default: the cards)")
    args = ap.parse_args()
    main(args.device, args.ranks)
