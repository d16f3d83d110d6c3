"""Entry points of the port: a one-card step and a multi-rank dry run.

Counterpart of __graft_entry__.py.  `entry()` is its key/payload sort step
(u32 keys + u32 payload, 2^16 rows, the comparison engine); and
`dryrun_multichip(n)` runs its distributed steps with its data (4096 rows a
rank, half the keys drawn from 4 hot values, seed 1) over n ranks of
torch.distributed: the distributed sort, filter, group-by aggregate, a join
with one hot probe key and, for an even n, the hierarchical sort and
aggregate over two slices, each gated as the JAX file gates it.

    python -m simd_radix_sort_tpu_torch.entry [--device cpu]

On cards the dry run takes one NCCL rank a card, every visible card;
with --device cpu it takes 8 Gloo processes, as ci.sh's check takes 8
virtual devices.  One rank runs in this process, more are spawned.
Nothing falls back: with no card and no --device cpu both entries raise,
and a failed step raises.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .ops import cuda_partition, xla_sort
from .parallel import dist_ops, dist_sort, multihost
from .utils import common, interop
from .workloads.common import one_rank_group

ENTRY_ROWS = 1 << 16
ROWS_PER_RANK = 4096
HOT_PROBE_KEY = 7
MIX = np.uint64(0x9E3779B97F4A7C15)


def entry(device=None):
    """(step, args): `step(keys, payload)` sorts u32 keys with their u32
    payload on the comparison engine and returns (keys, payload); `args`
    are __graft_entry__.entry()'s 2^16 rows (default_rng(0)) on `device`
    (None is CUDA, and raises without a card)."""
    dev = common.resolve_device(device)

    def step(keys, payload):
        keys_out, (pay_out,) = xla_sort.sort_arrays(keys, (payload,),
                                                    ascending=True)
        return keys_out, pay_out

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, ENTRY_ROWS, dtype=np.uint32)
    payload = rng.integers(0, 2**32, ENTRY_ROWS, dtype=np.uint32)
    return step, (interop.from_numpy(keys, dev),
                  interop.from_numpy(payload, dev))


def dryrun_data(n_devices: int) -> dict:
    """The dry run's global tables for n_devices ranks, drawn as
    __graft_entry__.dryrun_multichip draws them: u64 keys (half from 4 hot
    values) and payloads; the join's u32 probe keys (key 7 on 40% of the
    rows) and its sparse build keys (each even key below 4096 on n/2048
    rows, key 7 on 4)."""
    n = ROWS_PER_RANK * n_devices
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    hot_vals = rng.integers(0, 2**64, 4, dtype=np.uint64)
    dup_at = rng.random(n) < 0.5
    keys[dup_at] = hot_vals[rng.integers(0, 4, int(dup_at.sum()))]
    pay = rng.integers(0, 2**64, n, dtype=np.uint64)
    probe = rng.integers(0, 4096, n).astype(np.uint32)
    probe[rng.random(n) < 0.4] = np.uint32(HOT_PROBE_KEY)
    build = (2 * (np.arange(n, dtype=np.uint32) % 2048)).astype(np.uint32)
    build[:4] = np.uint32(HOT_PROBE_KEY)
    return {"keys": keys, "pay": pay, "probe": probe, "build": build}


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def pair_prints(keys: np.ndarray, pay: np.ndarray) -> np.ndarray:
    """The key<->payload pair fingerprints (k·MIX) ^ p, sorted: a multiset
    that a payload parted from its key changes."""
    with np.errstate(over="ignore"):
        return np.sort((keys * MIX) ^ pay)


def _check_sorted_table(label, gk, gp, keys, pay) -> None:
    _require(gk.shape == keys.shape, f"{label}: {gk.shape} rows, not "
             f"{keys.shape}")
    _require(np.all(gk[:-1] <= gk[1:]), f"{label}: keys out of order")
    _require(np.array_equal(gk, np.sort(keys)),
             f"{label}: the key multiset changed")
    _require(np.array_equal(pair_prints(gk, gp), pair_prints(keys, pay)),
             f"{label}: key<->payload pairing broken")


def _above_2_63(k: torch.Tensor) -> torch.Tensor:
    """k > 2^63 for uint64 keys, on their int64 view (torch compares no
    uint64 on the CPU): the view is negative from 2^63, which is its
    minimum."""
    s = common.as_signed(k)
    return (s < 0) & (s != torch.iinfo(torch.int64).min)


def _per_rank(t: torch.Tensor, group) -> list:
    """A (1,) count or flag of every rank, in rank order."""
    return dist_sort.all_gather_rows(t.to(torch.int64).reshape(1),
                                     group).tolist()


def dryrun_rank(group=None, device=None) -> dict:
    """The dry run on this rank of `group` (an initialised process group;
    None is the default one), every rank holding the global tables.
    Raises on a failed gate.  Returns the same record on every rank: the
    sort's per-rank counts and gathered keys, the filter's, aggregate's and
    join's totals, the join's hot-key statistics, the hierarchical steps'
    results (None for an odd rank count), this rank's K5 launches and each
    step's seconds."""
    dev = dist_sort.rank_device(device)
    num_p = dist.get_world_size(group)
    d = dryrun_data(num_p)
    keys, pay = d["keys"], d["pay"]
    n = keys.shape[0]
    kw = {"group": group, "device": dev}
    k5 = cuda_partition.LAUNCHES["partition_pass"]
    seconds, rec = {}, {"ranks": num_p, "rows": n, "device": str(dev)}

    # 1. distributed sort, as the JAX file's jitted sharded step
    t0 = time.perf_counter()
    out_k, out_p, counts, overflow = dist_sort.distributed_sort_sharded(
        dist_sort.shard_rows(keys, group, dev),
        (dist_sort.shard_rows(pay, group, dev),), group,
        capacity_factor=2.0, samples_per_device=32)
    gk, (gp,) = dist_sort.gather_result(out_k, out_p, counts, group)
    gk, gp = interop.to_numpy(gk), interop.to_numpy(gp)
    _require(not dist_sort.fetch_flag(overflow).any(), "sort overflowed")
    _check_sorted_table("sort", gk, gp, keys, pay)
    rec["sort_counts"] = _per_rank(counts, group)
    rec["sorted_keys"] = gk
    seconds["sort"] = time.perf_counter() - t0

    # 2. distributed filter
    t0 = time.perf_counter()
    fcounts, fk, (fp,) = dist_ops.distributed_filter(_above_2_63, keys, pay,
                                                     **kw)
    fk, (fp,) = dist_ops.gather_filtered(fcounts, fk, (fp,), group)
    mask = keys > 2**63
    _require(np.array_equal(interop.to_numpy(fk), keys[mask])
             and np.array_equal(interop.to_numpy(fp), pay[mask]),
             "filter rows differ from the mask's")
    rec["filter_rows"] = int(mask.sum())
    seconds["filter"] = time.perf_counter() - t0

    # 3. distributed group-by aggregate
    t0 = time.perf_counter()
    small = (keys % 16).astype(np.int32)
    ones = np.ones(n, np.int32)
    ng, _, sums = dist_ops.distributed_group_aggregate(small, ones, "sum",
                                                       **kw)
    total = int(sums.sum())
    _require(total == n, f"aggregate sums to {total}, not {n}")
    rec["aggregate_groups"], rec["aggregate_sum"] = ng, total
    seconds["aggregate"] = time.perf_counter() - t0

    # 4. distributed join: key 7 is 40% of the probe rows.  The JAX file
    # argues its hot path must engage because that key's volume alone
    # would overflow a receive buffer, which holds only for n > 5 ranks;
    # here the sample's verdict is read back instead
    t0 = time.perf_counter()
    pk, bk = d["probe"], d["build"]
    jc, _, _, _, jov, hot = dist_ops.distributed_join(
        pk, (pay,), bk, (np.arange(n, dtype=np.int32),),
        capacity_factor=2.0, out_rows_per_device=8 * n,
        return_hot_stats=True, **kw)
    _require(not dist_sort.fetch_flag(jov).any(), "join overflowed")
    uk, pc = np.unique(pk, return_counts=True)
    bcount = dict(zip(*np.unique(bk, return_counts=True)))
    want = int(sum(int(c) * int(bcount.get(k, 0)) for k, c in zip(uk, pc)))
    pairs = sum(_per_rank(jc, group))
    _require(pairs == want, f"join gave {pairs} pairs, not {want}")
    hot_rows = _per_rank(hot["hot_probe_rows_per_device"], group)
    flagged = int(hot["hot_key_slots_flagged"].item())
    if num_p >= 4:
        # the default threshold asks for s·capacity_factor/2 = 128 of the
        # P·128 sampled probe keys; key 7 gets about 51·P
        hot_key_rows = int((pk == HOT_PROBE_KEY).sum())
        _require(flagged >= 1 and sum(hot_rows) == hot_key_rows,
                 f"key {HOT_PROBE_KEY} not flagged hot: {flagged} slots, "
                 f"{sum(hot_rows)} hot probe rows of {hot_key_rows}")
    rec["join_pairs"] = pairs
    rec["join_hot"] = {"key_slots_flagged": flagged,
                       "probe_rows_per_rank": hot_rows,
                       "build_rows_per_rank": _per_rank(
                           hot["hot_build_rows_per_device"], group)}
    seconds["join"] = time.perf_counter() - t0

    # 5. the hierarchical sort and aggregate over a (2, P/2) mesh
    rec["hierarchical"] = None
    if num_p % 2 == 0:
        t0 = time.perf_counter()
        mesh = multihost.make_hierarchical_groups(num_slices=2, group=group)
        _require((mesh.num_slices, mesh.chips_per_slice) == (2, num_p // 2),
                 f"mesh {mesh.num_slices} x {mesh.chips_per_slice}")
        hk, (hp,), hcounts, hov = multihost.hierarchical_sort(
            keys, pay, num_slices=2, **kw)
        _require(not dist_sort.fetch_flag(hov).any(),
                 "hierarchical sort overflowed")
        hk, (hp,) = dist_sort.gather_result(hk, (hp,), hcounts, group)
        _check_sorted_table("hierarchical sort", interop.to_numpy(hk),
                            interop.to_numpy(hp), keys, pay)
        hng, hgk, (hs, hc) = multihost.hierarchical_group_aggregate(
            small, ones, agg=("sum", "count"), num_slices=2, **kw)
        hs, hc = interop.to_numpy(hs), interop.to_numpy(hc)
        _require(int(hs.sum()) == n, "hierarchical aggregate lost rows")
        _require(np.array_equal(hs, hc), "hierarchical sum != count")
        _require(np.array_equal(interop.to_numpy(hgk), np.unique(small)),
                 "hierarchical aggregate's group keys")
        rec["hierarchical"] = {"sort_counts": _per_rank(hcounts, group),
                               "groups": hng, "sums": hs.tolist()}
        seconds["hierarchical"] = time.perf_counter() - t0
    rec["k5_launches"] = cuda_partition.LAUNCHES["partition_pass"] - k5
    rec["seconds"] = seconds
    return rec


def _rank_main(rank: int, world: int, tmp: str, device_type: str) -> None:
    """One spawned rank: NCCL on card `rank`, or Gloo on the CPU; rank 0
    writes the record."""
    init = {"init_method": f"file://{tmp}/store", "rank": rank,
            "world_size": world,
            "timeout": datetime.timedelta(seconds=120)}
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **init)
    else:
        # many small ranks on one host: one thread each
        torch.set_num_threads(1)
        dev = torch.device("cpu")
        dist.init_process_group("gloo", **init)
    try:
        rec = dryrun_rank(None, dev)
        if rank == 0:
            with open(os.path.join(tmp, "record.pkl"), "wb") as f:
                pickle.dump(rec, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, group=None) -> dict:
    """The dry run over n_devices ranks; returns rank 0's record
    (`dryrun_rank`).  With `group` (or any initialised process group) it
    runs on this rank of it, which must have n_devices ranks.  Otherwise
    one rank runs in this process on a group of its own and more are
    spawned: NCCL ranks, one a card, for CUDA (device=None raises without
    a card), or Gloo processes for device="cpu"."""
    dev = common.resolve_device(device)
    if group is not None or dist.is_initialized():
        size = dist.get_world_size(group)
        if size != n_devices:
            raise ValueError(f"group has {size} ranks, not {n_devices}")
        return dryrun_rank(group, dev)
    if n_devices == 1:
        with one_rank_group(dev):
            return dryrun_rank(None, dev)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need as many cards; "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_devices, tmp, dev.type), nprocs=n_devices,
            join=True, start_method="spawn")
        with open(os.path.join(tmp, "record.pkl"), "rb") as f:
            return pickle.load(f)


def default_ranks(device: torch.device) -> int:
    """The dry run's rank count: every card, or 8 Gloo processes."""
    return torch.cuda.device_count() if device.type == "cuda" else 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions and Gloo ranks "
                         "(default: the cards)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    step, (keys, payload) = entry(dev)
    out_k, _ = step(keys, payload)
    print(f"entry: OK {tuple(out_k.shape)} on {dev}")
    ranks = default_ranks(dev)
    rec = dryrun_multichip(ranks, dev)
    print(f"dryrun_multichip({ranks}): OK - sorted {rec['rows']} rows over "
          f"{ranks} ranks (flat"
          f"{' + 2-phase' if rec['hierarchical'] else ''}), joined, "
          f"filtered, aggregated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
