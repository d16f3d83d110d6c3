"""North-star configuration 5: the distributed sort and join under Zipf skew.

Counterpart of scripts/config5_scale.py.  BASELINE.json configs[4]:
"distributed sort + hash join on hash-partitioned 1B-row tables with
Zipf-skewed keys, ragged all-to-all shuffle with skew repartitioning".
Keys are splitmix64-hashed Zipf ranks: the hash spreads the ranks over the
u64 key space and keeps their multiplicities.  Build tables are dimension
tables (unique keys); probe tables draw Zipf-distributed foreign keys, so
every probe row matches exactly one build row and the join returns as many
rows as the probe table has.  The tables are made on the host with NumPy,
as the JAX script makes them, and staged.

Two legs:

  card  one rank (a process group of one, NCCL): distributed_sort_sharded
        of 10^8 Zipf(1.1) rows with final_mode "sort" and "blocked", and
        distributed_join of 10^8 probe x 10^7 build rows under Zipf(1.1),
        and under Zipf(1.5) with the hot-key path on (hot_keys=8) and off
        (0), samples_per_device=512; each gated on the device.
  gloo  the same sort and the Zipf(1.1) and Zipf(1.5) joins on 2 and 4
        CPU processes (Gloo), the sorted keys also held against NumPy's.

The JAX script's third leg, a virtual 8-device CPU mesh, has no
counterpart: the port has no virtual mesh, and its workloads run in the
two legs above.  A failure at the stated size raises: nothing retries
smaller.

    python -m simd_radix_sort_tpu_torch.workloads.config5_scale --leg card
        [--n-sort N] [--n-probe N] [--n-build N] [--reps R] [--device cpu]
    python -m simd_radix_sort_tpu_torch.workloads.config5_scale --leg gloo
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import _build
from ..parallel import dist_ops, dist_sort
from ..utils import common as ucommon
from ..utils import interop
from ..utils import transforms
from . import common
from .common import splitmix64_np

BUILD_SALT = 0xC0FFEE  # build payload = splitmix64(key ^ BUILD_SALT)
# (label, Zipf exponent, probe table seed, hot_keys): the JAX script's joins
CARD_JOINS = (("join_zipf11", 1.1, 7, 8), ("join_zipf15_hot", 1.5, 9, 8),
              ("join_zipf15_hot_off_ablation", 1.5, 9, 0))
GLOO_JOINS = CARD_JOINS[:2]


def zipf_ranks(n: int, a: float, domain: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.zipf(a, n).astype(np.uint64)
    return ((r - np.uint64(1)) % np.uint64(domain)) + np.uint64(1)


def make_sort_table(n: int, a: float, seed: int):
    """[u64 key, u64 payload] with Zipf(a)-skewed hashed keys; the payload
    is a function of (key, row) for the pair fingerprints."""
    ranks = zipf_ranks(n, a, 1 << 62, seed)
    keys = splitmix64_np(ranks)
    pays = splitmix64_np(keys ^ np.arange(n, dtype=np.uint64))
    return keys, pays


def make_join_tables(n_probe: int, n_build: int, a: float, seed: int):
    """(probe keys, probe payloads, build keys, build payloads): a fact
    table of Zipf(a) foreign keys into a shuffled dimension table of
    n_build unique keys."""
    ranks = zipf_ranks(n_probe, a, n_build, seed)
    probe_keys = splitmix64_np(ranks)
    probe_pay = splitmix64_np(probe_keys ^ np.arange(n_probe,
                                                     dtype=np.uint64))
    build_keys = splitmix64_np(np.arange(1, n_build + 1, dtype=np.uint64))
    build_keys = np.random.default_rng(seed + 1).permutation(build_keys)
    build_pay = splitmix64_np(build_keys ^ np.uint64(BUILD_SALT))
    return probe_keys, probe_pay, build_keys, build_pay


def skew_stats(keys: np.ndarray) -> dict:
    _, counts = np.unique(keys, return_counts=True)
    counts.sort()
    n = keys.shape[0]
    return {"distinct_keys": int(counts.size),
            "top1_share": float(counts[-1] / n),
            "top8_share": float(counts[-8:].sum() / n)}


def skew_stats_device(keys: torch.Tensor) -> dict:
    """`skew_stats` of a tensor, on its device."""
    counts = torch.unique(common.signed(keys), return_counts=True)[1]
    top = torch.sort(counts, descending=True).values[:8].tolist()
    n = keys.shape[0]
    return {"distinct_keys": int(counts.numel()),
            "top1_share": top[0] / n, "top8_share": sum(top) / n}


def gate_sort(out, sums, n: int, group, label: str):
    """Raise unless the distributed sort's output, gathered from every
    rank, holds n rows in key order with the input's key and pair
    fingerprints `sums`.  Returns the gathered keys."""
    if int(out[3].max()):
        raise AssertionError(f"{label}: overflow")
    ks, (ps,) = dist_sort.gather_result(out[0], out[1], out[2], group)
    (c,) = transforms.key_operands(ks, True)
    if ks.shape[0] != n or not bool((c[1:] >= c[:-1]).all()):
        raise AssertionError(f"{label}: {ks.shape[0]} rows, not {n} in "
                             "key order")
    got = common.device_checksums((ks, ps))
    if got[:2] != sums[:2]:
        raise AssertionError(f"{label}: key multiset broken")
    if got[2:] != sums[2:]:
        raise AssertionError(f"{label}: pair fingerprints broken")
    return ks


def gate_join(out, n_probe: int, probe_sums, group, label: str) -> None:
    """Raise unless the join, gathered from every rank, returns one row per
    probe row, each build payload the function of its key, and the probe
    (key, payload) pairs' fingerprints `probe_sums`."""
    if int(out[4].max()):
        raise AssertionError(f"{label}: overflow")
    k, (pp,), (bp,) = dist_ops.gather_joined(out[0], out[1], out[2], out[3],
                                             group)
    if k.shape[0] != n_probe:
        raise AssertionError(f"{label}: {k.shape[0]} output rows, not "
                             f"{n_probe}")
    want_bp = common.splitmix64(common.signed(k) ^ BUILD_SALT)
    if not torch.equal(common.signed(bp), want_bp):
        raise AssertionError(f"{label}: build payload decoupled from key")
    if common.device_checksums((k, pp))[2:] != probe_sums[2:]:
        raise AssertionError(f"{label}: probe pair multiset broken")


def _stage(arrays, dev):
    return [interop.from_numpy(a, dev) for a in arrays]


def sort_case(keys, pays, mode: str, group, dev):
    """(call, gate) of the distributed sort of the global table (keys,
    pays), tensors on `dev`: the call sorts this rank's block."""
    kl = dist_sort.shard_rows(keys, group, dev)
    pl = dist_sort.shard_rows(pays, group, dev)
    sums = common.device_checksums((keys, pays))

    def call():
        return dist_sort.distributed_sort_sharded(kl, (pl,), group,
                                                  final_mode=mode)

    def gate(out):
        return gate_sort(out, sums, keys.shape[0], group, f"sort {mode}")

    return call, gate


def join_case(tables, hot_keys: int, group, dev, label: str,
              out_rows=None):
    """(call, gate) of the distributed join of the global tables, tensors
    on `dev`; `out_rows` is a rank's output capacity (the join's default
    when None)."""
    pk, pp, bk, bp = tables
    probe_sums = common.device_checksums((pk, pp))

    def call():
        return dist_ops.distributed_join(
            pk, (pp,), bk, (bp,), group=group, hot_keys=hot_keys,
            return_hot_stats=True, samples_per_device=512,
            out_rows_per_device=out_rows, device=dev)

    def gate(out):
        gate_join(out, pk.shape[0], probe_sums, group, label)

    return call, gate


def hot_record(hot_stats) -> dict:
    return {k: v.tolist() for k, v in hot_stats.items()}


def card_cases(n_sort: int, n_probe: int, n_build: int, device=None):
    """The card leg's cases on one rank of an initialised process group:
    (label, rows, skew, call, gate).  The host tables are made in threads
    (NumPy's Zipf sampler is a serial loop) and staged."""
    dev = ucommon.resolve_device(device)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        sort_f = pool.submit(make_sort_table, n_sort, 1.1, 41)
        join_f = {seed: pool.submit(make_join_tables, n_probe, n_build, a,
                                    seed)
                  for a, seed in {(a, s) for _, a, s, _ in CARD_JOINS}}
        sort_t = _stage(sort_f.result(), dev)
        joins = {seed: _stage(f.result(), dev) for seed, f in join_f.items()}
    cases = []
    skew = skew_stats_device(sort_t[0])
    for mode in ("sort", "blocked"):
        cases.append((f"sort_{mode}", n_sort, skew,
                      *sort_case(*sort_t, mode, None, dev)))
    # the JAX card leg's output capacity: each probe row matches once, and
    # the join's default, 2·(probe + build) rows, would double the peak
    out_rows = int(1.25 * n_probe)
    for label, _, seed, hot in CARD_JOINS:
        cases.append((label, n_probe, skew_stats_device(joins[seed][0]),
                      *join_case(joins[seed], hot, None, dev, label,
                                 out_rows)))
    return cases


def leg_card(n_sort: int, n_probe: int, n_build: int, reps: int = 2,
             device=None) -> dict:
    """The card leg: each case driven once and gated, then timed (a wait
    after every call).  Runs on a process group of one unless one is
    initialised."""
    dev = ucommon.resolve_device(device)
    rec = {"device": common.device_name(dev)}
    with common.one_rank_group(dev):
        for label, rows, skew, call, gate in card_cases(n_sort, n_probe,
                                                        n_build, dev):
            out = call()
            gate(out)
            r = {"n": rows, "skew": skew}
            if len(out) == 6:
                r["hot_stats"] = hot_record(out[5])
            del out
            r["run_s"] = common.timeit(call, reps=reps, warmup=0,
                                       per_rep_fence=True, device=dev)
            r["rows_per_s"] = rows / r["run_s"]
            rec[label] = r
    return rec


def gloo_worker(rank: int, world: int, init: str, n_sort: int, n_probe: int,
                n_build: int, out_path: str) -> None:
    """One of `world` Gloo ranks of the gloo leg; rank 0 writes the record
    to `out_path`."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        cpu = torch.device("cpu")
        keys, pays = make_sort_table(n_sort, 1.1, 31)
        call, gate = sort_case(*_stage((keys, pays), cpu), "sort", None, cpu)
        t0 = time.perf_counter()
        out = call()
        t_run = time.perf_counter() - t0
        ks = gate(out)
        if not np.array_equal(interop.to_numpy(ks), np.sort(keys)):
            raise AssertionError("gloo sort: keys differ from NumPy's sort")
        rec = {"n_sort": n_sort, "sort_run_s": t_run, "ranks": world,
               "skew": skew_stats(keys)}
        for label, a, seed, hot in GLOO_JOINS:
            tables = _stage(make_join_tables(n_probe, n_build, a, seed), cpu)
            call, gate = join_case(tables, hot, None, cpu, label)
            t0 = time.perf_counter()
            out = call()
            t_run = time.perf_counter() - t0
            gate(out)
            rec[label] = {"n_probe": n_probe, "n_build": n_build,
                          "zipf_a": a, "hot_keys": hot, "run_s": t_run,
                          "hot_stats": hot_record(out[5])}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def leg_gloo(n_sort: int, n_probe: int, n_build: int, procs=(2, 4),
             work_dir=None) -> dict:
    """The gloo leg on each count of processes in `procs`, spawned; the
    store and records go to `work_dir` (default build/srs_torch/config5)."""
    work = os.fspath(work_dir or _build.BUILD_DIR / "config5")
    os.makedirs(work, exist_ok=True)
    results = {}
    for world in procs:
        store = os.path.join(work, f"store{world}")
        if os.path.exists(store):
            os.remove(store)
        out_path = os.path.join(work, f"gloo{world}.json")
        torch.multiprocessing.start_processes(
            gloo_worker, nprocs=world, start_method="spawn",
            args=(world, f"file://{store}", n_sort, n_probe, n_build,
                  out_path))
        with open(out_path) as f:
            results[f"{world}proc"] = json.load(f)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=("card", "gloo"), required=True)
    ap.add_argument("--n-sort", type=int, default=0)
    ap.add_argument("--n-probe", type=int, default=0)
    ap.add_argument("--n-build", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the card leg on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.leg == "card":
        rec = leg_card(args.n_sort or 10**8, args.n_probe or 10**8,
                       args.n_build or 10**7, args.reps, args.device)
    else:
        rec = leg_gloo(args.n_sort or 1 << 24, args.n_probe or 1 << 23,
                       args.n_build or 1 << 20)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
