"""North-star configuration 4: filter -> sort -> group aggregate, 10^9 rows.

Counterpart of scripts/pipeline_1e9.py.  BASELINE.json config 4: "Filter
-> radix sort -> hash aggregate (group-by on sorted key prefix) on 1B rows,
single host".  The rows stream through the card in equal chunks, each made
on the device from its global row index (splitmix64), so nothing crosses
from the host; the calls of every chunk are queued back to back and nothing
is read back until the merge's group count.

Per chunk: a u32 group key splitmix64(i) % groups and a u64 value
splitmix64(i ^ M3); the predicate keeps rows whose value's low two bits are
not both zero (75%).  Mode "fused" gives rejected rows the sentinel key
`groups`, so they sort to the tail as one group; mode "staged" compacts the
kept rows first (filter.compact, one K5 launch, the tail filled with
`groups`).  Then the comparison sort of (key, value), the sorted-prefix
aggregate (hashagg.group_aggregate, presorted; its compaction is one K5
launch) and a partial table of at most groups + 1 rows.  The merge is one
more group_aggregate over the chunks' partials.  Sums wrap mod 2^64.

Each partial is copied out of its chunk's tensors: a slice would keep the
whole chunk's storage alive (ten 10^8-row chunks, about 16 GB).

    python -m simd_radix_sort_tpu_torch.workloads.pipeline_1e9 [--n N]
        [--chunks C] [--groups G] [--mode fused|staged] [--reps R]
        [--validate] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import filter as filter_ops
from ..ops import hashagg
from ..ops.xla_sort import sort_arrays
from ..utils import common as ucommon
from . import common

MODES = ("fused", "staged")


def chunk_rows(base: int, n_chunk: int, groups: int, device):
    """Rows [base, base + n_chunk): (group key int32, value int64 carrier
    of the u64, keep mask)."""
    i = torch.arange(base, base + n_chunk, dtype=torch.int64, device=device)
    k = common.umod(common.splitmix64(i), groups).to(torch.int32)
    v = common.splitmix64(i ^ common.wrap64(common.M3))
    return k, v, (v & 3) != 0


def make_chunk_fn(n_chunk: int, groups: int, mode: str, device):
    """The pipeline over the n_chunk rows that start at row `base`.

    Returns padded per-chunk partials (group_keys[cap] int32, sums[cap]
    int64, counts[cap] int64), cap = min(groups + 1, n_chunk); rows past
    the chunk's group count carry the sentinel key `groups`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    # at most groups distinct keys, + 1 for the sentinel group of the
    # rejected rows
    cap = min(groups + 1, n_chunk)

    def chunk(base: int):
        k, v, keep = chunk_rows(base, n_chunk, groups, device)
        if mode == "fused":
            kk = torch.where(keep, k, groups)
            ks, (vs,) = sort_arrays(kk, (v,), ascending=True)
        else:
            # the tail of both streams is filled with `groups`: its values
            # land in the sentinel group, which the merge drops
            _, fk, fv = filter_ops.compact(keep, k, v, fill=groups)
            ks, (vs,) = sort_arrays(fk, (fv,), ascending=True)
        ng, gk, ((sums,), cnt_g) = hashagg.group_aggregate(
            ks, vs, aggs=("sum", "count"), presorted=True)
        sel = torch.arange(cap, dtype=torch.int32, device=device) < ng
        return (torch.where(sel, gk[:cap], groups), sums[:cap].clone(),
                cnt_g[:cap].to(torch.int64))

    return chunk


def merge(gks, sums, cnts):
    """The chunks' partials merged by one more aggregate: (num_groups 0-d
    tensor, keys, sums, counts), padded."""
    ng, mk, ((msum, mcnt),) = hashagg.group_aggregate(
        torch.cat(gks), (torch.cat(sums), torch.cat(cnts)), aggs=("sum",),
        agg_streams=[(0, 1)])
    return ng, mk, msum, mcnt


def build(n: int, chunks: int, groups: int, mode: str, device=None):
    """The chunk function, the merge and the chunks' first rows, after one
    untimed chunk and merge (the JAX script compiles here)."""
    dev = ucommon.resolve_device(device)
    n_chunk = n // chunks
    if n_chunk * chunks != n:
        raise ValueError(f"n={n} does not divide into {chunks} chunks")
    chunk_fn = make_chunk_fn(n_chunk, groups, mode, dev)
    bases = [c * n_chunk for c in range(chunks)]
    warm = chunk_fn(bases[0])
    merge(*([w] * chunks for w in warm))
    common.fence(dev)
    return chunk_fn, merge, bases


def run_pipeline(n: int, chunks: int, groups: int, mode: str, programs=None,
                 device=None):
    """One pass over the n rows.  Returns (seconds from the first chunk's
    dispatch to the merge's group count on the host, group keys uint32,
    sums uint64, counts int64), the sentinel group dropped."""
    dev = ucommon.resolve_device(device)
    chunk_fn, merge_fn, bases = programs or build(n, chunks, groups, mode,
                                                  dev)
    t0 = time.perf_counter()
    parts = [chunk_fn(b) for b in bases]  # queued back to back
    ng, mk, msum, mcnt = merge_fn(*zip(*parts))
    ng = int(ng)
    dt = time.perf_counter() - t0
    mk = mk[:ng].cpu().numpy().astype(np.uint32)
    msum = msum[:ng].cpu().numpy().view(np.uint64)
    mcnt = mcnt[:ng].cpu().numpy()
    real = mk < groups
    return dt, mk[real], msum[real], mcnt[real]


def expected(n: int, chunks: int, groups: int, device=None):
    """The per-group answer by other means: the kept rows of each chunk
    added into a table of `groups` sums (`index_add_`, wrapping) and
    counted (`bincount`).  Returns (keys uint32, sums uint64, counts
    int64) of the groups that hold a row."""
    dev = ucommon.resolve_device(device)
    n_chunk = n // chunks
    sums = torch.zeros(groups, dtype=torch.int64, device=dev)
    counts = torch.zeros(groups, dtype=torch.int64, device=dev)
    for c in range(chunks):
        k, v, keep = chunk_rows(c * n_chunk, n_chunk, groups, dev)
        k = k[keep].to(torch.int64)
        sums.index_add_(0, k, v[keep])
        counts += torch.bincount(k, minlength=groups)
    uk = torch.nonzero(counts).squeeze(1)
    return (uk.cpu().numpy().astype(np.uint32),
            sums[uk].cpu().numpy().view(np.uint64), counts[uk].cpu().numpy())


def check_splitmix64(device) -> None:
    """Raise unless splitmix64 on `device` equals NumPy's on 2^16 rows."""
    i = np.arange(1 << 16, dtype=np.uint64)
    got = common.splitmix64(torch.from_numpy(i.view(np.int64)).to(device))
    if not np.array_equal(got.cpu().numpy().view(np.uint64),
                          common.splitmix64_np(i)):
        raise AssertionError("splitmix64 on the device differs from NumPy's")


def case(n: int, chunks: int, groups: int, mode: str, device=None):
    """Build the pipeline.  Returns (the call, one pass: run_pipeline's
    result; its gate: the groups equal `expected`'s, and the device's
    splitmix64 NumPy's)."""
    dev = ucommon.resolve_device(device)
    programs = build(n, chunks, groups, mode, dev)

    def call():
        return run_pipeline(n, chunks, groups, mode, programs, dev)

    def gate(out) -> None:
        check_splitmix64(dev)
        for what, got, want in zip(("keys", "sums", "counts"), out[1:],
                                   expected(n, chunks, groups, dev)):
            if not np.array_equal(got, want):
                raise AssertionError(f"group {what} mismatch")

    return call, gate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=float, default=1e9)
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--groups", type=int, default=1 << 20)
    ap.add_argument("--mode", choices=MODES, default="fused")
    ap.add_argument("--validate", action="store_true",
                    help="also hold the groups against index_add_/bincount")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    n = int(args.n)
    dev = ucommon.resolve_device(args.device)
    call, gate = case(n, args.chunks, args.groups, args.mode, dev)
    if args.validate:
        gate(call())
    best = None
    for _ in range(args.reps):
        dt, mk, _, mcnt = call()
        best = dt if best is None else min(best, dt)
    print(json.dumps({
        "metric": "filter+sort+aggregate pipeline rows/s/chip",
        "value": round(n / best),
        "unit": "rows/s",
        "n": n, "chunks": args.chunks, "groups": args.groups,
        "mode": args.mode, "seconds": round(best, 3),
        "groups_out": int(mk.size), "rows_kept": int(mcnt.sum()),
        "device": common.device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
