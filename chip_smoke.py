#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simd_radix_sort_tpu_torch) on one card.

    python3 chip_smoke.py [--n ROWS] [--reps R] [--seed S] [--out FILE]

Phases, each raising on failure:
  1. device: the card's name and power limit; build the CUDA kernels.
  2. kernels: each of K1-K6 against its plain PyTorch version on the card,
     exactly (all are integer functions), at the main path's shapes and at
     ragged, misaligned and edge cases; K6 also against K4's uint8 output.
     K4 and K6 also where runs meet their tiles' edges
     (cuda_hist.tile_edge_cases), at the tile the wrappers launch with and
     at a 64-byte tile.
  3. main paths at --n rows (default 10^8), data made from --seed with the
     port's utils/data.py, each case driven with the launch counts set to 0
     just before it and read just after:
       (a)-(e) `sort(...)` with method="auto", checking the engine it
               resolves to and its output on the device;
       (f)     `sort(..., method="radix")`, u64 key + u64 payload;
       (g)     `radix.sort_arrays(..., engine="pallas")`, the same data:
               64 K5 launches;
       (h)     engine="pallas", int32 keys descending, uint16 payload;
       (i)     engine="scatter", int32 keys, int32 payload, 2^22 rows;
       (j)     uint8 keys through K1 and K6, the path of
               scripts/u8_attack.py's packed fill.
     (f)-(j) must equal the stable comparison sort of their input byte for
     byte; (a), (f) and (g) also pass bench.py's checksums.  Then the
     query operators over TPC-H scale factor 10 (tpch_tables: 59,986,052
     lineitems, 15,000,000 orders) and the rank and quick engines, each
     gated on an answer the code under test does not give
     (operator_cases):
       (k)     filter_rows with Q6's predicate: one K5 launch;
       (l)     group_aggregate, Q1's 4 groups, sum/mean/count of three
               float64 columns, with max_groups=4 and without;
       (m)     group_aggregate by l_orderkey (15·10^6 groups);
       (n)     lookup_join, semi_join, inner_join_expand and
               merge_join_indices of lineitem and orders;
       (o)     top_k (k=100) over (a)'s data and over int32 keys with
               many ties; unique over int32 keys with 1% distinct;
       (p)     sort(method="quick") at 4·10^6 rows (QUICK_N), stable and
               not (the blocked path must run); quick_sort.partition;
               method="rank" at 4096 rows.
     Then the host engines, method="torch" and method="cpp" (the native
     harness, built here with g++), at 10^6 rows of (a)'s data: each must
     equal the stable comparison sort byte for byte.
  3b. (k)-(p) again at 10^6 rows, on the CPU and on the card: the outputs
     must agree (integers exactly, float sums to 1e-12).
  4. times: CUDA events, median of --reps after warm-up, for each kernel
     (kernel, plain version, one library call, bound) and each main-path
     case (rows/s and fraction of the roofline model); one further call of
     each under torch.profiler gives device time by kernel and the
     device's idle share of the call.  K4 and K6 are also timed at tiles
     of 4-64 KiB, and each of their calls must be one kernel on the card.
  5. the distributed tier (simd_radix_sort_tpu_torch/parallel/) on P NCCL
     ranks, one card each, P the largest of 1, 2, 4 that the machine has
     (P = 1 runs in this process, P > 1 in spawned ones), each rank making
     phase 3's data from --seed (distributed_phase, distributed_cases):
       (q)     distributed_sort of (a)'s data, final_mode "sort" and
               "blocked";
       (r)     distributed_sort_multi, ORDER BY l_shipdate, l_orderkey DESC
               with l_extendedprice;
       (s)     distributed_filter, Q6;
       (t)     distributed_group_aggregate, Q1's groups and l_orderkey's;
       (u)     distributed_join of lineitem and orders, uniform and with
               one order's key on every fourth lineitem (the hot path);
       (v)     distributed_top_k (k=100) and distributed_unique;
       (w)     the hierarchical tier on an S x C mesh of the ranks ((1, 1),
               (2, 1), (2, 2) at P = 1, 2, 4): hierarchical_sort of (a)'s
               data with exchange_chunks=2, and
               hierarchical_group_aggregate, Q1's groups and l_orderkey's;
     each gated on the whole result (gather_*) against single-card torch
     calls, then timed and profiled (NCCL device time, host reads of split
     sizes, K5 launches, which join the kernels line's counts); then the
     same cases at 10^6 rows on a Gloo group on the CPU and on the NCCL
     group on the card, which must agree.

Prints one {"kernels": [...]} line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

HIST_SOURCE = "simd_radix_sort_tpu_torch/csrc/hist_kernels.cu"
PARTITION_SOURCE = "simd_radix_sort_tpu_torch/csrc/partition_kernels.cu"
# wrapper -> (TPU kernel it replaces, CUDA source)
TPU_KERNELS = {
    "histogram": ("simd_radix_sort_tpu/ops/pallas_hist.py:39", HIST_SOURCE),
    "minmax_hist16": ("simd_radix_sort_tpu/ops/pallas_hist.py:90",
                      HIST_SOURCE),
    "tiny_sort16": ("simd_radix_sort_tpu/ops/pallas_hist.py:177",
                    HIST_SOURCE),
    "fill_runs": ("simd_radix_sort_tpu/ops/pallas_hist.py:325", HIST_SOURCE),
    "partition_pass": ("simd_radix_sort_tpu/ops/pallas_partition.py:64",
                       PARTITION_SOURCE),
    "fill_runs_packed": ("scripts/u8_attack.py:65", HIST_SOURCE),
}
# the CUDA functions each wrapper launches, as the profiler names them
KERNEL_FUNCTIONS = {
    "histogram": ("histogram_kernel",),
    "minmax_hist16": ("minmax_hist16_kernel",),
    "tiny_sort16": ("minmax_hist16_kernel", "fill16_kernel"),
    "fill_runs": ("fill_runs_kernel",),
    "partition_pass": ("partition_count_kernel", "partition_scatter_kernel"),
    "fill_runs_packed": ("fill_runs_packed_kernel",),
}
# non-tensor-core int32/float32 peak of an H100 SXM (NVIDIA data sheet);
# every kernel here does a few integer operations per byte, far below it
PEAK_OPS = 67e12
MIX = 0x9E3779B97F4A7C15  # odd multiplier of bench.py's pair fingerprint


def log(msg: str) -> None:
    print(msg, flush=True)


# TPC-H (specification v3, section 4.2): scale factor 10 has 15,000,000
# orders and 59,986,052 lineitems; dates as day numbers since 1970-01-01
SF10_ORDERS, SF10_LINEITEMS = 15_000_000, 59_986_052
STARTDATE, ENDDATE = 8035, 10591  # 1992-01-01, 1998-12-31
CURRENTDATE = 9298  # 1995-06-17
Q6_FROM, Q6_TO = 8766, 9131  # 1994-01-01, 1995-01-01


def tpch_tables(n_orders: int, n_lineitems: int, extra_rows: int,
                seed: int, device, u64_pair=None):
    """`orders` and `lineitem` as dbgen shapes them, made from `seed` on
    `device`, plus the other inputs of cases (o) and (p): `extra_rows`
    int32 keys with many ties and with 1% distinct values, and u64 keys +
    u64 payloads (`u64_pair`, else made here).

    o_orderkey is sparse as dbgen makes it (the first 8 of every 32 keys);
    each order has 1-7 lineitems (nudged to sum to exactly `n_lineitems`),
    in order-key order.  l_quantity 1-50, l_extendedprice = quantity x a
    retail price of 900.00-2098.99, l_discount 0.00-0.10, all float64, and
    kept also as exact integers (units, cents, hundredths) for the gates.
    l_shipdate is 1-121 days after o_orderdate; l_returnflag x l_linestatus
    as in Q1 (4 groups: A/F, N/F, N/O, R/F) is the int32 code `l_rfls`."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def ri(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device)

    t = {}
    i = torch.arange(n_orders, device=device)
    t["o_orderkey"] = (i // 8) * 32 + i % 8 + 1
    t["o_orderdate"] = ri(STARTDATE, ENDDATE - 151 + 1, n_orders).to(
        torch.int32)
    t["o_totalprice"] = ri(85_700, 55_558_628, n_orders).double() / 100
    per = ri(1, 8, n_orders)
    diff = n_lineitems - int(per.sum())
    room = torch.nonzero(per < 7 if diff > 0 else per > 1).squeeze(1)
    per[room[:abs(diff)]] += 1 if diff > 0 else -1
    if int(per.sum()) != n_lineitems:
        raise AssertionError("lineitem count")
    n = n_lineitems
    t["o_lines"] = per
    t["l_orderkey"] = torch.repeat_interleave(t["o_orderkey"], per)
    t["l_orderdate"] = torch.repeat_interleave(t["o_orderdate"], per)
    t["l_rowid"] = torch.arange(n, device=device)
    t["qty_units"] = ri(1, 51, n)
    t["price_cents"] = t["qty_units"] * ri(90_000, 209_900, n)
    t["disc_hundredths"] = ri(0, 11, n)
    t["l_quantity"] = t["qty_units"].double()
    t["l_extendedprice"] = t["price_cents"].double() / 100
    t["l_discount"] = t["disc_hundredths"].double() / 100
    ship = t["l_orderdate"] + ri(1, 122, n).to(torch.int32)
    receipt = ship + ri(1, 31, n).to(torch.int32)
    t["l_shipdate"] = ship
    # A/F 0, N/F 1, N/O 2, R/F 3 (Q1's ORDER BY): returnflag N once
    # received after CURRENTDATE, else A or R; linestatus O once shipped
    # after it (which makes the flag N)
    flag = torch.where(receipt > CURRENTDATE, 1, 3 * ri(0, 2, n))
    t["l_rfls"] = torch.where(ship > CURRENTDATE, 2, flag).to(torch.int32)
    # (o) and (p)
    m = extra_rows
    if u64_pair is None:  # uniform 64-bit patterns from two 32-bit halves
        u64_pair = [((ri(0, 2**32, m) << 32) | ri(0, 2**32, m)).view(
            torch.uint64) for _ in range(2)]
    t["u64"], t["u64_pay"] = u64_pair
    t["ties"] = ri(0, 1000, m).to(torch.int32)
    t["uniq"] = ri(0, max(1, m // 100), m).to(torch.int32)
    t["uniq_row"] = torch.arange(m, dtype=torch.int32, device=device)
    return t


Q6_COLUMNS = ("l_shipdate", "l_quantity", "l_extendedprice", "l_discount")


def q6_mask(t):
    """TPC-H Q6's predicate: shipped in 1994, discount 0.06 +- 0.01,
    quantity < 24."""
    return ((t["l_shipdate"] >= Q6_FROM) & (t["l_shipdate"] < Q6_TO)
            & (t["l_discount"] >= 0.05) & (t["l_discount"] <= 0.07)
            & (t["l_quantity"] < 24))


def flat(out):
    """The tensors of a nested output, in order."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [x for o in out for x in flat(o)]


def signed(t):
    """The same-width signed view of a tensor."""
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def wrap64(x: int) -> int:
    return (int(x) + 2**63) % 2**64 - 2**63


def xor_reduce(t) -> int:
    import torch

    while t.numel() > 1:
        if t.numel() % 2:
            t = torch.cat([t, t.new_zeros(1)])
        h = t.numel() // 2
        t = t[:h] ^ t[h:]
    return int(t.item())


def device_checksums(out):
    """bench.py's gate on the card: the sum and xor of the keys and of the
    key-payload pair fingerprint, mod 2^64 (independent of row order)."""
    ko, po = (signed(t) for t in out)
    pair = (ko * wrap64(MIX)) ^ po
    return (int(ko.sum().item()), xor_reduce(ko),
            int(pair.sum().item()), xor_reduce(pair))


def time_calls(fn, reps: int, warmup: int = 2) -> float:
    """Median ms of `reps` calls of `fn`, each between CUDA events, after
    `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def profile_call(fn, kernels=()):
    """One call under torch.profiler after a warm-up: its wall time (CUDA
    events, profiler on) and the device time of every kernel, memset or
    copy it issued, by name.  The trace at times comes back without some
    device events, so it is taken again (at most three times) until every
    wrapper in `kernels` shows its CUDA functions; if none is complete, the
    device times are {}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = [f for k in kernels for f in KERNEL_FUNCTIONS[k]]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
        per = {}
        for ev in prof.events():
            # "nccl:..." events are NCCL's annotations of its own kernels
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    not ev.name.startswith("nccl:"):
                per[ev.name] = (per.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
        if per and all(any(f in k for k in per) for f in want):
            return s.elapsed_time(e), per
    return s.elapsed_time(e), {}


# rows of case (p): the quick engine's 1024 buckets average <= its
# 4096-row target below 4,194,304 rows.  Up to 1024 * BLOCK/2 = 8,388,608
# it still partitions, but at 8·10^6 the segments average 95% of the
# blocked cleanup's BLOCK/2 bound and the largest passes it: the anti-skew
# fallback runs (as on the TPU, with the same constants).
QUICK_N = 4_000_000
SMALL_N = 1_000_000  # rows of the CPU-against-card comparison


def agree(label, cpu_out, card_out, signed):
    """The same outputs on the CPU and on the card: integers exactly,
    floats to the tests' float64 tolerance (sums in another order)."""
    import torch

    for i, (a, b) in enumerate(zip(flat(cpu_out), flat(card_out),
                                   strict=True)):
        b = signed(b).cpu().view(b.dtype)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label} output {i}: {a.dtype} "
                                 f"{tuple(a.shape)} on the CPU, {b.dtype} "
                                 f"{tuple(b.shape)} on the card")
        if a.dtype.is_floating_point:
            same = torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            same = torch.equal(signed(a), signed(b))
        if not same:
            raise AssertionError(f"{label} output {i}: the CPU and the "
                                 "card differ")


def operator_cases(t, quick_n: int):
    """Cases (k)-(p) over the tables `t`: each (label, engine, rows,
    run(t), gate(t, out), kernels that must launch, K5 launches, bytes a
    row, canon(out)).  `gate` holds the output against an answer that the
    code under test does not give: one known by construction, or other
    torch calls.  `canon` is what of the output must agree between the CPU
    and the card (rows past a count are padding; where the port sorts
    unstably, a sum over pairs stands for their order)."""
    import torch

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch.ops import (filter as filt, hashagg,
                                               hashjoin, quick_sort, topk)

    def signed(x):
        return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])

    def take(x, idx):
        return signed(x).index_select(0, idx)

    def eq(label, got, want):
        if got.shape != want.shape or not torch.equal(signed(got),
                                                      signed(want)):
            raise AssertionError(f"{label}: differs from its gate")

    def close(label, got, want):
        # the tests' float64 tolerance: sums in another order
        if not torch.allclose(got, want, rtol=1e-12, atol=0):
            err = ((got - want).abs() / want.abs()).max().item()
            raise AssertionError(f"{label}: relative error {err}")

    def pair_fp(k, p):
        return ((signed(k) * 0x7FFFFFFF) ^ signed(p)).sum()

    cases = []
    q6 = Q6_COLUMNS

    # (k) filter, Q6's predicate
    def gate_k(t, out):
        mask = q6_mask(t)
        sel, rest = (torch.nonzero(mask).squeeze(1),
                     torch.nonzero(~mask).squeeze(1))
        if int(out[0]) != sel.numel():
            raise AssertionError("(k) count")
        for col, o in zip(q6, out[1:]):
            eq("(k) " + col, o, torch.cat([take(t[col], sel),
                                           take(t[col], rest)]))

    cases.append(("k filter_rows Q6", "filter", "l_shipdate",
                  lambda t: filt.filter_rows(q6_mask(t),
                                             *(t[c] for c in q6)),
                  gate_k, ["partition_pass"], 1, 28, lambda out: out))

    # (l) Q1's group-by; (m) by l_orderkey
    def groupby_ref(t, key, cols):
        uk, inv, cnt = torch.unique(t[key], sorted=True,
                                    return_inverse=True, return_counts=True)
        sums = [torch.zeros(uk.numel(), dtype=torch.int64,
                            device=uk.device).index_add_(0, inv, t[c])
                for c in cols]
        return uk, cnt, sums

    exact = {"l_quantity": ("qty_units", 1), "l_extendedprice":
             ("price_cents", 100), "l_discount": ("disc_hundredths", 100)}

    def group_gate(label, key, cols, aggs):
        def gate(t, out):
            ng, gk, res = out
            uk, cnt, sums = groupby_ref(t, key, [exact[c][0] for c in cols])
            g = uk.numel()
            if int(ng) != g:
                raise AssertionError(f"{label}: {int(ng)} groups, not {g}")
            eq(label + " keys", gk[:g], uk)
            want_sum = [s.double() / exact[c][1] for s, c in zip(sums, cols)]
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r[:g], cnt.to(torch.int32))
                    continue
                for c, got, s in zip(cols, r, want_sum):
                    close(f"{label} {agg} {c}", got[:g],
                          s if agg == "sum" else s / cnt)
        return gate

    def group_canon(aggs):
        def canon(out):
            ng, gk, res = out
            g = int(ng)
            return [ng, gk[:g]] + [x[:g] for agg, r in zip(aggs, res)
                                   for x in ((r,) if agg == "count" else r)]
        return canon

    q1_cols = ("l_quantity", "l_extendedprice", "l_discount")
    q1_aggs = ("sum", "mean", "count")
    for label, kw in (("l Q1 group_aggregate max_groups=4",
                       {"max_groups": 4}),
                      ("l Q1 group_aggregate", {})):
        cases.append((
            label, "hashagg", "l_rfls",
            lambda t, kw=kw: hashagg.group_aggregate(
                t["l_rfls"], tuple(t[c] for c in q1_cols), aggs=q1_aggs,
                **kw),
            group_gate("(l)", "l_rfls", q1_cols, q1_aggs), ["partition_pass"],
            1, 28, group_canon(q1_aggs)))
    m_cols, m_aggs = ("l_extendedprice",), ("sum", "count")
    cases.append((
        "m group_aggregate by l_orderkey", "hashagg", "l_orderkey",
        lambda t: hashagg.group_aggregate(
            t["l_orderkey"], (t["l_extendedprice"],), aggs=m_aggs),
        group_gate("(m)", "l_orderkey", m_cols, m_aggs), ["partition_pass"],
        1, 16, group_canon(m_aggs)))

    # (n) joins of lineitem and orders
    def gate_lookup(t, out):
        found, counts, (date, price) = out
        if not bool(found.all()) or not bool((counts == 1).all()):
            raise AssertionError("(n) lookup: a lineitem lost its order")
        eq("(n) lookup o_orderdate", date, t["l_orderdate"])
        eq("(n) lookup o_totalprice", price,
           torch.repeat_interleave(t["o_totalprice"], t["o_lines"]))

    cases.append(("n lookup_join lineitem->orders", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.lookup_join(
                      t["l_orderkey"], t["o_orderkey"],
                      (t["o_orderdate"], t["o_totalprice"])),
                  gate_lookup, [], 0, 8, lambda out: out))

    def gate_semi(t, out):
        if int(out[0]) != t["l_orderkey"].numel():
            raise AssertionError("(n) semi_join count")
        eq("(n) semi keys", out[1], t["l_orderkey"])
        eq("(n) semi price", out[2], t["l_extendedprice"])

    cases.append(("n semi_join lineitem in orders", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.semi_join(
                      t["l_orderkey"], (t["l_extendedprice"],),
                      t["o_orderkey"]),
                  gate_semi, ["partition_pass"], 1, 16, lambda out: out))

    def check_pairs(label, total, ok, n_l):
        """As many pairs as lineitems, each joining equal keys."""
        if int(total) != n_l:
            raise AssertionError(f"{label}: total {int(total)} != {n_l}")
        if not bool(ok.all()):
            raise AssertionError(f"{label}: a pair joins different keys")

    def gate_expand(t, out):
        total, pidx, pk, (pdate,), (rowid,) = out
        check_pairs("(n) inner_join_expand", total,
                    take(t["l_orderkey"], rowid) == pk,
                    t["l_orderkey"].numel())
        eq("(n) expand probe keys", pk, t["l_orderkey"])
        eq("(n) expand probe dates", pdate, t["l_orderdate"])
        eq("(n) expand rows", torch.sort(rowid).values, t["l_rowid"])

    def expand_canon(out):
        total, pidx, pk, pps, (rowid,) = out
        return [total, pidx, pk, *pps,
                torch.sort(pidx.to(torch.int64) * rowid.numel()
                           + rowid).values]

    cases.append(("n inner_join_expand orders x lineitem", "hashjoin",
                  "l_orderkey",
                  lambda t: hashjoin.inner_join_expand(
                      t["o_orderkey"], (t["o_orderdate"],), t["l_orderkey"],
                      (t["l_rowid"],), t["l_orderkey"].numel()),
                  gate_expand, [], 0, 16, expand_canon))

    def gate_merge(t, out):
        total, pidx, bidx = out
        check_pairs("(n) merge_join_indices", total,
                    take(t["o_orderkey"], pidx)
                    == take(t["l_orderkey"], bidx),
                    t["l_orderkey"].numel())
        eq("(n) merge rows", torch.sort(bidx.to(torch.int64)).values,
           t["l_rowid"])

    cases.append(("n merge_join_indices", "hashjoin", "l_orderkey",
                  lambda t: hashjoin.merge_join_indices(
                      (srs.to_sortable(t["o_orderkey"]),),
                      t["o_orderkey"].numel(),
                      (srs.to_sortable(t["l_orderkey"]),),
                      t["l_orderkey"].numel(), t["l_orderkey"].numel()),
                  gate_merge, ["partition_pass"], 1, 8, lambda out: out))

    # (o) top_k and unique
    def topk_gate(label, key, pay):
        def gate(t, out):
            order = torch.sort(srs.to_sortable(t[key], False),
                               stable=True).indices[:100]
            eq(label + " keys", out[0], take(t[key], order))
            if pay:
                eq(label + " payload", out[1], take(t[pay], order))
        return gate

    cases.append(("o top_k k=100 u64+u64", "topk", "u64",
                  lambda t: topk.top_k(t["u64"], t["u64_pay"], k=100),
                  topk_gate("(o) top_k u64", "u64", "u64_pay"), [], 0, 16,
                  lambda out: out))
    cases.append(("o top_k k=100 int32 ties", "topk", "ties",
                  lambda t: topk.top_k(t["ties"], t["uniq_row"], k=100),
                  topk_gate("(o) top_k ties", "ties", "uniq_row"), [], 0, 8,
                  lambda out: out))

    def gate_unique(t, out):
        count, ku, first, mult = out
        uk, inv, cnt = torch.unique(t["uniq"], sorted=True,
                                    return_inverse=True, return_counts=True)
        g = uk.numel()
        if int(count) != g:
            raise AssertionError("(o) unique count")
        eq("(o) unique keys", ku[:g], uk)
        eq("(o) unique multiplicity", mult[:g], cnt.to(torch.int32))
        want = torch.full((g,), t["uniq"].numel(), dtype=torch.int32,
                          device=uk.device).scatter_reduce_(
            0, inv, t["uniq_row"], "amin")
        eq("(o) unique first rows", first[:g], want)

    cases.append(("o unique int32", "topk", "uniq",
                  lambda t: topk.unique(t["uniq"], t["uniq_row"]),
                  gate_unique, ["partition_pass"], 1, 8, lambda out: out))

    # (p) the engines and the pivot partition
    def quick(t, stable):
        quick_sort.reset_paths()
        return srs.sort(t["u64"][:quick_n], t["u64_pay"][:quick_n],
                        method="quick", stable=stable,
                        device=t["u64"].device)

    def quick_gate(stable):
        def gate(t, out):
            if quick_sort.PATHS["blocked"] != 1:
                raise AssertionError(f"(p) quick took {quick_sort.PATHS}")
            k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
            want = srs.sort(k, p, method="xla", stable=True,
                            device=k.device)
            eq("(p) quick keys", out[0], want[0])
            if stable:
                eq("(p) quick payload", out[1], want[1])
            elif int(pair_fp(*out)) != int(pair_fp(k, p)):
                raise AssertionError("(p) quick: a payload left its key")
        return gate

    for stable in (True, False):
        cases.append((f"p sort quick stable={stable}", "quick", quick_n,
                      lambda t, s=stable: quick(t, s), quick_gate(stable),
                      [], 0, 16,
                      (lambda out: out) if stable else
                      (lambda out: [out[0], pair_fp(*out)])))

    def pivot_of(t):
        return t["u64"][quick_n // 2]

    def gate_partition(t, out):
        k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
        c = srs.to_sortable(k)
        le = c <= srs.to_sortable(pivot_of(t).reshape(1))
        left, right = (torch.nonzero(le).squeeze(1),
                       torch.nonzero(~le).squeeze(1))
        order = torch.cat([left, right])
        eq("(p) partition keys", out[0], take(k, order))
        eq("(p) partition payload", out[1][0], take(p, order))
        if int(out[2]) != left.numel():
            raise AssertionError("(p) partition split")
        ends = torch.sort(c).values
        eq("(p) partition kmin", srs.to_sortable(out[3].reshape(1)),
           ends[:1])
        eq("(p) partition kmax", srs.to_sortable(out[4].reshape(1)),
           ends[-1:])

    cases.append(("p quick_sort.partition u64+u64", "quick", quick_n,
                  lambda t: quick_sort.partition(
                      t["u64"][:quick_n], (t["u64_pay"][:quick_n],),
                      pivot_of(t)),
                  gate_partition, ["partition_pass"], 1, 16,
                  lambda out: out))

    def gate_rank(t, out):
        want = srs.sort(t["u64"][:4096], t["u64_pay"][:4096], method="xla",
                        stable=True, device=t["u64"].device)
        eq("(p) rank keys", out[0], want[0])
        eq("(p) rank payload", out[1], want[1])

    cases.append(("p sort rank n=4096", "rank", 4096,
                  lambda t: srs.sort(t["u64"][:4096], t["u64_pay"][:4096],
                                     method="rank", device=t["u64"].device),
                  gate_rank, [], 0, 16, lambda out: out))
    return cases


def distributed_cases(t, world: int, group, device):
    """Cases (q)-(w), the distributed tier (simd_radix_sort_tpu_torch/
    parallel/) on `world` ranks over the tables `t`, which every rank holds
    whole (the entries keep the rank's block of rows): each (label, rows,
    run(), gate(out), K5 launches at P = 1, canon(out)).  Each gate
    assembles the whole result on every rank (gather_*) and holds it
    against single-card torch calls on the whole input; `canon` is what
    must agree between the CPU and the card."""
    import torch

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import parallel as par

    kw = {"group": group, "device": device}
    n_l = t["l_orderkey"].numel()
    cases = []

    def take(x, idx):
        return signed(x).index_select(0, idx)

    def eq(label, got, want):
        if got.shape != want.shape or not torch.equal(signed(got),
                                                      signed(want)):
            raise AssertionError(f"{label}: differs from its gate")

    def close(label, got, want):
        if not torch.allclose(got, want, rtol=1e-12, atol=0):
            err = ((got - want).abs() / want.abs()).max().item()
            raise AssertionError(f"{label}: relative error {err}")

    def no_overflow(label, ov):
        if int(ov.max()):
            raise AssertionError(f"{label}: overflow flagged")

    def pair_fp(k, p):
        return ((signed(k) * 0x7FFFFFFF) ^ signed(p)).sum()

    # (q) the splitter sort of (a)'s data; gate: torch.sort, (a)'s checksums
    k64, p64 = t["u64"], t["u64_pay"]

    def q_gather(out):
        gk, (gp,) = par.gather_result(out[0], out[1], out[2], group)
        return gk, gp

    def q_canon(out):
        gk, gp = q_gather(out)
        return [gk, pair_fp(gk, gp)]

    def q_gate(label):
        def gate(out):
            no_overflow(label, out[3])
            gk, gp = q_gather(out)
            eq(label + " keys", gk, srs.sort(k64, method="xla",
                                             device=k64.device))
            if device_checksums((gk, gp)) != device_checksums((k64, p64)):
                raise AssertionError(f"{label}: checksums differ")
        return gate

    for mode in ("sort", "blocked"):
        label = f"q distributed_sort final_mode={mode} u64+u64"
        cases.append((
            label, k64.numel(),
            lambda mode=mode: par.distributed_sort(k64, p64, final_mode=mode,
                                                   **kw),
            q_gate(label), 0, q_canon))

    # (r) ORDER BY l_shipdate, l_orderkey DESC carrying l_extendedprice;
    # gate: sort_multi(stable=True) column by column (the payload exactly
    # at P = 1, where the distributed sort is stable; else by fingerprint)
    cols = (t["l_shipdate"], t["l_orderkey"])
    price = t["l_extendedprice"]

    def r_gather(out):
        return par.gather_result_multi(out[0], out[1], out[2], group)

    def r_canon(out):
        (g1, g2), (gp,) = r_gather(out)
        return [g1, g2, pair_fp(g2, gp)]

    def r_gate(out):
        no_overflow("(r)", out[3])
        (g1, g2), (gp,) = r_gather(out)
        (w1, w2), (wp,) = srs.sort_multi(cols, price, ascending=(True, False),
                                         stable=True, device=price.device)
        eq("(r) l_shipdate", g1, w1)
        eq("(r) l_orderkey", g2, w2)
        if world == 1:
            eq("(r) l_extendedprice", gp, wp)
        elif int(pair_fp(g2, gp)) != int(pair_fp(w2, wp)):
            raise AssertionError("(r) a payload left its row")

    cases.append((
        "r distributed_sort_multi l_shipdate,l_orderkey desc", n_l,
        lambda: par.distributed_sort_multi(cols, price,
                                           ascending=(True, False), **kw),
        r_gate, 0, r_canon))

    # (s) Q6's filter; gate as (k), on the gathered rows
    mask = q6_mask(t)

    def s_gather(out):
        gk, gp = par.gather_filtered(*out, group=group)
        return [gk, *gp]

    def s_gate(out):
        got = s_gather(out)
        sel = torch.nonzero(mask).squeeze(1)
        if got[0].numel() != sel.numel():
            raise AssertionError("(s) count")
        for col, o in zip(Q6_COLUMNS, got):
            eq("(s) " + col, o, take(t[col], sel))

    cases.append(("s distributed_filter Q6", n_l,
                  lambda: par.distributed_filter(
                      mask, *(t[c] for c in Q6_COLUMNS), **kw),
                  s_gate, 1, s_gather))

    # (t) Q1's groups and l_orderkey's; gate: torch.unique + index_add_ of
    # the exact integer cents
    def t_gate(label, key, aggs):
        def gate(out):
            ng, gk, res = out
            uk, inv, cnt = torch.unique(t[key], sorted=True,
                                        return_inverse=True,
                                        return_counts=True)
            cents = torch.zeros(uk.numel(), dtype=torch.int64,
                                device=uk.device).index_add_(
                0, inv, t["price_cents"])
            if ng != uk.numel():
                raise AssertionError(f"{label}: {ng} groups, not "
                                     f"{uk.numel()}")
            eq(label + " keys", gk, uk)
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r, cnt.to(torch.int32))
                else:
                    want = cents.double() / 100
                    close(f"{label} {agg}", r,
                          want if agg == "sum" else want / cnt)
        return gate

    for label, key, aggs in (
            ("t Q1 distributed_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("t distributed_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label, n_l,
            lambda key=key, aggs=aggs: par.distributed_group_aggregate(
                t[key], price, aggs, **kw),
            t_gate(label, key, aggs), 2,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))

    # (u) lineitem x orders, uniform and with one order's key on every
    # fourth lineitem (hot: flagged by the sample, joined by broadcast);
    # gate: every lineitem matched once, its order's payload as a
    # searchsorted lookup finds it
    okey = t["o_orderkey"]
    build = (t["o_orderdate"], t["o_totalprice"])
    hot = t["l_orderkey"].clone()
    hot[::4] = okey[okey.numel() // 3]
    cap_out = min(2 * n_l // world, n_l)

    def u_gather(out):
        gk, (rowid,), (date, tprice) = par.gather_joined(
            out[0], out[1], out[2], out[3], group)
        order = torch.argsort(rowid)
        return [x.index_select(0, order) for x in (gk, rowid, date, tprice)]

    def u_gate(label, keys, is_hot):
        def gate(out):
            no_overflow(label, out[4])
            gk, rowid, date, tprice = u_gather(out)
            eq(label + " rows", rowid, t["l_rowid"])
            eq(label + " keys", gk, keys)
            at = torch.searchsorted(okey, gk)
            eq(label + " o_orderdate", date, take(build[0], at))
            eq(label + " o_totalprice", tprice, take(build[1], at))
            if is_hot and int(out[5]["hot_key_slots_flagged"]) < 1:
                raise AssertionError(f"{label}: no hot key flagged")
        return gate

    for label, keys, extra in (
            ("u distributed_join uniform", t["l_orderkey"], {}),
            ("u distributed_join hot key", hot, {"hot_min_count": 16})):
        cases.append((
            label, n_l + okey.numel(),
            lambda keys=keys, extra=extra: par.distributed_join(
                keys, (t["l_rowid"],), okey, build,
                out_rows_per_device=cap_out, return_hot_stats=True,
                **extra, **kw),
            u_gate(label, keys, bool(extra)), 5,
            lambda out: [*u_gather(out),
                         out[5]["hot_key_slots_flagged"]]))

    # (v) top_k of (a)'s data; unique of 1%-distinct int32 keys; gates as
    # (o)
    def v_topk_gate(out):
        order = torch.sort(srs.to_sortable(k64, False),
                           stable=True).indices[:100]
        eq("(v) top_k keys", out[0], take(k64, order))
        eq("(v) top_k payload", out[1], take(p64, order))

    cases.append(("v distributed_top_k k=100 u64+u64", k64.numel(),
                  lambda: par.distributed_top_k(k64, p64, k=100, **kw),
                  v_topk_gate, 0, list))

    def v_unique_gate(out):
        ng, gk, mult = out
        uk, cnt = torch.unique(t["uniq"], sorted=True, return_counts=True)
        if ng != uk.numel():
            raise AssertionError("(v) unique count")
        eq("(v) unique keys", gk, uk)
        eq("(v) unique multiplicity", mult, cnt.to(torch.int32))

    cases.append(("v distributed_unique int32", t["uniq"].numel(),
                  lambda: par.distributed_unique(t["uniq"], **kw),
                  v_unique_gate, 2,
                  lambda out: [torch.tensor(out[0]), out[1], out[2]]))

    # (w) the hierarchical tier on an S x C mesh of the ranks: (1, 1) at
    # P = 1, (2, 1) at P = 2, (2, 2) at P = 4; gated as (q) and (t).  At
    # P = 1 the sort is one local sort and each aggregate is tier 0 alone
    # (the one-slice shortcut): one K5 launch each
    slices = 1 if world == 1 else 2
    label = "w hierarchical_sort exchange_chunks=2 u64+u64"
    cases.append((
        label, k64.numel(),
        lambda: par.hierarchical_sort(k64, p64, num_slices=slices,
                                      exchange_chunks=2, **kw),
        q_gate(label), 0, q_canon))
    for label, key, aggs in (
            ("w Q1 hierarchical_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("w hierarchical_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label, n_l,
            lambda key=key, aggs=aggs: par.hierarchical_group_aggregate(
                t[key], price, aggs, num_slices=slices, **kw),
            t_gate(label, key, aggs), 1,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))
    return cases


def distributed_phase(rank: int, world: int, port: int, n: int, seed: int,
                      reps: int, out_path=None):
    """Phase 5 on rank `rank` of `world`, one card per rank: an NCCL group
    (tcp://localhost:port), cases (q)-(w) at full size (--n rows and TPC-H
    SF10, made from --seed on this rank's card), each driven once with the
    launch and host-read counts set to 0 just before it, then timed and
    profiled; then the same cases at 10^6 rows through a Gloo group of the
    same ranks on the CPU and the NCCL group on the card, which must agree.
    Returns rank 0's record (and writes it to `out_path` when given)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from simd_radix_sort_tpu_torch.ops import cuda_hist as ch
    from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
    from simd_radix_sort_tpu_torch.parallel import dist_sort as ds
    from simd_radix_sort_tpu_torch.utils import data as D, interop

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        gloo = dist.new_group(backend="gloo")
        t0 = time.perf_counter()
        keys = D.make_keys(n, np.uint64, D.Distribution.UNIFORM, seed)
        (pay,) = D.make_payloads(keys, [np.uint64])
        pair = (interop.from_numpy(keys, dev), interop.from_numpy(pay, dev))
        del keys, pay
        tables = tpch_tables(SF10_ORDERS, SF10_LINEITEMS, n, seed, dev,
                             u64_pair=pair)
        if rank == 0:
            log(f"phase 5: {world} NCCL rank(s), NCCL "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}; data "
                f"made in {time.perf_counter() - t0:.1f} s")
        results = []
        for (label, rows, run, gate, k5, _) in distributed_cases(
                tables, world, None, dev):
            ch.reset_launches()
            cp.reset_launches()
            ds.reset_host_reads()
            out = run()
            torch.cuda.synchronize()
            launches = {**ch.LAUNCHES, **cp.LAUNCHES}
            host_reads = ds.HOST_READS["split_sizes"]
            gate(out)
            del out
            if launches["partition_pass"] < (k5 > 0) or (
                    world == 1 and launches["partition_pass"] != k5):
                raise AssertionError(f"{label}: {launches} K5 launches, "
                                     f"expected {k5}")
            ms = time_calls(run, max(5, reps // 2))
            wall, per = profile_call(run, ["partition_pass"] if k5 else [])
            busy = sum(per.values())
            nccl = sum(v for k, v in per.items() if "nccl" in k.lower())
            top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
            res = {"case": label, "ranks": world, "n": rows, "ms": ms,
                   "rows_per_s": rows / (ms / 1e3),
                   "launches": {k: v for k, v in launches.items() if v},
                   "split_size_host_reads": host_reads,
                   "trace": {"wall_ms_profiled": wall,
                             "device_busy_ms": busy,
                             "nccl_device_ms": nccl if per else None,
                             "idle_share": 1 - busy / ms if per else None,
                             "top": [[k[:90], v] for k, v in top]}}
            results.append(res)
            if rank == 0:
                log(f"phase 5: {json.dumps(res)}")
        del tables, pair
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        small = tpch_tables(SMALL_N // 4, SMALL_N, SMALL_N, seed, "cpu")
        small_dev = {k: signed(v).to(dev).view(v.dtype)
                     for k, v in small.items()}
        agreed = []
        for on_cpu, on_card in zip(
                distributed_cases(small, world, gloo, "cpu"),
                distributed_cases(small_dev, world, None, dev)):
            out_cpu = on_cpu[2]()
            on_cpu[3](out_cpu)
            out_card = on_card[2]()
            on_card[3](out_card)
            agree(on_cpu[0], on_cpu[5](out_cpu), on_card[5](out_card),
                  signed)
            agreed.append(on_cpu[0])
        if rank == 0:
            log(f"phase 5: {len(agreed)} distributed cases agree between "
                f"the CPU (Gloo) and the card (NCCL) at {SMALL_N} rows in "
                f"{time.perf_counter() - t0:.1f} s")
        record = {"ranks": world,
                  "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                  "cases": results, "cpu_card_agree": agreed}
        if out_path is not None and rank == 0:
            with open(out_path, "w") as f:
                json.dump(record, f)
        return record
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    import simd_radix_sort_tpu_torch as srs
    from simd_radix_sort_tpu_torch import methods
    from simd_radix_sort_tpu_torch.models import roofline
    from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                               cuda_partition as cp, radix)
    from simd_radix_sort_tpu_torch.utils import (data as D, interop, native,
                                                 transforms)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    chip = roofline.chip_for_name(kind)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"roofline {chip.name} {chip.hbm_gbps} GB/s")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({_build.library_path().name})")
    nvcc_log = _build.library_path().with_suffix(".log")
    if nvcc_log.exists():
        log(nvcc_log.read_text().strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = args.n
    ragged = 1_000_003

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64)

    def as_width(v, width):
        """int64 values -> carrier of `width` bytes holding their low
        bits."""
        bits = v & ((1 << (8 * width)) - 1)
        half = 1 << (8 * width - 1)
        return torch.where(bits >= half, bits - 2 * half, bits).to(
            {1: torch.int8, 2: torch.int16, 4: torch.int32}[width])

    def diff(a, b) -> int:
        """max |a - b| over the integer results, as int64."""
        a = a.to(torch.int64) if a.dim() else a.reshape(1).to(torch.int64)
        b = b.to(torch.int64) if b.dim() else b.reshape(1).to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return int((a - b).abs().max().item()) if a.numel() else 0

    errs = {name: 0 for name in TPU_KERNELS}
    checks = {name: 0 for name in TPU_KERNELS}

    def hold(name, got, want, what):
        e = max(diff(g, w) for g, w in zip(got, want))
        if e:
            raise AssertionError(f"{name} {what}: kernel differs from its "
                                 f"plain version by up to {e}")
        errs[name] = max(errs[name], e)
        checks[name] += 1

    # ---- phase 2: kernels against their plain versions ---------------------
    t0 = time.perf_counter()
    for width in (1, 2, 4):
        for k in (16, 256, 1024):
            for size in (n, ragged):
                base = int(randint(0, 1 << (8 * width), 1).item())
                v = as_width(base + randint(-8, k + 8, size + 1), width)
                # the ragged case reads from an offset (misaligned) view
                x = v[1:] if size == ragged else v[:size]
                hold("histogram", (ch.histogram(x, k, base),),
                     (ch.histogram_plain(x, k, base),),
                     f"w={width} k={k} n={size}")
    # (lo, carrier bytes, flip, span): windows straddling 2^31 and 2^32, a
    # 2-byte carrier ordered through its sign flip, and one wide range
    # (out of contract: the stats stay exact, the output is defined)
    for lo, width, flip, span in ((0, 4, 0, 16), (2**31 - 5, 4, 0, 16),
                                  (2**32 - 16, 4, 0, 16),
                                  (0x7FF9, 2, 0x8000, 16),
                                  (0, 4, 0x80000000, 1 << 32)):
        mask = (1 << (8 * width)) - 1
        for size in (n, ragged):
            u = (lo + randint(0, span, size)) & mask
            v = as_width(u ^ flip, width)
            hold("minmax_hist16", ch.minmax_hist16(v, flip),
                 ch.minmax_hist16_plain(v, flip), f"lo={lo} n={size}")
            got = ch.tiny_sort16(v, flip)
            hold("tiny_sort16", got, ch.tiny_sort16_plain(v, flip),
                 f"lo={lo} n={size}")
            if span <= 16:  # in contract: the output is the sorted input
                s = (signed(got[0]).to(torch.int64) & mask) ^ flip
                if not torch.equal(s, torch.sort(u).values):
                    raise AssertionError(f"tiny_sort16 lo={lo}: not sorted")
    fill_cases = [(n, 256, torch.int8, 0x80), (n, 1024, torch.int32, 77),
                  (ragged, 1024, torch.int16, 0x7FF0)]
    for size, k, dtype, base in fill_cases:
        hist = torch.bincount(randint(0, k, size), minlength=k).to(
            torch.int32)
        hold("fill_runs", (ch.fill_runs(hist, size, base, dtype),),
             (ch.fill_runs_plain(hist, size, base, dtype),),
             f"k={k} n={size}")
    for hist_list, dtype in (([3] * 512, torch.int32),
                             ([0, 5, 0, 0, 2, 0], torch.uint8),
                             ([0] * 100 + [n] + [0] * 100, torch.int16)):
        hist = torch.tensor(hist_list, dtype=torch.int32, device=dev)
        size = int(sum(hist_list))
        hold("fill_runs", (ch.fill_runs(hist, size, 3, dtype),),
             (ch.fill_runs_plain(hist, size, 3, dtype),),
             f"skewed/empty k={len(hist_list)}")
    def fill_at_tile(hist, size, base, dtype, tile):
        """K4 launched with a tile of `tile` bytes, or K6 for dtype None,
        past the wrappers (and their launch counts)."""
        out = torch.empty(size, dtype=dtype or torch.uint8, device=dev)
        if dtype is None:
            _build.launch("srs_fill_runs_packed", dev, hist.data_ptr(),
                          hist.numel(), size, tile, out.data_ptr())
        else:
            w = out.element_size()
            _build.launch("srs_fill_runs", dev, hist.data_ptr(), hist.numel(),
                          size, base & ((1 << (8 * w)) - 1), w, tile,
                          out.data_ptr())
        return out

    # K4 and K6 where runs meet the tiles' edges: at the wrappers' tile,
    # and at a 64-byte tile, where most runs of these cases span whole
    # tiles; K6 also against K4's uint8 output
    for width, dtype, base in ((1, torch.int8, 0x80),
                               (2, torch.int16, 0x7FF0),
                               (4, torch.int32, 77)):
        for label, (h, size) in ch.tile_edge_cases(width).items():
            hist = torch.from_numpy(h).to(dev)
            want = (ch.fill_runs_plain(hist, size, base, dtype),)
            hold("fill_runs", (ch.fill_runs(hist, size, base, dtype),), want,
                 f"{label} {dtype} n={size}")
            hold("fill_runs", (fill_at_tile(hist, size, base, dtype, 64),),
                 want, f"{label} {dtype} n={size} tile=64")
    for label, (h, size) in ch.tile_edge_cases(1, ch.MAX_PACKED_K).items():
        hist = torch.from_numpy(h).to(dev)
        size -= size % 4
        want = (ch.fill_runs_packed_plain(hist, size),)
        got = ch.fill_runs_packed(hist, size)
        hold("fill_runs_packed", (got,), want, f"{label} n={size}")
        hold("fill_runs_packed", (got,),
             (ch.fill_runs(hist, size, 0, torch.uint8),),
             f"{label} n={size} against K4")
        hold("fill_runs_packed", (fill_at_tile(hist, size, 0, None, 64),),
             want, f"{label} n={size} tile=64")
    # K5: masks all False, all True, alternating and random; 1, 2 and 4
    # streams of 4- and 8-byte words; the ragged size reads offset views
    # (a misaligned mask) and also runs the smallest tile
    def words(size, width):
        if width == 8:
            return randint(-(2**62), 2**62, size + 1)[1:]
        return randint(-(2**31), 2**31 - 1, size + 1).to(torch.int32)[1:]

    for size in (n, ragged):
        idx = torch.arange(size + 1, device=dev)
        masks = {"all False": idx < 0, "all True": idx >= 0,
                 "alternating": idx % 2 == 1,
                 "random": randint(0, 2, size + 1) == 1}
        del idx
        for widths in ((8,), (8, 4), (8, 4, 8, 4)):
            streams = [words(size, w) for w in widths]
            for pattern, m in masks.items():
                mk = m[1:] if size == ragged else m[:size]
                for block in ((256, cp.PART_BLOCK) if size == ragged
                              else (cp.PART_BLOCK,)):
                    hold("partition_pass",
                         cp.partition_pass(streams, mk, block=block),
                         cp.partition_pass_plain(streams, mk),
                         f"{pattern} widths={widths} n={size} "
                         f"block={block}")
            del streams
        del masks
    # K6 against its plain version and against K4's uint8 output: uniform,
    # skewed (one bucket; halving counts) and empty-bucket histograms
    n4 = n - n % 4
    halving = [n4 >> (b + 1) for b in range(255)]
    packed_cases = [
        ("uniform", torch.bincount(randint(0, 256, n4), minlength=256)),
        ("one bucket", torch.tensor([0] * 100 + [n4] + [0] * 155)),
        ("halving", torch.tensor(halving + [n4 - sum(halving)])),
        ("empty buckets", torch.tensor([0, 5, 0, 0, 3, 0])),
        ("ragged uniform", torch.bincount(randint(0, 256, 1_000_004),
                                          minlength=256))]
    for shape, hist in packed_cases:
        hist = hist.to(device=dev, dtype=torch.int32)
        size = int(hist.sum().item())
        got = ch.fill_runs_packed(hist, size)
        hold("fill_runs_packed", (got,),
             (ch.fill_runs_packed_plain(hist, size),), f"{shape} n={size}")
        hold("fill_runs_packed", (got,),
             (ch.fill_runs(hist, size, 0, torch.uint8),),
             f"{shape} n={size} against K4")
    torch.cuda.synchronize()
    log(f"phase 2: kernels equal their plain versions "
        f"({json.dumps(checks)} comparisons) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3: main paths ------------------------------------------------
    def time_ms(fn, reps=args.reps, warmup=2):
        return time_calls(fn, reps, warmup)

    device_profile = profile_call

    def count_launches(fn):
        ch.reset_launches()
        cp.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {**ch.LAUNCHES, **cp.LAUNCHES}

    def bench_checksums(keys, pay):
        """bench.py's gate on the host input: key sum and xor, and the sum
        and xor of the key-payload pair fingerprint, all mod 2^64."""
        with np.errstate(over="ignore"):
            pair_in = (keys * np.uint64(MIX)) ^ pay
            return (wrap64(keys.sum(dtype=np.uint64)),
                    wrap64(np.bitwise_xor.reduce(keys)),
                    wrap64(pair_in.sum(dtype=np.uint64)),
                    wrap64(np.bitwise_xor.reduce(pair_in)))

    def as_tuple(out):
        if isinstance(out, torch.Tensor):
            return (out,)
        keys, rest = out[0], out[1:]
        if len(rest) == 1 and isinstance(rest[0], tuple):
            rest = rest[0]  # radix.sort_arrays: (keys, payloads)
        return (keys, *rest)

    def stage(keys, pays):
        return (interop.from_numpy(keys, dev),
                tuple(interop.from_numpy(p, dev) for p in pays))

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    # (label, engine, rows, run, check, kernels expected, roofline)
    cases = []

    def lsd_roofline(row_bytes, key_bits):
        return (f"lsd_radix_8bit({row_bytes} B rows)",
                roofline.radix_sort_roofline_rows_per_s(
                    row_bytes=row_bytes, key_bits=key_bits, chip=chip))

    def stream_roofline(row_bytes):
        return (f"one read + one write of {row_bytes} B rows",
                roofline.stream_roofline_rows_per_s(row_bytes, 1.0,
                                                    chip=chip))

    def sorted_carrier(out, asc):
        c = srs.to_sortable(out, asc)
        return bool((c[1:] >= c[:-1]).all())

    # (a) u64 key + u64 payload: the comparison engine; (f), (g) reuse it
    keys = D.make_keys(n, np.uint64, D.Distribution.UNIFORM, args.seed)
    (pay,) = D.make_payloads(keys, [np.uint64])
    sums64 = bench_checksums(keys, pay)
    k64, (p64,) = stage(keys, (pay,))
    del keys, pay

    def check_bench(label, out):
        if not sorted_carrier(out[0], True):
            raise AssertionError(f"{label}: not sorted")
        got = device_checksums(out)
        if got != sums64:
            raise AssertionError(f"{label}: checksums {got} != {sums64}")

    def auto_case(label, keys, pays, asc, engine, row_bytes):
        """A case of sort(method="auto") on the count engine."""
        m = methods.resolve("auto", keys.dtype, [p.dtype for p in pays],
                            keys.shape[0])
        if m.name != engine:
            raise AssertionError(f"{label}: auto resolved to {m.name}, "
                                 f"expected {engine}")
        kd, pd = stage(keys, pays)

        def run():
            return as_tuple(srs.sort(kd, *pd, ascending=asc))

        u = transforms.to_sortable_np(keys)
        span = int(u.max()) - int(u.min())
        if keys.dtype.itemsize == 1:
            expect = ["histogram", "fill_runs"]
        elif span < 16:
            expect = ["minmax_hist16", "tiny_sort16"]
        elif span < 1024:
            expect = ["minmax_hist16", "tiny_sort16", "histogram",
                      "fill_runs"]
        else:
            expect = ["minmax_hist16", "tiny_sort16"]

        def check(out):
            ref = srs.sort(kd, ascending=asc, method="xla")
            if not torch.equal(signed(out[0]), signed(ref)):
                raise AssertionError(f"{label}: differs from the "
                                     "comparison sort of its input")
            if not sorted_carrier(out[0], asc):
                raise AssertionError(f"{label}: not sorted")

        cases.append((label, engine, keys.shape[0], run, check, expect,
                      stream_roofline(row_bytes)))

    def stable_case(label, engine, kd, pd, asc, run, expect, roof,
                    extra=None):
        """A case whose output must equal the stable comparison sort of
        its input byte for byte, keys and payloads."""
        def check(out):
            want = as_tuple(srs.sort(kd, *pd, ascending=asc, method="xla",
                                     stable=True))
            if len(out) != len(want) or not all(
                    g.dtype == w.dtype and torch.equal(signed(g), signed(w))
                    for g, w in zip(out, want)):
                raise AssertionError(f"{label}: differs from the stable "
                                     "comparison sort of its input")
            if extra is not None:
                extra(out)

        cases.append((label, engine, kd.shape[0], run, check, expect, roof))

    m = methods.resolve("auto", k64.dtype, [p64.dtype], n)
    if m.name != "xla":
        raise AssertionError(f"a: auto resolved to {m.name}, expected xla")
    cases.append(("a u64+u64 Uniform", "xla", n,
                  lambda: as_tuple(srs.sort(k64, p64)),
                  lambda out: check_bench("a u64+u64 Uniform", out), [],
                  lsd_roofline(16, 64)))
    # (b) uint8 keys only: 256-bucket counting
    keys8 = D.make_keys(n, np.uint8, D.Distribution.UNIFORM, args.seed)
    auto_case("b uint8 Uniform", keys8, (), True, "count", 1)
    # (c) int32 keys only, tiny range
    for dist in (D.Distribution.ZERO, D.Distribution.ZERO_ONE):
        auto_case(f"c int32 {dist.value}",
                  D.make_keys(n, np.int32, dist, args.seed), (), True,
                  "count", 4)
    # (d) int32 keys only in [-500, 500): the 1024-bucket branch
    auto_case("d int32 [-500,500)",
              rng.integers(-500, 500, n, dtype=np.int32), (), True,
              "count", 4)
    # (e) int16 Gaussian, descending
    auto_case("e int16 Gaussian desc",
              D.make_keys(n, np.int16, D.Distribution.GAUSSIAN, args.seed),
              (), False, "count", 2)
    # (f) the radix engine's default mover: 2 passes of 32-bit digits
    stable_case("f u64+u64 Uniform radix", "radix/sort", k64, (p64,), True,
                lambda: as_tuple(srs.sort(k64, p64, method="radix")), [],
                lsd_roofline(16, 64),
                lambda out: check_bench("f u64+u64 Uniform radix", out))
    # (g) one K5 partition per key bit
    stable_case("g u64+u64 Uniform radix pallas", "radix/pallas", k64,
                (p64,), True,
                lambda: as_tuple(radix.sort_arrays(k64, (p64,),
                                                   engine="pallas")),
                ["partition_pass"], lsd_roofline(16, 64),
                lambda out: check_bench("g u64+u64 Uniform radix pallas",
                                        out))
    # (h) K5 with a widened payload and the top-bit flip of a descending
    # signed key
    keys = D.make_keys(n, np.int32, D.Distribution.UNIFORM, args.seed)
    kh, ph = stage(keys, D.make_payloads(keys, [np.uint16]))
    stable_case("h int32+uint16 Uniform desc radix pallas", "radix/pallas",
                kh, ph, False,
                lambda: as_tuple(radix.sort_arrays(kh, ph, ascending=False,
                                                   engine="pallas")),
                ["partition_pass"], lsd_roofline(6, 32))
    # (i) the scatter mover, the semantic model, at 2^22 rows
    keys = D.make_keys(1 << 22, np.int32, D.Distribution.UNIFORM, args.seed)
    ki, pi = stage(keys, D.make_payloads(keys, [np.int32]))
    stable_case("i int32+int32 Uniform radix scatter", "radix/scatter", ki,
                pi, True,
                lambda: as_tuple(radix.sort_arrays(ki, pi,
                                                   engine="scatter")),
                [], lsd_roofline(8, 32))
    # (j) uint8 keys through K1 and K6: scripts/u8_attack.py's packed-fill
    # path (a histogram of the raw bytes, then the packed run fill)
    kj, _ = stage(keys8[:n4], ())
    stable_case("j uint8 Uniform K1+K6", "K1+K6", kj, (), True,
                lambda: (ch.fill_runs_packed(ch.histogram(kj, 256), n4),),
                ["histogram", "fill_runs_packed"], stream_roofline(1))
    # (k)-(p): the query operators over TPC-H SF10 and the rank and quick
    # engines; top_k and quick reuse (a)'s u64 keys and payloads
    quick_n = min(QUICK_N, n)
    tables = tpch_tables(SF10_ORDERS, SF10_LINEITEMS, n, args.seed, dev,
                         u64_pair=(k64, p64))
    k5_launches = {}
    for (label, engine, rows, run, gate, expect, k5, row_bytes,
         _) in operator_cases(tables, quick_n):
        rows = tables[rows].numel() if isinstance(rows, str) else rows
        cases.append((label, engine, rows,
                      lambda run=run: run(tables),
                      lambda out, gate=gate: gate(tables, out), expect,
                      stream_roofline(row_bytes)))
        k5_launches[label] = k5
    del keys, keys8
    log(f"phase 3: data made in {time.perf_counter() - t0:.1f} s")

    results = []
    for label, engine, rows, run, check, expect, (model, roof) in cases:
        out, launches = count_launches(run)
        check(out)
        del out
        missing = [k for k in expect if launches[k] < 1]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} not launched "
                                 f"({launches})")
        ms = time_ms(run, reps=max(5, args.reps // 2))
        rows_s = rows / (ms / 1e3)
        wall, per = device_profile(run, expect)
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        res = {"case": label, "engine": engine, "n": rows, "ms": ms,
               "rows_per_s": rows_s, "roofline_model": model,
               "roofline_rows_per_s": roof, "roofline_frac": rows_s / roof,
               "launches": {k: v for k, v in launches.items() if v},
               "expected_kernels": expect,
               # idle share against the unprofiled median: the profiler
               # slows the host, not the device
               "trace": {"wall_ms_profiled": wall, "device_busy_ms": busy,
                         "idle_share": 1 - busy / ms if per else None,
                         "top": [[k[:90], v] for k, v in top]}}
        results.append(res)
        log(f"phase 3: {json.dumps(res)}")
    for case, bits in (("g", 64), ("h", 32)):  # one K5 pass per key bit
        r = next(r for r in results if r["case"].startswith(case + " "))
        if r["launches"].get("partition_pass") != bits:
            raise AssertionError(f"({case}) launched {r['launches']}, "
                                 f"expected {bits} K5 passes")
    for r in results:  # one K5 pass per compaction or pivot partition
        want = k5_launches.get(r["case"])
        if want is not None and r["launches"].get("partition_pass",
                                                  0) != want:
            raise AssertionError(f"({r['case']}) launched {r['launches']}, "
                                 f"expected {want} K5 passes")
    main_launches = {name: sum(r["launches"].get(name, 0) for r in results)
                     for name in TPU_KERNELS}

    # the host engines, torch.sort and the native radix on the host, at
    # SMALL_N rows of (a)'s data: each must equal the stable comparison sort
    t0 = time.perf_counter()
    native.build()
    # the native radix runs one thread per hardware thread it is told of
    host_engines = {"native_build_s": time.perf_counter() - t0,
                    "cpu_count": os.cpu_count(),
                    "cpus_usable": len(os.sched_getaffinity(0))}
    log(f"phase 3: native harness built in "
        f"{host_engines['native_build_s']:.1f} s "
        f"({native.library_path().name})")
    hk, hp = k64[:SMALL_N], p64[:SMALL_N]
    want = srs.sort(hk, hp, method="xla", stable=True)
    for name in ("torch", "cpp"):
        got = srs.sort(hk, hp, method=name)
        if not all(g.device == w.device and torch.equal(signed(g), signed(w))
                   for g, w in zip(got, want)):
            raise AssertionError(f"method={name}: differs from the stable "
                                 "comparison sort of its input")
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            srs.sort(hk, hp, method=name)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        host_engines[name] = {"n": SMALL_N, "host_ms": statistics.median(
            reps), "host_ms_runs": reps}
    log(f"phase 3: host engines equal xla stable=True at {SMALL_N} rows "
        f"u64+u64: {json.dumps(host_engines)}")
    del hk, hp, want, got

    # ---- phase 3b: (k)-(p) at 10^6 rows on the CPU and on the card --------
    t0 = time.perf_counter()
    small = tpch_tables(SMALL_N // 4, SMALL_N, SMALL_N, args.seed, "cpu")
    small_dev = {k: signed(v).to(dev).view(v.dtype) for k, v in small.items()}
    agreed = []
    for on_cpu, on_card in zip(operator_cases(small, SMALL_N),
                               operator_cases(small_dev, SMALL_N)):
        label, run, gate, canon = (on_cpu[0], on_cpu[3], on_cpu[4],
                                   on_cpu[8])
        out_cpu = run(small)
        gate(small, out_cpu)
        out_card = on_card[3](small_dev)
        gate(small_dev, out_card)
        agree(label, canon(out_cpu), canon(out_card), signed)
        agreed.append(label)
    # torch.searchsorted on 1- and 2-byte carriers: the quick engine's
    # bucket ids and a join's probes
    from simd_radix_sort_tpu_torch.ops import hashjoin
    for dt in (torch.int8, torch.int16):
        keys = {d: small_t["ties"].to(dt) for d, small_t in
                (("cpu", small), ("cuda", small_dev))}
        outs = {d: (srs.sort(k, method="quick", device=k.device),
                    hashjoin.lookup_join(k, k[:1000])[:2])
                for d, k in keys.items()}
        agree(f"narrow {dt}", outs["cpu"], outs["cuda"], signed)
        agreed.append(f"narrow {dt}")
    del small, small_dev
    log(f"phase 3b: {len(agreed)} cases agree between the CPU and the card "
        f"at {SMALL_N} rows in {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: kernel times at the main paths' shapes -------------------
    del cases, kh, ph, ki, pi, kj
    u8 = as_width(randint(0, 256, n), 1)
    i32 = as_width(randint(0, 2, n), 4)
    i32w = as_width(randint(-500, 500, n), 4)
    h256 = ch.histogram(u8, 256, 0x80)
    h1024 = ch.histogram(i32w, 1024, (-500) & 0xFFFFFFFF)
    h256u = ch.histogram(u8[:n4], 256, 0)
    flip32 = 0x80000000
    part = [signed(k64), signed(p64)]
    part_mask = randint(0, 2, n) == 1
    u8_values = torch.arange(256, device=dev).to(torch.uint8)

    q6_streams = [tables[c] for c in Q6_COLUMNS]
    q6_keep = ~q6_mask(tables)  # K5 puts mask=False rows first
    n_q6 = q6_keep.numel()

    def bound(nbytes, ops):
        t_bytes = roofline.bound_ms(nbytes, chip)
        t_ops = ops / PEAK_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def argsort_gather(streams, mask):
        order = torch.argsort(mask, stable=True)
        return [signed(s).index_select(0, order) for s in streams]

    # (name, shape, kernel, plain, library call, its description, bytes,
    # operations)
    shapes = [
        ("histogram", "uint8 n=%d k=256 (case b)" % n,
         lambda: ch.histogram(u8, 256, 0x80),
         lambda: ch.histogram_plain(u8, 256, 0x80),
         lambda: torch.bincount(u8.view(torch.uint8), minlength=256),
         "bincount", n + 256 * 4, n),
        ("histogram", "int32 n=%d k=1024 (case d)" % n,
         lambda: ch.histogram(i32w, 1024, -500),
         lambda: ch.histogram_plain(i32w, 1024, (-500) & 0xFFFFFFFF),
         lambda: torch.bincount(i32w + 500, minlength=1024),
         "bincount", 4 * n + 1024 * 4, n),
        ("minmax_hist16", "int32 n=%d (cases c-e)" % n,
         lambda: ch.minmax_hist16(i32, flip32),
         lambda: ch.minmax_hist16_plain(i32, flip32),
         lambda: (torch.aminmax(i32), torch.bincount(i32 & 15,
                                                     minlength=16)),
         "aminmax + bincount", 4 * n + 18 * 4, n),
        ("tiny_sort16", "int32 ZeroOne n=%d (case c)" % n,
         lambda: ch.tiny_sort16(i32, flip32),
         lambda: ch.tiny_sort16_plain(i32, flip32),
         lambda: torch.sort(i32).values,
         "sort", 8 * n, 2 * n),
        ("fill_runs", "int8 n=%d k=256 (case b)" % n,
         lambda: ch.fill_runs(h256, n, 0x80, torch.int8),
         lambda: ch.fill_runs_plain(h256, n, 0x80, torch.int8),
         lambda: torch.repeat_interleave(
             torch.arange(256, device=dev).to(torch.int8),
             h256.to(torch.int64), output_size=n),
         "repeat_interleave", n + 257 * 8, n),
        ("fill_runs", "int32 n=%d k=1024 (case d)" % n,
         lambda: ch.fill_runs(h1024, n, -500, torch.int32),
         lambda: ch.fill_runs_plain(h1024, n, (-500) & 0xFFFFFFFF,
                                    torch.int32),
         lambda: torch.repeat_interleave(
             torch.arange(-500, 524, device=dev, dtype=torch.int32),
             h1024.to(torch.int64), output_size=n),
         "repeat_interleave", 4 * n + 1025 * 8, n),
        # the mask read once, two int64 streams read once and written once
        ("partition_pass",
         "2 x int64 streams n=%d, random mask (one pass of case g)" % n,
         lambda: cp.partition_pass(part, part_mask),
         lambda: cp.partition_pass_plain(part, part_mask),
         lambda: argsort_gather(part, part_mask),
         "argsort(mask, stable=True) + one index_select per stream",
         33 * n, n),
        # the Q6 filter's pass (case k): an int32 and three float64 streams
        ("partition_pass",
         "int32 + 3 x float64 streams n=%d, Q6 mask (case k)" % n_q6,
         lambda: cp.partition_pass(q6_streams, q6_keep),
         lambda: cp.partition_pass_plain(q6_streams, q6_keep),
         lambda: argsort_gather(q6_streams, q6_keep),
         "argsort(mask, stable=True) + one index_select per stream",
         57 * n_q6, n_q6),
        ("fill_runs_packed", "uint8 n=%d k=256 (case j)" % n4,
         lambda: ch.fill_runs_packed(h256u, n4),
         lambda: ch.fill_runs_packed_plain(h256u, n4),
         lambda: torch.repeat_interleave(u8_values, h256u.to(torch.int64),
                                         output_size=n4),
         "repeat_interleave", n4 + 257 * 8, n4),
    ]
    timings = []
    for name, shape, kern, plain, lib, lib_call, nbytes, ops in shapes:
        # plain, kernel, kernel, plain: the two versions alternate
        p1, k1 = time_ms(plain), time_ms(kern)
        k2, p2 = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound(nbytes, ops)
        _, per = device_profile(kern, (name,))
        mine = {k: v for k, v in per.items()
                if any(f in k for f in KERNEL_FUNCTIONS[name])}
        if name in ("fill_runs", "fill_runs_packed") and len(per) > 1:
            raise AssertionError(f"{name}: one call ran {sorted(per)} on "
                                 "the card, not its kernel alone")
        t = {"name": name, "shape": shape, "ms": min(k1, k2),
             "device_ms": sum(mine.values()) if per else None,
             "device_ms_by_function": {k[:80]: v for k, v in mine.items()},
             "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
             "plain_ms_runs": [p1, p2], "library_ms": lib_ms,
             "library_call": lib_call,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        timings.append(t)
        log(f"phase 4: {json.dumps(t)}")

    # K4 and K6 at tiles of 4-64 KiB, past the wrappers: the kernel's
    # device time in one call from the profiler (back-to-back launches
    # between events would time the host's launch rate), the tiles taken in
    # turn forwards and backwards, twice
    fill_shapes = [("fill_runs", "int8 k=256 (case b)", h256, n, 0x80,
                    torch.int8),
                   ("fill_runs", "int32 k=1024 (case d)", h1024, n, -500,
                    torch.int32),
                   ("fill_runs_packed", "uint8 k=256 (case j)", h256u, n4, 0,
                    None)]
    tiles = (4096, 8192, 16384, 32768, 65536)
    tile_ms = {(shape, tile): [] for _, shape, *_ in fill_shapes
               for tile in tiles}
    for name, shape, hist, size, base, dtype in fill_shapes:
        want = (ch.fill_runs_packed_plain(hist, size) if dtype is None
                else ch.fill_runs_plain(hist, size, base, dtype))
        for tile in tiles:
            hold(name, (fill_at_tile(hist, size, base, dtype, tile),),
                 (want,), f"{shape} tile={tile}")
        del want
        for tile in (*tiles, *reversed(tiles)) * 2:
            _, per = device_profile(
                lambda: fill_at_tile(hist, size, base, dtype, tile), (name,))
            tile_ms[(shape, tile)].append(sum(per.values()) if per else None)
    tile_sweep = [{"name": name, "shape": shape, "tile_bytes": tile,
                   "shipped": tile == ch.FILL_TILE_BYTES,
                   "device_ms_runs": tile_ms[(shape, tile)]}
                  for name, shape, *_ in fill_shapes for tile in tiles]
    for t in tile_sweep:
        log(f"phase 4: tile sweep {json.dumps(t)}")

    # ---- phase 5: the distributed tier --------------------------------------
    # each rank makes its own data; this process's tensors go first
    del shapes, fill_shapes, tables, k64, p64, u8, i32, i32w, part, part_mask
    del q6_streams, q6_keep, h256, h1024, h256u
    torch.cuda.empty_cache()
    world = max(p for p in (1, 2, 4) if p <= torch.cuda.device_count())
    t0 = time.perf_counter()
    if world == 1:
        distributed = distributed_phase(0, 1, free_port(), n, args.seed,
                                        args.reps)
    else:
        record = _build.BUILD_DIR / "distributed_phase.json"
        torch.multiprocessing.start_processes(
            distributed_phase, nprocs=world, start_method="spawn",
            args=(world, free_port(), n, args.seed, args.reps, str(record)))
        distributed = json.loads(record.read_text())
    for r in distributed["cases"]:
        for name, count in r["launches"].items():
            main_launches[name] += count
    log(f"phase 5: the distributed tier on {world} rank(s) in "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (replaces, source) in TPU_KERNELS.items():
        t = next(x for x in timings if x["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": replaces,
            "launches": main_launches[name], "equal": errs[name] == 0,
            "comparisons": checks[name], "max_abs_err": errs[name],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")

    report = {"card": card, "torch": torch.__version__,
              "nvcc_report": (nvcc_log.read_text() if nvcc_log.exists()
                              else None),
              "cuda": torch.version.cuda, "n": n, "seed": args.seed,
              "kernels": kernels, "kernel_timings": timings,
              "fill_tile_sweep": tile_sweep,
              "main_path": results, "host_engines": host_engines,
              "cpu_card_agree": agreed,
              "distributed": distributed,
              "seconds": time.perf_counter() - t_start}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(f"card: {card}")  # again here, within any tail of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
