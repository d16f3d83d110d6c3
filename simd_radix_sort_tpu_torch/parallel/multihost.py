"""Multi-host / multi-slice scale-out over torch.distributed: the
hierarchical two-phase sort and the matching two-tier group aggregate.

Counterpart of simd_radix_sort_tpu/parallel/multihost.py.  The ranks of a
process group form an S x C mesh, slice-major: rank r = s·C + c is chip c
of slice s (a host, or a pod slice).  Its outer axis (DCN, between slices)
is the S ranks that share c; its inner axis (ICI, within a slice) is the C
ranks of slice s.  The sort crosses the outer axis once:

  phase 1 (DCN, chunked): S-1 coarse splitters from a global sample assign
      every row to a destination slice; each rank sends its rows bound for
      slice s to its same-position peer there.  The local rows go in Q
      chunks, each sorted on its own and exchanged with its own capacity,
      the Q exchanges in flight together (`dist_sort.exchange_chunks`: one
      host read of split sizes for all of them);
  phase 2 (ICI): within each slice, the flat splitter sort of
      parallel/dist_sort.py over the inner axis.

Every row crosses the outer axis at most once, and the P-way partitioning
traffic stays within a slice.  The splitters, capacities, sample counts,
overflow flags and output rows per rank are the JAX package's, so each
rank's count, overflow and valid key prefix equal its device's there.

The mesh axes are `dist_sort.Subgroup`s of the group: their collectives run
on the group's own communicators, so nothing here creates a process group
(a torch subgroup is collective over the whole world, or, made with local
synchronisation, named after how many groups its creator had made before;
neither fits a group whose ranks have made different groups).  What the
backend changes is dist_sort.py's list (its docstring): the final sorts
order the valid prefix only, so the JAX package's invalid-row flag stream
is not needed; float64 travels as float64, so there is no `meta`.
"""

from __future__ import annotations

import math
import os
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import hashagg, xla_sort
from ..utils import common, transforms
from . import dist_ops, dist_sort
from .dist_sort import Subgroup, rank_device, shard_rows


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> None:
    """Initialise the default process group, unless one exists: NCCL, or
    Gloo for device="cpu".  The arguments default to the environment
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them);
    coordinator_address is "host:port".  With NCCL, the process takes card
    LOCAL_RANK (0 without it)."""
    if dist.is_initialized():
        return
    dev = common.resolve_device(device)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "nccl",
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"), **kw)


class HierarchicalGroups(NamedTuple):
    """This rank's place in an S x C mesh of a process group (the JAX
    package's 2-D Mesh): its slice and chip, and its two axes."""
    num_slices: int
    chips_per_slice: int
    slice_index: int
    chip_index: int
    dcn: Subgroup  # the S ranks that share this chip index
    ici: Subgroup  # the C ranks of this slice


def _host_names(group) -> list:
    names = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, socket.gethostname(), group=group)
    return names


def make_hierarchical_groups(num_slices: int | None = None,
                             group=None) -> HierarchicalGroups:
    """The S x C mesh of `group` (None is the default group): slices on the
    outer (DCN) axis, each slice's ranks on the inner (ICI) axis, slice-
    major.  With num_slices=None a slice is a host: the ranks of one host
    must be as many on every host (ragged hosts raise rather than become a
    1 x P mesh) and consecutive in rank order.  Creates no process group,
    so it costs nothing but the host names' all-gather, and any subset of
    the world may call it on its group."""
    dist_sort._require_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if num_slices is None:
        names = _host_names(group)
        hosts = list(dict.fromkeys(names))
        per = {h: [r for r, x in enumerate(names) if x == h] for h in hosts}
        if len({len(v) for v in per.values()}) != 1:
            raise ValueError(f"uneven ranks per host: "
                             f"{ {h: len(v) for h, v in per.items()} }")
        num_slices = len(hosts)
        width = world // num_slices
        if any(v != list(range(i * width, (i + 1) * width))
               for i, v in enumerate(per.values())):
            raise ValueError(f"the ranks of a host are not consecutive: "
                             f"{per}")
    if num_slices < 1 or world % num_slices:
        raise ValueError(f"{world} ranks not divisible into {num_slices} "
                         "slices")
    width = world // num_slices
    s, c = divmod(rank, width)
    return HierarchicalGroups(
        num_slices, width, s, c,
        Subgroup(group, tuple(range(c, world, width))),
        Subgroup(group, tuple(range(s * width, (s + 1) * width))))


# the JAX package's name for it
make_hierarchical_mesh = make_hierarchical_groups


def _sort_chunks(kop, pl_ops, q: int):
    """Each of q equal chunks of the carrier `kop` sorted on its own (one
    batched sort), the payload streams following."""
    vals, idx = torch.sort(kop.view(q, -1), dim=1)
    chunk = vals.shape[1]
    idx = (idx + torch.arange(q, device=kop.device)[:, None] * chunk).view(-1)
    return vals.view(-1), tuple(xla_sort.gather(p, idx) for p in pl_ops)


def hierarchical_sort_sharded(keys: torch.Tensor, payloads,
                              mesh: HierarchicalGroups,
                              ascending: bool = True,
                              capacity_factor: float = 2.0,
                              samples_per_device: int = 128,
                              exchange_chunks: int = 2, use_ragged=None):
    """Two-phase sort of this rank's rows over `mesh` (every rank passes
    the same number of rows, on its device).

    Returns (keys, payloads, counts, overflow) like
    `dist_sort.distributed_sort_sharded`: keys and payloads padded, when
    C = 1, to phase 1's rows (Q·cap1, or n_local with one slice), else to
    cap2 = ceil(capacity_factor · n_local);
    counts a (1,) int32 tensor; overflow a (1,) int32 tensor, the same on
    every rank: the largest over the ranks of the sum of the Q chunks'
    flags (each the largest over the rank's outer axis) and the inner
    exchange's flag, as the JAX package sums and then maximises them.
    Concatenating the valid prefixes in rank order is the sorted table."""
    S, C = mesh.num_slices, mesh.chips_per_slice
    num_p = S * C
    group = mesh.dcn.parent
    me = mesh.slice_index * C + mesh.chip_index
    n_local = keys.shape[0]
    q = max(1, min(exchange_chunks, n_local))
    while n_local % q:
        q -= 1
    chunk = n_local // q
    cap1 = max(int(math.ceil(capacity_factor * chunk)), 1)
    cap2 = max(int(math.ceil(capacity_factor * n_local)), 1)
    dev = keys.device
    (kop,) = transforms.key_operands(keys, ascending)
    pl_ops = dist_sort.split_payload_streams(payloads)

    # ---- phase 1: route every row to its slice over the outer axis -------
    if S > 1:
        k_s, p_s = _sort_chunks(kop, pl_ops, q)
        # positions interleave ranks and chunks: chunk i's row j is
        # j·(P·Q) + rank·Q + i; the sample reads the Q domains end to end
        pos = (torch.arange(chunk, device=dev)[None, :] * (num_p * q)
               + (me * q + torch.arange(q, device=dev))[:, None]).view(-1)
        splitters = dist_sort.gather_splitters((k_s, pos), group, S - 1,
                                               samples_per_device)
        chunks = []
        for i in range(q):
            part = slice(i * chunk, (i + 1) * chunk)
            bounds = dist_sort.lex_bounds((k_s[part], pos[part]), splitters)
            chunks.append(((k_s[part],) + tuple(p[part] for p in p_s),
                           *dist_sort.runs_of_bounds(bounds, chunk)))
        merged, totals, flags = dist_sort.exchange_chunks(chunks, mesh.dcn,
                                                          cap1)
        total1, ov1 = sum(totals), sum(flags)
        dist_sort._sort_prefix(merged, 1, total1)
    else:
        # one slice: nothing to route, and no chunk sorts
        ks, ps = dist_sort._sort_rows((kop,), pl_ops)
        merged, total1, ov1 = [*ks, *ps], n_local, 0

    # ---- phase 2: the flat splitter sort within the slice ----------------
    n1 = merged[0].shape[0]
    if C > 1:
        domain = (merged[0], torch.arange(n1, device=dev) * num_p + me)
        splitters = dist_sort.gather_splitters(
            domain, mesh.ici, C - 1, samples_per_device, n_valid=total1)
        bounds = dist_sort.lex_bounds(tuple(w[:total1] for w in domain),
                                      splitters)
        out, count, ov2 = dist_sort.exchange_by_bounds(
            merged, bounds, mesh.ici, cap2, n_valid=total1)
        dist_sort._sort_prefix(out, 1, count)
    else:
        out, count, ov2 = merged, total1, 0
    return (transforms.keys_from_operands((out[0],), keys.dtype, ascending),
            dist_sort.merge_payload_streams(out[1:],
                                            [p.dtype for p in payloads]),
            torch.tensor([count], dtype=torch.int32, device=dev),
            dist_sort.pmax(torch.tensor(ov1 + ov2, device=dev), group))


def hierarchical_sort(keys, *payloads, group=None,
                      num_slices: int | None = None, ascending: bool = True,
                      capacity_factor: float = 2.0,
                      samples_per_device: int = 128,
                      exchange_chunks: int = 2, use_ragged=None,
                      device=None):
    """Host entry of the two-phase sort: the global keys and payloads on
    every rank of `group`, which keeps its block of rows; returns this
    rank's (padded_keys, payloads, counts, overflow) on its device
    (`dist_sort.gather_result` assembles the table).  Like the JAX entry it
    does not retry on overflow."""
    dev = rank_device(device)
    mesh = make_hierarchical_groups(num_slices, group)
    return hierarchical_sort_sharded(
        shard_rows(keys, group, dev),
        tuple(shard_rows(p, group, dev) for p in payloads), mesh, ascending,
        capacity_factor, samples_per_device, exchange_chunks)


def hierarchical_group_aggregate_sharded(keys: torch.Tensor, values,
                                         mesh: HierarchicalGroups, aggs_req,
                                         capacity_factor: float = 2.0,
                                         cap1: int | None = None,
                                         cap2: int | None = None,
                                         samples_per_device: int = 128,
                                         use_ragged=None):
    """Two-tier group aggregate of this rank's rows over `mesh`: the
    hierarchical sort's schedule applied to aggregate partials
    (dist_ops' partial-stream algebra).

      0. a local group_aggregate: one partial row per key per rank, so a
         hot key's volume anywhere is bounded by the rank count;
      1. coarse key-range splitters from a global sample route each partial
         to its owner slice over the outer axis; arriving partials combine;
      2. fine splitters within the slice route the combined partials to
         their owner rank over the inner axis; a final combine finishes.

    With one slice, tier 0's table (already grouped, unique and sorted)
    goes to tier 2 as it is.  Returns (count, group_keys, partial_totals...,
    overflow): count and overflow (1,) int32 tensors, overflow the same on
    every rank; concatenating the valid prefixes in rank order is the
    ascending group table."""
    S, C = mesh.num_slices, mesh.chips_per_slice
    group = mesh.dcn.parent
    n_local = keys.shape[0]
    if cap1 is None:
        cap1 = max(int(math.ceil(capacity_factor * n_local)), 1)
    if cap2 is None:
        cap2 = max(int(math.ceil(capacity_factor * n_local)), 1)
    partial_aggs = dist_ops.partial_streams_for(aggs_req)
    (carrier,) = transforms.key_operands(keys, True)
    top = torch.iinfo(carrier.dtype).max

    # ---- tier 0: local partials -------------------------------------------
    ng, gkc, results = hashagg.group_aggregate(carrier, values,
                                               aggs=partial_aggs)
    parts = tuple(res if pa == "count" else res[0]
                  for pa, res in zip(partial_aggs, results))
    # rows past the valid prefix sort past every splitter
    gkc = dist_ops._fill_past(gkc, int(ng), top)

    # ---- tier 1: each partial to its owner slice --------------------------
    if S > 1:
        splitters = dist_sort.gather_splitters(
            (gkc,), group, S - 1, samples_per_device, n_valid=ng)
        recv, total, ov1 = dist_sort.exchange_by_bounds(
            (gkc,) + parts, dist_sort.lex_bounds((gkc,), splitters),
            mesh.dcn, cap1, n_valid=ng)
        # tier 2 samples a cap1-row table, as the JAX package's
        cnt1, gk1, parts1 = dist_ops.combine_received_partials(
            recv, partial_aggs, total, rows=cap1 if C > 1 else None)
        gk1 = dist_ops._fill_past(gk1, int(cnt1), top)
    else:
        cnt1, gk1, parts1, ov1 = ng, gkc, parts, 0

    # ---- tier 2: each combined partial to its owner rank ------------------
    if C > 1:
        splitters = dist_sort.gather_splitters(
            (gk1,), mesh.ici, C - 1, samples_per_device, n_valid=cnt1)
        recv, total, ov2 = dist_sort.exchange_by_bounds(
            (gk1,) + tuple(parts1), dist_sort.lex_bounds((gk1,), splitters),
            mesh.ici, cap2, n_valid=cnt1)
        cnt, gk_f, tot_f = dist_ops.combine_received_partials(
            recv, partial_aggs, total)
    else:
        cnt, gk_f, tot_f, ov2 = cnt1, gk1, parts1, 0
    dev = keys.device
    return (torch.as_tensor(cnt, device=dev).to(torch.int32).reshape(1),
            transforms.keys_from_operands((gk_f,), keys.dtype, True),
            *tot_f,
            dist_sort.pmax(torch.tensor(ov1 + ov2, device=dev), group))


def hierarchical_group_aggregate(keys, values, agg="sum", group=None,
                                 num_slices: int | None = None,
                                 capacity_factor: float = 2.0,
                                 samples_per_device: int = 128,
                                 max_retries: int = 2, use_ragged=None,
                                 device=None):
    """Host entry of the two-tier group aggregate: the contract of
    `dist_ops.distributed_group_aggregate` (agg a name or a tuple of names
    sharing one set of exchanges; returns (num_groups, group_keys,
    result_or_tuple) on every rank, keys ascending), with the partials
    exchanged hierarchically.  Both tiers receive into cap_recv =
    capacity_factor · n_local rows, doubled on overflow up to max_retries;
    an overflow at the last attempt raises."""
    dev = rank_device(device)
    mesh = make_hierarchical_groups(num_slices, group)
    aggs_req, k_l, v_l = dist_ops.stage_aggregate_inputs(
        keys, values, agg, "hierarchical_group_aggregate", group, dev)

    def step(cap_recv):
        return hierarchical_group_aggregate_sharded(
            k_l, v_l, mesh, aggs_req, cap1=cap_recv, cap2=cap_recv,
            samples_per_device=samples_per_device)

    out = dist_ops.run_elastic_aggregate(
        step, k_l.shape[0], mesh.num_slices * mesh.chips_per_slice,
        capacity_factor, max_retries, "hierarchical_group_aggregate")
    return dist_ops.assemble_aggregate_result(
        out, agg, aggs_req, dist_ops.partial_streams_for(aggs_req), group)


def distributed_sort_multihost(keys, *payloads, group=None, **kw):
    """The flat single-phase sort across every rank of `group`
    (`dist_sort.distributed_sort`).  Prefer `hierarchical_sort` across
    slices: it sends each row between slices once."""
    return dist_sort.distributed_sort(keys, *payloads, group=group, **kw)
