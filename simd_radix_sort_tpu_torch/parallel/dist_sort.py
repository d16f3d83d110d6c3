"""Distributed sort over torch.distributed.

Counterpart of simd_radix_sort_tpu/parallel/dist_sort.py: the splitter sort
(histogram sort with sampling) of a table whose rows are split across the
ranks of a process group, one process per rank:

  1. each rank sorts its rows (the comparison engine, ops/xla_sort.py);
  2. evenly strided samples of (key words, position) are all-gathered and
     sorted, and P-1 splitters are read off at the sample quantiles;
  3. each rank cuts its sorted rows into P key ranges (a binary search per
     splitter) and sends range p to rank p, one `all_to_all_single` a
     stream;
  4. each rank sorts the valid prefix of what it received.

The JAX package runs this inside `shard_map` over a mesh axis.  Here each
process is one rank of `group` (None is the default group), and the mesh
axis' index and size are `dist.get_rank(group)` and
`dist.get_world_size(group)`.  Host entries take the global arrays on every
rank, and rank r keeps rows [r·n/P, (r+1)·n/P), the block layout of the JAX
package's `NamedSharding(mesh, P(axis))`; the `_sharded` form takes the
rank's own rows.  Every rank must make the same calls in the same order.

The capacity protocol is the JAX package's: receive buffers of
cap_recv = ceil(capacity_factor · n_local) rows, the whole (P, P) size
matrix clipped on every rank, an overflow flag that is the maximum over the
ranks (read off the gathered size matrix, which every rank holds), an
elastic retry that doubles the factor up to P, and outputs padded per rank
to the capacity; what overflows is truncated and flagged.  What the backend
changes:

  * the size matrix comes to the host, one read per exchange
    (`HOST_READS`), because the split sizes of `all_to_all_single` are
    Python ints.  So the final sort orders only the valid prefix
    [0, total_recv), and the rows past it are zeros (the JAX package sorts
    its padding behind an invalid flag);
  * the exchange is one path on every backend (`use_ragged` is accepted and
    ignored): runs that are adjacent are sent as they lie, runs with gaps
    (the blocked mode's, a clipped overflow's) are first copied together;
    `exchange_chunks` makes several exchanges with one host read, their
    transfers in flight together;
  * a mesh axis of a 2-D mesh (parallel/multihost.py) is a `Subgroup`: some
    ranks of a group, whose collectives run on that group's communicator
    with the other ranks' shares empty;
  * every stream travels as its bytes, an (n, itemsize) int8 view: Gloo has
    no int16, and neither Gloo nor NCCL has uint16/32/64;
  * a 64-bit key or payload is one int64 word (the JAX package's u32
    (hi, lo) words serve the TPU's X64 rewriter), float64 travels as it is
    (the card's float64 is exact, so there is no f64-as-bits staging and no
    `meta`), and the tie-break position is int64 (the JAX package's u32
    position limits a sort to 2^32 rows);
  * nothing is traced or cached: the port runs eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import sort as sort_ops
from ..ops import xla_sort
from ..utils import common, transforms

# host reads of an exchange's size matrix (one per exchange_by_runs call)
HOST_READS = {"split_sizes": 0}

_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def reset_host_reads() -> None:
    HOST_READS["split_sizes"] = 0


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "torch.distributed.init_process_group first, one process per "
            "rank")


class Subgroup(NamedTuple):
    """Some ranks of the process group `parent` (None is the default group)
    that exchange only among themselves: one axis of a 2-D mesh.  `ranks`
    are ranks of `parent`, ascending, so member order is rank order.  Its
    collectives run on the parent's communicator, with empty shares for
    the other ranks; every rank of the parent takes part in each one, each
    for its own subgroup, so no communicator is created for it."""
    parent: object
    ranks: tuple


def rank_and_size(group) -> tuple[int, int]:
    """This process's rank in `group` (a process group or a Subgroup) and
    the group's size."""
    if isinstance(group, Subgroup):
        return group.ranks.index(dist.get_rank(group.parent)), len(group.ranks)
    return dist.get_rank(group), dist.get_world_size(group)


def make_group(num_devices: int | None = None):
    """The process group of the first `num_devices` ranks (every rank by
    default): the counterpart of the JAX package's `make_mesh`.  Every rank
    must call it; a rank outside a smaller group gets
    `GroupMember.NON_GROUP_MEMBER`."""
    _require_group()
    world = dist.get_world_size()
    if num_devices is None or num_devices == world:
        return dist.group.WORLD
    if not 1 <= num_devices <= world:
        raise ValueError(f"num_devices={num_devices} outside [1, {world}]")
    return dist.new_group(list(range(num_devices)))


def rank_device(device=None) -> torch.device:
    """The device rule of the distributed entries: None is this process's
    current CUDA device, and no card raises unless the caller passes
    device="cpu"; then a process group must be initialised."""
    dev = common.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _require_group()
    return dev


def stage_host_bits(x, device) -> torch.Tensor:
    """A host array or tensor on `device`, every bit kept: the staging every
    distributed entry shares (float64 stays float64; a bool mask stays
    bool)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
        return x.to(device)
    if isinstance(x, np.ndarray) and x.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return sort_ops._stage(x, device)


def shard_rows(x, group, device) -> torch.Tensor:
    """This rank's block of rows of a global array, on `device`."""
    rank, num_p = dist.get_rank(group), dist.get_world_size(group)
    n = x.shape[0]
    if n % num_p:
        raise ValueError(f"global length {n} not divisible by group size "
                         f"{num_p}")
    m = n // num_p
    return stage_host_bits(x[rank * m:(rank + 1) * m], device).contiguous()


def fetch_flag(x) -> np.ndarray:
    """Host-read a small flag or count tensor.  The flags the tier returns
    are already the same on every rank (reduced by MAX), so unlike the JAX
    package's multi-process path nothing is gathered first."""
    return torch.as_tensor(x).detach().cpu().numpy()


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A 1-D stream as the (n, itemsize) int8 rows a collective carries."""
    t = t.contiguous()
    return t.view(torch.int8).view(t.shape[0], t.element_size())


def _unwire(b: torch.Tensor, dtype) -> torch.Tensor:
    return b.view(-1).view(dtype)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of `t` from every rank of `group`, in rank order (the JAX
    package's `lax.all_gather(...).reshape(-1)`).  Every rank passes the
    same number of rows.  A Subgroup gathers over its parent and keeps its
    members' rows."""
    w = _wire(t)
    parent = group.parent if isinstance(group, Subgroup) else group
    world = dist.get_world_size(parent)
    out = w.new_empty((world * w.shape[0], w.shape[1]))
    _all_gather_single(out, w, group=parent)
    if isinstance(group, Subgroup):
        members = torch.tensor(group.ranks, device=out.device)
        out = out.view(world, *w.shape).index_select(0, members).view(
            -1, w.shape[1])
    return _unwire(out, t.dtype)


def _all_to_all(out, src, recv, send, group):
    """`all_to_all_single` with split sizes per rank of `group`, issued with
    async_op=True: returns its work.  A Subgroup's exchange runs on its
    parent, with zero rows to and from every other rank."""
    if isinstance(group, Subgroup):
        world = dist.get_world_size(group.parent)
        recv_all, send_all = [0] * world, [0] * world
        for i, r in enumerate(group.ranks):
            recv_all[r], send_all[r] = recv[i], send[i]
        recv, send, group = recv_all, send_all, group.parent
    return dist.all_to_all_single(out, src, recv, send, group=group,
                                  async_op=True)


def pmax(flag, group=None) -> torch.Tensor:
    """int32 maximum of a flag or count over the ranks (`lax.pmax`)."""
    x = torch.as_tensor(flag).to(torch.int32).reshape(1).clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def split_payload_streams(payloads):
    """Payload streams as the signed views the local sorts and gathers
    move.  The JAX package splits 64-bit streams into u32 (hi, lo) words
    here; the port moves every width whole."""
    return tuple(common.as_signed(p) for p in payloads)


def merge_payload_streams(ops, dtypes):
    """Inverse of split_payload_streams: the same bits in `dtypes`."""
    return tuple(o.view(dt) for o, dt in zip(ops, dtypes))


# ---------------------------------------------------------------------------
# the exchange core
# ---------------------------------------------------------------------------


def exchange_by_bounds(streams, bounds, group, cap_recv: int,
                       use_ragged=None, n_valid=None):
    """Bucketed all-to-all of runs that lie side by side (the exchange core
    of the distributed sort, join and aggregate).

    `streams` are this rank's n_local rows, whose bucket-p rows are the run
    [bounds[p-1], bounds[p]) (bounds holds P-1 entries; run 0 starts at 0,
    run P-1 ends at n_local, or at `n_valid`: rows past it are padding from
    an earlier exchange and never travel).  Bucket p of every rank goes to
    rank p, packed source-major into a cap_recv-row buffer per stream.

    Returns (recv_streams, total_recv, overflow), two Python ints: rows past
    total_recv are zeros; overflow is 1 when some rank's buckets exceeded
    cap_recv (its results are then truncated).  `use_ragged` is ignored."""
    n_local = streams[0].shape[0]
    if n_local == 0:
        # every rank holds the same number of rows, so every rank skips
        return [s.new_zeros(cap_recv) for s in streams], 0, 0
    starts, lens = runs_of_bounds(bounds, n_local, n_valid)
    return exchange_by_runs(streams, starts, lens, group, cap_recv)


def runs_of_bounds(bounds, n_local: int, n_valid=None):
    """(starts, lens), int64, of the P runs that P-1 bounds cut from a
    sorted buffer of n_local rows; the last run ends at n_local, or at
    `n_valid`, where every run is clipped."""
    end = torch.as_tensor(n_local if n_valid is None else n_valid,
                          device=bounds.device).to(torch.int64).clamp(
                              max=n_local)
    bounds = torch.minimum(bounds.to(torch.int64), end)
    starts = torch.cat([bounds.new_zeros(1), bounds])
    return starts, torch.cat([bounds, end.reshape(1)]) - starts


def exchange_by_runs(streams, starts, lens, group, cap_recv: int,
                     use_ragged=None):
    """Bucketed all-to-all in general: the run [starts[p], starts[p] +
    lens[p]) of every rank's streams goes to rank p, packed source-major
    into a cap_recv-row buffer per stream.  The runs need not be adjacent
    (the blocked mode sends one key segment at a time), but must be
    disjoint and in destination order.  Returns as exchange_by_bounds."""
    recv, totals, overflows = exchange_chunks([(streams, starts, lens)],
                                              group, cap_recv)
    return recv, totals[0], overflows[0]


def exchange_chunks(chunks, group, cap_recv: int):
    """Q bucketed all-to-alls in one: `chunks` is a list of (streams,
    starts, lens), each an `exchange_by_runs` of its own, clipped to its own
    cap_recv rows exactly as Q separate calls would clip it.  One all-gather
    carries every chunk's run table, so the Q exchanges cost one host read
    of split sizes, not Q, and every chunk's `all_to_all_single` is in
    flight before any is waited on.  Every chunk has the same streams'
    dtypes and the same row count.

    Returns (recv_streams, totals, overflows): one buffer of Q·cap_recv
    rows per stream, chunk i's totals[i] received rows at offset
    sum(totals[:i]) (the received rows of all chunks form one prefix, the
    rest are zeros), and one overflow flag per chunk, 1 when some rank's
    chunk exceeded cap_recv; totals and flags are Python ints."""
    rank, num_p = rank_and_size(group)
    q = len(chunks)
    first = chunks[0][0]
    if first[0].shape[0] == 0:
        # every rank holds the same number of rows, so every rank skips
        return [s.new_zeros(q * cap_recv) for s in first], [0] * q, [0] * q
    meta = torch.cat([torch.cat([lens, starts]) for _, starts, lens
                      in chunks]).to(torch.int64)
    sizes = all_gather_rows(meta, group).view(num_p, q, 2, num_p).tolist()
    HOST_READS["split_sizes"] += 1
    outs = [_wire(s).new_zeros((q * cap_recv, s.element_size()))
            for s in first]
    works, totals, overflows, offset = [], [], [], 0
    for i, (streams, _, _) in enumerate(chunks):
        # clip the WHOLE size matrix, as every rank does, so that what rank
        # s sends to rank d is what rank d expects from rank s
        clipped = [[0] * num_p for _ in range(num_p)]
        raw = [0] * num_p  # rows bound for each rank before clipping
        for d in range(num_p):
            for s in range(num_p):
                size = sizes[s][i][0][d]
                clipped[s][d] = max(0, min(size, cap_recv - raw[d]))
                raw[d] += size
        total = min(raw[rank], cap_recv)
        send = clipped[rank]
        recv = [clipped[s][rank] for s in range(num_p)]
        my_starts = sizes[rank][i][1]
        adjacent = all(my_starts[d] + send[d] == my_starts[d + 1]
                       for d in range(num_p - 1))
        for s, out in zip(streams, outs):
            w = _wire(s)
            if adjacent:
                src = w.narrow(0, my_starts[0], sum(send))
            else:
                src = torch.cat([w.narrow(0, a, m)
                                 for a, m in zip(my_starts, send)])
            works.append(_all_to_all(out.narrow(0, offset, total), src,
                                     recv, send, group))
        totals.append(total)
        overflows.append(int(max(raw) > cap_recv))
        offset += total
    for work in works:
        work.wait()
    return ([_unwire(o, s.dtype) for o, s in zip(outs, first)], totals,
            overflows)


def _lex_less(rows, splitters) -> torch.Tensor:
    less = torch.zeros(rows[0].shape, dtype=torch.bool, device=rows[0].device)
    eq = torch.ones_like(less)
    for r, s in zip(rows, splitters):
        less |= eq & (r < s)
        eq &= r == s
    return less


def lex_bounds(domain, splitters) -> torch.Tensor:
    """Bucket boundaries of splitters in a sorted multi-word lexicographic
    domain: bounds[p] = the number of rows strictly below splitter p, as
    int64.  One word is a `searchsorted`; several are a binary search per
    splitter, all splitters at once (ceil(log2(n + 1)) steps of a gather
    and a compare; the JAX package counts an (n, P-1) compare instead)."""
    num_s = splitters[0].shape[0]
    dev = domain[0].device
    if len(domain) == 1:
        return torch.searchsorted(domain[0].contiguous(),
                                  splitters[0].contiguous())
    n = domain[0].shape[0]
    lo = torch.zeros(num_s, dtype=torch.int64, device=dev)
    hi = torch.full((num_s,), n, dtype=torch.int64, device=dev)
    if num_s == 0:
        return lo
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        at = mid.clamp(max=n - 1)
        less = _lex_less([w.index_select(0, at) for w in domain], splitters)
        active = lo < hi
        lo, hi = (torch.where(active & less, mid + 1, lo),
                  torch.where(active & ~less, mid, hi))
    return lo


def lex_argsort(words) -> torch.Tensor:
    """The permutation that sorts rows by several words lexicographically:
    stable sorts from the last word to the first."""
    perm = None
    for w in reversed(tuple(words)):
        k = w if perm is None else w.index_select(0, perm)
        order = torch.argsort(k, stable=True)
        perm = order if perm is None else perm.index_select(0, order)
    return perm


def _sort_rows(kops, streams):
    """Sort lock-step streams by the key words `kops` (signed carriers):
    one unstable `torch.sort` for one word (the JAX package's local sorts
    are unstable too), else `lex_argsort`.  Returns (kops, streams)."""
    if len(kops) == 1:
        vals, idx = torch.sort(kops[0])
        return (vals,), tuple(xla_sort.gather(s, idx) for s in streams)
    perm = lex_argsort(kops)
    return (tuple(k.index_select(0, perm) for k in kops),
            tuple(xla_sort.gather(s, perm) for s in streams))


def _sort_prefix(recv, nk: int, total: int) -> None:
    """Sort rows [0, total) of the received streams by their first nk
    streams, in place."""
    if total == 0:
        return
    ks, ps = _sort_rows(tuple(r[:total] for r in recv[:nk]),
                        tuple(r[:total] for r in recv[nk:]))
    for r, h in zip(recv, ks + ps):
        r[:total] = h


# ---------------------------------------------------------------------------
# splitters
# ---------------------------------------------------------------------------


def sample_strided(domain, group, s: int, n_valid=None):
    """`s` evenly strided rows of this rank's (valid prefix of its)
    multi-word domain, all-gathered: a list of (s·P,) words.  The index
    arithmetic is float32, as the JAX package's, so both packages read the
    same rows.  An empty rank contributes `s` zero rows."""
    n_local = domain[0].shape[0]
    if n_local == 0:
        return [all_gather_rows(w.new_zeros(s), group) for w in domain]
    dev = domain[0].device
    base = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    if n_valid is None:
        step = torch.tensor(n_local / s, dtype=torch.float32, device=dev)
        idx = (base * step).to(torch.int64)
    else:
        nv = torch.as_tensor(n_valid, device=dev).to(torch.int64)
        idx = (base * (nv.clamp(min=1).to(torch.float32) / s)).to(torch.int64)
        idx = torch.minimum(idx, (nv - 1).clamp(min=0))
    return [all_gather_rows(w.index_select(0, idx), group) for w in domain]


def gather_splitters(domain, group, num_splitters: int,
                     samples_per_shard: int, n_valid=None):
    """Splitters of one locally sorted domain: a tuple of words, each
    (num_splitters,).  `n_valid` restricts sampling to a valid prefix (with
    padding in the sample, the quantiles collapse toward it)."""
    return gather_splitters_parts([(domain, n_valid)], group, num_splitters,
                                  samples_per_shard)


def gather_splitters_parts(parts, group, num_splitters: int,
                           samples_per_shard: int):
    """gather_splitters over several locally sorted buffers pooled into one
    sample (a join's probe and build tables, each with its own valid
    prefix).  `parts` is a list of (domain_words, n_valid_or_None); each
    part's sample count is proportional to its buffer size.  Samples from
    a rank whose valid prefix is empty are marked invalid and sort behind
    the valid ones, so they cannot drag the quantiles."""
    total_local = sum(d[0].shape[0] for d, _ in parts) or 1
    nwords = len(parts[0][0])
    pools, valids = [], []
    for domain, n_valid in parts:
        n_local = domain[0].shape[0]
        dev = domain[0].device
        s = (max(1, min(n_local, samples_per_shard * n_local // total_local))
             if n_local else 1)
        pools.append(sample_strided(domain, group, s, n_valid))
        if n_local == 0:
            v = torch.zeros(s, dtype=torch.bool, device=dev)
        elif n_valid is None:
            v = torch.ones(s, dtype=torch.bool, device=dev)
        else:
            v = (torch.as_tensor(n_valid, device=dev) > 0).expand(s)
        valids.append(all_gather_rows(v, group))
    samples = [torch.cat([p[i] for p in pools]) for i in range(nwords)]
    valid = torch.cat(valids)
    order = lex_argsort([(~valid).to(torch.int8)] + samples)
    flat = [w.index_select(0, order) for w in samples]
    n_ok = valid.sum()
    denom = n_ok.clamp(min=1).to(torch.float32)
    spl_idx = (torch.arange(1, num_splitters + 1, dtype=torch.float32,
                            device=valid.device)
               * (denom / (num_splitters + 1))).to(torch.int64)
    spl_idx = torch.minimum(spl_idx, (n_ok - 1).clamp(min=0))
    return tuple(w.index_select(0, spl_idx) for w in flat)


# ---------------------------------------------------------------------------
# the sort bodies
# ---------------------------------------------------------------------------


def _sorted_domain(kops, pl_ops, rank: int, num_p: int):
    """Local sort, and the search domain (key words..., position): the
    position rank-interleaved (i·P + rank), so it breaks every tie exactly
    and duplicate-heavy inputs stay balanced."""
    kops_s, pays_s = _sort_rows(tuple(kops), tuple(pl_ops))
    n_local = kops_s[0].shape[0]
    pos = (torch.arange(n_local, dtype=torch.int64, device=kops_s[0].device)
           * num_p + rank)
    return kops_s, pays_s, kops_s + (pos,)


def splitter_sort_core(kops, pl_ops, group, num_p: int, cap_recv: int,
                       samples_per_shard: int, use_ragged=None):
    """The splitter sort's per-rank body: local sort, splitters of the
    (key words, position) domain, one exchange of contiguous runs, a sort
    of the valid prefix.  `kops` may hold any number of key words (one
    carrier, or one per column of a multi-column ORDER BY).

    Returns (kops_final, pays_final, count, overflow): streams of cap_recv
    rows, `count` valid; count and overflow are Python ints."""
    rank = dist.get_rank(group)
    kops_s, pays_s, domain = _sorted_domain(kops, pl_ops, rank, num_p)
    splitters = gather_splitters(domain, group, num_p - 1, samples_per_shard)
    recv, total, overflow = exchange_by_bounds(
        kops_s + pays_s, lex_bounds(domain, splitters), group, cap_recv)
    nk = len(kops_s)
    _sort_prefix(recv, nk, total)
    return tuple(recv[:nk]), tuple(recv[nk:]), total, overflow


def splitter_sort_blocked_core(kops, pl_ops, group, num_p: int, cap_seg: int,
                               samples_per_shard: int, use_ragged, segments):
    """Blocked variant of `splitter_sort_core`: the key domain is cut into
    num_p · segments global ranges by finer splitters; rank p receives its
    `segments` ranges into cap_seg-row sub-buffers (one exchange each, so
    `segments` host reads) and sorts each one's valid prefix.

    Returns (kops_final, pays_final, counts, overflow): streams of
    segments · cap_seg rows, segment-major, and one count per segment (a
    list of ints); `gather_result` reads each segment as one more buffer."""
    rank = dist.get_rank(group)
    seg = int(segments)
    kops_s, pays_s, domain = _sorted_domain(kops, pl_ops, rank, num_p)
    n_local = kops_s[0].shape[0]
    splitters = gather_splitters(domain, group, num_p * seg - 1,
                                 samples_per_shard)
    fine = lex_bounds(domain, splitters)
    all_b = torch.cat([fine.new_zeros(1), fine, fine.new_full((1,), n_local)])
    # rank p owns ranges [p·seg, (p+1)·seg), so segment-major output is
    # globally ordered
    dst = torch.arange(num_p, device=fine.device) * seg
    streams = kops_s + pays_s
    nk = len(kops_s)
    parts, counts, overflow = [], [], 0
    for k in range(seg):
        starts = all_b.index_select(0, dst + k)
        ends = all_b.index_select(0, dst + k + 1)
        recv, total, ov = exchange_by_runs(streams, starts, ends - starts,
                                           group, cap_seg)
        _sort_prefix(recv, nk, total)
        parts.append(recv)
        counts.append(total)
        overflow = max(overflow, ov)
    flat = [torch.cat([p[i] for p in parts]) for i in range(len(streams))]
    return tuple(flat[:nk]), tuple(flat[nk:]), counts, overflow


def distributed_sort_sharded(keys: torch.Tensor, payloads, group=None,
                             ascending: bool = True,
                             capacity_factor: float = 2.0,
                             samples_per_device: int = 256,
                             use_ragged=None, final_mode: str = "sort",
                             segments_per_device: int = 8):
    """Distributed sort of this rank's rows (every rank passes the same
    number of rows, on its device).

    Returns (keys, payloads, counts, overflow): keys and payloads padded to
    cap_recv rows (final_mode "sort") or segments_per_device · cap_seg rows
    ("blocked": a batch of segment buffers, the JAX package's one batched
    block sort); counts is an int32 tensor of one valid-prefix count per
    buffer, (1,) or (segments_per_device,); overflow an int32 (1,) tensor,
    the same on every rank."""
    if final_mode not in ("sort", "blocked"):
        raise ValueError(f"unknown final_mode {final_mode!r}")
    num_p = dist.get_world_size(group)
    n_local = keys.shape[0]
    seg = max(int(segments_per_device), 1)
    s_per_dev = min(n_local, samples_per_device) or 1
    kops = transforms.key_operands(keys, ascending)
    pl_ops = split_payload_streams(payloads)
    if final_mode == "blocked":
        # per segment: the same memory as the one padded buffer; finer
        # ranges see more sampling error, which the elastic retry absorbs
        cap_seg = max(int(math.ceil(capacity_factor * n_local / seg)), 1)
        kf, pf, counts, overflow = splitter_sort_blocked_core(
            kops, pl_ops, group, num_p, cap_seg, s_per_dev, use_ragged, seg)
    else:
        cap_recv = max(int(math.ceil(capacity_factor * n_local)), 1)
        kf, pf, count, overflow = splitter_sort_core(
            kops, pl_ops, group, num_p, cap_recv, s_per_dev)
        counts = [count]
    dev = keys.device
    return (transforms.keys_from_operands(kf, keys.dtype, ascending),
            merge_payload_streams(pf, [p.dtype for p in payloads]),
            torch.tensor(counts, dtype=torch.int32, device=dev),
            torch.tensor([overflow], dtype=torch.int32, device=dev))


def distributed_sort(keys, *payloads, group=None, ascending: bool = True,
                     capacity_factor: float = 2.0,
                     samples_per_device: int = 256, max_retries: int = 2,
                     final_mode: str = "sort", segments_per_device: int = 8,
                     device=None):
    """Host entry: the global keys and payloads (NumPy arrays or tensors)
    on every rank; sorts them across `group` and returns this rank's
    (padded_keys, payloads, counts, overflow) on its device
    (`distributed_sort_sharded`'s layout; `gather_result` assembles the
    table).  `final_mode` and `segments_per_device` reach the sharded form,
    which the JAX package's host entry does not expose.

    Elastic recovery: when sampling error or skew overflows the receive
    capacity, the sort runs again with the capacity factor doubled, up to
    `max_retries` times and at most to P (a factor of P holds everything on
    one rank).  Every rank reads the same flag, so all retry together."""
    dev = rank_device(device)
    keys_l = shard_rows(keys, group, dev)
    pays_l = tuple(shard_rows(p, group, dev) for p in payloads)
    num_p = dist.get_world_size(group)
    cap = capacity_factor
    for attempt in range(max_retries + 1):
        out = distributed_sort_sharded(
            keys_l, pays_l, group, ascending, cap, samples_per_device,
            final_mode=final_mode, segments_per_device=segments_per_device)
        if not fetch_flag(out[3]).any():
            break
        if attempt == max_retries or cap >= num_p:
            break
        cap = min(cap * 2.0, float(num_p))
    return out


def distributed_sort_multi(keys_columns, *payloads, group=None,
                           ascending=True, capacity_factor: float = 2.0,
                           samples_per_device: int = 256,
                           max_retries: int = 2, use_ragged=None,
                           device=None):
    """Distributed ORDER BY over several key columns (each ascending or
    descending): each column's carrier is one key word of the splitter
    sort, whose sampling, tie-break, exchange and merge are the single-key
    sort's.  Returns this rank's (key_columns, payloads, counts, overflow);
    gather with `gather_result_multi`."""
    dev = rank_device(device)
    keys_columns = tuple(keys_columns)
    if not keys_columns:
        raise ValueError("need at least one key column")
    if isinstance(ascending, bool):
        ascending = (ascending,) * len(keys_columns)
    if len(ascending) != len(keys_columns):
        raise ValueError("one ascending flag per key column")
    lengths = {c.shape[0] for c in keys_columns}
    if len(lengths) != 1:
        raise ValueError(f"key columns differ in length: {sorted(lengths)}")
    cols = [shard_rows(c, group, dev) for c in keys_columns]
    pays = tuple(shard_rows(p, group, dev) for p in payloads)
    num_p = dist.get_world_size(group)
    n_local = cols[0].shape[0]
    s_per_dev = min(n_local, samples_per_device) or 1
    kops = tuple(transforms.key_operands(c, up)[0]
                 for c, up in zip(cols, ascending))
    pl_ops = split_payload_streams(pays)
    cap = capacity_factor
    for attempt in range(max_retries + 1):
        cap_recv = max(int(math.ceil(cap * n_local)), 1)
        kf, pf, count, overflow = splitter_sort_core(
            kops, pl_ops, group, num_p, cap_recv, s_per_dev)
        if not overflow or attempt == max_retries or cap >= num_p:
            break
        cap = min(cap * 2.0, float(num_p))
    cols_out = tuple(transforms.keys_from_operands((w,), c.dtype, up)
                     for w, c, up in zip(kf, cols, ascending))
    return (cols_out, merge_payload_streams(pf, [p.dtype for p in pays]),
            torch.tensor([count], dtype=torch.int32, device=dev),
            torch.tensor([overflow], dtype=torch.int32, device=dev))


def gather_result(out_keys, out_pays, counts, group=None):
    """The whole sorted table on every rank: each rank's valid prefixes
    (one per buffer of `counts`) concatenated in rank order, as tensors on
    the rank's device.  One all-gather of the counts (one host read), then
    one all-gather per stream of the valid rows padded to the longest."""
    num_p = dist.get_world_size(group)
    nbuf = counts.numel()
    per_buf = out_keys.shape[0] // nbuf
    all_counts = all_gather_rows(counts.to(torch.int64).reshape(-1),
                                 group).view(num_p, nbuf).tolist()
    mine = all_counts[dist.get_rank(group)]
    totals = [sum(c) for c in all_counts]
    longest = max(totals)
    out = []
    for s in (out_keys,) + tuple(out_pays):
        w = _wire(s)
        valid = torch.cat([w.narrow(0, b * per_buf, c)
                           for b, c in enumerate(mine)]
                          + [w.new_zeros((longest - sum(mine), w.shape[1]))])
        rows = all_gather_rows(_unwire(valid, s.dtype), group)
        out.append(torch.cat([rows[r * longest: r * longest + t]
                              for r, t in enumerate(totals)]))
    return out[0], tuple(out[1:])


def gather_result_multi(out_cols, out_pays, counts, group=None):
    """gather_result for distributed_sort_multi: (key_columns, payloads)."""
    first, rest = gather_result(out_cols[0],
                                tuple(out_cols[1:]) + tuple(out_pays),
                                counts, group)
    streams = (first,) + rest
    ncols = len(out_cols)
    return streams[:ncols], streams[ncols:]
