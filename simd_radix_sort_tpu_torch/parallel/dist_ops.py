"""Distributed query operators over torch.distributed.

Counterpart of simd_radix_sort_tpu/parallel/dist_ops.py, on the exchange
core of dist_sort.py: one process per rank of `group` (None is the default
group); host entries take the global arrays on every rank and keep rank r's
block of rows; results are tensors on the rank's device.

  * `distributed_filter`: each rank compacts its rows (one K5 launch).
  * `distributed_group_aggregate`: per-rank partial aggregates, a KEY-RANGE
    exchange of the partials, so rank p combines exactly the p-th key range
    (O(n_local) work and traffic per rank).  Combinable aggregates only
    ("sum", "count", "min", "max", "mean", or a tuple of them, sharing one
    exchange).
  * `distributed_join`: range-partitioned sort-merge inner join, with a
    broadcast path for sampled heavy-hitter keys.
  * `distributed_top_k`: local top-k, a k·P-row all-gather, a final top-k.
  * `distributed_unique`: distinct keys + multiplicities through the
    aggregate's exchange.

The JAX package raises NotImplementedError for float64 on a backend whose
float64 is lossy (its TPU); the card's float64 is exact, so the port
computes the answer, as the JAX package does on its CPU backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import filter as filter_op
from ..ops import hashagg, hashjoin, topk, xla_sort
from ..utils import common, transforms
from . import dist_sort
from .dist_sort import rank_device, shard_rows

# ---- aggregate partial-stream algebra (shared with the hierarchical tier) --
# each requested aggregate decomposes into partial streams; each partial
# stream has its own cross-rank combine op
PARTIALS = {"sum": ("sum",), "count": ("count",), "min": ("min",),
            "max": ("max",), "mean": ("sum", "count")}
COMBINE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def partial_streams_for(aggs_req):
    """Deduped partial-stream list for a tuple of requested aggregates
    (sum/mean/count families share streams)."""
    partial_aggs = []
    for a in aggs_req:
        for pa in PARTIALS[a]:
            if pa not in partial_aggs:
                partial_aggs.append(pa)
    return tuple(partial_aggs)


def combine_identity(dtype, combine):
    """The combine op's neutral element for a torch dtype, as a Python
    number: what the rows past a combined table's count hold."""
    if combine == "sum":
        return 0
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return info.max if combine == "min" else info.min
    return float("inf") if combine == "min" else float("-inf")


def _fill_past(t: torch.Tensor, count: int, value) -> torch.Tensor:
    """`t`, in place, with the rows at and past `count` set to `value` (bits
    kept for the unsigned dtypes torch stores but cannot compare).  The
    callers read the count to the host once: a mask from `torch.arange`
    costs more on the card."""
    v = common.as_signed(torch.full((), value, dtype=t.dtype))
    common.as_signed(t)[count:] = v.to(t.device)
    return t


def stage_aggregate_inputs(keys, values, agg, what, group, device):
    """Validation and staging shared by the aggregate entries.  Returns
    (aggs_req, keys_local, values_local)."""
    aggs_req = (agg,) if isinstance(agg, str) else tuple(agg)
    if not aggs_req:
        raise ValueError(f"{what}: empty agg tuple")
    for a in aggs_req:
        if a not in PARTIALS:
            raise ValueError(f"{what}: unsupported aggregate {a!r}")
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"values length {values.shape[0]} != keys "
                         f"length {keys.shape[0]}")
    return (aggs_req, shard_rows(keys, group, device),
            shard_rows(values, group, device))


def run_elastic_aggregate(step, n_local, num_p, capacity_factor, max_retries,
                          what):
    """The elastic-capacity retry of the aggregate entries: `step(cap_recv)`
    runs the per-rank body (overflow flag last); the capacity doubles on
    overflow up to max_retries and to P; raises if even the widest attempt
    overflowed.  Returns the final step's output."""
    cap = capacity_factor
    for attempt in range(max_retries + 1):
        cap_recv = max(int(cap * n_local), 1)
        out = step(cap_recv)
        if not dist_sort.fetch_flag(out[-1]).any():
            break
        if attempt == max_retries or cap >= num_p:
            break
        cap = min(cap * 2.0, float(num_p))
    if dist_sort.fetch_flag(out[-1]).any():
        raise ValueError(
            f"{what}: a key range's partials exceed receive capacity even "
            f"at factor {cap}; groups are too skewed for the per-rank buffer")
    return out


def assemble_aggregate_result(out, agg, aggs_req, partial_aggs, group):
    """Gather the per-rank group tables (rank order IS key order) and unpack
    the partial totals into the requested aggregates.  Returns
    (num_groups, group_keys, result or tuple of results); a mean is float64,
    as the JAX package's host division gives it."""
    counts, gks, totals = out[0], out[1], out[2:-1]
    gk_out, tot = dist_sort.gather_result(gks, tuple(totals), counts, group)
    slot = {pa: i for i, pa in enumerate(partial_aggs)}

    def result_for(a):
        if a == "mean":
            return tot[slot["sum"]] / tot[slot["count"]].to(torch.float64)
        return tot[slot[PARTIALS[a][0]]]

    ng = int(gk_out.shape[0])
    if isinstance(agg, str):
        return ng, gk_out, result_for(agg)
    return ng, gk_out, tuple(result_for(a) for a in aggs_req)


def combine_received_partials(recv, partial_aggs, total_recv: int,
                              rows: int | None = None):
    """Combine exchanged partial rows into per-group totals.

    `recv` holds the key carrier stream followed by the partial streams
    (partial_aggs order), with total_recv valid rows.  The valid prefix is
    known on the host, so only it is combined: no padding row enters, and
    the JAX package's validity stream and second compaction (which keep
    padding out of its groups) are not needed.  One group_aggregate, each
    partial under its combine op (one K5 launch).

    Returns (num_groups (1,) int32 tensor, carrier_groups, totals):
    total_recv rows in ascending carrier order, or `rows` rows when given
    (the JAX package's cap_recv, where a further exchange reads the table:
    every rank then holds as many rows); past num_groups the carriers are 0
    and each total holds its combine's identity."""
    combine_ops, streams_per_op = [], {}
    for i, pa in enumerate(partial_aggs):
        op = COMBINE[pa]
        if op not in streams_per_op:
            combine_ops.append(op)
            streams_per_op[op] = []
        streams_per_op[op].append(i)
    ng, gk, res_all = hashagg.group_aggregate(
        recv[0][:total_recv], tuple(p[:total_recv] for p in recv[1:]),
        aggs=tuple(combine_ops),
        agg_streams=tuple(tuple(streams_per_op[op]) for op in combine_ops))
    def grown(t):
        if rows is None or rows <= t.shape[0]:
            return t
        out = t.new_zeros(rows)
        common.as_signed(out)[:t.shape[0]] = common.as_signed(t)
        return out

    totals = [None] * len(partial_aggs)
    n = int(ng)
    for op, res in zip(combine_ops, res_all):
        for j, i in enumerate(streams_per_op[op]):
            totals[i] = _fill_past(grown(res[j]), n,
                                   combine_identity(res[j].dtype, op))
    return ng.reshape(1), _fill_past(grown(gk), n, 0), totals


def distributed_filter(predicate, keys, *payloads, group=None, device=None):
    """Filter a table across the ranks: `predicate` (keys -> bool mask)
    runs on each rank's rows, or is the global bool mask, which each rank
    cuts as it cuts the rows (as `filter_rows` takes a mask; a predicate
    over several columns, TPC-H Q6's, is such a mask).  Returns this rank's
    (count, keys, payloads): its selected rows packed at the front, count a
    (1,) int32 tensor."""
    dev = rank_device(device)
    if not callable(predicate):
        predicate = shard_rows(predicate, group, dev)
    out = filter_op.filter_rows(
        predicate, shard_rows(keys, group, dev),
        *(shard_rows(p, group, dev) for p in payloads))
    return out[0].reshape(1), out[1], tuple(out[2:])


def gather_filtered(counts, keys, payloads=(), group=None):
    """Every rank's valid prefix, concatenated in rank order, on every
    rank."""
    return dist_sort.gather_result(keys, tuple(payloads), counts, group)


def distributed_group_aggregate(keys, values, agg="sum", group=None,
                                capacity_factor: float = 2.0,
                                samples_per_device: int = 128,
                                max_retries: int = 2, use_ragged=None,
                                device=None):
    """Aggregate values per distinct key across the ranks.

    Two phases with a key-range exchange of the partials: each rank's
    partial aggregates (group_aggregate on the key carrier) are range-
    partitioned by shared splitters over the group-key domain and exchanged
    (`dist_sort.exchange_by_bounds`), so rank p combines exactly the p-th
    key range.  The number of groups a range may hold is capacity_factor ·
    n_local (doubled on overflow up to `max_retries`).

    Returns (num_groups, group_keys, result) on every rank, group keys
    ascending.  agg is one of "sum", "count", "min", "max", "mean", or a
    tuple of them computed in the same exchange ("mean" travels as (sum,
    count), so ("sum", "mean", "count") ships two partial streams), and then
    result is a tuple in request order.  Float keys group by IEEE-754
    totalOrder bits: -0.0 is its own group below +0.0."""
    dev = rank_device(device)
    aggs_req, k_l, v_l = stage_aggregate_inputs(
        keys, values, agg, "distributed_group_aggregate", group, dev)
    num_p = dist.get_world_size(group)
    partial_aggs = partial_streams_for(aggs_req)

    def step(cap_recv):
        # both phases group the CARRIER (the order-preserving image of the
        # key): the exchange ships ranges of the grouped prefix, which must
        # be sorted in the order the splitters and bounds use
        (carrier,) = transforms.key_operands(k_l, True)
        ng, gkc, results = hashagg.group_aggregate(carrier, v_l,
                                                   aggs=partial_aggs)
        parts = tuple(res if pa == "count" else res[0]
                      for pa, res in zip(partial_aggs, results))
        # the padded tail is forced to the signed carrier's maximum (the
        # JAX package's unsigned maximum: the same place in the order), so
        # no bound counts it below a splitter
        gkc = _fill_past(gkc, int(ng), torch.iinfo(gkc.dtype).max)
        # key-domain splitters only, no position tie-break: all partials of
        # one key must land on one rank
        splitters = dist_sort.gather_splitters(
            (gkc,), group, num_p - 1, samples_per_device, n_valid=ng)
        recv, total_recv, overflow = dist_sort.exchange_by_bounds(
            (gkc,) + parts, dist_sort.lex_bounds((gkc,), splitters), group,
            cap_recv, n_valid=ng)
        cnt, gk_fc, tot_f = combine_received_partials(recv, partial_aggs,
                                                      total_recv)
        gk_f = transforms.keys_from_operands((gk_fc,), k_l.dtype, True)
        return (cnt, gk_f, *tot_f,
                torch.tensor([overflow], dtype=torch.int32, device=dev))

    out = run_elastic_aggregate(step, k_l.shape[0], num_p, capacity_factor,
                                max_retries, "distributed_group_aggregate")
    return assemble_aggregate_result(out, agg, aggs_req, partial_aggs, group)


def _hot_keys_from_sample(domain, group, samples_per_shard: int, h: int,
                          min_count: int):
    """The `h` most frequent keys of a gathered strided sample of ONE
    table's key domain, each flagged valid when it has >= min_count sample
    occurrences.  Every rank derives the identical list from the identical
    sample.  Ties in frequency go to the key that sorts first, as
    `lax.top_k` breaks them (lowest index first).  Returns (words tuple of
    (h',) tensors, valid (h',) bool), h' <= h."""
    n_local = domain[0].shape[0]
    if n_local == 0:  # empty table: no hot keys
        return (tuple(w.new_zeros(1) for w in domain),
                torch.zeros(1, dtype=torch.bool, device=domain[0].device))
    s = min(n_local, samples_per_shard) or 1
    samples = dist_sort.sample_strided(domain, group, s)
    order = dist_sort.lex_argsort(samples)
    swords = [w.index_select(0, order) for w in samples]
    total = swords[0].shape[0]
    neq = torch.zeros(total, dtype=torch.bool, device=order.device)
    for w in swords:
        neq |= w != torch.roll(w, 1)
    neq[0] = True
    pos = torch.arange(total, device=order.device)
    # cummax on the s·P-row sample only: on a long tensor it runs far
    # below the card's rate
    run_start = torch.cummax(torch.where(neq, pos, 0), 0).values
    is_last = torch.roll(neq, -1)
    is_last[-1] = True
    score = torch.where(is_last, pos - run_start + 1, -1)
    counts, top = torch.sort(score, descending=True, stable=True)
    counts, top = counts[:min(h, total)], top[:min(h, total)]
    return tuple(w.index_select(0, top) for w in swords), counts >= min_count


def _match_any(domain, hot_words, hot_valid):
    """Row mask: does the row's key equal any valid hot key?  The port's
    join key is one carrier word, so this is one `searchsorted` in the
    sorted hot list (valid copies first among equal keys), where the JAX
    package compares every row with every hot key."""
    (w,), (hw,) = domain, hot_words
    order = dist_sort.lex_argsort((hw, (~hot_valid).to(torch.int8)))
    hw_s, hv_s = hw.index_select(0, order), hot_valid.index_select(0, order)
    at = torch.searchsorted(hw_s, w.contiguous()).clamp(max=hw_s.shape[0] - 1)
    return (hw_s.index_select(0, at) == w) & hv_s.index_select(0, at)


def _take_valid(words, idx, valid):
    """words[idx] where `valid`, else 0 (the padding slots' indices may
    point anywhere, so they are clamped); a 0-row stream (an empty side)
    gives zeros."""
    return tuple(torch.where(valid, xla_sort.gather(
        w, idx.clamp(0, w.shape[0] - 1)), 0)
                 if w.shape[0] else w.new_zeros(idx.shape) for w in words)


def distributed_join(probe_keys, probe_payloads, build_keys, build_payloads,
                     group=None, capacity_factor: float = 2.0,
                     out_rows_per_device: int | None = None,
                     samples_per_device: int = 128, use_ragged=None,
                     hot_keys: int = 8, hot_min_count: int | None = None,
                     hot_rows_per_device: int | None = None,
                     return_hot_stats: bool = False, device=None):
    """Inner join across the ranks: range-partition BOTH tables by shared
    splitters of the key (no position tie-break: equal keys must meet on
    one rank), exchange each side, sort-merge join locally
    (`hashjoin.merge_join_indices`).

    Heavy hitters: a key whose rows exceed a receive buffer cannot be
    range-partitioned, so the `hot_keys` most frequent keys of EACH table's
    gathered sample (>= hot_min_count sample occurrences, by default half
    the overflow frequency) take a broadcast path: their BUILD rows are
    all-gathered to every rank and their PROBE rows stay where they are.
    Each rank sorts its rows by key and moves the hot ones behind the cold
    ones with one stable K5 partition.  `hot_rows_per_device` caps one
    rank's contributed hot build rows (default n_build/P^2: the gathered hot
    table is one build shard); hot_keys=0 turns the path off.

    Returns this rank's (count, keys, probe_payloads, build_payloads,
    overflow): matches of its key range, then its hot matches, packed at
    the front (the two packed by one K5 compaction); count and overflow are
    (1,) int32 tensors, overflow the same on every rank (it sums the flags
    of the probe and build receive buffers, the cold and hot output
    capacity and the hot table).  With return_hot_stats=True a dict of this
    rank's hot probe and build rows, the hot key slots flagged and the five
    overflow parts follows overflow.  Keys of both tables share one dtype."""
    dev = rank_device(device)
    num_p = dist.get_world_size(group)
    if common.np_dtype(probe_keys.dtype) != common.np_dtype(build_keys.dtype):
        raise ValueError("probe and build key dtypes must match")
    for name, arr in (("probe", probe_keys), ("build", build_keys)):
        if arr.shape[0] % num_p:
            raise ValueError(f"{name} rows {arr.shape[0]} not divisible by "
                             f"group size {num_p}")
    n_lp = probe_keys.shape[0] // num_p
    n_lb = build_keys.shape[0] // num_p
    cap_p = int(capacity_factor * n_lp)
    cap_b = int(capacity_factor * n_lb)
    cap_out = out_rows_per_device or 2 * (n_lp + n_lb)
    # the gathered hot table is P · cap_hot rows: by default one build shard
    cap_hot = hot_rows_per_device or max(128, n_lb // num_p)

    # a key endangers a receive buffer when its share of ITS table nears
    # capacity_factor/P: in that table's sample that is s · capacity_factor
    # hits; demand half
    def min_count(n_l):
        return hot_min_count if hot_min_count is not None else max(
            2, int(min(n_l, samples_per_device) * capacity_factor / 2))

    pk = shard_rows(probe_keys, group, dev)
    bk = shard_rows(build_keys, group, dev)
    pp = dist_sort.split_payload_streams(
        [shard_rows(p, group, dev) for p in probe_payloads])
    bp = dist_sort.split_payload_streams(
        [shard_rows(p, group, dev) for p in build_payloads])
    p_dts = [common.torch_dtype(p.dtype) for p in probe_payloads]
    b_dts = [common.torch_dtype(p.dtype) for p in build_payloads]
    kp = transforms.key_operands(pk, True)
    kb = transforms.key_operands(bk, True)
    # the branch is the same on every rank: n_lp and n_lb are
    use_hot = hot_keys > 0 and n_lp > 0 and n_lb > 0

    if use_hot:
        hw_p, hv_p = _hot_keys_from_sample(kp, group, samples_per_device,
                                           hot_keys, min_count(n_lp))
        hw_b, hv_b = _hot_keys_from_sample(kb, group, samples_per_device,
                                           hot_keys, min_count(n_lb))
        hot_words = tuple(torch.cat([a, b]) for a, b in zip(hw_p, hw_b))
        hot_valid = torch.cat([hv_p, hv_b])

        def split_hot(kops, pays):
            """Sort by key, then one stable K5 partition: the cold rows
            first (key-sorted, contiguous for the exchange), the hot rows
            at the tail (key-sorted too)."""
            flag = _match_any(kops, hot_words, hot_valid)
            (k_s,), (f_s, *p_s) = dist_sort._sort_rows(kops, (flag,) + pays)
            k_s, *p_s = filter_op.partition_streams(f_s, (k_s, *p_s))
            n_cold = (~flag).sum()
            is_hot = torch.arange(flag.shape[0], device=dev) >= n_cold
            return (k_s,), tuple(p_s), is_hot, n_cold

        dom_p, pp_s, hot_ps, n_cold_p = split_hot(kp, pp)
        dom_b, bp_s, hot_bs, n_cold_b = split_hot(kb, bp)
    else:
        dom_p, pp_s = dist_sort._sort_rows(kp, pp)
        dom_b, bp_s = dist_sort._sort_rows(kb, bp)
        n_cold_p = n_cold_b = None

    # shared splitters pooled from BOTH tables' samples; in hot mode only
    # the cold prefixes are sampled (a hot key would pull half the
    # quantiles onto itself)
    splitters = dist_sort.gather_splitters_parts(
        [(dom_p, n_cold_p), (dom_b, n_cold_b)], group, num_p - 1,
        samples_per_device)
    if use_hot:
        # bounds over the cold prefix only: a leading hot-flag word puts
        # every hot row above every (flag 0, splitter)
        zero = (splitters[0].new_zeros(splitters[0].shape, dtype=torch.int8),)
        bounds_p = dist_sort.lex_bounds((hot_ps.to(torch.int8),) + dom_p,
                                        zero + splitters)
        bounds_b = dist_sort.lex_bounds((hot_bs.to(torch.int8),) + dom_b,
                                        zero + splitters)
    else:
        bounds_p = dist_sort.lex_bounds(dom_p, splitters)
        bounds_b = dist_sort.lex_bounds(dom_b, splitters)
    recv_p, tot_p, ov_p = dist_sort.exchange_by_bounds(
        dom_p + pp_s, bounds_p, group, cap_p, n_valid=n_cold_p)
    recv_b, tot_b, ov_b = dist_sort.exchange_by_bounds(
        dom_b + bp_s, bounds_b, group, cap_b, n_valid=n_cold_b)

    total_c, pidx_c, bidx_c = hashjoin.merge_join_indices(
        (recv_p[0][:tot_p],), tot_p, (recv_b[0][:tot_b],), tot_b, cap_out)
    count = total_c.clamp(max=cap_out)
    valid_c = torch.arange(cap_out, device=dev) < count
    ov_out_cold = dist_sort.pmax(total_c > cap_out, group)
    ov_out_hot = ov_hotcap = torch.zeros(1, dtype=torch.int32, device=dev)
    out_k = _take_valid(recv_p[:1], pidx_c, valid_c)
    out_pp = _take_valid(recv_p[1:], pidx_c, valid_c)
    out_bp = _take_valid(recv_b[1:], bidx_c, valid_c)

    if use_hot:
        # broadcast join of the hot keys: every rank's hot BUILD rows (its
        # tail [n_cold_b, n_lb)) gathered to all, joined with the LOCAL hot
        # probe rows; hot rows never enter an exchange
        n_hot_b = n_lb - n_cold_b
        idx_hb = (n_cold_b + torch.arange(cap_hot, device=dev)).clamp(
            0, max(n_lb - 1, 0))
        hot_all = [dist_sort.all_gather_rows(s.index_select(0, idx_hb), group)
                   for s in dom_b + bp_s]
        valid_hb = dist_sort.all_gather_rows(
            torch.arange(cap_hot, device=dev) < n_hot_b, group)
        ov_hotcap = dist_sort.pmax(n_hot_b > cap_hot, group)
        total_h, pidx_h, bidx_h = hashjoin.merge_join_indices(
            dom_p, hot_ps, tuple(hot_all[:1]), valid_hb, cap_out)
        count_h = total_h.clamp(max=cap_out)
        valid_h = torch.arange(cap_out, device=dev) < count_h
        ov_out_hot = dist_sort.pmax(total_h > cap_out, group)
        hot_out = (_take_valid(dom_p, pidx_h, valid_h)
                   + _take_valid(pp_s, pidx_h, valid_h)
                   + _take_valid(hot_all[1:], bidx_h, valid_h))
        # [cold valid | hot valid | padding]: one stable K5 compaction
        _, *packed = filter_op.compact(
            torch.cat([valid_c, valid_h]),
            *(torch.cat([c, h]) for c, h in zip(out_k + out_pp + out_bp,
                                               hot_out)))
        npw = len(pp_s)
        out_k, out_pp, out_bp = (tuple(packed[:1]), tuple(packed[1:1 + npw]),
                                 tuple(packed[1 + npw:]))
        count = count + count_h

    ov_parts = torch.cat([torch.tensor([ov_p, ov_b], dtype=torch.int32,
                                       device=dev),
                          ov_out_cold, ov_out_hot, ov_hotcap])
    base = (count.to(torch.int32).reshape(1),
            transforms.keys_from_operands(out_k, pk.dtype, True),
            dist_sort.merge_payload_streams(out_pp, p_dts),
            dist_sort.merge_payload_streams(out_bp, b_dts),
            ov_parts.sum(dtype=torch.int32).reshape(1))
    if not return_hot_stats:
        return base
    if use_hot:
        hot = (n_lp - n_cold_p, n_lb - n_cold_b, hot_valid.sum())
    else:
        hot = (0, 0, 0)
    hot = [torch.as_tensor(h, device=dev).to(torch.int32).reshape(1)
           for h in hot]
    hot_stats = {"hot_probe_rows_per_device": hot[0],
                 "hot_build_rows_per_device": hot[1],
                 "hot_key_slots_flagged": hot[2],
                 # which capacity tripped: probe recv / build recv / cold
                 # out / hot out / hot table
                 "overflow_parts_probe_build_coldout_hotout_hotcap":
                     ov_parts.reshape(1, 5)}
    return base + (hot_stats,)


def gather_joined(counts, keys, probe_payloads=(), build_payloads=(),
                  group=None):
    """Every rank's valid join-output prefix, concatenated in rank order, on
    every rank: (keys, probe_payloads, build_payloads)."""
    k, pays = dist_sort.gather_result(
        keys, tuple(probe_payloads) + tuple(build_payloads), counts, group)
    npp = len(probe_payloads)
    return k, pays[:npp], pays[npp:]


def distributed_top_k(keys, *payloads, k: int, largest: bool = True,
                      group=None, device=None):
    """The k extreme rows across the ranks: local top-k, a k·P-row
    all-gather, one final top-k (traffic k·P rows, independent of n).
    Returns (keys_k, payloads_k...) best-first on every rank; ties go to
    the lower global row, as the JAX package breaks them."""
    dev = rank_device(device)
    k_l = shard_rows(keys, group, dev)
    if k > keys.shape[0]:
        raise ValueError(f"k={k} exceeds global row count {keys.shape[0]}")
    loc = topk.top_k(k_l, *(shard_rows(p, group, dev) for p in payloads),
                     k=min(k, k_l.shape[0]), largest=largest)
    gathered = [dist_sort.all_gather_rows(s, group) for s in loc]
    return topk.top_k(gathered[0], *gathered[1:], k=k, largest=largest)


def distributed_unique(keys, group=None, device=None, **kw):
    """Distinct keys across the ranks with multiplicities: the aggregate's
    exchange with agg="count".  Returns (num_unique, keys_ascending,
    counts) on every rank."""
    # a stride-0 view: each rank materialises only its block, where its
    # keys lie
    where = keys.device if isinstance(keys, torch.Tensor) else "cpu"
    ones = torch.ones((), dtype=torch.int32, device=where).expand(
        keys.shape[0])
    return distributed_group_aggregate(keys, ones, "count", group=group,
                                       device=device, **kw)
