"""Join on keys (the north star's "hash join").

Counterpart of simd_radix_sort_tpu/ops/hashjoin.py, and sort-merge like it:
the build side is sorted by key with the comparison engine, probe rows find
their match range with two binary searches (`torch.searchsorted`) on the
key carriers, and matched build payloads are fetched with gathers.

  * lookup_join: one output row per probe row (first match + match count).
  * inner_join_expand: the full inner join with duplicate build keys, into
    a caller-given capacity (padded + total count), by rank arithmetic over
    the match offsets.
  * merge_join_indices: the padded sort-merge matching the distributed
    join uses, over operand tuples of any number of words.  The port's
    operands are signed carriers (one int64 word holds a 64-bit key),
    where the JAX package has u32 (hi, lo) pairs; its run starts are
    packed by one K5 compaction (ops/filter.py).
  * semi_join: lookup + one stable compaction (K5).
"""

from __future__ import annotations

import torch

from ..utils import profiling, transforms
from . import filter as filter_ops
from . import xla_sort


def _searchsorted_side(sorted_u, query_u, side):
    return torch.searchsorted(sorted_u, query_u.contiguous(),
                              right=side == "right")


def _take(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p[idx] for any dtype; an empty `p` gives zeros, where the JAX
    package's `take` reads out of bounds."""
    if p.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=p.dtype, device=p.device)
    return xla_sort.gather(p, idx)


def build_index(build_keys: torch.Tensor, build_payloads=()):
    """Sort the build side by key; returns (sorted_carriers, sorted_keys,
    sorted_payloads) — the "hash table"."""
    with profiling.span("srs.join.build"):
        keys_s, pays_s = xla_sort.sort_arrays(
            build_keys, tuple(build_payloads), ascending=True)
        u = transforms.to_sortable(keys_s, True).contiguous()
    return u, keys_s, pays_s


def lookup_join(probe_keys: torch.Tensor, build_keys: torch.Tensor,
                build_payloads=(), probe_is_transformed: bool = False):
    """For each probe row: (found, match_count, first-match build payloads).

    Returns (found_mask, match_counts, gathered_build_payloads).  With
    duplicate build keys the first (lowest sorted position) match is
    returned; match_counts (int32) reports how many build rows matched.
    `probe_is_transformed`: the probe keys are already carriers."""
    with profiling.span("srs.join"):
        u_build, _, pays_s = build_index(build_keys, build_payloads)
        with profiling.span("srs.join.probe"):
            u_probe = (probe_keys if probe_is_transformed
                       else transforms.to_sortable(probe_keys, True))
            lo = _searchsorted_side(u_build, u_probe, "left")
            hi = _searchsorted_side(u_build, u_probe, "right")
            counts = (hi - lo).to(torch.int32)
            found = counts > 0
            safe = lo.clamp(0, max(build_keys.shape[0] - 1, 0))
            gathered = tuple(_take(p, safe) for p in pays_s)
    return found, counts, gathered


def inner_join_expand(probe_keys: torch.Tensor, probe_payloads,
                      build_keys: torch.Tensor, build_payloads,
                      capacity: int):
    """Full inner join with duplicate build keys, expanded into `capacity`
    output rows.  Returns (total_matches, out_probe_idx, out_probe_keys,
    out_probe_payloads, out_build_payloads); rows past total_matches are
    padding.  If total_matches > capacity the result is truncated (the
    caller checks and runs again with a larger capacity).

    Output slot t finds its probe row by binary search over the cumulative
    match counts, then its build row by rank arithmetic within that probe
    row's match range."""
    u_build, _, build_pays_s = build_index(build_keys, build_payloads)
    u_probe = transforms.to_sortable(probe_keys, True)
    lo = _searchsorted_side(u_build, u_probe, "left")
    hi = _searchsorted_side(u_build, u_probe, "right")
    counts = (hi - lo).to(torch.int32)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)  # inclusive
    total = (cum[-1] if counts.shape[0]
             else torch.zeros((), dtype=torch.int32, device=cum.device))

    dev = probe_keys.device
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    # probe row of output slot t: first row whose inclusive cumsum exceeds t
    probe_idx = torch.searchsorted(cum, t, right=True, out_int32=True)
    probe_idx_safe = probe_idx.clamp(0, max(probe_keys.shape[0] - 1, 0))
    start_of_row = _take(cum, probe_idx_safe) - _take(counts, probe_idx_safe)
    build_pos = _take(lo, probe_idx_safe) + (t - start_of_row)
    build_pos = build_pos.clamp(0, max(build_keys.shape[0] - 1, 0))

    out_probe_keys = _take(probe_keys, probe_idx_safe)
    out_probe_pays = tuple(_take(p, probe_idx_safe) for p in probe_payloads)
    out_build_pays = tuple(_take(p, build_pos) for p in build_pays_s)
    return (total, probe_idx_safe, out_probe_keys, out_probe_pays,
            out_build_pays)


# Saturation bound of `_saturating_cumsum`: headroom so that a saturating
# add a+b <= 2*_SAT32 never wraps int32.
_SAT32 = (1 << 30) - 1


def _saturating_cumsum(count: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of non-negative counts, as int32, that
    saturates at _SAT32 instead of wrapping: prefixes whose true sum is
    below _SAT32 are exact, larger ones read _SAT32.  The JAX package needs
    it when 64-bit integers are off; the port always has them, so this is
    the int64 prefix clamped, which for non-negative counts equals the
    JAX package's min(a+b, S) scan."""
    c = count.to(torch.int64).clamp(max=_SAT32)
    return torch.cumsum(c, 0).clamp(max=_SAT32).to(torch.int32)


def _invalid(iota: torch.Tensor, v) -> torch.Tensor:
    """Invalid rows: a bool mask's False rows, or rows at index >= v."""
    if getattr(v, "ndim", 0) == 1:  # boolean validity mask
        if v.dtype != torch.bool:
            # ~ on an int 0/1 mask is -1/-2: every row would be silently
            # flagged invalid and the join would return 0
            raise TypeError(f"validity mask must be boolean, got {v.dtype}")
        return ~v.to(iota.device)
    return iota >= v


def merge_join_indices(probe_ops, n_probe_valid, build_ops, n_build_valid,
                       capacity: int):
    """Inner-join row matching over padded carrier operand tuples
    (lexicographic multi-word keys; one int64 word holds a 64-bit key).

    probe_ops / build_ops are tuples of same-length signed words; rows at
    index >= n_*_valid are buffer padding (contents ignored).  Either
    n_*_valid may instead be a boolean mask of valid rows (any positions).
    Returns (total, probe_idx, build_idx): output slot t joins probe row
    probe_idx[t] with build row build_idx[t]; slots past `total` carry
    clipped padding indices.  total (int64) may exceed `capacity`
    (truncated output): callers treat that as overflow and retry bigger.

    The JAX package sorts both tables' rows keyed (invalid, key words,
    side), stably.  Here the build rows come first in the concatenation,
    so stable sorts keyed (invalid, key words) alone keep every key's build
    rows before its probe rows; torch.sort takes one key, so they run from
    the last key word to the first, then on the invalid flag.  The row's
    position in the concatenation gives back its side and index."""
    n_p = probe_ops[0].shape[0]
    n_b = build_ops[0].shape[0]
    m = n_b + n_p
    dev = probe_ops[0].device
    if m == 0:  # both buffers empty: no pairs
        zero_idx = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return torch.zeros((), dtype=torch.int32, device=dev), zero_idx, \
            zero_idx
    iota_p = torch.arange(n_p, dtype=torch.int32, device=dev)
    iota_b = torch.arange(n_b, dtype=torch.int32, device=dev)
    inval = torch.cat([_invalid(iota_b, n_build_valid),
                       _invalid(iota_p, n_probe_valid)]).to(torch.int8)
    words = [torch.cat([bw, pw]) for bw, pw in zip(build_ops, probe_ops)]

    perm = None
    for key in [*reversed(words), inval]:
        k = key if perm is None else key.index_select(0, perm)
        order = torch.argsort(k, stable=True)
        perm = order if perm is None else perm.index_select(0, order)
    s_inval = inval.index_select(0, perm)
    s_words = [w.index_select(0, perm) for w in words]
    s_side = perm >= n_b
    s_idx = torch.where(s_side, perm - n_b, perm).to(torch.int32)

    valid = s_inval == 0
    is_build = (~s_side & valid).to(torch.int32)
    is_probe = s_side & valid
    # key-run starts (invalid rows form their own runs at the tail)
    neq = torch.zeros(m, dtype=torch.bool, device=dev)
    for w in (s_inval, *s_words):
        neq[1:] |= w[1:] != w[:-1]
    neq[0] = True
    # each row's run start: the run's index into the packed start
    # positions (one K5 compaction; torch.cummax on CUDA scans a 1-D
    # tensor slowly)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    run_id = torch.cumsum(neq, 0, dtype=torch.int32) - 1
    run_start = filter_ops.compact(neq, pos)[1].index_select(0, run_id)
    cb = torch.cumsum(is_build, 0, dtype=torch.int32)  # inclusive builds
    cb_before_run = cb.index_select(0, run_start) - is_build.index_select(
        0, run_start)
    # builds sort before probes within a run, so every build of the run
    # precedes any probe row i of the run: matches(i) = cb[i] - before
    count = torch.where(is_probe, cb - cb_before_run, 0)

    # int64 accumulation: a hot key can produce > 2^31 pairs; only the
    # prefix below `capacity` must be exact in 32 bits, so the search runs
    # on the capped cumsum
    cum = torch.cumsum(count.to(torch.int64), 0)
    total = cum[-1]
    cum_cap = cum.clamp(max=capacity).to(torch.int32)
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    mpos = torch.searchsorted(cum_cap, t, right=True).clamp(0, m - 1)
    start = cum.index_select(0, mpos) - count.index_select(0, mpos).to(
        torch.int64)
    offset = t - start.clamp(0, capacity).to(torch.int32)
    bpos = (run_start.index_select(0, mpos) + offset).clamp(0, m - 1)
    return total, s_idx.index_select(0, mpos), s_idx.index_select(0, bpos)


def semi_join(probe_keys, probe_payloads, build_keys, anti: bool = False):
    """Rows of the probe table whose key does (semi) or does not (anti)
    appear in the build table: lookup + stable compaction (K5).

    Returns (count, probe_keys_packed, probe_payloads_packed...)."""
    found, _, _ = lookup_join(probe_keys, build_keys)
    mask = ~found if anti else found
    return filter_ops.compact(mask, probe_keys, *probe_payloads)
