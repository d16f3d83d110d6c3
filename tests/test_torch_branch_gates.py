"""The count engine's branch gates and the quick engine's constants
against the tables measured on the card.

Each constant of ops/counting.py and ops/quick_sort.py is the value that
a stated rule picks from bench_out_h100/ (workloads/campaign.py on an
H100; CARD.json there names the card, its power limit and the commands):

  * counting.SMALL_MIN_N (campaign part g, large_n/gate-<type>-<shape>.dat,
    int16, uint16, int32 and uint32 keys of range in [16, 1024) in three
    shapes, 2^14..2^27 rows, the branch forced on and off and xla in
    turns, 5 rounds each): the smallest swept power of two n0 from which
    no row of any table shows the branch resolvably slower than the
    fallback, that is with its median above the fallback's and its
    fastest round slower than the fallback's slowest (the rounds are in
    logs/campaign-gate-<type>.out).  Where the rounds overlap the two
    columns tie: below 2^24 both are host-bound and their medians trade
    places within the rounds' spread;
  * counting.K_MAX_RANGE (part g's Span tables, spans 16..1023 at 2^24
    and 2^27 rows): the kernel's limit, 1024, if the branch beats the
    fallback at span 1023 in every table at every row from SMALL_MIN_N;
    else one past the largest span at which it still does;
  * quick_sort.MAX_BUCKETS, OVERSAMPLE, BLOCK and SEGMENT_TARGET (part h,
    quick_grid/grid.dat): the grid point with the lowest median ns per
    element over its cells; points within 2% of that median tie, and
    among ties the one with the fewest `fallback` cells wins (then the
    lower median).
"""

import functools
import json
import os
import statistics

import pytest

from simd_radix_sort_tpu_torch.ops import counting, cuda_hist, quick_sort
from simd_radix_sort_tpu_torch.workloads import campaign

BENCH_DIR = os.path.join(os.path.dirname(__file__), "..", "bench_out_h100")
LARGE_N_DIR = os.path.join(BENCH_DIR, "large_n")
GRID = os.path.join(BENCH_DIR, campaign.QUICK_DIR, "grid.dat")


def _gate_rows(type_name, shape):
    """[(n, {column: ns per element})] of one part-g table."""
    path = os.path.join(LARGE_N_DIR, f"gate-{type_name}-{shape}.dat")
    with open(path) as f:
        header = f.readline().split()
        assert header == ["number_of_elements", *campaign.GATE_COLUMNS]
        return [(int(v[0]), dict(zip(header[1:], map(float, v[1:]))))
                for v in (line.split() for line in f if line.strip())]


def _shape_tables():
    return {(t, s): _gate_rows(t, s) for t in campaign.GATE_TYPES
            for s in campaign.GATE_SHAPES}


@functools.cache
def _gate_rounds(type_name):
    """{(table, n): {column: [ns per element of each round]}} from the
    part-g log of `type_name`; a row measured again keeps its last
    rounds."""
    path = os.path.join(BENCH_DIR, "logs", f"campaign-gate-{type_name}.out")
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                rec = json.loads(line)
                out[(rec["table"], rec["n"])] = rec["rounds"]
    return out


def _branch_resolvably_slower(type_name, shape, n, row) -> bool:
    rounds = _gate_rounds(type_name)[(f"gate-{type_name}-{shape}.dat", n)]
    # the table holds the rounds' medians
    assert all(float(f"{statistics.median(rounds[c]):.4f}") == row[c]
               for c in campaign.GATE_COLUMNS), (type_name, shape, n)
    return (row["branch"] > row["fallback"]
            and min(rounds["branch"]) > max(rounds["fallback"]))


def _slower_rows():
    """[(type, shape, n)] of the shape tables' rows where the branch is
    resolvably slower than the fallback."""
    return [(t, s, n) for (t, s), rows in _shape_tables().items()
            for n, r in rows if _branch_resolvably_slower(t, s, n, r)]


def small_min_n_pick():
    """The SMALL_MIN_N rule over the shape tables: the power of two past
    the largest row where the branch is resolvably slower, else the
    smallest swept size."""
    slower = _slower_rows()
    if slower:
        return 2 * max(n for *_, n in slower)
    return min(n for rows in _shape_tables().values() for n, _ in rows)


def k_max_range_pick():
    """The K_MAX_RANGE rule over the Span tables, at rows from
    counting.SMALL_MIN_N."""
    def wins(span):
        return all(r["branch"] <= r["fallback"]
                   for t in campaign.GATE_TYPES
                   for n, r in _gate_rows(t, f"Span{span}")
                   if n >= counting.SMALL_MIN_N)

    spans = sorted(campaign.GATE_SPANS)
    if wins(spans[-1]):
        return cuda_hist.MAX_HIST_K
    won = [s for s in spans if wins(s)]
    return won[-1] + 1 if won else counting.K_TINY_RANGE


def _grid():
    """{(MAX_BUCKETS, OVERSAMPLE, BLOCK, target): [(ns, path)]}."""
    with open(GRID) as f:
        assert f.readline().split() == campaign.QUICK_HEADER.split()
        cells = {}
        for line in f:
            v = line.split()
            cells.setdefault(tuple(map(int, v[:4])), []).append(
                (float(v[7]), v[8]))
    return cells


def quick_pick():
    cells = _grid()
    med = {p: statistics.median(ns for ns, _ in c) for p, c in cells.items()}
    best = min(med.values())
    ties = [p for p in med if med[p] <= 1.02 * best]
    return min(ties, key=lambda p: (sum(path == "fallback"
                                        for _, path in cells[p]), med[p]))


@pytest.mark.parametrize("type_name", campaign.GATE_TYPES)
@pytest.mark.parametrize("shape", campaign.GATE_SHAPES)
def test_gate_tables_cover_the_sweep(type_name, shape):
    """Every part-g shape table runs from 2^14 to 2^27 rows, each row's
    columns positive."""
    rows = _gate_rows(type_name, shape)
    assert [n for n, _ in rows] == [1 << e for e in range(14, 28)]
    assert all(v > 0 for _, r in rows for v in r.values())


def test_small_min_n_is_the_gate_tables_pick():
    assert counting.SMALL_MIN_N == small_min_n_pick(), _shape_tables()


def test_branch_not_slower_from_small_min_n_on_any_table():
    late = [row for row in _slower_rows() if row[2] >= counting.SMALL_MIN_N]
    assert not late, late
    # from 2^24 the branch's median wins outright on every table
    lose = [(key, n) for key, rows in _shape_tables().items()
            for n, r in rows if n >= 1 << 24 and r["branch"] > r["fallback"]]
    assert not lose, lose


def test_k_max_range_is_the_span_tables_pick():
    for t in campaign.GATE_TYPES:
        for span in campaign.GATE_SPANS:
            rows = _gate_rows(t, f"Span{span}")
            assert [n for n, _ in rows] == list(campaign.GATE_SPAN_NS)
    assert counting.K_MAX_RANGE == k_max_range_pick()
    # K1 keeps K_MAX_RANGE counters in shared memory
    assert counting.K_MAX_RANGE <= cuda_hist.MAX_HIST_K


def test_quick_constants_are_the_grid_pick():
    cells = _grid()
    assert set(cells) == set(campaign.quick_points())
    # 4 workloads x 4 sizes, and stable at 2^24
    assert {len(c) for c in cells.values()} == {20}
    assert (quick_sort.MAX_BUCKETS, quick_sort.OVERSAMPLE, quick_sort.BLOCK,
            quick_sort.SEGMENT_TARGET) == quick_pick()


def test_quick_constants_keep_the_engine_exact():
    """Bucket ids are int16; the blocked cleanup is exact for segments of
    at most BLOCK/2 rows, so the target segment stays below that bound,
    and _block_sort's two phases need whole half blocks."""
    assert quick_sort.MAX_BUCKETS - 1 <= 32767
    assert quick_sort.SEGMENT_TARGET <= quick_sort.BLOCK // 4
    assert quick_sort.BLOCK % 2 == 0
