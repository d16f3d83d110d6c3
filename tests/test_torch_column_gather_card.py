"""K10 on the card (`csrc/column_gather.cu`, `ops/cuda_columns.py`): the
pack and the gather-split byte for byte against their plain versions at
2^24 rows of TPC-H lineitem's 16 column widths, on views off the 16-byte
alignment and strided columns, at ragged row counts, with int32 and int64
indexes, and past 2^32 staged bytes (the 64-bit offsets); `sort_multi`'s
grouped output equal to the per-column gathers it replaced, its launches
and counters, and its peak memory no higher than theirs.  Every test here
skips where there is no CUDA card.  On the card:

    python -m pytest tests/test_torch_column_gather_card.py -q -p no:cacheprovider --noconftest
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simd_radix_sort_tpu_torch.ops import cuda_columns as cc, sort as sort_ops
from simd_radix_sort_tpu_torch.ops import xla_sort
from simd_radix_sort_tpu_torch.utils import profiling, transforms

pytestmark = pytest.mark.card

N = 1 << 24
RAGGED = 1_000_003
BIG = (1 << 27) + 3  # staged rows of 32 bytes: past 2^32 bytes
# lineitem's columns in the cell's order: the 3 keys, then 13 payloads
LINEITEM = (torch.int32, torch.int64, torch.int32, torch.int64, torch.int64,
            torch.float64, torch.float64, torch.float64, torch.float64,
            torch.int8, torch.int8, torch.int32, torch.int32, torch.int8,
            torch.int8, torch.int64)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K10 is a hand-written kernel")
    return torch.device("cuda")


def random_column(n, dtype, card, seed):
    """n elements of `dtype` of random bits (NaN payloads and -0.0 among
    the floats' bit patterns)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    w = torch.empty((), dtype=dtype).element_size()
    return torch.randint(0, 256, (n * w,), generator=g, dtype=torch.uint8,
                         device=card).view(dtype)


def index(n, card, seed, dtype=torch.int32):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randperm(n, generator=g, device=card).to(dtype)


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def held(columns, idx):
    """gather_columns on the card against each column's index_select, and
    each group's pack and gather-split against their plain versions."""
    cc.reset_launches()
    got = cc.gather_columns(columns, idx)
    torch.cuda.synchronize()
    groups = cc.plan_groups(idx.numel(),
                            [c.element_size() for c in columns])
    staged = sum(g.staged for g in groups)
    assert cc.LAUNCHES == {"column_pack": staged if idx.numel() else 0,
                           "column_gather": len(groups) if idx.numel()
                           else 0}
    for col, out in zip(columns, got):
        assert out.is_contiguous()
        assert same_bits(out, xla_sort.gather(col, idx.to(torch.int64)))
    for g in groups:
        if not g.staged:
            continue
        cols = [columns[i] for i in g.columns]
        rows = cc.pack(cols, g.offsets, g.row_bytes)
        assert torch.equal(rows, cc.pack_plain(cols, g.offsets, g.row_bytes))
        dtypes = [c.dtype for c in cols]
        for a, b in zip(cc.gather_split(rows, idx, dtypes, g.offsets),
                        cc.gather_split_plain(rows, idx, dtypes, g.offsets)):
            assert same_bits(a, b)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [N, RAGGED])
def test_k10_equals_the_plain_version_at_lineitem_widths(card, n,
                                                         index_dtype):
    cols = [random_column(n, d, card, k) for k, d in enumerate(LINEITEM)]
    held(cols, index(n, card, n, index_dtype))


@pytest.mark.parametrize("widths", [(8,), (4,), (2,), (1,), (8, 4),
                                    (2, 2, 1), (8, 8, 8, 8, 8, 4),
                                    (1,) * 32, (4, 2, 1, 1, 8)])
def test_k10_on_mixes_and_single_columns(card, widths):
    dt = {1: torch.uint8, 2: torch.float16, 4: torch.float32,
          8: torch.int64}
    cols = [random_column(RAGGED, dt[w], card, 7 * k + w)
            for k, w in enumerate(widths)]
    held(cols, index(RAGGED, card, 3))


@pytest.mark.parametrize("skip", [1, 3])
def test_k10_on_views_off_the_alignment_and_strided(card, skip):
    # each column a view that starts `skip` elements into its storage, and
    # every other one strided: none of them at a 16-byte boundary
    n = RAGGED
    cols = []
    for k, d in enumerate(LINEITEM):
        base = random_column(2 * n + skip, d, card, 11 + k)
        cols.append(base[skip:skip + 2 * n:2] if k % 2 else
                    base[skip:skip + n])
    assert any(c.data_ptr() % 16 for c in cols)
    held(cols, index(n, card, 5))


def test_k10_on_no_rows_and_one_row(card):
    for n in (0, 1):
        cols = [random_column(n, d, card, k) for k, d in enumerate(LINEITEM)]
        held(cols, index(n, card, 9))


def test_k10_past_two_to_the_32_staged_bytes(card):
    cols = [random_column(BIG, torch.int64, card, k) for k in range(4)]
    rows = cc.pack(cols, (0, 8, 16, 24), 32)
    assert rows.numel() > 1 << 32
    assert torch.equal(rows, cc.pack_plain(cols, (0, 8, 16, 24), 32))
    del cols
    idx = index(BIG, card, 13)
    got = cc.gather_split(rows, idx, [torch.int64] * 4, (0, 8, 16, 24))
    want = rows.index_select(0, idx)
    for k, col in enumerate(got):
        assert torch.equal(col.view(torch.uint8).view(BIG, 8),
                           want[:, 8 * k:8 * k + 8])


def per_column_sort_multi(keys, pays, ascending):
    """sort_multi as it was before K10: the key passes, then one gather a
    column with the last pass's carrier and sort still alive."""
    perm = None
    for col, up in zip(reversed(keys), reversed(ascending)):
        c = transforms.to_sortable(col, up)
        if perm is not None:
            c = c.index_select(0, perm)
        order = torch.argsort(c, stable=True)
        perm = order if perm is None else perm.index_select(0, order)
    return (tuple(xla_sort.gather(k, perm) for k in keys),
            tuple(xla_sort.gather(p, perm) for p in pays))


@pytest.fixture(scope="module")
def lineitem(card):
    """2^24 rows of lineitem's 16 dtypes; the 3 keys with ties."""
    g = torch.Generator(device=card)
    g.manual_seed(17)
    keys = (torch.randint(8035, 10591, (N,), generator=g, device=card,
                          dtype=torch.int32),
            torch.randint(1, 1 << 22, (N,), generator=g, device=card),
            torch.randint(1, 8, (N,), generator=g, device=card,
                          dtype=torch.int32))
    pays = tuple(random_column(N, d, card, 100 + k)
                 for k, d in enumerate(LINEITEM[3:]))
    return keys, pays


def test_sort_multi_equals_the_per_column_gathers(card, lineitem):
    keys, pays = lineitem
    up = (True, False, True)
    got = sort_ops.sort_multi(keys, *pays, ascending=up)
    want = per_column_sort_multi(keys, pays, up)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert same_bits(a, b)


def test_sort_multi_peak_memory_no_higher(card, lineitem):
    keys, pays = lineitem
    up = (True, False, True)
    peaks = {}
    for name, fn in (("per_column", per_column_sort_multi),
                     ("grouped", lambda k, p, a: sort_ops.sort_multi(
                         k, *p, ascending=a)),
                     ("per_column_again", per_column_sort_multi)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(keys, pays, up)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del out
    assert peaks["grouped"] <= min(peaks["per_column"],
                                   peaks["per_column_again"]), peaks


def test_sort_multi_launches_and_counts(card, lineitem):
    keys, pays = lineitem
    cc.reset_launches()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        sort_ops.sort_multi(keys, *pays, ascending=(True, False, True))
        torch.cuda.synchronize()
    assert cc.LAUNCHES == {"column_pack": 4, "column_gather": 4}
    assert profiling.COUNTERS["column_gather.groups"] == 4
    assert profiling.COUNTERS["column_gather.staged_bytes"] == 84 * N
    assert profiling.COUNTERS["sort_multi.gather_bytes"] == 364 * N
    profiling.reset_counters()
