"""K10's plain versions, wrapper and plan on the CPU (`ops/cuda_columns.py`):
the pack and the gather-split against NumPy at every field width and at
bool, float16 and bfloat16, NaN payloads and both zeros among the bits;
`plan_groups` at TPC-H lineitem's and Q18's widths and its memory rule at
every group of random width mixes; `sort_multi`'s grouped output bit for
bit against the per-column gathers it replaced, at SF 0.01 lineitem and on
odd mixes; the counters' rules, and nothing counted with tracing off."""

import json
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from simd_radix_sort_tpu_torch.ops import cuda_columns as cc, cuda_sort
from simd_radix_sort_tpu_torch.ops import sort as sort_ops, xla_sort
from simd_radix_sort_tpu_torch.utils import profiling, transforms

# the cell's order: l_shipdate, l_orderkey, l_linenumber, then 13 payloads
LINEITEM_WIDTHS = [4, 8, 4, 8, 8, 8, 8, 8, 8, 1, 1, 4, 4, 1, 1, 8]
Q18_WIDTHS = [8, 4, 8, 8, 8, 8]
SIZES = [0, 1, 1000, 4099]


def bits_of(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as NumPy (n, width) uint8 rows."""
    w = t.element_size()
    return t.contiguous().view(torch.uint8).numpy().reshape(-1, w)


def column(n, dtype, seed):
    """n elements of `dtype` of random bits, with NaN payloads of either
    sign and both zeros among the first floating ones."""
    g = torch.Generator().manual_seed(seed)
    w = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (n * w,), generator=g, dtype=torch.uint8)
    if dtype == torch.bool:
        raw &= 1
    col = raw.view(dtype).clone()
    if dtype.is_floating_point and n:
        special = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0],
                               dtype=dtype)
        bits = col.view({2: torch.int16, 4: torch.int32,
                         8: torch.int64}[w])
        m = min(n, 4)
        col[:m] = special[:m]
        if n > 4:
            bits[4] = special[:1].view(bits.dtype) | 5  # another payload
    return col


GROUPS = [
    ([torch.int64, torch.float64, torch.int64, torch.float64], 32),
    ([torch.int32, torch.float32, torch.uint32, torch.int32], 16),
    ([torch.int8, torch.bool, torch.uint8, torch.int8], 4),
    ([torch.float16, torch.bfloat16, torch.int16], 8),
    ([torch.float64, torch.float32, torch.bfloat16, torch.bool], 16),
    ([torch.float64, torch.int32, torch.int16, torch.uint8, torch.bool,
      torch.float64, torch.int32, torch.float16, torch.int8, torch.bool],
     32),
]


def offsets_of(dtypes):
    """Widest first, each at the next offset: the plan's layout."""
    order = sorted(range(len(dtypes)),
                   key=lambda i: -torch.empty((), dtype=dtypes[i])
                   .element_size())
    offs, off = [0] * len(dtypes), 0
    for i in order:
        offs[i] = off
        off += torch.empty((), dtype=dtypes[i]).element_size()
    return offs


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtypes,row_bytes", GROUPS,
                         ids=[f"g{i}" for i in range(len(GROUPS))])
def test_pack_and_gather_split_equal_numpy(dtypes, row_bytes, n):
    cols = [column(n, d, 31 * k + n) for k, d in enumerate(dtypes)]
    offs = offsets_of(dtypes)
    want = np.zeros((n, row_bytes), np.uint8)
    for col, off in zip(cols, offs):
        want[:, off:off + col.element_size()] = bits_of(col)
    for fn in (cc.pack_plain, cc.pack):
        rows = fn(cols, offs, row_bytes)
        assert rows.dtype == torch.uint8 and rows.shape == (n, row_bytes)
        assert np.array_equal(rows.numpy(), want)
    rng = np.random.default_rng(n)
    for idx in (rng.permutation(n), rng.integers(0, max(n, 1), n)):
        for it in (torch.int32, torch.int64):
            t_idx = torch.from_numpy(idx).to(it)
            for fn in (cc.gather_split_plain, cc.gather_split):
                got = fn(rows, t_idx, dtypes, offs)
                for g, col in zip(got, cols):
                    assert g.dtype == col.dtype and g.is_contiguous()
                    assert np.array_equal(bits_of(g), bits_of(col)[idx])


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32, torch.int16,
                                   torch.bfloat16, torch.uint8, torch.bool])
def test_a_column_alone_is_gathered_straight_strided_or_not(dtype):
    base = column(2 * 4099 + 3, dtype, 5)
    idx = torch.from_numpy(np.random.default_rng(2).permutation(4099))
    for col in (base[3:4102], base[3::2]):
        (got,) = cc.gather_columns([col], idx)
        assert np.array_equal(bits_of(got), bits_of(col)[idx.numpy()])


def test_strided_columns_are_packed_as_they_lie():
    cols = [column(2 * 1000, torch.int64, 1)[::2],
            column(3 * 1000, torch.int32, 2)[1::3]]
    rows = cc.pack(cols, [0, 8], 16)
    assert np.array_equal(rows[:, :8].numpy(), bits_of(cols[0]))
    assert np.array_equal(rows[:, 8:12].numpy(), bits_of(cols[1]))
    assert not rows[:, 12:].any()


@pytest.mark.parametrize("fault", ["overlap", "misaligned", "outside",
                                   "row_size", "too_many", "length",
                                   "width", "index_dtype", "rows_dtype"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    a, b = torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int32)
    rows, idx = torch.zeros((8, 16), dtype=torch.uint8), torch.arange(8)
    call = {
        "overlap": lambda: cc.pack([a, b], [0, 4], 16),
        "misaligned": lambda: cc.pack([a, b], [0, 10], 16),
        "outside": lambda: cc.pack([a, b], [0, 16], 16),
        "row_size": lambda: cc.pack([a, b], [0, 8], 12),
        "too_many": lambda: cc.pack([torch.zeros(8, dtype=torch.int8)] * 33,
                                    list(range(33)), 32),
        "length": lambda: cc.pack([a, b[:4]], [0, 8], 16),
        "width": lambda: cc.plan_groups(8, [8, 16]),
        "index_dtype": lambda: cc.gather_split(
            rows, idx.to(torch.int16), [torch.int64], [0]),
        "rows_dtype": lambda: cc.gather_split(
            rows.view(torch.int64), idx, [torch.int64], [0]),
    }[fault]
    with pytest.raises((TypeError, ValueError)):
        call()


def sizes_of(groups, widths):
    return [(sum(widths[i] for i in g.columns), g.row_bytes)
            for g in groups]


def test_plan_at_lineitem_widths():
    n = 179_998_372
    groups = cc.plan_groups(n, LINEITEM_WIDTHS)
    assert sizes_of(groups, LINEITEM_WIDTHS) == [(32, 32), (32, 32),
                                                 (16, 16), (4, 4)]
    assert [[LINEITEM_WIDTHS[i] for i in g.columns] for g in groups] == [
        [8] * 4, [8] * 4, [4] * 4, [1] * 4]
    assert all(g.staged for g in groups)
    # 16 columns, every one once
    assert sorted(i for g in groups for i in g.columns) == list(range(16))
    assert sort_ops.multi_gather_bytes(n, LINEITEM_WIDTHS) == 364 * n
    # the call's own peak: 100n against the 104n of the per-column gathers
    # (84n of outputs, the int64 index and the last pass's sort, 4n carrier)
    assert max(live_peaks(n, LINEITEM_WIDTHS, groups)) == 100


def test_plan_at_q18_widths():
    groups = cc.plan_groups(1000, Q18_WIDTHS)
    assert sizes_of(groups, Q18_WIDTHS) == [(32, 32), (12, 16)]
    # the 4-byte date rides at the end of the second group
    assert groups[1].offsets == (0, 8)
    assert [Q18_WIDTHS[i] for i in groups[1].columns] == [8, 4]


def live_peaks(n, widths, groups):
    """The live bytes of the call at each group, in units of n: outputs
    allocated so far (this group's included), its staged rows, the
    index."""
    index, done, out = cc.index_bytes(n), 0, []
    for g in groups:
        done += sum(widths[i] for i in g.columns)
        out.append(done + (g.row_bytes if g.staged else 0) + index)
    return out


@pytest.mark.parametrize("n", [10**6, cuda_sort.MAX_ITEMS,
                               cuda_sort.MAX_ITEMS + 1])
@pytest.mark.parametrize("seed", range(40))
def test_the_memory_rule_holds_at_every_group(seed, n):
    rng = random.Random(seed)
    widths = [rng.choice(cc.FIELD_WIDTHS)
              for _ in range(rng.randint(1, 40))]
    groups = cc.plan_groups(n, widths)
    limit = sum(widths) + 16 + widths[0]
    assert all(p <= limit for p in live_peaks(n, widths, groups))
    assert sorted(i for g in groups for i in g.columns) == \
        list(range(len(widths)))
    for g in groups:
        used = sum(widths[i] for i in g.columns)
        assert used <= 32 and len(g.columns) <= cc.MAX_FIELDS
        if g.staged:
            assert g.row_bytes == cc.staged_row(used)
        else:
            assert g.row_bytes == used
        for i, off in zip(g.columns, g.offsets):
            assert off % widths[i] == 0 and off + widths[i] <= g.row_bytes
        # offsets one after another, widest first
        ws = [widths[i] for i in g.columns]
        assert ws == sorted(ws, reverse=True)
        assert list(g.offsets) == [sum(ws[:k]) for k in range(len(ws))]


@pytest.mark.parametrize("widths,want", [
    # a group of 32 would breach the limit: 16, then 16, then 4
    ([8, 4, 8, 8, 4, 2, 1], [(16, 16), (16, 16), (3, 4)]),
    # one column: gathered straight, no staging
    ([8], [(8, 8)]),
    ([1, 1], [(2, 4)]),
])
def test_plan_by_hand(widths, want):
    assert sizes_of(cc.plan_groups(10**6, widths), widths) == want


def per_column_sort_multi(keys, pays, ascending):
    """sort_multi as it was before K10: the key passes, then one
    index_select a column."""
    perm = None
    for col, up in zip(reversed(keys), reversed(ascending)):
        c = transforms.to_sortable(col, up)
        if perm is not None:
            c = c.index_select(0, perm)
        order = torch.argsort(c, stable=True)
        perm = order if perm is None else perm.index_select(0, order)
    return (tuple(xla_sort.gather(k, perm) for k in keys),
            tuple(xla_sort.gather(p, perm) for p in pays))


def assert_bitwise(got, want):
    for g, w in zip(got[0] + got[1], want[0] + want[1], strict=True):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert np.array_equal(bits_of(g), bits_of(w))


def test_sort_multi_at_sf_001_lineitem_equals_the_per_column_gathers():
    conf = harness.load_file_module("configs", "tpch_sf30_lineitem")
    _, entry = harness.cell_of(harness.load_benchmark(), "tpch_sf30_orderby")
    base = json.loads((harness.REPO / entry["file"]).read_text())
    cfg = dict(base, scale_factor=0.01, orders=15000, lineitems=60175)
    mix = {"calls": [{"op": "orderby", "params": {"copy": 0}}]}
    state = conf.setup(cfg, mix, 2**33 + 5, harness.Context(
        torch.device("cpu")))
    t = state.tables[0]
    keys = tuple(t[k] for k in conf.KEYS)
    pays = tuple(t[c] for c in conf.PAYLOADS)
    assert [c.element_size() for c in keys + pays] == LINEITEM_WIDTHS
    for up in (conf.ASCENDING, (False, True, False)):
        got = sort_ops.sort_multi(keys, *pays, ascending=up, device="cpu")
        assert_bitwise(got, per_column_sort_multi(keys, pays, up))


MIXES = {
    "one key": ([torch.float64], [torch.float32, torch.uint8]),
    "keys only": ([torch.int16, torch.uint64], []),
    "33 bytes": ([torch.uint8], [torch.int8] * 32),
    "every dtype": ([torch.uint32, torch.float64],
                    [torch.uint8, torch.uint16, torch.uint32, torch.uint64,
                     torch.int8, torch.int16, torch.int32, torch.int64,
                     torch.float32, torch.float64]),
    "q18": ([torch.float64, torch.int32, torch.int64],
            [torch.int64, torch.int64, torch.float64]),
}


@pytest.mark.parametrize("n", [1, 2, 4099])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sort_multi_on_odd_mixes_equals_the_per_column_gathers(mix, n):
    kd, pd = MIXES[mix]
    # keys of few values (ties), NaN and both zeros among the floats
    keys = tuple(column(n, d, 7 * k) if d.is_floating_point else
                 (column(n, torch.uint8, 7 * k) % 5).to(d)
                 for k, d in enumerate(kd))
    pays = tuple(column(n, d, 100 + k) for k, d in enumerate(pd))
    for up in (True, False):
        got = sort_ops.sort_multi(keys, *pays, ascending=up, device="cpu")
        assert_bitwise(got, per_column_sort_multi(keys, pays,
                                                  (up,) * len(keys)))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_counters_follow_the_plan(mix):
    kd, pd = MIXES[mix]
    n = 3001
    keys = tuple(column(n, d, k) for k, d in enumerate(kd))
    pays = tuple(column(n, d, 50 + k) for k, d in enumerate(pd))
    widths = [t.element_size() for t in keys + pays]
    groups = cc.plan_groups(n, widths)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        sort_ops.sort_multi(keys, *pays, device="cpu")
    staged = sum(n * g.row_bytes for g in groups if g.staged)
    want = {"column_gather.groups": len(groups),
            "sort_multi.gather_bytes": sort_ops.multi_gather_bytes(n, widths)}
    if staged:
        want["column_gather.staged_bytes"] = staged
    assert dict(profiling.COUNTERS) == want
    profiling.reset_counters()
    sort_ops.sort_multi(keys, *pays, device="cpu")  # no profiler
    assert not profiling.COUNTERS


def test_lineitem_counts_four_groups_and_84_staged_bytes_a_row():
    n = 2000
    dts = {8: torch.int64, 4: torch.int32, 1: torch.int8}
    cols = [column(n, dts[w], k) for k, w in enumerate(LINEITEM_WIDTHS)]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        sort_ops.sort_multi(cols[:3], *cols[3:], device="cpu")
    assert profiling.COUNTERS["column_gather.groups"] == 4
    assert profiling.COUNTERS["column_gather.staged_bytes"] == 84 * n
    assert profiling.COUNTERS["sort_multi.gather_bytes"] == 364 * n
    profiling.reset_counters()


def test_no_launch_on_the_cpu():
    cc.reset_launches()
    cols = [column(100, torch.int64, k) for k in range(5)]
    cc.gather_columns(cols, torch.arange(100).flip(0))
    assert cc.LAUNCHES == {"column_pack": 0, "column_gather": 0}
