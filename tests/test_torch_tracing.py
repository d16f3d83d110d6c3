"""The port's own spans and counters (utils/profiling.py `span`, `count`),
on the CPU: free and silent with no profiler recording; under one, only
the listed names, each inside its parent, and counts that match a hand
count; and the benchmark's readers of them on synthetic traces."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_radix_sort_tpu_torch as tsrs
from benchmark import calls, harness
from benchmark.trace import CALL, WINDOW, Event, Trace
from simd_radix_sort_tpu_torch import methods
from simd_radix_sort_tpu_torch.ops import (cuda_columns, cuda_partition,
                                           cuda_sort, hashagg,
                                           hashjoin)
from simd_radix_sort_tpu_torch.ops import filter as filt
from simd_radix_sort_tpu_torch.ops import sort as sort_ops
from simd_radix_sort_tpu_torch.utils import profiling

# the spans each span must lie inside, in the calls below; None: top level
PARENTS = {
    "srs.sort": None, "srs.compact": None, "srs.hashagg": None,
    "srs.join": None, "srs.join.semi": None, "srs.sort_multi": None,
    "srs.sort.stage": ("srs.sort",), "srs.sort.resolve": ("srs.sort",),
    "srs.packed.keys": ("srs.sort",), "srs.packed.rows": ("srs.sort",),
    "srs.engine.count": ("srs.sort",), "srs.engine.xla": ("srs.sort",),
    "srs.count.u8": ("srs.engine.count",),
    "srs.count.tiny": ("srs.engine.count",),
    "srs.count.range": ("srs.engine.count",),
    "srs.count.k1024": ("srs.engine.count",),
    "srs.count.fallback": ("srs.engine.count",),
    "srs.transform": ("srs.engine.count", "srs.engine.xla", "srs.hashagg",
                      "srs.join.build", "srs.join.probe",
                      "srs.sort_multi.keys"),
    "srs.xla.sort": ("srs.engine.xla", "srs.hashagg.sort", "srs.join.build"),
    "srs.xla.gather": ("srs.engine.xla", "srs.hashagg.sort",
                       "srs.join.build"),
    "srs.xla.pairs": ("srs.engine.xla", "srs.hashagg.sort", "srs.join.build"),
    "srs.xla.bits": ("srs.xla.pairs",),
    "srs.k5": ("srs.compact",), "srs.widen": ("srs.compact",),
    "srs.fill": ("srs.compact",),
    "srs.hashagg.sort": ("srs.hashagg",), "srs.hashagg.scan": ("srs.hashagg",),
    "srs.hashagg.compact": ("srs.hashagg",),
    "srs.join.build": ("srs.join",), "srs.join.probe": ("srs.join",),
    "srs.sort_multi.keys": ("srs.sort_multi",),
    "srs.sort_multi.gather": ("srs.sort_multi",),
}


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def packed_rows(n: int, esize: int, seed: int = 3) -> torch.Tensor:
    """n seeded (n, esize) uint8 rows, an 8-byte key in each one's lead."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, esize), generator=g, dtype=torch.uint8)


def calls_of_every_layer():
    """A sort through count (each branch), two through xla (one payload:
    the pair sort; two: torch.sort and the gathers), a combined-layout sort
    of 64-byte rows, a filter, a bounded compaction padded past its rows, a
    group-aggregate with a float sum and one with two, a lookup join of one
    payload and one of two, a semi-join and a multi-column sort, on the
    CPU."""
    g = torch.Generator().manual_seed(7)
    n = 1 << 14  # counting.SMALL_MIN_N: the 1024-bucket branch opens
    tsrs.sort(torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8),
              method="count", device="cpu")
    for hi in (8, 1000, 30000):  # tiny, k1024, fallback
        tsrs.sort(torch.randint(0, hi, (n,), generator=g, dtype=torch.int16),
                  method="count", ascending=False, device="cpu")
    keys = torch.randint(0, 1 << 40, (4096,), generator=g)
    tsrs.sort(keys, torch.arange(4096), method="xla", device="cpu")
    tsrs.sort(keys, torch.arange(4096), keys % 3, method="xla", device="cpu")
    tsrs.sort_packed(packed_rows(4096, 64), np.uint64, device="cpu")
    filt.filter_rows(lambda k: k % 3 == 0, keys, torch.arange(4096) % 7)
    filt.compact_bounded(keys[:100] % 2 == 0, keys[:100],
                         torch.arange(100, dtype=torch.int16), max_out=128)
    hashagg.group_aggregate(keys % 5, torch.rand(4096, generator=g,
                                                 dtype=torch.float64),
                            aggs=("sum", "count"), max_groups=5)
    hashagg.group_aggregate(keys % 5, (keys % 11, keys % 13), aggs=("min",),
                            max_groups=5)
    hashjoin.lookup_join(keys % 900, torch.arange(1000),
                         (torch.arange(1000) * 3,))
    hashjoin.lookup_join(keys % 900, torch.arange(1000),
                         (torch.arange(1000) * 3, torch.arange(1000) % 7))
    hashjoin.semi_join(keys % 900, (torch.arange(4096),), torch.arange(300))
    tsrs.sort_multi((torch.rand(4096, generator=g, dtype=torch.float64),
                     (keys % 7).to(torch.int32), keys), torch.arange(4096),
                    ascending=(False, True, True), device="cpu")


def test_names_are_the_ports_own():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert len(set(profiling.COUNTER_NAMES)) == len(profiling.COUNTER_NAMES)
    for name in profiling.SPANS + profiling.COUNTER_NAMES:
        assert not name.startswith("cu")
    assert all(s.startswith("srs.") for s in profiling.SPANS)
    assert {f"srs.engine.{m}" for m in methods.REGISTRY} <= \
        set(profiling.SPANS)
    bench = {WINDOW, CALL}
    for conf in ("sort_thesis", "tpch_sf30", "tpch_sf100",
                 "sort_thesis_combined", "tpch_sf30_lineitem"):
        bench |= set(harness.load_file_module("configs", conf).SPANS)
    assert not bench & set(profiling.SPANS)


def test_off_constructs_no_span_and_counts_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not profiling.recording()
    launches = dict(cuda_partition.LAUNCHES)
    calls_of_every_layer()
    assert not profiling.COUNTERS
    for name in profiling.DEVICE_COUNTER_NAMES:
        assert profiling.device_counted(name) is None
    assert cuda_partition.LAUNCHES == launches


def test_on_emits_listed_spans_each_inside_its_parent(monkeypatch):
    # every pair sort reads its bit window, however few its rows
    monkeypatch.setattr(cuda_sort, "HOST_READ_S", 0.0)
    resize = filt._resize

    def marked_resize(s, length):
        with torch.profiler.record_function("test.resize"):
            return resize(s, length)

    monkeypatch.setattr(filt, "_resize", marked_resize)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls_of_every_layer()
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(("srs.", "test.")):
            spans[e.name].append((e.time_range.start, e.time_range.end))
    cuts = spans.pop("test.resize")
    assert set(spans) <= set(profiling.SPANS)
    assert set(spans) == set(PARENTS)
    for name, ivs in spans.items():
        parents = PARENTS[name]
        if parents is None:
            continue
        for s, e in ivs:
            assert any(ps <= s and e <= pe for p in parents
                       for ps, pe in spans[p]), (name, s, e)
    # compact_bounded's cut and pad (two aggregates and the padded call:
    # 3 + 3 + 2 streams) lie inside `srs.compact`, which never nests
    assert len(cuts) == 8
    compacts = sorted(spans["srs.compact"])
    for s, e in cuts:
        assert any(ps <= s and e <= pe for ps, pe in compacts), (s, e)
    assert all(e <= s for (_, e), (s, _) in zip(compacts, compacts[1:]))


@pytest.mark.parametrize("dtype,hi,syncs", [
    (torch.int16, 1000, 1), (torch.int16, 16, 1), (torch.int32, 3, 1),
    (torch.int32, 1 << 20, 1), (torch.uint8, 256, 0)])
def test_count_range_read_counted_once_per_wide_call(dtype, hi, syncs):
    keys = torch.randint(0, hi, (5000,), dtype=dtype)
    with profile(activities=[ProfilerActivity.CPU]):
        out = tsrs.sort(keys, method="count", device="cpu")
    assert torch.equal(out, torch.sort(keys).values)
    assert profiling.COUNTERS["host_syncs.count.range"] == syncs
    assert profiling.COUNTERS.total() == syncs


@pytest.mark.parametrize("longest", [1, 2, 3, 37, 64, 65])
def test_scan_counts_one_flag_read_a_pass_and_the_last(longest):
    sizes = [1, longest, min(2, longest), max(1, longest // 3)]
    keys = torch.repeat_interleave(torch.arange(len(sizes)),
                                   torch.tensor(sizes))
    vals = torch.ones(keys.shape[0], dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]):
        ng, _, ((sums,),) = hashagg.group_aggregate(keys, vals,
                                                    aggs=("sum",))
    assert sums[:int(ng)].tolist() == sizes
    # the scan reads no flag back, whatever the longest group: the CPU's
    # doubling runs ceil(log2 n) passes and K7 (on the card alone, so not
    # counted here) none at all
    assert not any(k.startswith(("host_syncs.hashagg", "hashagg.scan"))
                   for k in profiling.COUNTERS)


def test_compaction_bytes_by_hand():
    n = 1000
    mask = torch.arange(n) % 3 == 0
    with profile(activities=[ProfilerActivity.CPU]):
        cnt, a, b = filt.compact(mask, torch.arange(n),
                                 torch.arange(n, dtype=torch.int8), fill=0)
    assert int(cnt) == 334 and int(a[333]) == 999 and int(a[334]) == 0
    c = profiling.COUNTERS
    # K5: the mask by the count and one scatter launch; the int64 stream
    # and the int8 one's int32 words each read and written
    assert c["compaction.k5_bytes"] == 2 * n + 2 * 8 * n + 2 * 4 * n
    # int8 -> int32 (n + 4n), the mask (4n + 4n); back (4n + n)
    assert c["compaction.widen_bytes"] == 13 * n + 5 * n
    # the row mask (8n + 8n + n); where over int64 (n + 16n), int8 (n + 2n)
    assert c["compaction.fill_bytes"] == 17 * n + 17 * n + 3 * n
    assert c["host_syncs.filter.fill"] == 2
    assert c.total() == 26 * n + 18 * n + 37 * n + 2


class Untouchable:
    """A value that fails a test when anything reads it."""

    def __getattribute__(self, name):
        raise AssertionError(f"the device counter touched .{name}")


def test_device_counter_holds_nothing_and_touches_nothing_when_off():
    assert not profiling.recording()
    profiling.count_on_device("compact.needed_bytes", Untouchable(), 3,
                              cap=Untouchable())
    profiling.count_on_device("compact.needed_bytes", 10**6)
    assert profiling.device_counted("compact.needed_bytes") is None


@pytest.mark.parametrize("entries", [
    [(5, 1, None)],
    [(torch.tensor(7, dtype=torch.int32), 18, None), (1000, 1, None)],
    [(torch.tensor(334, dtype=torch.int32), 18, 5),
     (torch.tensor(3), 18, 5), (torch.tensor(0, dtype=torch.int16), 9, 1),
     (40, 2, 7), (3, 2, 7)],
    [(torch.tensor(2**31 - 1, dtype=torch.int32), 70, None),
     (torch.tensor(6 * 10**8), 32, None)]])
def test_device_counter_adds_up_by_hand(entries):
    with profile(activities=[ProfilerActivity.CPU]):
        for value, weight, cap in entries:
            profiling.count_on_device("compact.needed_bytes", value, weight,
                                      cap=cap)
    want = sum(w * (int(v) if cap is None else min(int(v), cap))
               for v, w, cap in entries)
    assert profiling.device_counted("compact.needed_bytes") == want
    # reading leaves it as it was; the counters of COUNTERS never see it
    assert profiling.device_counted("compact.needed_bytes") == want
    assert not profiling.COUNTERS
    profiling.reset_counters()
    assert profiling.device_counted("compact.needed_bytes") is None


def test_device_counter_refuses_a_value_written_after_it_was_kept():
    count = torch.tensor(7, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_on_device("compact.needed_bytes", count, 2)
    count.add_(1)
    with pytest.raises(RuntimeError, match="written"):
        profiling.device_counted("compact.needed_bytes")
    profiling.reset_counters()
    with torch.inference_mode():  # no count of writes: kept unguarded
        inferred = torch.tensor(5, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_on_device("compact.needed_bytes", inferred, 3)
    assert profiling.device_counted("compact.needed_bytes") == 15
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(TypeError):
            profiling.count_on_device("compact.needed_bytes",
                                      torch.ones(2, dtype=torch.int32))
        with pytest.raises(TypeError):
            profiling.count_on_device("compact.needed_bytes",
                                      torch.tensor(1.0))


def _mixed_streams(n):
    # test_compaction_bytes_by_hand's streams: int64 and int8, 9 bytes a row
    return torch.arange(n), torch.arange(n, dtype=torch.int8)


@pytest.mark.parametrize("call,kept", [
    (lambda m, *s: filt.compact(m, *s), 334),
    (lambda m, *s: filt.compact(m, *s, fill=0), 334),
    (lambda m, *s: filt.compact_bounded(m, *s, max_out=100), 100),
    (lambda m, *s: filt.compact_bounded(m, *s, max_out=2000), 334)])
def test_compact_needed_bytes_by_hand(call, kept):
    n = 1000
    mask = torch.arange(n) % 3 == 0
    with profile(activities=[ProfilerActivity.CPU]):
        cnt, a, b = call(mask, *_mixed_streams(n))
    assert int(cnt) == 334 and int(a[kept - 1]) == 3 * (kept - 1)
    # the mask once; each kept row read and written at 8 + 1 bytes
    assert profiling.device_counted("compact.needed_bytes") == \
        n + 2 * kept * 9


def test_needed_bytes_leave_the_compaction_counters_as_they_were():
    n = 1000
    mask = torch.arange(n) % 3 == 0
    with profile(activities=[ProfilerActivity.CPU]):
        filt.compact(mask, *_mixed_streams(n), fill=0)
    # test_compaction_bytes_by_hand's totals, value for value
    c = profiling.COUNTERS
    assert c["compaction.k5_bytes"] == 26 * n
    assert c["compaction.widen_bytes"] == 18 * n
    assert c["compaction.fill_bytes"] == 37 * n
    assert c["host_syncs.filter.fill"] == 2
    assert c.total() == 26 * n + 18 * n + 37 * n + 2
    assert set(c) <= set(profiling.COUNTER_NAMES)
    assert profiling.device_counted("compact.needed_bytes") == n + 18 * 334


@pytest.mark.parametrize("n,every,dtypes", [
    (1000, 3, (torch.int64, torch.int8)),
    (4099, 50, (torch.int8, torch.int8, torch.float64, torch.float64,
                torch.float64, torch.float64)),
    (777, 1, (torch.int64, torch.int32, torch.float64, torch.int16)),
    (500, 1000, (torch.float64, torch.float64))])
def test_filter_rows_needed_bytes_are_the_benchmarks_rule(n, every, dtypes):
    mask = torch.arange(n) % every == 0
    streams = [torch.arange(n).to(d) for d in dtypes]
    with profile(activities=[ProfilerActivity.CPU]):
        cnt, *_ = filt.filter_rows(mask, *streams)
    work = harness.load_file_module("work", "filter_rows")
    assert profiling.device_counted("compact.needed_bytes") == \
        work.bytes_needed({"n": n, "selected": int(cnt),
                           "stream_bytes": [d.itemsize for d in dtypes]})


def _span_times(prof, prefix="srs."):
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(prefix):
            spans[e.name].append((e.time_range.start, e.time_range.end))
    return spans


@pytest.mark.parametrize("ascending", [True, False])
def test_packed_spans_wrap_the_copies_around_the_pair_sort(ascending,
                                                          monkeypatch):
    monkeypatch.setattr(cuda_sort, "HOST_READ_S", 0.0)
    rows = packed_rows(5000, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsrs.sort_packed(rows, np.uint64, ascending=ascending, device="cpu")
    spans = _span_times(prof)
    (whole,) = spans["srs.sort"]
    (keys,), (pairs,), (out,) = (spans[n] for n in (
        "srs.packed.keys", "srs.xla.pairs", "srs.packed.rows"))
    assert whole[0] <= keys[0] and out[1] <= whole[1]
    # the key column and index, then the engine's pair sort, then the rows
    assert keys[1] <= pairs[0] and pairs[1] <= out[0]
    (engine,) = spans["srs.engine.xla"]
    assert keys[1] <= engine[0] and engine[1] <= out[0]
    # the plain row gather: whole rows by the sorted index, no `cat`
    names = {e.name for e in prof.events()}
    assert "aten::index_select" in names and "aten::cat" not in names


@pytest.mark.parametrize("n,esize,want", [
    (5000, 64, 160 * 5000),   # key 16n, index 8n, row gather 8n + 128n
    (4099, 24, (16 + 8 + 8 + 48) * 4099),
    (3000, 8, 16 * 3000),     # keys alone: the assembly alone
])
def test_packed_copy_bytes_counted_once_a_call(n, esize, want):
    rows = packed_rows(n, esize)
    with profile(activities=[ProfilerActivity.CPU]):
        for ascending in (True, False):
            tsrs.sort_packed(rows, np.uint64, ascending=ascending,
                             device="cpu")
    assert profiling.COUNTERS["packed.copy_bytes"] == 2 * want
    profiling.reset_counters()
    tsrs.sort_packed(rows, np.uint64, device="cpu")  # no profiler
    assert not profiling.COUNTERS


def lineitem_like(n: int, seed: int = 5):
    """Three key columns with ties (int32, int64, int32) and four payloads
    of 1, 4, 8 and 8 bytes, seeded."""
    g = torch.Generator().manual_seed(seed)
    keys = (torch.randint(0, 50, (n,), generator=g, dtype=torch.int32),
            torch.randint(0, 300, (n,), generator=g),
            torch.randint(1, 8, (n,), generator=g, dtype=torch.int32))
    pays = (torch.randint(0, 4, (n,), generator=g, dtype=torch.int8),
            torch.arange(n, dtype=torch.int32), torch.arange(n),
            torch.rand(n, generator=g, dtype=torch.float64))
    return keys, pays


@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_sort_multi_spans_wrap_the_key_passes_then_the_gathers(nkeys):
    keys, pays = lineitem_like(3000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsrs.sort_multi(keys[:nkeys], *pays,
                        ascending=(True, False, True)[:nkeys], device="cpu")
    spans = _span_times(prof)
    (whole,) = spans["srs.sort_multi"]
    passes, (gather,) = spans["srs.sort_multi.keys"], \
        spans["srs.sort_multi.gather"]
    assert len(passes) == nkeys
    for s, e in passes + [gather]:
        assert whole[0] <= s and e <= whole[1]
    # one pass a key column, one after another, then the gathers
    for (_, e), (s, _) in zip(passes, passes[1:] + [gather]):
        assert e <= s
    # one gather a group of output columns, all inside the gather span; the
    # sorts inside the passes
    picks = [e.time_range for e in prof.events()
             if e.name == "aten::index_select"
             and gather[0] <= e.time_range.start <= gather[1]]
    widths = [t.element_size() for t in keys[:nkeys] + pays]
    assert len(picks) == len(cuda_columns.plan_groups(3000, widths))
    sorts = [e.time_range for e in prof.events() if e.name == "aten::sort"]
    assert sorts and all(any(s <= r.start and r.end <= e for s, e in passes)
                         for r in sorts)


@pytest.mark.parametrize("n,nkeys", [(3000, 3), (4099, 1), (1, 2)])
def test_sort_multi_gather_bytes_counted_once_a_call(n, nkeys):
    keys, pays = lineitem_like(n)
    widths = [t.element_size() for t in keys[:nkeys] + pays]
    with profile(activities=[ProfilerActivity.CPU]):
        for up in (True, False):
            tsrs.sort_multi(keys[:nkeys], *pays, ascending=up, device="cpu")
    # the index narrowed, then each group packed and gathered
    groups = cuda_columns.plan_groups(n, widths)
    want = 12 * n + sum(
        n * (2 * used + 2 * g.row_bytes + 4) if g.staged else
        n * (2 * used + 4)
        for g, used in ((g, sum(widths[i] for i in g.columns))
                        for g in groups))
    assert sort_ops.multi_gather_bytes(n, widths) == want
    staged = sum(n * g.row_bytes for g in groups if g.staged)
    assert profiling.COUNTERS == {
        "sort_multi.gather_bytes": 2 * want,
        "column_gather.groups": 2 * len(groups),
        "column_gather.staged_bytes": 2 * staged}
    profiling.reset_counters()
    tsrs.sort_multi(keys[:nkeys], *pays, device="cpu")  # no profiler
    assert not profiling.COUNTERS


def orderby_run(spans=True):
    """Two traced ORDER BY calls of 10^4 84-byte rows (one untraced); with
    `spans`, the port's inner spans, else `srs.sort_multi` alone."""
    n = 10**4
    facts = {"rows": n, "orderby": [{"n": n, "row_bytes": 84}]}
    recs = [harness.Record(calls.Call(i, "orderby", {}), latency_ms=1.0,
                           facts=facts, traced=i < 2) for i in range(3)]
    ev = [Event(WINDOW, "op", 0, 100),
          Event("orderby", "op", 0, 45), Event("srs.sort_multi", "op", 1, 44),
          Event("orderby", "op", 50, 95),
          Event("srs.sort_multi", "op", 51, 94)]
    if spans:
        ev += [Event("srs.sort_multi.keys", "op", 2, 4),
               Event("srs.sort_multi.keys", "op", 5, 8),
               Event("srs.sort_multi.gather", "op", 9, 12),
               Event("srs.sort_multi.keys", "op", 52, 55),
               Event("srs.sort_multi.gather", "op", 58, 64)]
    # keys [3,7] [6,15] and [53,60]; gathers [15,30] and [60,69]; a launch
    # at 56, between the spans, [60,61] inside `srs.sort_multi` alone
    ev += (launch(3, 3, 7, 1) + launch(6, 6, 15, 2) + launch(10, 15, 30, 3)
           + launch(53, 53, 60, 4) + launch(56, 60, 61, 5)
           + launch(59, 61, 69, 6))
    return harness.Run("w", recs, 1.0, 0.0, 0,
                       trace=Trace(ev, {"orderby"}))


def test_orderby_readers_by_hand(monkeypatch):
    n = 10**4
    monkeypatch.setattr(profiling, "COUNTERS", collections.Counter({
        "sort_multi.gather_bytes": 2 * 364 * n, "xla.pairs_calls": 1}))
    run = orderby_run()
    # busy from the passes: [3,15] + [53,60] = 19 us over 2 calls
    assert metric("operators.orderby_keys_ms")(run) == pytest.approx(0.0095)
    # from the gathers: [15,30] + [61,69] = 23 us over 2 calls
    assert metric("operators.orderby_gather_ms")(run) == pytest.approx(
        0.0115)
    assert metric("operators.orderby_gb")(run) == pytest.approx(
        364 * n / 1e9)
    # two calls' 2 * n * 84 bytes at 3.35 TB/s over [3,30] + [53,69]
    assert metric("orderby_roofline")(run) == pytest.approx(
        100 * 2 * 2 * n * 84 / 3.35e12 / 43e-6)


def test_orderby_readers_silent_without_the_spans(monkeypatch):
    # a program with `srs.sort_multi` alone and no counter of its gathers
    monkeypatch.setattr(profiling, "COUNTERS",
                        collections.Counter({"xla.pairs_calls": 1}))
    run = orderby_run(spans=False)
    for name in ("operators.orderby_keys_ms", "operators.orderby_gather_ms",
                 "operators.orderby_gb"):
        assert metric(name)(run) is None, name
    # the whole call's share reads what the outer span holds
    assert metric("orderby_roofline")(run) == pytest.approx(
        100 * 2 * 2 * 10**4 * 84 / 3.35e12 / 43e-6)
    # untraced: nothing
    run.trace = None
    assert metric("orderby_roofline")(run) is None


def metric(name):
    return harness.load_file_module("metrics", name).read


def record(kind, traced=True):
    return harness.Record(calls.Call(0, "x", {}), latency_ms=1.0,
                          facts={"rows": 1, kind: [{}]}, traced=traced)


def launch(host, start, end, i):
    return [Event("cudaLaunchKernel", "runtime", host, host + 0.5, id=i),
            Event(f"k{i}", "device", start, end, id=i)]


def sort_trace():
    """A 100 us window and two sort calls.  Kernels launched from the
    transforms (8-14, 25-27, 56-60), the gather (12-18) and the sort's own
    host time (62-70)."""
    ev = [Event(WINDOW, "op", 0, 100),
          Event(CALL, "op", 0, 40), Event("sort", "op", 1, 30),
          Event("srs.sort", "op", 2, 28),
          Event("srs.transform", "op", 3, 6),
          Event("srs.xla.gather", "op", 10, 12),
          Event("srs.transform", "op", 20, 24),
          Event(CALL, "op", 50, 95), Event("sort", "op", 51, 80),
          Event("srs.sort", "op", 52, 78),
          Event("srs.transform", "op", 53, 55)]
    ev += (launch(4, 8, 14, 1) + launch(11, 12, 18, 2) + launch(21, 25, 27, 3)
           + launch(54, 56, 60, 4) + launch(62, 62, 70, 5))
    return Trace(ev, {"sort"})


def test_span_readers_by_hand():
    recs = [record("sort"), record("sort"), record("sort", traced=False)]
    run = harness.Run("w", recs, 1.0, 0.0, 0, trace=sort_trace())
    # busy from the transforms: [8,14] + [25,27] + [56,60] = 12 us, 2 calls
    assert metric("engine.transform_ms")(run) == pytest.approx(0.006)
    assert metric("engine.transform_ms.host_bound")(run) == \
        pytest.approx(0.006)
    assert metric("kernels.gather_ms")(run) == pytest.approx(0.003)
    # idle [0,8] [18,25] [27,56] [60,62] [70,100] inside [2,28] and [52,78]:
    # 6 + 7 + 1 and 4 + 2 + 8
    assert metric("engine.idle_in_sort_us")(run) == pytest.approx(14.0)
    # the benchmark's own readings are those of the trace without them
    assert run.trace.busy_s("sort") == pytest.approx(24e-6)

    q = [record("query"), record("query", traced=False)]
    ev = [Event(WINDOW, "op", 0, 100), Event("query", "op", 0, 90),
          Event("srs.hashagg.scan", "op", 10, 20),
          Event("srs.join.build", "op", 30, 40),
          Event("srs.hashagg.compact", "op", 60, 64),
          Event("srs.join.semi", "op", 70, 80),
          Event("srs.sort_multi", "op", 82, 88)]
    ev += launch(12, 15, 25, 1) + launch(35, 36, 41, 2) + launch(50, 50, 60, 3)
    ev += launch(61, 62, 66, 4) + launch(72, 74, 77, 5) + launch(83, 84, 85, 6)
    run = harness.Run("w", q, 1.0, 0.0, 0, trace=Trace(ev, {"query"}))
    assert metric("operators.scan_ms")(run) == pytest.approx(0.010)
    assert metric("operators.join_build_ms")(run) == pytest.approx(0.005)
    assert metric("operators.agg_compact_ms")(run) == pytest.approx(0.004)
    assert metric("operators.semi_join_ms")(run) == pytest.approx(0.003)
    # busy [84,85], and idle [82,84] and [85,88] while inside the span
    assert metric("operators.orderby_us")(run) == pytest.approx(6.0)


def test_span_readers_read_nothing_where_there_is_nothing():
    recs = [record("sort"), record("query")]
    names = ("engine.transform_ms", "kernels.gather_ms",
             "engine.idle_in_sort_us", "operators.scan_ms",
             "operators.join_build_ms", "operators.agg_compact_ms",
             "operators.semi_join_ms", "operators.orderby_us",
             "kernels.packed_ms", "kernels.packed_gb", "packed_roofline",
             "operators.orderby_keys_ms", "operators.orderby_gather_ms",
             "operators.orderby_gb", "orderby_roofline",
             "operators.compact_useful", "operators.compact_ms",
             "operators.compact_idle_us")
    # no trace; a trace without the program's spans (a program that has
    # none); one without a call of the metric's kind
    bare = Trace([Event(WINDOW, "op", 0, 10), *launch(1, 2, 3, 1)], set())
    for trace in (None, bare):
        run = harness.Run("w", recs, 1.0, 0.0, 0, trace=trace)
        for name in names:
            assert metric(name)(run) is None, name
    run = harness.Run("w", [], 1.0, 0.0, 0, trace=sort_trace())
    assert metric("engine.transform_ms")(run) is None


def test_packed_readers_by_hand(monkeypatch):
    n = 10**4
    monkeypatch.setattr(profiling, "COUNTERS", collections.Counter({
        "packed.copy_bytes": 2 * 272 * n, "xla.pairs_calls": 2}))
    facts = {"rows": n, "sort": [{"n": n, "row_bytes": 64}],
             "packed": [{"n": n, "row_bytes": 64, "key_bytes": 8}]}
    recs = [harness.Record(calls.Call(i, "sort_packed", {}), latency_ms=1.0,
                           facts=facts, traced=i < 2) for i in range(3)]
    ev = [Event(WINDOW, "op", 0, 100),
          Event("sort", "op", 0, 45), Event("srs.sort", "op", 1, 44),
          Event("srs.packed.keys", "op", 2, 5),
          Event("srs.xla.pairs", "op", 6, 8),
          Event("srs.packed.rows", "op", 9, 12),
          Event("sort", "op", 50, 95), Event("srs.sort", "op", 51, 94),
          Event("srs.packed.keys", "op", 52, 54),
          Event("srs.xla.pairs", "op", 55, 57),
          Event("srs.packed.rows", "op", 58, 64)]
    # keys [3,7] and [53,55]; the pair sort [7,20] and [56,61] (not
    # counted); rows [20,30] and [61,69]
    ev += (launch(3, 3, 7, 1) + launch(7, 7, 20, 2) + launch(10, 20, 30, 3)
           + launch(53, 53, 55, 4) + launch(56, 56, 61, 5)
           + launch(61, 61, 69, 6))
    run = harness.Run("w", recs, 1.0, 0.0, 0, trace=Trace(ev, {"sort"}))
    assert metric("kernels.packed_ms")(run) == pytest.approx(0.012)
    assert metric("kernels.packed_gb")(run) == pytest.approx(272 * n / 1e9)
    # two calls' 2 * n * 64 bytes at 3.35 TB/s over 24 us; the whole call
    # over the 27 + 15 us busy inside its `sort` span
    assert metric("packed_roofline")(run) == pytest.approx(
        100 * 2 * 2 * n * 64 / 3.35e12 / 24e-6)
    assert metric("sort_roofline")(run) == pytest.approx(
        100 * 2 * 2 * n * 64 / 3.35e12 / 42e-6)
    # a program without the counter (the copies uncounted) reads nothing
    monkeypatch.setattr(profiling, "COUNTERS",
                        collections.Counter({"xla.pairs_calls": 2}))
    assert metric("kernels.packed_gb")(run) is None


def test_counter_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", collections.Counter({
        "host_syncs.count.range": 3, "host_syncs.filter.fill": 1,
        "compaction.k5_bytes": 4 * 10**9, "compaction.fill_bytes": 2 * 10**9,
        "compaction.widen_bytes": 10**9}))
    sorts = [record("sort"), record("sort"), record("sort", traced=False)]
    queries = [record("query"), record("query")]
    tr = sort_trace()
    assert metric("engine.host_syncs")(
        harness.Run("w", sorts, 1.0, 0.0, 0, trace=tr)) == pytest.approx(2.0)
    run = harness.Run("w", queries, 1.0, 0.0, 0, trace=tr)
    assert metric("operators.host_syncs")(run) == pytest.approx(2.0)
    assert metric("operators.compaction_gb")(run) == pytest.approx(3.5)
    # untraced: nothing; a program without counters: nothing
    assert metric("operators.compaction_gb")(
        harness.Run("w", queries, 1.0, 0.0, 0)) is None
    monkeypatch.delattr(profiling, "COUNTERS")
    assert metric("operators.host_syncs")(run) is None
    assert metric("engine.host_syncs")(
        harness.Run("w", sorts, 1.0, 0.0, 0, trace=tr)) is None


def compact_run():
    """Two traced queries (one untraced) of a 100 us window: `srs.compact`
    at [2,10], inside the aggregate's `srs.hashagg.compact` at [21,29],
    and at [55,70]; launches from inside them at 3, 22 and 56, one from
    outside at 40."""
    q = [record("query"), record("query"), record("query", traced=False)]
    ev = [Event(WINDOW, "op", 0, 100), Event("query", "op", 0, 45),
          Event("srs.compact", "op", 2, 10),
          Event("srs.hashagg.compact", "op", 20, 30),
          Event("srs.compact", "op", 21, 29),
          Event("query", "op", 50, 95), Event("srs.compact", "op", 55, 70)]
    ev += (launch(3, 4, 12, 1) + launch(22, 22, 26, 2)
           + launch(40, 40, 50, 3) + launch(56, 60, 65, 4))
    return harness.Run("w", q, 1.0, 0.0, 0, trace=Trace(ev, {"query"}))


def test_compact_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", collections.Counter({
        "compaction.k5_bytes": 4 * 10**9, "compaction.widen_bytes": 10**9,
        "compaction.fill_bytes": 2 * 10**9, "host_syncs.filter.fill": 3}))
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_on_device("compact.needed_bytes", 7 * 10**8)
        profiling.count_on_device("compact.needed_bytes",
                                  torch.tensor(10**7), 70)
    run = compact_run()
    # 1.4 GB needed of the 7 GB the compactions move
    assert metric("operators.compact_useful")(run) == pytest.approx(20.0)
    # busy [4,12] + [22,26] + [60,65] = 17 us over 2 queries; the
    # aggregate's own compaction [22,26] alone
    assert metric("operators.compact_ms")(run) == pytest.approx(0.0085)
    assert metric("operators.agg_compact_ms")(run) == pytest.approx(0.002)
    # idle [2,4]; [21,22] and [26,29]; [55,60] and [65,70]: 16 us
    assert metric("operators.compact_idle_us")(run) == pytest.approx(8.0)


def test_compact_readers_silent_where_there_is_nothing(monkeypatch):
    names = ("operators.compact_useful", "operators.compact_ms",
             "operators.compact_idle_us")
    with profile(activities=[ProfilerActivity.CPU]):
        filt.compact(torch.arange(10) % 2 == 0, torch.arange(10))
    run = compact_run()
    # untraced: nothing
    untraced = harness.Run("w", run.records, 1.0, 0.0, 0)
    for name in names:
        assert metric(name)(untraced) is None, name
    # a trace without `srs.compact`: no busy or idle time to read
    bare = Trace([Event(WINDOW, "op", 0, 10), *launch(1, 2, 3, 1)], set())
    for name in names[1:]:
        assert metric(name)(harness.Run("w", run.records, 1.0, 0.0, 0,
                                        trace=bare)) is None, name
    # nothing counted: no share
    profiling.reset_counters()
    assert metric("operators.compact_useful")(run) is None
    # a program without the device counter, whose `srs.compact` leaves
    # compact_bounded's cut and pad out: nothing, though its spans are there
    monkeypatch.delattr(profiling, "device_counted")
    monkeypatch.delattr(profiling, "DEVICE_COUNTER_NAMES")
    for name in names:
        assert metric(name)(run) is None, name
