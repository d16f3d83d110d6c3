"""The port's own spans and counters (utils/profiling.py `span`, `count`),
on the CPU: free and silent with no profiler recording; under one, only
the listed names, each inside its parent, and counts that match a hand
count; and the benchmark's readers of them on synthetic traces."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_radix_sort_tpu_torch as tsrs
from benchmark import calls, harness
from benchmark.trace import CALL, WINDOW, Event, Trace
from simd_radix_sort_tpu_torch import methods
from simd_radix_sort_tpu_torch.ops import (cuda_partition, cuda_sort, hashagg,
                                           hashjoin)
from simd_radix_sort_tpu_torch.ops import filter as filt
from simd_radix_sort_tpu_torch.utils import profiling

# the spans each span must lie inside, in the calls below; None: top level
PARENTS = {
    "srs.sort": None, "srs.compact": None, "srs.hashagg": None,
    "srs.join": None, "srs.join.semi": None, "srs.sort_multi": None,
    "srs.sort.stage": ("srs.sort",), "srs.sort.resolve": ("srs.sort",),
    "srs.engine.count": ("srs.sort",), "srs.engine.xla": ("srs.sort",),
    "srs.count.u8": ("srs.engine.count",),
    "srs.count.tiny": ("srs.engine.count",),
    "srs.count.range": ("srs.engine.count",),
    "srs.count.k1024": ("srs.engine.count",),
    "srs.count.fallback": ("srs.engine.count",),
    "srs.transform": ("srs.engine.count", "srs.engine.xla", "srs.hashagg",
                      "srs.join.build", "srs.join.probe", "srs.sort_multi"),
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
}


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def calls_of_every_layer():
    """A sort through count (each branch), two through xla (one payload:
    the pair sort; two: torch.sort and the gathers), a filter, a
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
    filt.filter_rows(lambda k: k % 3 == 0, keys, torch.arange(4096) % 7)
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
    for conf in ("sort_thesis", "tpch_sf30", "tpch_sf100"):
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
    assert cuda_partition.LAUNCHES == launches


def test_on_emits_listed_spans_each_inside_its_parent(monkeypatch):
    # every pair sort reads its bit window, however few its rows
    monkeypatch.setattr(cuda_sort, "HOST_READ_S", 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls_of_every_layer()
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("srs."):
            spans[e.name].append((e.time_range.start, e.time_range.end))
    assert set(spans) <= set(profiling.SPANS)
    assert set(spans) == set(PARENTS)
    for name, ivs in spans.items():
        parents = PARENTS[name]
        if parents is None:
            continue
        for s, e in ivs:
            assert any(ps <= s and e <= pe for p in parents
                       for ps, pe in spans[p]), (name, s, e)


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
             "operators.semi_join_ms", "operators.orderby_us")
    # no trace; a trace without the program's spans (a program that has
    # none); one without a call of the metric's kind
    bare = Trace([Event(WINDOW, "op", 0, 10), *launch(1, 2, 3, 1)], set())
    for trace in (None, bare):
        run = harness.Run("w", recs, 1.0, 0.0, 0, trace=trace)
        for name in names:
            assert metric(name)(run) is None, name
    run = harness.Run("w", [], 1.0, 0.0, 0, trace=sort_trace())
    assert metric("engine.transform_ms")(run) is None


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
