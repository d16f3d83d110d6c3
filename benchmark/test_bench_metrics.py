"""The yardstick's arithmetic: byte counts against hand counts, the p95
over every call, the idle share and busy time from overlapping
intervals, the roofline shares of a synthetic trace."""

import pytest

from benchmark import calls, harness
from benchmark.trace import CALL, WINDOW, Event, Trace


def work(name):
    return harness.load_file_module("work", name).bytes_needed


def metric(name):
    return harness.load_file_module("metrics", name).read


def test_byte_counts_by_hand():
    # 10 rows of a uint64 key and a uint64 payload: 10 x 16 read, written
    assert work("sort")({"n": 10, "row_bytes": 16}) == 320
    # mask of 10 rows; 3 kept rows of an int8 and an f64 stream
    assert work("filter_rows")(
        {"n": 10, "selected": 3, "stream_bytes": [1, 8]}) == 10 + 2 * 3 * 9
    # Q1: shipdate over 10 rows; 34 bytes over 4 kept; 6 x 9 x 8 answer
    assert work("q1")({"n": 10, "selected": 4}) == 40 + 136 + 432
    # Q6: 20 bytes over 10 rows, 8 over 2 kept, 8 answer
    assert work("q6")({"n": 10, "selected": 2}) == 200 + 16 + 8
    # Q12: 13 over 10 rows, 8 over 1 kept, 9 x 5 orders, 7 x 3 x 8 answer
    assert work("q12")({"n": 10, "selected": 1, "orders": 5}) == \
        130 + 8 + 45 + 168


def record(latency, rows=1, **facts):
    return harness.Record(calls.Call(0, "x", {}), latency_ms=latency,
                          facts=dict(rows=rows, **facts))


def test_p95_over_every_call_and_rows_per_s():
    recs = [record(float(i)) for i in range(1, 101)]
    recs.append(harness.Record(calls.Call(0, "x", {}), error="raised"))
    run = harness.Run("w", recs, window_s=2.0, setup_s=1.0, peak_bytes=0)
    # inclusive method: the 95th of 1..100 lies at 95.05
    assert metric("p95_ms")(run) == pytest.approx(95.05)
    assert metric("rows_per_s")(run) == pytest.approx(50.0)
    assert metric("setup_s")(run) == 1.0
    assert metric("peak_mem_gib")(run) is None


def synthetic_trace():
    """A 100 us window; two calls; kernels overlapping and one launched
    from outside any layer span."""
    ev = [Event(WINDOW, "op", 0, 100),
          Event(CALL, "op", 0, 40), Event("sort", "op", 1, 30),
          Event(CALL, "op", 50, 95), Event("sort", "op", 51, 60),
          Event("aten::item", "op", 70, 90),
          # runtime launches (host) and their kernels (device)
          Event("cudaLaunchKernel", "runtime", 2, 3, id=1),
          Event("cudaLaunchKernel", "runtime", 4, 5, id=2),
          Event("cudaLaunchKernel", "runtime", 52, 53, id=3),
          Event("cudaLaunchKernel", "runtime", 62, 63, id=4),
          Event("k_a", "device", 10, 30, id=1),
          Event("k_b", "device", 20, 35, id=2),    # overlaps k_a
          Event("k_a", "device", 55, 65, id=3),
          Event("k_c", "device", 64, 70, id=4)]    # outside "sort"
    return Trace(ev, {"sort"})


def test_busy_and_idle_from_overlapping_intervals():
    tr = synthetic_trace()
    assert tr.window_s == pytest.approx(100e-6)
    # union: [10, 35] and [55, 70] -> 40 us
    assert tr.busy_s() == pytest.approx(40e-6)
    # launched from inside "sort": [10, 35] and [55, 65] -> 35 us
    assert tr.busy_s("sort") == pytest.approx(35e-6)
    run = harness.Run("w", [], 1.0, 0.0, 0, trace=tr)
    assert metric("device.idle")(run) == pytest.approx(60.0)
    ops = dict((n, s) for n, s in tr.device_ops())
    assert ops["k_a"] == pytest.approx(30e-6)
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    # [0,10] and [35,40] in the first call's spans, [40,50] between calls,
    # [50,55] in the second call, [70,100] in aten::item (inside the call
    # until 95, outside it after)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert gaps["sort"] == pytest.approx(10e-6)
    assert gaps["bench.call: aten::item"] == pytest.approx(30e-6)


def test_roofline_shares_from_the_trace():
    tr = synthetic_trace()
    rec = record(1.0, rows=10, sort=[{"n": 10, "row_bytes": 16}])
    rec.traced = True
    run = harness.Run("w", [rec], 1.0, 0.0, 0, trace=tr)
    want = 100.0 * 320 / 3.35e12 / 35e-6
    assert metric("sort_roofline")(run) == pytest.approx(want)
    # nothing to read: no share at all, never 0
    assert metric("filter_roofline")(run) is None
    assert metric("query_roofline")(run) is None
    assert metric("sort_roofline")(
        harness.Run("w", [rec], 1.0, 0.0, 0)) is None


def test_host_waits_per_call():
    recs = [record(1.0, sort=[{}]), record(1.0, sort=[{}]),
            record(1.0, query=[{}])]
    recs[0].waits, recs[1].waits, recs[2].waits = 0, 1, 7
    run = harness.Run("w", recs, 1.0, 0.0, 0)
    assert metric("engine.host_waits")(run) == pytest.approx(0.5)
    assert metric("operators.host_waits")(run) == pytest.approx(7.0)
