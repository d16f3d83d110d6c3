"""The full-table ORDER BY on the card: `sort_multi` of 2^24 lineitem rows,
all 16 columns (made by the `tpch_sf30_lineitem` configuration's
generator), by l_shipdate, l_orderkey DESC, l_linenumber, against the plain
reference; its spans and counter in a profiled call; and the control, which
the comparison must find wrong.  Every test here skips where there is no
CUDA card.  On the card:

    python -m pytest tests/test_torch_tpch_orderby_card.py -q -p no:cacheprovider --noconftest
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import calls, harness, program_spans, trace
from simd_radix_sort_tpu_torch.utils import profiling

pytestmark = pytest.mark.card

N = 1 << 24
conf = harness.load_file_module("configs", "tpch_sf30_lineitem")
ref = harness.load_file_module("reference", "tpch_sf30_lineitem")
LIMITS = {"limits": {"keys_differing": 0, "rows_differing": 0}}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ORDER BY runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state(card):
    ctx = harness.Context(card)
    mix = {"calls": [{"op": "orderby", "params": {"copy": 0}}]}
    _, entry = harness.cell_of(harness.load_benchmark(), "tpch_sf30_orderby")
    base = json.loads((harness.REPO / entry["file"]).read_text())
    # 2^24 lines of 2^22 orders: SF 2.796, where 4.2.3's rules still hold
    cfg = dict(base, orders=1 << 22, lineitems=N, scale_factor=2.796)
    return conf.setup(cfg, mix, 2**33 + 11, ctx), ctx


def checked(st, ctx, out):
    rec = harness.Record(calls.Call(0, "orderby", {"copy": 0}),
                         answer=conf.capture(st, None, out))
    checks, wrong = conf.compare(st, [rec], ref, ctx, LIMITS)
    return (checks["keys_differing"]["value"],
            checks["rows_differing"]["value"], wrong)


def test_orderby_equals_the_reference(state):
    st, ctx = state
    out, facts = conf.orderby(st, {"copy": 0}, ctx)
    keys, pays = out
    assert all(c.device.type == "cuda" and c.shape == (N,)
               for c in keys + pays)
    assert facts["orderby"] == [{"n": N, "row_bytes": 84}]
    assert checked(st, ctx, out) == (0, 0, 0)


def test_control_is_not_correct(state):
    st, ctx = state
    out, _ = conf.CONTROL["orderby"](st, {"copy": 0}, ctx)
    bad_keys, bad_rows, wrong = checked(st, ctx, out)
    assert bad_keys > 0 and bad_rows > 0 and wrong == 1


def test_spans_and_counter_in_a_profiled_call(state):
    st, ctx = state
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            conf.orderby(st, {"copy": 0}, ctx)
            torch.cuda.synchronize()
    tr = trace.from_profiler(prof, ())
    (whole,) = program_spans.spans(tr, "srs.sort_multi")
    passes = sorted((e.start, e.end) for e in tr.ops
                    if e.name == "srs.sort_multi.keys")
    (gather,) = program_spans.spans(tr, "srs.sort_multi.gather")
    assert len(passes) == 3
    for s, e in passes + [gather]:
        assert whole[0] <= s and e <= whole[1]
    assert passes[-1][1] <= gather[0]
    for name in ("srs.sort_multi.keys", "srs.sort_multi.gather"):
        assert program_spans.busy_s(tr, name) > 0, name
    assert profiling.COUNTERS["sort_multi.gather_bytes"] == 364 * N
    assert profiling.COUNTERS["column_gather.groups"] == 4
    assert profiling.COUNTERS["column_gather.staged_bytes"] == 84 * N
    profiling.reset_counters()
