"""The combined layout on the card: `sort_packed` of 2^24 64-byte rows
(a uint64 key and seven uint64 fields, made by the `sort_thesis_combined`
configuration's generator) against the plain reference in both
directions, its two spans and counter in a profiled call, and its one
K9 launch a call, in 16-byte vectors.  Every test here skips where there
is no CUDA card.  On the card:

    python -m pytest tests/test_torch_sort_combined_card.py -q -p no:cacheprovider --noconftest
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_radix_sort_tpu_torch as tsrs
from benchmark import calls, harness, program_spans, trace
from simd_radix_sort_tpu_torch.ops import cuda_rows
from simd_radix_sort_tpu_torch.utils import profiling

pytestmark = pytest.mark.card

N = 1 << 24
NAME = "uint64.Uniform" + "+uint64" * 7
conf = harness.load_file_module("configs", "sort_thesis_combined")
ref = harness.load_file_module("reference", "sort_thesis_combined")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sort runs cub's pair sort")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state(card):
    ctx = harness.Context(card)
    mix = {"calls": [{"op": "sort_packed",
                      "params": {"input": NAME, "copy": 0}}]}
    cfg = harness.load_benchmark()
    _, entry = harness.cell_of(cfg, "sort_u64_pay7_1e8")
    base = json.loads((harness.REPO / entry["file"]).read_text())
    return conf.setup(dict(base, rows_per_call=N), mix, 2**33 + 11, ctx), ctx


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_packed_equals_the_reference(state, ascending):
    st, ctx = state
    params = {"input": NAME, "ascending": ascending, "copy": 0}
    out, _ = conf.sort_packed_op(st, params, ctx)
    assert out.device.type == "cuda" and out.shape == (N, 64)
    rec = harness.Record(calls.Call(0, "sort_packed", params),
                         answer=conf.capture(st, None, out))
    checks, wrong = conf.compare(st, [rec], ref, ctx,
                                 {"limits": {"keys_differing": 0,
                                             "rows_differing": 0}})
    assert checks["keys_differing"]["value"] == 0
    assert checks["rows_differing"]["value"] == 0 and wrong == 0


def test_spans_and_counter_in_a_profiled_call(state):
    st, _ = state
    rows = st.tables[NAME, 0]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            out = tsrs.sort_packed(rows, np.uint64, ascending=False)
            torch.cuda.synchronize()
    tr = trace.from_profiler(prof, ())
    for name in ("srs.packed.keys", "srs.xla.pairs", "srs.packed.rows"):
        assert len(program_spans.spans(tr, name)) == 1, name
        assert program_spans.busy_s(tr, name) > 0, name
    (keys,), (rows_span,) = (program_spans.spans(tr, n) for n in (
        "srs.packed.keys", "srs.packed.rows"))
    (pairs,) = program_spans.spans(tr, "srs.xla.pairs")
    assert keys[1] <= pairs[0] and pairs[1] <= rows_span[0]
    assert profiling.COUNTERS["packed.copy_bytes"] == 160 * N
    profiling.reset_counters()
    assert out.shape == rows.shape


def test_one_row_gather_a_call(state):
    st, _ = state
    rows = st.tables[NAME, 0]
    cuda_rows.reset_launches()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [tsrs.sort_packed(rows, np.uint64, ascending=asc)
                for asc in (True, False)]
        torch.cuda.synchronize()
    assert cuda_rows.LAUNCHES["row_gather"] == 2
    assert profiling.COUNTERS["row_gather.calls"] == 2
    assert profiling.COUNTERS["row_gather.narrow_calls"] == 0
    assert profiling.COUNTERS["packed.copy_bytes"] == 2 * 160 * N
    profiling.reset_counters()
    # the two directions are each other's rows reversed: equal keys carry
    # equal rows, so the order of ties does not show
    assert torch.equal(outs[0], outs[1].flip(0))
