"""The port's profiling utilities on the CPU: a torch.profiler trace
exported where it is asked for, a Report that never puts a CPU time under a
device metric, and timing on the clock of the device asked for."""

import json
import os

import numpy as np
import pytest
import torch

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu.utils import profiling as jprofiling
from simd_radix_sort_tpu_torch.utils import profiling


def test_trace_exports_a_chrome_trace(tmp_path):
    keys = np.random.default_rng(0).integers(0, 1000, 4096, dtype=np.int32)
    with profiling.trace(str(tmp_path / "t"), device="cpu") as prof:
        tsrs.sort(keys, device="cpu")
    assert prof.events()
    path = tmp_path / "t" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("sort" in n for n in names)
    # no CUDA activity was asked for on the CPU
    assert not [e for e in events if e.get("cat") == "kernel"]


def test_measure_on_the_cpu_reports_no_roofline():
    keys = np.random.default_rng(1).permutation(8192).astype(np.int64)
    calls = []

    def fn(k):
        calls.append(1)
        return tsrs.sort(k, device="cpu")

    rep = profiling.measure(fn, keys, name="xla int64", reps=4,
                            device="cpu")
    assert len(calls) == 5  # one warm-up, 4 timed
    assert rep.rows == 8192 and rep.device == "cpu"
    assert rep.seconds > 0
    assert rep.rows_per_s == pytest.approx(rep.rows / rep.seconds)
    assert rep.ns_per_row == pytest.approx(rep.seconds / rep.rows * 1e9)
    assert rep.roofline_rows_per_s is None and rep.roofline_frac is None
    line = rep.line()
    assert line.startswith("xla int64 on cpu: ")
    assert line.endswith("roofline not measured (cpu)")
    assert "%" not in line


def test_report_fields_mirror_the_jax_report():
    import dataclasses

    mine = [f.name for f in dataclasses.fields(profiling.Report)]
    theirs = [f.name for f in dataclasses.fields(jprofiling.Report)]
    assert mine == theirs + ["device"]


def test_card_report_line_states_the_roofline():
    rep = profiling.Report("case (a)", 10**8, 0.018, 10**8 / 0.018, 0.18,
                           13.086e9, 10**8 / 0.018 / 13.086e9,
                           "NVIDIA H100 80GB HBM3")
    line = rep.line()
    assert line.startswith("case (a) on NVIDIA H100 80GB HBM3: 5555.6 Mrows/s")
    assert "42.5% of HBM roofline (13086 Mrows/s)" in line


def test_measure_rows_from_the_output_or_given():
    x = torch.arange(1000)
    rep = profiling.measure(lambda: (x[:300], x), device="cpu", reps=1)
    assert rep.rows == 300
    rep = profiling.measure(lambda: x, rows=77, device="cpu", reps=1)
    assert rep.rows == 77


def test_elapsed_seconds_on_the_cpu_runs_the_loop_once():
    calls = []
    s = profiling.elapsed_seconds(torch.device("cpu"),
                                  lambda: calls.append(1))
    assert s >= 0 and calls == [1]


def test_profiling_needs_a_card_unless_the_cpu_is_asked(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.measure(lambda: torch.zeros(1))
    assert not os.path.exists(tmp_path / "t")
