"""The port's measurement drivers against the JAX scripts, on the CPU.

`perf_suite`, `knob_epoch` and `remeasure_noise` must plan what
scripts/perf_suite.py, knob_epoch.py and remeasure_noise.py plan: the
same harness calls, in the same order, with the same arguments.  Each
side runs with its `perf_test*` functions replaced by recorders; the JAX
scripts run in a subprocess, since they set JAX's configuration when
imported.  Then each driver's smallest tier runs for real on the CPU, and
`run_test_matrix` runs a seeded sample of its cells and holds its cell
list to the JAX script's under the same capability gate.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simd_radix_sort_tpu_torch import methods as tmethods
from simd_radix_sort_tpu_torch import perf as tperf
from simd_radix_sort_tpu_torch.utils import data as D
from simd_radix_sort_tpu_torch.workloads import (
    campaign, knob_epoch, perf_suite, remeasure_noise, run_test_matrix)

REPO = Path(__file__).resolve().parent.parent

# Shared by both sides: replaces perf's table functions with recorders of
# (function, the arguments the caller passed), dtypes and distributions
# by name; each returns a path under perf.OUT_DIR as the real one does.
_RECORDER = r'''
import inspect, os
import numpy as np

TABLE_FUNCTIONS = ("perf_test", "perf_test_num", "perf_test_block",
                   "perf_test_thresh", "perf_test_speedup",
                   "perf_test_packed")


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if type(v).__name__ == "Distribution":
        return v.value
    if isinstance(v, np.dtype) or (isinstance(v, type)
                                   and issubclass(v, np.generic)):
        return np.dtype(v).name
    if type(v).__name__ == "device":
        return str(v)
    return v


def recorders(perf, log):
    out = {}
    for name in TABLE_FUNCTIONS:
        sig = inspect.signature(getattr(perf, name))

        def rec(*a, _name=name, _sig=sig, **kw):
            args = dict(_sig.bind(*a, **kw).arguments)
            args.update(args.pop("kw", {}))
            log.append([_name, {k: _norm(v) for k, v in args.items()}])
            return os.path.join(perf.OUT_DIR, f"{_name}-{len(log)}.dat")

        out[name] = rec
    return out
'''

_JAX_PLANS = r'''
import json, os, runpy, sys
repo, out_dir, jobs_path, result_path = sys.argv[1:5]
sys.path[:0] = [repo, os.path.join(repo, "scripts")]
os.chdir(repo)
exec(RECORDER)
from simd_radix_sort_tpu import perf
real = {name: getattr(perf, name) for name in TABLE_FUNCTIONS}
plans = {}
for key, script, argv, existing in json.load(open(jobs_path)):
    for name, fn in real.items():
        setattr(perf, name, fn)
    d = os.path.join(out_dir, key)
    os.makedirs(d)
    for name in existing:
        open(os.path.join(d, name), "w").close()
    perf.OUT_DIR = d
    log = []
    for name, fn in recorders(perf, log).items():
        setattr(perf, name, fn)
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join("scripts", script), run_name="__main__")
    except SystemExit:
        pass
    plans[key] = log
json.dump(plans, open(result_path, "w"))
'''

# tables a --resume run finds already written
_EXISTING = ["int32-Uniform-262144.dat", "tpe-int32-int32-Uniform.dat",
             "digits-int32-int32-Uniform-262144.dat",
             "thresh-quick-float-int64-Zero-262144.dat",
             "digits-int16-Uniform-262144.dat",
             "speedup-xla-vs-radix-Uniform-262144.dat",
             "quickstudy-int32-Gaussian-262144.dat",
             "int8-Sorted-262144.dat", "tpe-float-Sorted.dat",
             "tpe-anchor-int64-Uniform-100000000.dat",
             "packed-uint64-uint64-Uniform-60000000.dat"]

# (key, port driver, JAX script, argv, tables already written)
JOBS = [
    ("suite-default", perf_suite, "perf_suite.py", [], []),
    ("suite-full", perf_suite, "perf_suite.py", ["--full"], []),
    ("suite-full-2^22", perf_suite, "perf_suite.py",
     ["--full", "--n", "4194304"], []),
    ("suite-full-resume", perf_suite, "perf_suite.py",
     ["--full", "--resume"], _EXISTING),
    ("suite-int8", perf_suite, "perf_suite.py", ["--int8"], []),
    ("suite-tpe-breadth", perf_suite, "perf_suite.py", ["--tpe-breadth"], []),
    ("suite-packed", perf_suite, "perf_suite.py", ["--packed"], []),
    ("suite-rounds-resume", perf_suite, "perf_suite.py",
     ["--int8", "--tpe-breadth", "--packed", "--resume"], _EXISTING),
    ("knob-default", knob_epoch, "knob_epoch.py", [], []),
    ("knob-2^12-resume", knob_epoch, "knob_epoch.py",
     ["--n", "4096", "--resume"],
     ["thresh-quick-int8-int64-ZeroOne-4096.dat",
      "digits-int64-Uniform-4096.dat"]),
    ("noise", remeasure_noise, "remeasure_noise.py", [], []),
]


@pytest.fixture(scope="module")
def jax_plans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_plans")
    jobs = tmp / "jobs.json"
    jobs.write_text(json.dumps([[k, s, a, e] for k, _, s, a, e in JOBS]))
    result = tmp / "plans.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp / "jax_cache")}
    proc = subprocess.run(
        [sys.executable, "-c", f"RECORDER = {_RECORDER!r}\n" + _JAX_PLANS,
         str(REPO), str(tmp / "out"), str(jobs), str(result)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(result.read_text())


def _port_plan(monkeypatch, tmp_path, driver, argv, existing):
    ns = {}
    exec(_RECORDER, ns)
    log = []
    for name, fn in ns["recorders"](tperf, log).items():
        monkeypatch.setattr(tperf, name, fn)
    monkeypatch.setattr(tperf, "OUT_DIR", str(tmp_path))
    for name in existing:
        (tmp_path / name).touch()
    assert driver.main(argv + ["--device", "cpu"]) == 0
    return log


@pytest.mark.parametrize("key,driver,script,argv,existing", JOBS,
                         ids=[j[0] for j in JOBS])
def test_plan_equals_the_jax_scripts(jax_plans, monkeypatch, tmp_path, key,
                                     driver, script, argv, existing):
    got = _port_plan(monkeypatch, tmp_path, driver, argv, existing)
    want = jax_plans[key]
    assert want, f"the JAX {script} planned nothing"
    # every harness call is told the device the driver was given
    assert all(args.pop("device") == "cpu" for _, args in got)
    assert got == want


def _table(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [ln.split() for ln in lines[1:]]


def _supported(meths, kdt, pdts, n):
    return [m for m in meths if m not in tmethods.REGISTRY
            or tmethods.REGISTRY[m].supports(
                np.dtype(kdt), tuple(np.dtype(p) for p in pdts), n)]


@pytest.fixture
def small_protocol(monkeypatch, tmp_path):
    """One rep a cell (test_torch_perf.py's patch), tables into tmp_path."""
    monkeypatch.setattr(tperf, "REPS_NUMERATOR", 1024)
    monkeypatch.setattr(tperf, "OUT_DIR", str(tmp_path))
    return tmp_path


def test_perf_suite_default_tier_runs_on_cpu(small_protocol, capsys):
    n = 1024
    assert perf_suite.main(["--n", str(n), "--device", "cpu"]) == 0
    out = small_protocol
    for k, ps in perf_suite.TYPE_COMBOS[:4]:
        for dist in perf_suite.DISTS[:2]:
            head, rows = _table(out / tperf.table_name(k, ps, dist, n))
            assert head == "sort_method nanoseconds_per_element"
            assert [r[0] for r in rows] == _supported(perf_suite.METHODS, k,
                                                      ps, n)
            assert all(float(r[1]) > 0 for r in rows)
    head, rows = _table(out / "int32-int32-Uniform-4096.dat")
    assert [r[0] for r in rows] == _supported(perf_suite.METHODS + ["rank"],
                                              np.int32, (np.int32,), 4096)
    head, rows = _table(out / "tpe-int32-int32-Uniform.dat")
    assert head.split() == ["number_of_elements"] + _supported(
        perf_suite.METHODS, np.int32, (np.int32,), 1 << 18)
    assert [int(r[0]) for r in rows] == [1 << i for i in range(19)]
    for name, header, knobs in (
            ("digits-int32-int32-Uniform-1024.dat",
             "digitBits nanoseconds_per_element", ["4", "8", "16", "32"]),
            ("thresh-quick-int32-int32-Uniform-1024.dat",
             "cmpThresh nanoseconds_per_element",
             ["128", "256", "512", "1024", "2048", "4096"])):
        head, rows = _table(out / name)
        assert head == header and [r[0] for r in rows] == knobs
    head, rows = _table(out / "speedup-xla-vs-radix-Uniform-1024.dat")
    assert head == "key_type factor1 factor2 factor4 factor8"
    assert [r[0] for r in rows] == ["uint32", "int32", "float"]
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 13 and all(p.startswith("wrote ")
                                      for p in printed)
    # --resume writes nothing again
    assert perf_suite.main(["--n", str(n), "--resume", "--device",
                            "cpu"]) == 0
    assert all(p.startswith("skip ")
               for p in capsys.readouterr().out.splitlines())


def test_knob_epoch_runs_on_cpu(small_protocol, capsys):
    n = 256
    assert knob_epoch.main(["--n", str(n), "--device", "cpu"]) == 0
    names = sorted(os.listdir(small_protocol))
    assert len([x for x in names if x.startswith("thresh-quick-")]) == 48
    assert len([x for x in names if x.startswith("digits-")]) == 12
    head, rows = _table(small_protocol
                        / "thresh-quick-int8-int64-Zero-256.dat")
    assert head == "cmpThresh nanoseconds_per_element" and len(rows) == 6
    head, rows = _table(small_protocol / "digits-float-int64-Uniform-256.dat")
    assert head == "digitBits nanoseconds_per_element" and len(rows) == 4
    assert "0 failures" in capsys.readouterr().out


def test_knob_epoch_reports_a_failed_table_and_exits_1(small_protocol,
                                                       monkeypatch, capsys):
    real = tperf.perf_test_block

    def block(num, k, ps, **kw):
        if np.dtype(k) == np.int16:
            raise RuntimeError("injected")
        return real(num, k, ps, **kw)

    monkeypatch.setattr(tperf, "perf_test_block", block)
    assert knob_epoch.main(["--n", "128", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAILED digits-int16-int64-Uniform-128.dat" in out
    assert "RuntimeError: injected" in out and "2 failures" in out
    # the epoch went on past the failures
    assert (small_protocol / "digits-int64-Uniform-128.dat").exists()


def test_remeasure_noise_runs_on_cpu(small_protocol):
    assert remeasure_noise.main(["--device", "cpu"]) == 0
    for k, ps, dist, n, meths in (
            (np.int32, (np.int32,), D.Distribution.SORTED, 1 << 18,
             remeasure_noise.METHODS),
            (np.uint64, (), D.Distribution.SORTED, 1 << 18,
             remeasure_noise.METHODS),
            (np.int32, (np.int32,), D.Distribution.UNIFORM, 4096,
             remeasure_noise.METHODS + ["rank"]),
            (np.uint64, (np.uint64,), D.Distribution.UNIFORM, 4096,
             remeasure_noise.METHODS + ["rank"])):
        head, rows = _table(small_protocol / tperf.table_name(k, ps, dist, n))
        assert head == "sort_method nanoseconds_per_element"
        assert [r[0] for r in rows] == _supported(meths, k, ps, n)


def test_large_n_sweep_joins_its_two_gates(small_protocol):
    out = campaign.large_n_sweep(np.uint8, D.Distribution.UNIFORM, "cpu",
                                 min_num=1 << 8, device_gate=1 << 10,
                                 max_num=1 << 11)
    assert Path(out).name == "tpe-uint8-Uniform.dat"
    head, rows = _table(out)
    assert head == "number_of_elements xla count"
    assert [int(r[0]) for r in rows] == [256, 512, 1024, 2048]
    assert os.listdir(small_protocol) == ["tpe-uint8-Uniform.dat"]


def test_interleaved_takes_columns_in_turns(monkeypatch):
    monkeypatch.setattr(campaign, "ROUNDS", 3)
    monkeypatch.setattr(tperf, "REPS_NUMERATOR", 128)
    monkeypatch.setattr(tperf, "WARMUP_NUMERATOR", 64)
    calls = []
    cols = {name: (lambda k, p, name=name: calls.append(name))
            for name in ("a", "b", "c")}
    times, _ = campaign.interleaved(cols, [(None, ())], 64,
                                    torch.device("cpu"))
    assert calls == (["a", "b", "c"] + ["a"] * 2 + ["b"] * 2 + ["c"] * 2
                     + ["c"] * 2 + ["b"] * 2 + ["a"] * 2
                     + ["a"] * 2 + ["b"] * 2 + ["c"] * 2)
    assert {k: len(v) for k, v in times.items()} == {"a": 3, "b": 3, "c": 3}


def test_tables_at_one_size_on_cpu(small_protocol):
    assert campaign.main(["--tables", "uint16", "--n", "512",
                          "--device", "cpu"]) == 0
    for dist in D.ALL_DISTRIBUTIONS:
        head, rows = _table(small_protocol / tperf.table_name(
            np.uint16, (), dist, 512))
        assert head == "sort_method nanoseconds_per_element"
        assert [r[0] for r in rows] == campaign.DEVICE_METHODS
        assert all(float(r[1]) > 0 for r in rows)


def test_gate_part_runs_on_cpu(small_protocol, monkeypatch):
    monkeypatch.setattr(campaign, "LARGE_N_MIN", 1 << 9)
    monkeypatch.setattr(campaign, "LARGE_N_MAX", 1 << 10)
    monkeypatch.setattr(campaign, "GATE_SPAN_NS", (1 << 10,))
    from simd_radix_sort_tpu_torch.ops import counting
    gate = counting.SMALL_MIN_N
    for type_name in ("int16", "uint32"):
        assert campaign.main(["--gate", type_name, "--device", "cpu"]) == 0
    assert counting.SMALL_MIN_N == gate
    names = sorted(os.listdir(small_protocol / "large_n"))
    shapes = [*campaign.GATE_SHAPES,
              *(f"Span{s}" for s in campaign.GATE_SPANS)]
    assert names == sorted(f"gate-{t}-{s}.dat" for t in ("int16", "uint32")
                           for s in shapes)
    head, rows = _table(small_protocol / "large_n" / "gate-int16-Zipf.dat")
    assert head == "number_of_elements branch fallback xla"
    assert [int(r[0]) for r in rows] == [512, 1024]
    head, rows = _table(small_protocol / "large_n" / "gate-uint32-Span16.dat")
    assert [int(r[0]) for r in rows] == [1024]
    # a second run finds its tables and skips them
    before = {n: (small_protocol / "large_n" / n).stat().st_mtime
              for n in names}
    assert campaign.main(["--gate", "int16", "--device", "cpu"]) == 0
    assert before == {n: (small_protocol / "large_n" / n).stat().st_mtime
                      for n in names}


@pytest.mark.parametrize("shape", ["Uniform", "Zipf", "OneValue", "Span16",
                                   "Span1023"])
def test_gate_values_take_the_branch(shape):
    from simd_radix_sort_tpu_torch.ops import counting
    for unsigned in (False, True):
        v = campaign.gate_values(shape, unsigned, 1 << 12, 3)
        span = int(v.max()) - int(v.min())
        assert counting.K_TINY_RANGE <= span < counting.K_MAX_RANGE
        assert not unsigned or v.min() >= 0
    if shape.startswith("Span"):
        assert span == int(shape[4:])


def test_quick_grid_runs_on_cpu(small_protocol, monkeypatch):
    from simd_radix_sort_tpu_torch.ops import quick_sort
    monkeypatch.setattr(campaign, "QUICK_GRID", {
        "max_buckets": (4, 16), "oversample": (16,), "block": (256, 1024),
        "target_divisor": (8, 4)})
    monkeypatch.setattr(campaign, "QUICK_NS", (1 << 10, 1 << 12))
    monkeypatch.setattr(campaign, "QUICK_STABLE_NS", (1 << 12,))
    monkeypatch.setattr(campaign, "QUICK_LOOP_ROWS", 1 << 12)
    saved = (quick_sort.MAX_BUCKETS, quick_sort.OVERSAMPLE,
             quick_sort.BLOCK, quick_sort.SEGMENT_TARGET)
    assert campaign.main(["--quick-grid", "--device", "cpu"]) == 0
    assert saved == (quick_sort.MAX_BUCKETS, quick_sort.OVERSAMPLE,
                     quick_sort.BLOCK, quick_sort.SEGMENT_TARGET)
    head, rows = _table(small_protocol / "quick_grid" / "grid.dat")
    assert head == campaign.QUICK_HEADER
    points = campaign.quick_points()
    assert len(points) == 8
    # 4 workloads x (2 sizes + stable at one)
    assert len(rows) == len(points) * 12
    assert {tuple(map(int, r[:4])) for r in rows} == set(points)
    assert {r[4] for r in rows} == {"uint64-uint64-Uniform", "int32-Uniform",
                                    "double-Gaussian", "int32-Zipf"}
    assert {r[8] for r in rows} <= set(quick_sort.PATHS)
    assert {r[8] for r in rows} >= {"one_sort", "blocked"}
    assert all(float(r[7]) > 0 for r in rows)


def test_campaign_parts_name_real_driver_options():
    for cmds in campaign.PARTS.values():
        for argv in cmds:
            mod = {"perf_suite": perf_suite, "knob_epoch": knob_epoch,
                   "remeasure_noise": remeasure_noise,
                   "campaign": campaign}[argv[0]]
            assert callable(mod.main)
            for flag in (a for a in argv[1:] if a.startswith("--")):
                assert flag in Path(mod.__file__).read_text(), (argv, flag)
    sweeps = [a[2] for a in campaign.PARTS["d"]]
    assert sweeps == ["uint8-Uniform", "int32-Uniform", "int32-Zero",
                      "int32-ZeroOne", "uint8-Zero", "uint8-Sorted",
                      "uint8-ReverseSorted", "int8-Uniform"]


@pytest.mark.parametrize("driver,argv", [
    (perf_suite, []), (knob_epoch, []), (remeasure_noise, []),
    (run_test_matrix, ["1"]), (campaign, ["--parts", "c"])],
    ids=["perf_suite", "knob_epoch", "remeasure_noise", "run_test_matrix",
         "campaign"])
def test_drivers_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path,
                                                 driver, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tperf, "OUT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv + (["--out", str(tmp_path)]
                            if driver is campaign else []))
    assert os.listdir(tmp_path) == []


# ---- run_test_matrix ------------------------------------------------------

_JAX_MATRIX = r'''
import json, os, sys
repo, result_path = sys.argv[1:3]
sys.path.insert(0, repo)
os.chdir(repo)
from simd_radix_sort_tpu.utils import native
native._sources_mtime = lambda: 0.0  # the committed library; never make
sys.path.insert(0, os.path.join(repo, "scripts"))
import run_test_matrix as rtm
assert native.available()
cells = []

def run_cell(method, combined, up, kdt, pdts, dist, num, seed):
    m = rtm.methods.REGISTRY[method]
    if not m.supports(rtm.np.dtype(kdt),
                      tuple(rtm.np.dtype(p) for p in pdts), num):
        return None
    cells.append([method, combined, up, rtm.np.dtype(kdt).name,
                  [rtm.np.dtype(p).name for p in pdts], dist.value, num])
    return True

rtm.run_cell = run_cell
sys.argv = ["run_test_matrix.py", "100"]
try:
    rtm.main()
except SystemExit as e:
    assert e.code == 0
json.dump(cells, open(result_path, "w"))
'''


def _port_cells(max_num):
    return [[m, c, up, np.dtype(k).name, [np.dtype(p).name for p in ps],
             dist.value, n]
            for m, c, up, k, ps, dist, n in run_test_matrix.cells(max_num)
            if run_test_matrix.supported(m, k, ps, n)]


def test_matrix_cells_equal_the_jax_scripts(tmp_path):
    result = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MATRIX, str(REPO), str(result)],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(result.read_text())
    got = _port_cells(100)
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("method", run_test_matrix.METHODS)
def test_matrix_sample_passes_on_cpu(method, capsys):
    pool = [c for c in run_test_matrix.cells(100) if c[0] == method
            and run_test_matrix.supported(c[0], c[3], c[4], c[6])]
    rng = np.random.default_rng(run_test_matrix.METHODS.index(method))
    picks = rng.choice(len(pool), size=min(34, len(pool)), replace=False)
    for i in sorted(picks):
        assert run_test_matrix.run_cell(*pool[i], 7, "cpu") is True, pool[i]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(picks)
    assert all(ln.startswith(f"passed  {method:6s} ") for ln in lines)


def test_matrix_main_reports_failures_the_reference_way(monkeypatch, capsys):
    U, Z = D.Distribution.UNIFORM, D.Distribution.ZERO_ONE
    few = [("xla", False, True, np.uint8, (), U, 10),
           ("xla", True, False, np.float64, (np.uint64,), Z, 10),
           ("count", False, True, np.uint8, (), Z, 10),
           ("count", False, False, np.int16, (), U, 1),
           ("count", False, True, np.float64, (), U, 10)]  # gated out
    monkeypatch.setattr(run_test_matrix, "cells", lambda max_num: few)
    assert run_test_matrix.main(["10", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "ALL PASSED" and len(out) == 5

    def broken(keys, payloads, **kw):
        raise RuntimeError("engine broke")

    m = tmethods.REGISTRY["xla"]
    monkeypatch.setitem(tmethods.REGISTRY, "xla", tmethods.SortMethod(
        "xla", broken, m.supports, m.has_threshold, m.device))
    assert run_test_matrix.main(["10", "3", "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SOME FAILED"
    assert any(ln.startswith("FAILED  xla ") and "exception: engine broke"
               in ln for ln in out)
    assert any(ln.startswith("passed  count ") for ln in out)
