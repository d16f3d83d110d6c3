"""The import guard, and what a run does without a card: no JAX and no
JAX package in the harness's process, none of the port in the references,
no result where the card or the port is missing."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import guard

REPO = Path(__file__).resolve().parent.parent


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(
        {"numpy", "simd_radix_sort_tpu_torch", "simd_radix_sort_tpu_torch.ops"}
    ) == []
    assert guard.forbidden_loaded(
        {"jax.numpy", "simd_radix_sort_tpu.ops.sort", "flax", "jaxlib.xla"}
    ) == ["flax", "jax", "jaxlib", "simd_radix_sort_tpu"]
    assert guard.forbidden_loaded({"jaxtyping", "simd_radix_sort_tpu2"}) == []


def run_py(code: str, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = """
import json, sys, time, torch
from benchmark import harness, guard
res, checks = harness.run_cell(
    "tpch_sf30_q12", 3, 0.3, True, torch.device("cpu"), time.perf_counter(),
    config_override={"orders": 1000, "lineitems": 4000, "scale_factor": 0.01},
    log=lambda m: None)
print(json.dumps({"correct": res["correct"],
                  "loaded": sorted({m.partition(".")[0] for m in sys.modules}),
                  "forbidden": guard.forbidden_loaded()}))
"""
    out = run_py(code)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "simd_radix_sort_tpu_torch" in got["loaded"]
    assert got["forbidden"] == []
    assert not {"jax", "simd_radix_sort_tpu"} & set(got["loaded"])


def test_the_references_import_nothing_of_the_port():
    code = """
import sys
from benchmark import harness
for name in ("sort_thesis", "tpch_sf30"):
    harness.load_file_module("reference", name)
print(sorted({m.partition(".")[0] for m in sys.modules}))
"""
    out = run_py(code)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"simd_radix_sort_tpu_torch", "simd_radix_sort_tpu",
                         "jax"}
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert "simd_radix_sort" not in path.read_text()


def test_no_card_no_result():
    out = run_py("import sys; from benchmark import run; sys.exit(run.main("
                 "['--workload', 'sort_u64_pay_1e8', '--seed', '1', "
                 "'--seconds', '1', '--trace', '0']))")
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run fails before it prints anything."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = """
import sys, time, torch
from benchmark import harness
harness.run_cell("sort_u64_pay_1e8", 1, 0.2, False, torch.device("cpu"),
                 time.perf_counter(), config_override={"rows_per_call": 100})
print("result")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "simd_radix_sort_tpu_torch" in out.stderr
    assert out.stdout == ""
