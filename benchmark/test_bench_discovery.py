"""A cell, a traffic mix and a metric added as new files are found by
their names in BENCHMARK.json, with no file that exists edited."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/traffic/q6_only.json").write_text(json.dumps(
        {"calls": [{"op": "q6", "shape": [], "params": {
            "year": {"int": [1993, 1997]}, "discount": 6,
            "quantity": 24}}], "check": {"share": 1.0}}))
    (tmp_path / "benchmark/metrics/queries_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    bench["workloads"].append({
        "name": "tpch_sf30_q6_only", "config": "tpch_sf30",
        "traffic": "q6_only", "chips": 1, "why": "Q6 alone"})
    bench["end_to_end"].append({
        "name": "queries_done", "unit": "queries", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["tpch_sf30_q6_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, time, torch
from benchmark import harness
res, checks = harness.run_cell(
    "tpch_sf30_q6_only", 5, 0.3, False, torch.device("cpu"),
    time.perf_counter(), log=lambda m: None,
    config_override={"orders": 1000, "lineitems": 4000, "scale_factor": 0.01})
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["queries_done"]["value"] == res["attempted"]
    # the metrics without a cell list, and the new one (no peak on the CPU)
    assert set(res["metrics"]) == {"setup_s", "queries_done"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
