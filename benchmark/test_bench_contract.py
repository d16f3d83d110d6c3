"""BENCHMARK.json against the rules a benchmark file is held to: names,
units, sources, lengths, every file it names present, every per-layer
metric moving an end-to-end metric its cells report."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert all(line(w) for w in BENCH["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        for kind in ("configs", "reference"):
            assert (REPO / "benchmark" / kind / f"{c['name']}.py").is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and line(w["why"])
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names


def reports(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    cells = {w["name"] for w in BENCH["workloads"]}
    per_layer = m in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", cells)) <= cells
    assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()
    if "_roofline" in m["name"]:
        assert m["unit"] == "%"
    if per_layer:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        for cell in m.get("workloads", cells):
            assert m["moves"] in reports(cell), cell
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any("workloads" not in m or w["name"] in m["workloads"]
                   for m in BENCH["per_layer"])
