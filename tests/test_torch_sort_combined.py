"""The combined layout through the port's `sort_packed`
(benchmark/configs/sort_thesis_combined.py) against the plain reference
(benchmark/reference/sort_thesis_combined.py), on the CPU at tiny sizes:
the operation's answers in both directions, on keys with and without ties,
the generator's byte layout and field rule, planted faults that the cell's
comparison must catch, the byte counts, and the cell run end to end."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calls, harness
from simd_radix_sort_tpu_torch.ops import sort as sort_ops

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CTX = harness.Context(CPU)
SEEDS = (5, 2**33 + 17)
NAME = "uint64.Uniform" + "+uint64" * 7
LIMITS = {"limits": {"keys_differing": 0, "rows_differing": 0}}
conf = harness.load_file_module("configs", "sort_thesis_combined")
ref = harness.load_file_module("reference", "sort_thesis_combined")
thesis = harness.load_file_module("configs", "sort_thesis")
work = harness.load_file_module("work", "packed")
CFG = harness.load_benchmark()
_, _entry = harness.cell_of(CFG, "sort_u64_pay7_1e8")
BASE = json.loads((REPO / _entry["file"]).read_text())


def mix(name=NAME, copies=1):
    return {"calls": [{"op": "sort_packed", "shape": ["ascending", "input"],
                       "params": {"input": name,
                                  "ascending": {"choice": [True, False]},
                                  "copy": {"int": [0, copies - 1]}}}]}


def state_of(n, seed, name=NAME, copies=1):
    return conf.setup(dict(BASE, rows_per_call=n), mix(name, copies), seed,
                      CTX)


def expected(rows: torch.Tensor, ascending: bool) -> np.ndarray:
    """The reference's sorted table, whole: fine at the tests' sizes."""
    keys = rows.view(torch.int64)[:, 0].numpy().view(np.uint64)
    ordered = ref.sort_keys(keys)
    cols = np.stack([ref.column(ordered, c) for c in range(8)], axis=1)
    return (cols if ascending else cols[::-1]).copy().view(np.uint8)


def checked(state, params, got, block=None, monkeypatch=None):
    """(keys differing, rows differing, answers wrong) of one answer, by
    the cell's own comparison (in blocks of `block` rows where given)."""
    if block is not None:
        monkeypatch.setattr(conf, "BLOCK", block)
    rec = harness.Record(calls.Call(0, "sort_packed", params), answer=got)
    checks, wrong = conf.compare(state, [rec], ref, CTX, LIMITS)
    return (checks["keys_differing"]["value"],
            checks["rows_differing"]["value"], wrong)


def answer(state, ascending, name=NAME, copy=0):
    params = {"input": name, "ascending": ascending, "copy": copy}
    out, facts = conf.sort_packed_op(state, params, CTX)
    return params, conf.capture(state, None, out), facts


@pytest.mark.parametrize("block", [None, 1000])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("n", [4096, 10_007])
@pytest.mark.parametrize("seed", SEEDS)
def test_sort_packed_equals_the_reference(seed, n, ascending, block,
                                          monkeypatch):
    state = state_of(n, seed)
    params, got, facts = answer(state, ascending)
    rows = state.tables[NAME, 0]
    assert got.shape == (n, 64) and got.dtype == np.uint8
    assert np.array_equal(got, expected(rows, ascending))
    assert checked(state, params, got, block, monkeypatch) == (0, 0, 0)
    assert facts == {"rows": n, "sort": [{"n": n, "row_bytes": 64}],
                     "packed": [{"n": n, "row_bytes": 64, "key_bytes": 8}]}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dist", ["ZeroOne", "Zero"])
def test_equal_keys_carry_equal_rows(dist, ascending):
    name = f"uint64.{dist}" + "+uint64" * 7
    state = state_of(10_007, SEEDS[1], name)
    params, got, _ = answer(state, ascending, name)
    rows = state.tables[name, 0]
    # every key ties with thousands of others; an unstable order still has
    # one answer, since a row is a function of its key
    assert len(np.unique(rows[:, :8].numpy(), axis=0)) <= 2
    assert np.array_equal(got, expected(rows, ascending))
    assert checked(state, params, got) == (0, 0, 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_follows_the_layout(seed):
    n = 4096
    state = state_of(n, seed, copies=2)
    for copy in (0, 1):
        rows = state.tables[NAME, copy]
        assert rows.dtype == torch.uint8 and rows.shape == (n, 64)
        keys = thesis.make_keys(torch.uint64, "Uniform", n,
                                calls.derive(seed, "keys", NAME, copy), CPU)
        fields = [thesis.payload(keys, j) for j in range(7)]
        # key bytes first, little-endian, then fields 0-6: pack_rows
        want = sort_ops.pack_rows(keys.view(torch.int64).numpy(),
                                  [f.view(torch.int64).numpy()
                                   for f in fields])
        assert np.array_equal(rows.numpy(), want)
        host = keys.view(torch.int64).numpy().view(np.uint64)
        for j in range(7):
            col = rows.numpy()[:, 8 + 8 * j:16 + 8 * j].copy()
            assert np.array_equal(col.view(np.uint64)[:, 0],
                                  ref.payload(host, j))
    assert not torch.equal(state.tables[NAME, 0], state.tables[NAME, 1])
    with pytest.raises(ValueError):
        state_of(16, seed, "uint32.Uniform" + "+uint64" * 7)
    with pytest.raises(ValueError):
        state_of(16, seed, "uint64.Uniform" + "+uint64" * 6)


def _fault(kind, state, got):
    """The answer with one fault planted."""
    rows = state.tables[NAME, 0].numpy()
    got = got.copy()
    if kind == "torn_row":  # two differing bytes of one field swapped
        i = len(got) // 3
        j = next(b for b in range(24, 31) if got[i, b] != got[i, b + 1])
        got[i, j], got[i, j + 1] = got[i, j + 1], got[i, j]
    elif kind == "fields_apart":  # keys sorted, the fields left in place
        got[:, 8:] = rows[:, 8:]
    elif kind == "descending":  # the other direction
        got = got[::-1].copy()
    elif kind == "dropped_row":
        got = np.delete(got, len(got) // 2, axis=0)
    return got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["torn_row", "fields_apart", "descending",
                                   "dropped_row"])
def test_planted_faults_are_caught(fault, seed, monkeypatch):
    n = 4096
    state = state_of(n, seed)
    params, got, _ = answer(state, True)
    # blocks of 1000 rows: the torn row lies in the second of five
    bad_keys, bad_rows, wrong = checked(state, params,
                                        _fault(fault, state, got), 1000,
                                        monkeypatch)
    assert bad_rows >= 1 and wrong == 1
    want_keys = {"torn_row": 0, "fields_apart": 0, "dropped_row": n}
    if fault in want_keys:
        assert bad_keys == want_keys[fault]
    else:
        assert bad_keys > n // 2
    if fault == "torn_row":
        assert bad_rows == 1
    if fault == "dropped_row":
        assert bad_rows == n


def test_control_is_not_correct():
    # 2^20 uniform 64-bit keys: ~128 pairs tie in their upper 32 bits
    n = 1 << 20
    state = state_of(n, SEEDS[0])
    params = {"input": NAME, "ascending": False, "copy": 0}
    out, _ = conf.CONTROL["sort_packed"](state, params, CTX)
    bad_keys, bad_rows, wrong = checked(state, params, out.numpy())
    assert bad_keys > 0 and bad_rows > 0 and wrong == 1


@pytest.mark.parametrize("n,esize,ksize,copied,want", [
    # key column 2nk, index 8n, the row gather 8n + 2ne
    (10, 64, 8, True, 1600),
    (1000, 64, 8, True, 160_000),
    (7, 24, 8, True, 7 * (16 + 8 + 8 + 48)),
    (9, 8, 8, False, 9 * 16),   # keys alone: the key column is a view
    (5, 6, 2, True, 5 * (4 + 8 + 8 + 12)),
    (0, 64, 8, True, 0),
])
def test_copy_bytes_by_hand(n, esize, ksize, copied, want):
    assert sort_ops.packed_copy_bytes(n, esize, ksize, copied) == want


@pytest.mark.parametrize("n,row_bytes,want", [(10, 64, 1280), (3, 24, 144),
                                              (10**8, 64, 12.8e9)])
def test_bytes_needed_by_hand(n, row_bytes, want):
    assert work.bytes_needed({"n": n, "row_bytes": row_bytes,
                              "key_bytes": 8}) == want


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(traced):
    n = 4099
    res, checks = harness.run_cell(
        "sort_u64_pay7_1e8", 2**33 + 5, 0.4, traced, CPU,
        time.perf_counter(), config_override={"rows_per_call": n},
        mix_override=dict(mix(copies=2), check={"share": 1.0, "max": 6}),
        log=lambda m: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert checks == {"keys_differing": {"value": 0, "limit": 0},
                      "rows_differing": {"value": 0, "limit": 0}}
    if traced:
        # no device events on the CPU: the counter alone has a reading
        got = res["metrics"]["kernels.packed_gb"]["value"]
        assert got == pytest.approx(160 * n / 1e9)
    else:
        assert set(res["metrics"]) >= {"rows_per_s", "p95_ms", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_payload_is_the_thesis_rule(seed):
    keys = np.random.default_rng(seed).integers(
        0, 2**64, 50_000, dtype=np.uint64, endpoint=False)
    keys[:3] = (0, 2**64 - 1, 2**63)
    thesis_ref = harness.load_file_module("reference", "sort_thesis")
    for j in range(7):
        want = thesis_ref.payload(keys, j)
        assert np.array_equal(ref.payload(keys, j), want)
        # and the generator's torch copy of the rule
        got = thesis.payload(torch.from_numpy(keys.view(np.int64))
                             .view(torch.uint64), j)
        assert np.array_equal(got.view(torch.int64).numpy().view(np.uint64),
                              want)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; from benchmark import harness; "
            "harness.load_file_module('reference', 'sort_thesis_combined'); "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"simd_radix_sort_tpu_torch", "simd_radix_sort_tpu",
                         "jax", "torch"}
