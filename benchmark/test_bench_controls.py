"""The comparison that decides `correct`, shown to fail: each cell's
control (controls.py) and the faults the timed path can have, planted in
the port underneath a whole run, at sizes a CPU can hold.  The program
itself comes out correct at the same sizes."""

import time

import pytest
import torch

from benchmark import controls, harness
from simd_radix_sort_tpu_torch.ops import filter as filt
from simd_radix_sort_tpu_torch.ops import hashagg, hashjoin
import simd_radix_sort_tpu_torch as srs
from simd_radix_sort_tpu_torch.ops.sort import sort as real_sort

CPU = torch.device("cpu")
TPCH = {"orders": 2000, "lineitems": 8000, "scale_factor": 0.01}
SIZES = {
    # 2^20 keys: enough that a 32-bit sort of 64-bit keys meets ties
    "sort_u64_pay_1e8": {"rows_per_call": 1 << 20},
    "sort_narrow_keys_1e8": {"rows_per_call": 4096},
    "tpch_sf30_q1_q6": TPCH,
    # order keys above 2^24, where float32 keys collide
    "tpch_sf30_q12": {"orders": 4_500_000, "lineitems": 18_000_000,
                      "scale_factor": 3},
}
CELLS = list(SIZES)
ALL_KEPT = {"check": {"share": 1.0, "max": 64}}


def run(cell, seed=2**31 + 7, ops=None, sizes=None, seconds=0.3):
    res, checks = harness.run_cell(
        cell, seed, seconds, False, CPU, time.perf_counter(),
        config_override=sizes or SIZES[cell], mix_override=ALL_KEPT,
        ops=ops, log=lambda m: None)
    return res, checks


@pytest.mark.parametrize("cell", [c for c in CELLS if c != "tpch_sf30_q12"]
                         + ["tpch_sf30_q12 small"])
def test_program_is_correct(cell):
    name, _, small = cell.partition(" ")
    res, checks = run(name, sizes=TPCH if small else None)
    assert res["correct"], checks
    assert res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _, cfg = harness.cell_of(harness.load_benchmark(), cell)
    res, checks = run(cell, ops=controls.CONTROLS[cfg["name"]])
    assert not res["correct"], checks
    assert any(c["value"] > c["limit"] for c in checks.values())


# --- faults planted in the port, underneath the timed path ---------------

def sort_unchanged(keys, *payloads, **kw):
    return (keys, *payloads) if payloads else keys


def sort_half(keys, *payloads, **kw):
    """Sorts the first half and leaves the rest where it was."""
    h = keys.shape[0] // 2
    out = real_sort(keys[:h], *(p[:h] for p in payloads), **kw)
    out = out if payloads else (out,)
    full = tuple(torch.cat([o, t[h:]]) for o, t in zip(out, (keys,
                                                             *payloads)))
    return full if payloads else full[0]


def sort_altered(keys, *payloads, **kw):
    out = real_sort(keys, *payloads, **kw)
    k = out[0] if payloads else out
    k = k.clone()
    k.view(torch.int8)[k.numel() * k.element_size() // 2] ^= 1
    return (k, *out[1:]) if payloads else k


real_filter = filt.filter_rows
real_aggregate = hashagg.group_aggregate
real_join = hashjoin.lookup_join


def filter_unchanged(mask, keys, *payloads):
    """Every row kept, as if the mask were all True."""
    return (torch.tensor(keys.shape[0], dtype=torch.int32), keys, *payloads)


def filter_half(mask, keys, *payloads):
    m = mask.clone()
    m[m.shape[0] // 2:] = False
    return real_filter(m, keys, *payloads)


def aggregate_altered(*args, **kw):
    ng, keys, results = real_aggregate(*args, **kw)
    first = results[0][0].clone()
    first[0] += 1
    return ng, keys, ((first,) + tuple(results[0][1:]),) + tuple(results[1:])


def join_altered(*args, **kw):
    found, counts, (prio,) = real_join(*args, **kw)
    prio = prio.clone()
    prio[0] = 4 - prio[0]  # an urgent order made low, and back
    return found, counts, (prio,)


SORT_FAULTS = {"unchanged": sort_unchanged, "half": sort_half,
               "altered": sort_altered}
TPCH_FAULTS = {"unchanged": (filt, "filter_rows", filter_unchanged),
               "half": (filt, "filter_rows", filter_half),
               "altered q1": (hashagg, "group_aggregate", aggregate_altered),
               "altered q12": (hashjoin, "lookup_join", join_altered)}


@pytest.mark.parametrize("fault", SORT_FAULTS)
@pytest.mark.parametrize("cell", ["sort_u64_pay_1e8", "sort_narrow_keys_1e8"])
def test_sort_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(srs, "sort", SORT_FAULTS[fault])
    res, checks = run(cell, sizes={"rows_per_call": 4096})
    assert not res["correct"], checks


@pytest.mark.parametrize("fault", TPCH_FAULTS)
def test_query_fault_is_not_correct(fault, monkeypatch):
    mod, name, fn = TPCH_FAULTS[fault]
    monkeypatch.setattr(mod, name, fn)
    cell = "tpch_sf30_q12" if fault.endswith("q12") else "tpch_sf30_q1_q6"
    res, checks = run(cell, sizes=TPCH)
    assert not res["correct"], checks
