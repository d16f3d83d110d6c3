"""The port's perf harness against the JAX package's, on the CPU.

The parity is of the protocol, not of nanoseconds: the same reps and
warmups for every n, the same table file names, header rows and method
columns for the same cells, the same payload combinations, and a device
gate that catches what the JAX one catches.  The tests mirror
tests/test_perf.py with device="cpu".
"""

import numpy as np
import pytest
import torch

from simd_radix_sort_tpu import perf as jperf
from simd_radix_sort_tpu_torch import autotune, methods as tmethods
from simd_radix_sort_tpu_torch import perf as tperf
from simd_radix_sort_tpu_torch.utils import data as D
from simd_radix_sort_tpu_torch.utils import interop, profiling

KEY_DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
              np.int32, np.int64, np.float32, np.float64]


def test_protocol_constants_are_the_jax_packages():
    assert tperf.REPS_NUMERATOR == jperf.REPS_NUMERATOR
    assert tperf.WARMUP_NUMERATOR == jperf.WARMUP_NUMERATOR
    assert tperf.MIX64 == jperf.MIX64
    assert tperf.OUT_DIR.rstrip("/").split("/")[-1] != "bench_out"


@pytest.mark.parametrize("log2n", range(28))
def test_rep_counts_equal_the_jax_formula(log2n):
    n = 1 << log2n
    for num in (n, n + n // 3):
        want = (min(512, max(1, jperf.REPS_NUMERATOR // max(num, 1))),
                max(1, min(64, jperf.WARMUP_NUMERATOR // max(num, 1))))
        assert tperf.rep_counts(num) == want


def _counting(monkeypatch, name):
    """Wrap REGISTRY[name]'s run to count its calls."""
    m = tmethods.REGISTRY[name]
    calls = []

    def run(*a, **kw):
        calls.append(1)
        return m.run(*a, **kw)

    monkeypatch.setitem(tmethods.REGISTRY, name,
                        tmethods.SortMethod(name, run, m.supports,
                                            m.has_threshold, m.device))
    return calls


@pytest.mark.parametrize("name,num,want", [
    ("xla", 1 << 16, 4 + 512),   # 2^18/2^16 warmups, 512 reps (capped)
    ("xla", 1 << 20, 1 + 64),
    ("seq", 1 << 16, 1 + 3),     # host engines: at most 1 warmup, 3 reps
])
def test_measure_calls_the_engine_warmups_plus_reps_times(monkeypatch, name,
                                                          num, want):
    calls = _counting(monkeypatch, name)
    ns = tperf.measure_ns_per_element(name, num, np.int16, (), device="cpu",
                                      validate=False)
    assert ns > 0 and len(calls) == want


def test_measure_validates_and_returns_ns():
    ns = tperf.measure_ns_per_element("xla", 4096, np.int32, (np.uint8,),
                                      D.Distribution.UNIFORM, reps=2,
                                      warmups=1, device="cpu")
    assert ns > 0


def test_measure_host_method():
    ns = tperf.measure_ns_per_element("seq", 2048, np.float32, (),
                                      D.Distribution.GAUSSIAN, reps=2,
                                      warmups=1, device="cpu")
    assert ns > 0


@pytest.mark.parametrize("kdt,pdts", [
    (np.int32, (np.uint32,)), (np.uint64, (np.uint64,)),
    (np.float64, (np.int64,)), (np.int8, (np.float32, np.uint16)),
    (np.uint16, ())])
def test_measure_device_validate_mode(kdt, pdts):
    for method in ("xla", "radix", "quick"):
        ns = tperf.measure_ns_per_element(method, 4096, kdt, pdts,
                                          D.Distribution.GAUSSIAN, reps=2,
                                          warmups=1, validate="device",
                                          ascending=False, device="cpu")
        assert ns > 0


@pytest.mark.parametrize("kdt,pdt", [
    (np.int32, np.uint32), (np.uint64, np.uint64), (np.float64, np.int8),
    (np.uint8, np.float32), (np.int16, np.int64)])
def test_device_validate_catches_bad_output(kdt, pdt):
    keys = D.make_keys(512, kdt, D.Distribution.UNIFORM, 3)
    (pay,) = D.make_payloads(keys, (pdt,), "fast")
    order = np.argsort(D.transforms.to_sortable_np(keys), kind="stable")
    sk, sp = keys[order], pay[order]

    def gate(k, p):
        out = (interop.from_numpy(k, "cpu"), (interop.from_numpy(p, "cpu"),))
        return tperf._device_validate(out, keys, (pay,), True)

    assert gate(sk, sp) == ""
    assert "not sorted" in gate(keys, pay)
    # sorted keys, but two payload rows of different keys swapped
    i, j = 0, len(sk) - 1
    assert sk[i] != sk[j]
    swapped = sp.copy()
    swapped[[i, j]] = swapped[[j, i]]
    assert "fingerprint" in gate(sk, swapped)
    # one payload bit flipped
    flipped = sp.copy()
    flipped.view(np.uint8)[0] ^= 1
    assert "fingerprint" in gate(sk, flipped)
    # a key replaced by its neighbour: sorted, but the multiset changed
    dup = sk.copy()
    k = int(np.nonzero(sk[1:] != sk[:-1])[0][0])
    dup[k] = dup[k + 1]
    assert "fingerprint" in gate(dup, sp)


@pytest.mark.parametrize("validate", [True, "device"])
def test_wrong_output_raises(monkeypatch, validate):
    m = tmethods.REGISTRY["xla"]

    def unsorted(keys, payloads, **kw):
        return keys, tuple(payloads)

    monkeypatch.setitem(tmethods.REGISTRY, "xla",
                        tmethods.SortMethod("xla", unsorted, m.supports))
    with pytest.raises(tperf.WrongOutputError, match="wrong output"):
        tperf.measure_ns_per_element("xla", 1024, np.int32, (np.uint32,),
                                     reps=1, warmups=1, validate=validate,
                                     device="cpu")


def _entries():
    return {
        "measure_ns_per_element": lambda: tperf.measure_ns_per_element(
            "xla", 64, np.int32, ()),
        "perf_test": lambda: tperf.perf_test(["xla"], 64, np.int32, ()),
        "perf_test_num": lambda: tperf.perf_test_num(["xla"], np.int32, (),
                                                     max_num=64),
        "perf_test_block": lambda: tperf.perf_test_block(64, np.int32, ()),
        "perf_test_thresh": lambda: tperf.perf_test_thresh(64, np.int32, ()),
        "perf_test_speedup": lambda: tperf.perf_test_speedup("xla", "rank",
                                                             64),
        "perf_test_packed": lambda: tperf.perf_test_packed(64, np.int32, ()),
        "perf_test_combined": lambda: tperf.perf_test_combined(64, np.int32,
                                                               ()),
        "pick_method": lambda: autotune.pick_method(np.int32, (), 64,
                                                    refresh=True),
        "profiling.measure": lambda: profiling.measure(lambda: None),
        "profiling.trace": lambda: profiling.trace("unused").__enter__(),
    }


@pytest.mark.parametrize("entry", sorted(_entries()))
def test_entries_need_a_card_unless_the_cpu_is_asked(monkeypatch, tmp_path,
                                                     entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tperf, "OUT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entries()[entry]()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("kdt", KEY_DTYPES)
def test_payload_combo_for_factor_equals_jax(kdt):
    for factor in (1, 2, 4, 8):
        assert (tperf._payload_combo_for_factor(kdt, factor)
                == jperf._payload_combo_for_factor(kdt, factor))


def test_table_name_equals_jax():
    for kdt, pdts in ((np.uint8, ()), (np.float64, (np.uint64, np.int8)),
                      (np.int32, (np.float32,))):
        for dist in D.Distribution:
            jdist = type(jperf.D.Distribution.UNIFORM)(dist.value)
            assert (tperf.table_name(kdt, pdts, dist, 262144)
                    == jperf.table_name(kdt, pdts, jdist, 262144))


def _families():
    """(JAX call, port call) per table family at one 1024-row cell, each
    taking its perf module and the keyword arguments for it."""
    def dist(mod):
        return mod.D.Distribution.UNIFORM

    one = {"reps": 1, "warmups": 1}
    return {
        "perf_test": lambda mod, kw: mod.perf_test(
            ["xla", "count", "rank"], 1024, np.uint8, (), dist(mod),
            **one, **kw),
        "perf_test_gated": lambda mod, kw: mod.perf_test(
            ["xla", "count", "rank"], 1024, np.uint8, (np.uint8,),
            dist(mod), **one, **kw),
        "perf_test_num": lambda mod, kw: mod.perf_test_num(
            ["xla", "count", "rank", "auto"], np.int32, (), dist(mod),
            max_num=1024, min_num=256, **one, **kw),
        "perf_test_num_gated": lambda mod, kw: mod.perf_test_num(
            ["xla", "rank"], np.int32, (), dist(mod), max_num=8192,
            min_num=4096, **one, **kw),
        "perf_test_block": lambda mod, kw: mod.perf_test_block(
            1024, np.uint32, (np.uint32,), digits=(8, 16), **kw),
        "perf_test_thresh": lambda mod, kw: mod.perf_test_thresh(
            1024, np.uint64, (np.uint64,), thresholds=(256,), **kw),
        "perf_test_speedup": lambda mod, kw: mod.perf_test_speedup(
            "xla", "rank", 1024, key_dtypes=(np.uint32, np.float32),
            factors=(1, 2), **one, **kw),
        "perf_test_packed": lambda mod, kw: mod.perf_test_packed(
            1024, np.int32, (np.uint32,), methods=("xla", "radix", "count"),
            reps=1, **kw),
        "perf_test_packed_keys_only": lambda mod, kw: mod.perf_test_packed(
            1024, np.int16, (), methods=("xla", "count"), reps=1, **kw),
        "perf_test_combined": lambda mod, kw: mod.perf_test_combined(
            1024, np.int32, (np.uint32,), reps=1, **kw),
    }


@pytest.mark.parametrize("family", sorted(_families()))
def test_tables_equal_the_jax_packages(tmp_path, monkeypatch, family):
    """Both packages write the same cell: the same file name, header row
    and first column (methods, sizes, knob values or key types), and a
    positive number in every other cell."""
    call = _families()[family]
    tables = []
    for mod, kw in ((jperf, {}), (tperf, {"device": "cpu"})):
        out = tmp_path / mod.__name__.split(".")[0]
        monkeypatch.setattr(mod, "OUT_DIR", str(out))
        monkeypatch.setattr(mod, "REPS_NUMERATOR", 1024)
        path = call(mod, kw)
        assert path.startswith(str(out))
        with open(path) as f:
            tables.append((path[len(str(out)):],
                           f.read().strip().splitlines()))
    (jname, jlines), (tname, tlines) = tables
    assert tname == jname
    assert tlines[0] == jlines[0]
    assert [r.split()[0] for r in tlines] == [r.split()[0] for r in jlines]
    assert all(float(c) > 0 for r in tlines[1:] for c in r.split()[1:])


def test_time_pipelined_per_rep_fence():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    x = torch.zeros(8)
    for fence in (False, True):
        calls.clear()
        sec = tperf._time_pipelined(fn, [(x,)], 5, torch.device("cpu"),
                                    warmups=2, per_rep_fence=fence)
        assert sec > 0 and len(calls) == 7


def test_perf_test_packed_validates(tmp_path, monkeypatch):
    from simd_radix_sort_tpu_torch.ops import sort as sort_mod

    monkeypatch.setattr(tperf, "OUT_DIR", str(tmp_path))
    real = sort_mod.sort_packed

    def broken(p, key_dtype, **kw):
        return real(p, key_dtype, **kw).flip(0)

    monkeypatch.setattr(sort_mod, "sort_packed", broken)
    with pytest.raises(tperf.WrongOutputError, match="packed"):
        tperf.perf_test_packed(1024, np.int32, (np.uint32,),
                               methods=("xla",), reps=1, device="cpu")
