"""Autotune of the port, on the CPU: measured method selection with a
persistent cache of its own (mirrors tests/test_autotune.py), plus the two
repairs of the JAX module: a wrong engine never wins, and a failure other
than a candidate's own refusal is never swallowed."""

import json
import os

import numpy as np
import pytest
import torch

import simd_radix_sort_tpu as jsrs
import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu import autotune as jautotune
from simd_radix_sort_tpu_torch import autotune, methods as tmethods
from simd_radix_sort_tpu_torch.utils import interop


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(path))
    monkeypatch.setattr(autotune, "_cache", None)
    return path


def _patch(monkeypatch, name, run):
    m = tmethods.REGISTRY[name]
    monkeypatch.setitem(tmethods.REGISTRY, name,
                        tmethods.SortMethod(name, run, m.supports,
                                            m.has_threshold, m.device))


def test_pick_method_and_cache(cache):
    m = autotune.pick_method(np.uint32, (), n=4096, reps=1, device="cpu")
    assert m in autotune._CANDIDATES
    # second call hits the cache (and the file persisted)
    assert autotune.pick_method(np.uint32, (), n=4096, reps=1,
                                device="cpu") == m
    assert json.loads(cache.read_text()) == {
        autotune._key(np.uint32, (), 4096, "cpu"): m}


def test_sort_with_autotune_equals_jax_stable_sort(cache):
    # distinct keys: every correct sort equals the stable one byte for byte
    keys = np.random.default_rng(1).permutation(4096).astype(np.int32)
    pay = keys * np.int32(3) + np.int32(1)
    got = tsrs.sort(keys, pay, method="autotune", device="cpu")
    want = jsrs.sort(keys, pay, method="xla", stable=True)
    for g, w in zip(got, want):
        assert np.array_equal(interop.to_numpy(g).view(np.uint8),
                              np.asarray(w).view(np.uint8))
    assert len(json.loads(cache.read_text())) == 1


def test_cache_file_is_the_ports_own():
    assert os.path.basename(autotune._CACHE_PATH) != os.path.basename(
        jautotune._CACHE_PATH) or "SRS_TORCH_AUTOTUNE_CACHE" in os.environ
    if "SRS_TORCH_AUTOTUNE_CACHE" not in os.environ:
        assert autotune._CACHE_PATH.endswith(
            os.path.join(".cache", "srs_torch_autotune.json"))
    assert autotune._CANDIDATES == jautotune._CANDIDATES


@pytest.mark.parametrize("kdt,pdts,n", [
    (np.uint32, (), 4096), (np.uint64, (np.uint64, np.int8), 1 << 20),
    (np.float64, (np.float32,), 1), (np.int16, (), 3_000_000)])
def test_key_format_equals_jax_but_for_the_device_kind(kdt, pdts, n):
    mine = autotune._key(kdt, pdts, n, "cpu").split("|")
    theirs = jautotune._key(kdt, pdts, n).split("|")
    assert mine[:-1] == theirs[:-1]
    assert mine[-1] == "cpu"


def test_a_cpu_entry_never_answers_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(autotune, "device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3"
                        if dev.type == "cuda" else "cpu")
    card = autotune._key(np.uint32, (), 4096, "cuda")
    assert card.endswith("|NVIDIAH10080GBHBM3")
    assert card != autotune._key(np.uint32, (), 4096, "cpu")


def test_a_wrong_engine_never_wins(cache, monkeypatch):
    # the fastest candidate of all: it does not sort
    _patch(monkeypatch, "rank", lambda keys, payloads, **kw:
           (keys, tuple(payloads)))
    with pytest.warns(RuntimeWarning, match="'rank' skipped"):
        m = autotune.pick_method(np.uint32, (), n=1024, reps=1,
                                 device="cpu")
    assert m != "rank"
    assert "rank" not in json.loads(cache.read_text()).values()


def test_a_kernel_failure_is_not_swallowed(cache, monkeypatch):
    def broken(keys, payloads, **kw):
        raise RuntimeError("srs_histogram: an illegal memory access was "
                           "encountered (CUDA error 700)")

    _patch(monkeypatch, "count", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        autotune.pick_method(np.uint32, (), n=1024, reps=1, device="cpu")
    assert not cache.exists()


def test_a_candidates_own_refusal_skips_it(cache, monkeypatch):
    def refuses(keys, payloads, **kw):
        raise ValueError("quick: block_threshold out of range")

    _patch(monkeypatch, "quick", refuses)
    with pytest.warns(RuntimeWarning, match="'quick' skipped"):
        m = autotune.pick_method(np.uint64, (np.uint64,), n=1024, reps=1,
                                 device="cpu")
    assert m in ("xla", "radix", "rank")


def test_no_valid_candidate_raises(cache, monkeypatch):
    for name in autotune._CANDIDATES:
        _patch(monkeypatch, name, lambda keys, payloads, **kw:
               (keys.flip(0), tuple(payloads)))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(RuntimeError, match="no candidate"):
            autotune.pick_method(np.int32, (), n=1024, reps=1, device="cpu")
    assert not cache.exists()


def test_resolve_reads_the_device_only_for_autotune(cache, monkeypatch):
    m = tmethods.resolve("autotune", np.int32, (), 512, device="cpu")
    assert m.name in autotune._CANDIDATES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # other names never look at the device
    assert tmethods.resolve("xla", np.int32, (), 512).name == "xla"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmethods.resolve("autotune", np.int32, (), 512)


def test_sort_packed_with_autotune(cache):
    keys = np.random.default_rng(2).permutation(2048).astype(np.uint16)
    pay = np.arange(2048, dtype=np.uint32)
    packed = tsrs.pack_rows(keys, (pay,))
    got = interop.to_numpy(tsrs.sort_packed(packed, np.uint16,
                                            method="autotune", device="cpu"))
    want = np.asarray(jsrs.sort_packed(packed, np.uint16, method="xla",
                                       stable=True))
    assert np.array_equal(got, want)
