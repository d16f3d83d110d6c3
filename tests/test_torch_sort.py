"""The port's public sort API against the JAX package's, on the CPU.

The same NumPy datasets go through `simd_radix_sort_tpu.sort` (JAX, CPU
backend) and `simd_radix_sort_tpu_torch.sort(..., device="cpu")`.  Keys must
be byte-identical; payloads byte-identical under stable=True, and passing
the key-seeded payload oracle otherwise.  The counting engine runs its
card's control flow here, through the plain versions of its kernels.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

import simd_radix_sort_tpu as jsrs
import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu import methods as jmethods
from simd_radix_sort_tpu.utils import data as jdata
from simd_radix_sort_tpu_torch import methods as tmethods
from simd_radix_sort_tpu_torch.ops import counting, cuda_hist
from simd_radix_sort_tpu_torch.utils import data as tdata
from simd_radix_sort_tpu_torch.utils import interop

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
          np.int32, np.int64, np.float32, np.float64]
DISTS = ["UNIFORM", "ZERO", "GAUSSIAN", "ALMOST_SORTED"]
PAYLOAD_SETS = [(), (np.uint32,), (np.float64, np.int16)]
N = 4096


def _np(t):
    return interop.to_numpy(t)


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _as_tuple(out, npay):
    return (out,) if npay == 0 else tuple(out)


@pytest.mark.parametrize("payload_dtypes", PAYLOAD_SETS,
                         ids=lambda p: "-".join(np.dtype(d).name for d in p)
                         or "keys")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_matches_jax(dtype, payload_dtypes):
    rng = np.random.default_rng(0)
    for dist in DISTS:
        keys = tdata.make_keys(N, dtype, tdata.Distribution[dist], seed=3)
        assert _bytes_equal(keys, jdata.make_keys(
            N, dtype, jdata.Distribution[dist], seed=3))
        oracle_pays = tdata.make_payloads(keys, payload_dtypes)
        rand_pays = tuple(
            rng.integers(0, 256, N * np.dtype(d).itemsize, dtype=np.uint8)
            .view(d) for d in payload_dtypes)
        for asc in (True, False):
            # stable: every byte equal, payloads free of the key
            want = _as_tuple(jsrs.sort(keys, *rand_pays, ascending=asc,
                                       stable=True), len(payload_dtypes))
            got = _as_tuple(tsrs.sort(keys, *rand_pays, ascending=asc,
                                      stable=True, device="cpu"),
                            len(payload_dtypes))
            for g, w in zip(got, want):
                assert _bytes_equal(_np(g), w), (dist, asc)
            # default (unstable): keys equal, payloads pass the oracle
            got = _as_tuple(tsrs.sort(keys, *oracle_pays, ascending=asc,
                                      device="cpu"), len(payload_dtypes))
            want_k = _as_tuple(jsrs.sort(keys, *oracle_pays, ascending=asc),
                               len(payload_dtypes))[0]
            assert _bytes_equal(_np(got[0]), want_k), (dist, asc)
            assert tdata.check_data(_np(got[0]), [_np(p) for p in got[1:]],
                                    keys, asc) == "", (dist, asc)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16,
                                   np.uint32, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_count_engine_matches_jax(dtype):
    for dist in (tdata.Distribution.UNIFORM, tdata.Distribution.ZERO,
                 tdata.Distribution.ZERO_ONE, tdata.Distribution.GAUSSIAN):
        keys = tdata.make_keys(N, dtype, dist, seed=4)
        for asc in (True, False):
            got = tsrs.sort(keys, ascending=asc, method="count",
                            device="cpu")
            want = jsrs.sort(keys, ascending=asc, method="count")
            assert _bytes_equal(_np(got), want), (dist, asc)


def test_count_small_branch_at_2_21_matches_jax(monkeypatch):
    """n = 2^21 int16 keys with range < 1024 take the 1024-bucket branch
    (K3, then K1 with k = 1024 and K4) in both packages."""
    ks = []
    real = cuda_hist.histogram

    def spy(values, k, base=0):
        ks.append(k)
        return real(values, k, base)

    monkeypatch.setattr(cuda_hist, "histogram", spy)
    rng = np.random.default_rng(9)
    keys = rng.integers(-400, 400, 1 << 21).astype(np.int16)
    for asc in (True, False):
        assert tmethods.resolve("auto", keys.dtype, (), keys.size).name \
            == "count"
        got = tsrs.sort(keys, ascending=asc, device="cpu")
        want = jsrs.sort(keys, ascending=asc)
        assert _bytes_equal(_np(got), want)
    assert ks == [counting.K_MAX_RANGE] * 2


def test_count_wide_range_falls_back_to_comparison_sort(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_hist, "histogram",
                        lambda *a, **kw: calls.append(a))
    keys = tdata.make_keys(1 << 21, np.int32, tdata.Distribution.UNIFORM, 5)
    got = tsrs.sort(keys, method="count", device="cpu")
    assert _bytes_equal(_np(got), np.sort(keys))
    assert calls == []


def test_resolve_auto_matches_jax():
    for kdt in DTYPES:
        for pays in ((), (np.uint32,), (np.float64, np.uint8)):
            for n in (0, 4096, (1 << 17) - 1, 1 << 17, (1 << 21) - 1,
                      1 << 21, 10**8, None):
                want = jmethods.resolve("auto", kdt, pays, n).name
                assert tmethods.resolve("auto", kdt, pays, n).name == want, \
                    (kdt, pays, n)
    assert tmethods.COUNT_CROSSOVER_N_1BYTE == jmethods.COUNT_CROSSOVER_N_1BYTE
    assert tmethods.COUNT_MIN_N_ADAPTIVE == jmethods.COUNT_MIN_N_ADAPTIVE
    assert tmethods.COUNT_MIN_N_ADAPTIVE == counting.SMALL_MIN_N


@pytest.mark.parametrize("name", ["autotune"])
def test_unported_methods_raise(name, tmp_path, monkeypatch):
    """No JAX method is left unported: the last, autotune, now resolves on
    the CPU, and only a name neither package registers raises."""
    from simd_radix_sort_tpu_torch import autotune

    assert tmethods.NOT_YET_PORTED == ()
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "c.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    keys = np.arange(8, dtype=np.int32)[::-1].copy()
    out = tsrs.sort(keys, method=name, device="cpu")
    assert np.array_equal(_np(out), np.arange(8))
    with pytest.raises(ValueError, match="unknown sort method"):
        tsrs.sort(keys, method="no_such_method", device="cpu")


def test_explicit_methods_and_config():
    keys = tdata.make_keys(N, np.int16, tdata.Distribution.GAUSSIAN, 6)
    pays = tdata.make_payloads(keys, [np.uint64])
    want = jsrs.sort(keys, *pays, ascending=False, stable=True)
    for method in ("xla", "seq"):
        got = tsrs.sort(keys, *pays, ascending=False, stable=True,
                        method=method, device="cpu")
        assert all(_bytes_equal(_np(g), w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="does not support"):
        tsrs.sort(keys, *pays, method="count", device="cpu")
    jcfg = jsrs.SortConfig(ascending=False, method="count")
    cfg = interop.config_from_jax(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = tsrs.sort(keys, config=cfg, device="cpu")
    assert _bytes_equal(_np(got), jsrs.sort(keys, config=jcfg))
    k, ps = tsrs.sort_with_payloads(keys, pays, device="cpu")
    assert len(ps) == 1 and tdata.check_payloads(_np(k), [_np(ps[0])])


@pytest.mark.parametrize("key_dtype,payload_dtypes", [
    (np.uint8, ()), (np.int16, (np.uint8,)), (np.float32, (np.float64,)),
    (np.uint64, (np.uint64, np.int8)), (np.float64, (np.int32, np.uint16)),
    (np.int32, (np.uint8, np.uint8, np.uint8, np.uint8, np.uint16))])
def test_sort_packed_matches_jax(key_dtype, payload_dtypes):
    keys = tdata.make_keys(N, key_dtype, tdata.Distribution.GAUSSIAN, 7)
    rng = np.random.default_rng(7)
    rand = tuple(rng.integers(0, 256, N * np.dtype(d).itemsize,
                              dtype=np.uint8).view(d) for d in payload_dtypes)
    packed = tsrs.pack_rows(keys, rand)
    assert _bytes_equal(packed, jsrs.pack_rows(keys, rand))
    for asc in (True, False):
        want = np.asarray(jsrs.sort_packed(packed, key_dtype, ascending=asc,
                                           stable=True))
        got = _np(tsrs.sort_packed(packed, key_dtype, ascending=asc,
                                   stable=True, device="cpu"))
        assert _bytes_equal(got, want), asc
        k, ps = tsrs.unpack_rows(got, key_dtype, payload_dtypes)
        assert tdata.is_sorted(k, asc)
    # rows whose payloads are functions of the key are equal bytes under
    # any tie order, so the unstable sort matches byte for byte too
    packed = tsrs.pack_rows(keys, tdata.make_payloads(keys, payload_dtypes))
    assert _bytes_equal(_np(tsrs.sort_packed(packed, key_dtype,
                                             device="cpu")),
                        np.asarray(jsrs.sort_packed(packed, key_dtype)))


def test_sort_packed_empty_and_single():
    for key_dtype in (np.uint8, np.int32, np.float64):
        for n in (0, 1):
            keys = np.arange(n, dtype=key_dtype)
            for pays in ((), (keys.astype(np.int16),)):
                packed = tsrs.pack_rows(keys, pays)
                got = _np(tsrs.sort_packed(packed, key_dtype, device="cpu"))
                want = np.asarray(jsrs.sort_packed(packed, key_dtype))
                assert got.shape == want.shape
                assert _bytes_equal(got, want)


def test_sort_packed_count_engine():
    keys = tdata.make_keys(1 << 17, np.uint8, tdata.Distribution.UNIFORM, 8)
    packed = tsrs.pack_rows(keys, ())
    got = _np(tsrs.sort_packed(packed, np.uint8, device="cpu"))
    assert _bytes_equal(got, np.asarray(jsrs.sort_packed(packed, np.uint8)))
    with pytest.raises(ValueError):
        tsrs.sort_packed(tsrs.pack_rows(keys, (keys,)), np.uint8,
                         method="count", device="cpu")


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint64,
                                   np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_argsort_matches_jax(dtype):
    keys = tdata.make_keys(N, dtype, tdata.Distribution.GAUSSIAN, 9)
    for asc in (True, False):
        got = _np(tsrs.argsort(keys, ascending=asc, device="cpu"))
        want = np.asarray(jsrs.argsort(keys, ascending=asc))
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


def test_sort_multi_matches_jax():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 4, N).astype(np.int8)
    b = rng.normal(0, 1, N).round(1).astype(np.float64)
    c = rng.integers(0, 3, N).astype(np.uint64)
    pay = rng.integers(0, 2**31, N).astype(np.int32)
    for asc in (True, False, (True, False, True), (False, True, False)):
        want_cols, want_pays = jsrs.sort_multi((a, b, c), pay, ascending=asc,
                                               stable=True)
        got_cols, got_pays = tsrs.sort_multi((a, b, c), pay, ascending=asc,
                                             device="cpu")
        for g, w in zip(got_cols + got_pays, want_cols + want_pays):
            assert _bytes_equal(_np(g), w), asc
    with pytest.raises(ValueError):
        tsrs.sort_multi((), device="cpu")
    with pytest.raises(ValueError):
        tsrs.sort_multi((a, b), ascending=(True,), device="cpu")


def test_sort_batched_matches_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(-50, 50, (8, 512)).astype(np.int16)
    pay = rng.normal(0, 1, (8, 512)).astype(np.float32)
    for asc in (True, False):
        wk, wp = jsrs.sort_batched(keys, pay, ascending=asc, stable=True)
        gk, gp = tsrs.sort_batched(keys, pay, ascending=asc, stable=True,
                                   device="cpu")
        assert _bytes_equal(_np(gk), wk) and _bytes_equal(_np(gp), wp)
    assert _bytes_equal(_np(tsrs.sort_batched(keys, device="cpu")),
                        np.asarray(jsrs.sort_batched(jnp.asarray(keys))))
    with pytest.raises(ValueError):
        tsrs.sort_batched(keys[0], device="cpu")


def test_outputs_are_tensors_of_the_input_dtype():
    for dtype in DTYPES:
        keys = tdata.make_keys(64, dtype, tdata.Distribution.UNIFORM, 12)
        out = tsrs.sort(keys, device="cpu")
        assert out.device.type == "cpu"
        assert interop.to_numpy(out).dtype == np.dtype(dtype)
    assert tsrs.sort(np.zeros(0, np.int32), device="cpu").numel() == 0
