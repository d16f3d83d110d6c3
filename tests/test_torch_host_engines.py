"""The port's host engines against the JAX package's: the reference-exact
RNG copy (utils/cpp_rng.py), the "cpp" payload protocol
(utils/data.py), the native harness bindings (utils/native.py) and the
"torch" and "cpp" sort methods.

What must match: every RNG draw and every generated key, payload and
permutation bit for bit (no tolerance: all are integers); the two host
sort methods equal "seq" byte for byte, keys and payloads, since the
payloads are functions of the keys (any correct sort gives the same bytes).
The port builds the native library itself, into build/srs_torch/, and
never writes native/.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu_torch.ops import _build
from simd_radix_sort_tpu_torch.utils import common, cpp_rng, data as D
from simd_radix_sort_tpu_torch.utils import interop, native

from test_cpp_rng import GLIBC_GOLDEN, MT_GOLDEN

COMMITTED_LIB = Path(__file__).resolve().parent.parent / "native" / \
    "libsrsharness.so"


def _jax_native(monkeypatch):
    """The JAX package's bindings on the committed library: its loader
    would run `make` in native/ when the sources look newer."""
    from simd_radix_sort_tpu.utils import native as jnative

    monkeypatch.setattr(jnative, "_sources_mtime", lambda: 0.0)
    return jnative


def test_glibc_rand_goldens():
    seeds = np.array(sorted(GLIBC_GOLDEN), dtype=np.uint32)
    got = cpp_rng.glibc_rand_stream(seeds, 8)
    for row, s in zip(got, sorted(GLIBC_GOLDEN)):
        assert row.tolist() == GLIBC_GOLDEN[s], s


@pytest.mark.parametrize("seed", sorted(MT_GOLDEN))
def test_mt19937_goldens(seed):
    assert cpp_rng.Mt19937(seed).draw(6).tolist() == MT_GOLDEN[seed]


def test_mt19937_10000th():
    g = cpp_rng.Mt19937(5489)
    g.draw(9999)
    assert g.next() == 4123659995


def test_rng_streams_equal_the_jax_copy():
    from simd_radix_sort_tpu.utils import cpp_rng as jrng

    seeds = np.random.default_rng(5).integers(0, 2**32, 500,
                                              dtype=np.uint32)
    seeds[:2] = (0, 2**32 - 1)
    assert np.array_equal(cpp_rng.glibc_rand_stream(seeds, 24),
                          jrng.glibc_rand_stream(seeds, 24))
    assert np.array_equal(cpp_rng.glibc_rand_bytes(seeds, 13),
                          jrng.glibc_rand_bytes(seeds, 13))
    for seed in (0, 1, 2**31 + 7, 4242):
        a, b = cpp_rng.Mt19937(seed), jrng.Mt19937(seed)
        for k in (1, 623, 700, 1250):  # across the twist boundaries
            assert np.array_equal(a.draw(k), b.draw(k))


@pytest.mark.parametrize("kdt", common.KEY_DTYPES, ids=str)
def test_cpp_payload_protocol_equals_jax(kdt):
    from simd_radix_sort_tpu.utils import data as jD

    keys = D.make_keys(2000, kdt, D.Distribution.UNIFORM, seed=12)
    pdts = (np.uint8, np.float64, np.int16, np.uint32)
    got = D.make_payloads(keys, pdts, "cpp")
    want = jD.make_payloads(keys, pdts, "cpp")
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert D.check_payloads(keys, got, "cpp")
    assert not D.check_payloads(keys[::-1].copy(), got, "cpp")
    k, p = D.make_dataset(500, kdt, pdts, D.Distribution.GAUSSIAN, 3, "cpp")
    jk, jp = jD.make_dataset(500, kdt, pdts, jD.Distribution.GAUSSIAN, 3,
                             "cpp")
    assert np.array_equal(k.view(np.uint8), jk.view(np.uint8))
    assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
               for a, b in zip(p, jp))
    ks, *ps = tsrs.sort_np(k, *p)
    assert D.check_data(ks, ps, k, protocol="cpp") == ""
    assert D.check_data(ks, ps, k) == "payloads are not ok"


@pytest.mark.parametrize("dist", D.ALL_DISTRIBUTIONS, ids=lambda d: d.value)
def test_native_keys_equal_jax(monkeypatch, dist):
    jnative = _jax_native(monkeypatch)
    for kdt in common.KEY_DTYPES:
        got = native.make_keys(3000, kdt, dist, seed=9)
        want = jnative.make_keys(3000, kdt, dist.value, seed=9)
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), kdt


def test_native_payloads_argsort_and_oracles_equal_jax(monkeypatch):
    jnative = _jax_native(monkeypatch)
    pdts = (np.uint32, np.uint8, np.float64)
    for kdt in common.KEY_DTYPES:
        keys = native.make_keys(4000, kdt, D.Distribution.GAUSSIAN, seed=4)
        got = native.make_payloads(keys, pdts)
        want = jnative.make_payloads(keys, pdts)
        python = D.make_payloads(keys, pdts, "cpp")
        for g, w, py in zip(got, want, python, strict=True):
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
            assert np.array_equal(g.view(np.uint8), py.view(np.uint8))
        assert native.check_payloads(keys, got) == -1
        bad = [p.copy() for p in got]
        bad[1][17] ^= 1
        assert native.check_payloads(keys, bad) == \
            jnative.check_payloads(keys, bad) == 17
        u = tsrs.transforms.to_sortable_np(keys)
        perm = native.radix_argsort(u)
        assert np.array_equal(perm, jnative.radix_argsort(u))
        assert np.array_equal(perm, np.argsort(u, kind="stable"))
        s = keys[perm]
        assert native.is_sorted(s) and jnative.is_sorted(s)
        assert native.same_multiset(s, keys)
        packed = native.pack_rows(keys, got)
        assert np.array_equal(packed, jnative.pack_rows(keys, got))
        k2, p2 = native.unpack_rows(packed, kdt, pdts)
        assert np.array_equal(k2.view(np.uint8), keys.view(np.uint8))
        assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                   for a, b in zip(p2, got))
    nan_last = np.array([-1.0, -0.0, 0.0, 2.0, np.nan], np.float64)
    assert native.is_sorted(nan_last)
    assert not native.is_sorted(np.array([0.0, -0.0]))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("kdt", common.KEY_DTYPES, ids=str)
@pytest.mark.parametrize("method", ["torch", "cpp"])
def test_host_engines_equal_seq(method, kdt, ascending):
    keys = D.make_keys(3001, kdt, D.Distribution.GAUSSIAN, seed=21)
    pays = D.make_payloads(keys, (np.uint64, np.int16))
    got = tsrs.sort(keys, *pays, method=method, ascending=ascending,
                    device="cpu")
    want = tsrs.sort(keys, *pays, method="seq", ascending=ascending,
                     device="cpu")
    assert tsrs.SORT_METHODS[method].device is False
    for g, w in zip(got, want, strict=True):
        g, w = interop.to_numpy(g), interop.to_numpy(w)
        assert g.dtype == w.dtype
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def test_library_is_built_under_build_and_native_is_untouched(
        monkeypatch, tmp_path):
    before = hashlib.sha256(COMMITTED_LIB.read_bytes()).hexdigest()
    assert native.library_path().parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "srs_torch")
    assert native.build().is_file()
    # a fresh build, into an empty directory
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "srs_torch")
    built = native.build()
    assert built.parent == tmp_path / "srs_torch"
    assert sorted(p.name for p in built.parent.iterdir()) == [built.name]
    assert hashlib.sha256(COMMITTED_LIB.read_bytes()).hexdigest() == before


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "harness.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "srs_torch")
    native.lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native harness build "
                                               "failed:\n.*error"):
            tsrs.sort(np.arange(5, dtype=np.int32), method="cpp",
                      device="cpu")
    finally:
        native.lib.cache_clear()
    assert list((tmp_path / "srs_torch").iterdir()) == []
