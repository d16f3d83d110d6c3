"""The port's counting kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, exactly.

On a CPU tensor each wrapper in ops/cuda_hist.py runs its plain PyTorch
version; the CUDA kernels themselves are held against those plain versions
on the card by chip_smoke.py.  The parameter grids are those of
tests/test_pallas_hist.py.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.ops import counting as jcounting
from simd_radix_sort_tpu.ops import pallas_hist
from simd_radix_sort_tpu_torch.ops import cuda_hist
from simd_radix_sort_tpu_torch.utils import interop


def _t(a):
    return interop.from_numpy(a, "cpu")


def _np(t):
    return interop.to_numpy(t)


@pytest.mark.parametrize("k", [16, 256, 1024])
def test_histogram_matches_pallas_and_mxu(k):
    """int32 offsets with out-of-range values on both sides: K1 == the
    Pallas histogram == the MXU histogram it replaces."""
    rng = np.random.default_rng(k)
    v = rng.integers(-5, k + 5, 4099).astype(np.int32)
    got = _np(cuda_hist.histogram(_t(v), k))
    want = np.asarray(pallas_hist.histogram(jnp.asarray(v), k,
                                            interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jcounting.mxu_histogram(
        jnp.asarray(v), k)))


def test_histogram_ignores_out_of_range():
    v = np.array([0, 5, 5, 300, -1, 7], dtype=np.int32)
    got = _np(cuda_hist.histogram(_t(v), 8))
    want = np.asarray(pallas_hist.histogram(jnp.asarray(v), 8,
                                            interpret=True))
    assert np.array_equal(got, want)
    assert got.tolist() == [1, 0, 0, 0, 0, 2, 0, 1]


@pytest.mark.parametrize("dtype,base", [(np.uint8, 0), (np.int8, 0x80),
                                        (np.uint16, 65530), (np.int16, 7),
                                        (np.uint32, 2**32 - 3),
                                        (np.int32, -500)])
def test_histogram_base_wraps_in_carrier_width(dtype, base):
    """The carrier form: offsets (x - base) mod 2^w, w the carrier width."""
    rng = np.random.default_rng(11)
    w = np.dtype(dtype).itemsize * 8
    mask = (1 << w) - 1
    u = (base + rng.integers(-3, 1030, 5000)) & mask
    v = u.astype(np.uint64).astype(f"u{w // 8}").view(dtype)
    got = _np(cuda_hist.histogram(_t(v), 1024, base))
    off = (v.view(f"u{w // 8}").astype(np.int64) - base) & mask
    assert np.array_equal(got, np.bincount(off[off < 1024], minlength=1024))


def _skewed_offsets(kind: str, k: int) -> np.ndarray:
    """int64 offsets from a histogram's base that K1's design must count
    exactly whatever their skew: one value (more rows than an 8-bit and
    than a 16-bit counter holds), two values, sorted and reverse-sorted
    runs, Zipf(1.1) ranks mod 1000, buckets of exactly 255, 256 and 65,536
    rows in runs, and values outside [0, k) on both sides."""
    rng = np.random.default_rng(k)
    edge = rng.integers(-8, k + 8, 5000)
    if kind == "one value, 300 rows":
        return np.full(300, k // 2)
    if kind == "one value, 70000 rows":
        return np.full(70_000, k - 1)
    if kind == "two values":
        return rng.integers(0, 2, 5000) * (k - 1)
    if kind == "sorted":
        return np.sort(edge)
    if kind == "reverse-sorted":
        return np.sort(edge)[::-1].copy()
    if kind == "zipf":
        return (rng.zipf(1.1, 5000) - 1) % 1000
    if kind == "exactly 255, 256, 65536":
        runs = np.repeat([0, 1, 2], [255, 256, 65_536])
        rest = rng.integers(3, max(4, k), 3000)
        return np.concatenate([rest[:1000], runs, rest[1000:]])
    assert kind == "outside [0, k)"
    return rng.integers(-2 * k, 3 * k, 5000)


_SKEWED = ["one value, 300 rows", "one value, 70000 rows", "two values",
           "sorted", "reverse-sorted", "zipf", "exactly 255, 256, 65536",
           "outside [0, k)"]
_CARRIERS = {1: (np.int8, 0xF0), 2: (np.int16, 0x7FF0),
             4: (np.int32, 2**32 - 3)}


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("k", [16, 256, 1024])
@pytest.mark.parametrize("kind", _SKEWED)
def test_histogram_skewed_matches_jax(kind, k, width):
    """K1 on skewed inputs in each carrier width (a signed carrier and a
    base that wraps in its width): the port's histogram equals the JAX
    package's counterpart for that k, the Pallas histogram in interpret
    mode at k = 16 and the MXU histogram that the TPU path runs for
    k >= 256, on the offsets (x - base) mod 2^w."""
    dtype, base = _CARRIERS[width]
    mask = (1 << (8 * width)) - 1
    u = (base + _skewed_offsets(kind, k)) & mask
    v = u.astype(np.uint64).astype(f"u{width}").view(dtype)
    got = _np(cuda_hist.histogram(_t(v), k, base))
    off = ((u - base) & mask).astype(np.uint32).view(np.int32)
    if k == 16:
        want = np.asarray(pallas_hist.histogram(jnp.asarray(off), k,
                                                interpret=True))
    else:
        want = np.asarray(jcounting.mxu_histogram(jnp.asarray(off), k))
    assert np.array_equal(got, want)
    keep = (u - base) & mask
    assert np.array_equal(got, np.bincount(keep[keep < k], minlength=k))


@pytest.mark.parametrize("n_extra", [0, 1, 127, 12345])
def test_fill_runs_matches_pallas(n_extra):
    rng = np.random.default_rng(1)
    n = pallas_hist.FILL_BLOCK + n_extra
    v = rng.integers(0, 64, n).astype(np.int32)
    hist = np.bincount(v, minlength=64).astype(np.int32)
    got = _np(cuda_hist.fill_runs(_t(hist), n, 10, torch.int32))
    want = np.asarray(pallas_hist.fill_runs(jnp.asarray(hist), n, 10,
                                            jnp.int32, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.sort(v) + 10)


def test_fill_runs_skewed_many_transitions_per_block():
    k = 512
    hist = np.full(k, 3, np.int32)
    got = _np(cuda_hist.fill_runs(_t(hist), 3 * k, 0, torch.int32))
    want = np.asarray(pallas_hist.fill_runs(jnp.asarray(hist), 3 * k, 0,
                                            jnp.int32, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.repeat(np.arange(k), 3))


def test_fill_runs_empty_buckets():
    hist = np.array([0, 5, 0, 0, 2, 0], np.int32)
    got = _np(cuda_hist.fill_runs(_t(hist), 7, 0, np.uint8))
    want = np.asarray(pallas_hist.fill_runs(jnp.asarray(hist), 7, 0,
                                            jnp.uint8, interpret=True))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert got.tolist() == [1] * 5 + [4] * 2


def test_fill_runs_base_wraps_in_carrier_width():
    """base + b is taken modulo 2^w, as the counting engine's carriers
    need: int8 output from base 0x80 runs -128 .. 127."""
    hist = np.ones(256, np.int32)
    got = _np(cuda_hist.fill_runs(_t(hist), 256, 0x80, torch.int8))
    assert np.array_equal(got, np.arange(-128, 128, dtype=np.int8))


_FILL_BASES = {torch.int8: (0x80, jnp.int8), torch.int16: (0x7FF0, jnp.int16),
               torch.int32: (-500, jnp.int32), torch.uint8: (0, jnp.uint8)}


@pytest.mark.parametrize("dtype", list(_FILL_BASES), ids=str)
@pytest.mark.parametrize("case", list(cuda_hist.tile_edge_cases(1)))
def test_fill_runs_tile_edges_match_pallas(case, dtype):
    """Runs that meet the fill kernels' tile edges (FILL_TILE_BYTES of
    output, the tile the kernels are launched with): the port's fill equals
    the Pallas fill; for uint8 the packed fill equals the uint8 fill."""
    base, jdtype = _FILL_BASES[dtype]
    hist, n = cuda_hist.tile_edge_cases(dtype.itemsize)[case]
    got = _np(cuda_hist.fill_runs(_t(hist), n, base, dtype))
    want = np.asarray(pallas_hist.fill_runs(jnp.asarray(hist), n, base,
                                            jdtype, interpret=True))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    if dtype == torch.uint8:
        hist, n = cuda_hist.tile_edge_cases(1, cuda_hist.MAX_PACKED_K)[case]
        n -= n % 4
        assert torch.equal(cuda_hist.fill_runs_packed(_t(hist), n),
                           cuda_hist.fill_runs(_t(hist), n, 0, torch.uint8))


@pytest.mark.parametrize("lo,width", [(0, 16), (7, 16), (2**31 - 5, 16),
                                      (2**32 - 16, 16), (123456, 1),
                                      (0, 1)])
def test_minmax_hist16_matches_pallas(lo, width):
    rng = np.random.default_rng(3)
    n = pallas_hist.HIST_BLOCK_ROWS * 128 + 777
    v = np.uint32(lo) + rng.integers(0, width, n).astype(np.uint32)
    mn, mx, hm = cuda_hist.minmax_hist16(_t(v))
    jmn, jmx, jhm = jax.jit(lambda x: pallas_hist.minmax_hist16(
        x, interpret=True))(jnp.asarray(v))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))
    assert (int(mn), int(mx)) == (int(v.min()), int(v.max()))
    assert np.array_equal(_np(hm), np.asarray(jhm))


def test_minmax_hist16_small_and_empty():
    for n in (1, 5, 130):
        v = np.arange(n, dtype=np.uint32) % 3 + 10
        mn, mx, hm = cuda_hist.minmax_hist16(_t(v))
        jmn, jmx, jhm = pallas_hist.minmax_hist16(jnp.asarray(v),
                                                  interpret=True)
        assert (int(mn), int(mx)) == (int(jmn), int(jmx))
        assert np.array_equal(_np(hm), np.asarray(jhm))
    mn, mx, hm = cuda_hist.minmax_hist16(_t(np.zeros(0, np.uint32)))
    assert (int(mn), int(mx), int(hm.sum())) == (0, 0, 0)


@pytest.mark.parametrize("lo,width,n_extra", [
    (0, 16, 777), (7, 13, 0), (2**31 - 5, 16, 1), (2**32 - 16, 16, 12345),
    (42, 1, 130), (0, 1, 0)])
def test_tiny_sort16_matches_pallas(lo, width, n_extra):
    rng = np.random.default_rng(5)
    n = pallas_hist.TINY_BLOCK_ROWS * 128 + n_extra
    v = np.uint32(lo) + rng.integers(0, width, n).astype(np.uint32)
    out, mn, mx = cuda_hist.tiny_sort16(_t(v))
    jout, jmn, jmx = jax.jit(lambda x: pallas_hist.tiny_sort16(
        x, interpret=True))(jnp.asarray(v))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))
    assert np.array_equal(_np(out), np.asarray(jout))
    assert np.array_equal(_np(out), np.sort(v))


def test_tiny_sort16_multiblock_matches_pallas():
    rng = np.random.default_rng(6)
    n = pallas_hist.TINY_BLOCK_ROWS * 128 * 3 + 999
    v = rng.integers(100, 116, n).astype(np.uint32)
    out, mn, mx = cuda_hist.tiny_sort16(_t(v))
    jout, jmn, jmx = pallas_hist.tiny_sort16(jnp.asarray(v), interpret=True)
    assert np.array_equal(_np(out), np.asarray(jout))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))


def test_tiny_sort16_wide_range_matches_pallas_everywhere():
    """Out of contract (range >= 16): min and max stay exact, and the
    painted output is the same function of the residue histogram as the
    TPU kernel's."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    out, mn, mx = cuda_hist.tiny_sort16(_t(v))
    jout, jmn, jmx = pallas_hist.tiny_sort16(jnp.asarray(v), interpret=True)
    assert (int(mn), int(mx)) == (int(v.min()), int(v.max()))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))
    assert np.array_equal(_np(out), np.asarray(jout))


def test_tiny_sort16_two_byte_carrier_with_flip():
    """The counting engine's 2-byte form: an int16 carrier holding
    u ^ 0x8000, ordered by u, against the JAX kernel on u zero-extended."""
    rng = np.random.default_rng(8)
    u = (0x7FF8 + rng.integers(0, 16, 3000)).astype(np.uint16)
    carrier = (u ^ np.uint16(0x8000)).view(np.int16)
    out, mn, mx = cuda_hist.tiny_sort16(_t(carrier), flip=0x8000)
    jout, jmn, jmx = pallas_hist.tiny_sort16(
        jnp.asarray(u.astype(np.uint32)), interpret=True)
    assert out.dtype == torch.int16
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))
    got_u = _np(out).view(np.uint16) ^ np.uint16(0x8000)
    assert np.array_equal(got_u, np.asarray(jout).astype(np.uint16))


def test_wrappers_check_their_inputs():
    x = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(TypeError):
        cuda_hist.histogram(x, 16)
    with pytest.raises(TypeError):
        cuda_hist.minmax_hist16(torch.zeros(8, dtype=torch.int8))
    with pytest.raises(ValueError):
        cuda_hist.histogram(torch.zeros(8, dtype=torch.int32), 2048)
    with pytest.raises(ValueError):
        cuda_hist.histogram(torch.zeros((2, 4), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        cuda_hist.tiny_sort16(torch.zeros(8, dtype=torch.int32)[::2])
    with pytest.raises(TypeError):
        cuda_hist.fill_runs(torch.ones(4, dtype=torch.int64), 4, 0,
                            torch.int32)


def test_plain_versions_do_not_count_as_launches():
    cuda_hist.reset_launches()
    v = torch.arange(100, dtype=torch.int32)
    cuda_hist.tiny_sort16(v)
    cuda_hist.fill_runs(cuda_hist.histogram(v, 128), 100, 0, torch.int32)
    assert all(c == 0 for c in cuda_hist.LAUNCHES.values())


@functools.lru_cache(maxsize=None)
def _pallas_k23(u_bytes: bytes, width: int):
    """The Pallas K2 and K3 (interpret mode) on rows u zero-extended to
    uint32; cached, since every case runs with two flips of the same u."""
    u = np.frombuffer(u_bytes, f"u{width}").astype(np.uint32)
    mn, mx, hm = pallas_hist.minmax_hist16(jnp.asarray(u), interpret=True)
    out, tmn, tmx = pallas_hist.tiny_sort16(jnp.asarray(u), interpret=True)
    return ((int(mn), int(mx), np.asarray(hm)),
            (np.asarray(out), int(tmn), int(tmx)))


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("case", list(cuda_hist.k23_edge_cases(2)))
def test_k23_edge_cases_match_pallas(case, width):
    """K2 and K3 on the inputs that reach every path of their kernels
    (cuda_hist.k23_edge_cases, which chip_smoke.py also runs on the card):
    the port's minmax_hist16 and tiny_sort16 equal the Pallas kernels on
    u = carrier ^ flip zero-extended, exactly; K3's output modulo 2^w, the
    carrier's width, for the ranges of 16 and more, whose paint may carry
    past it in the TPU kernel's uint32."""
    carrier, flip, start = cuda_hist.k23_edge_cases(width)[case]
    x = _t(carrier)[start:]
    mask = (1 << (8 * width)) - 1
    u = (carrier[start:].view(f"u{width}") ^ flip).astype(f"u{width}")
    (jmn, jmx, jhm), (jout, tmn, tmx) = _pallas_k23(u.tobytes(), width)
    mn, mx, hm = cuda_hist.minmax_hist16(x, flip)
    assert (int(mn), int(mx)) == (jmn, jmx) == (int(u.min()), int(u.max()))
    assert np.array_equal(_np(hm), jhm)
    out, mn, mx = cuda_hist.tiny_sort16(x, flip)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert (int(mn), int(mx)) == (tmn, tmx) == (jmn, jmx)
    got_u = (_np(out).view(f"u{width}") ^ flip).astype(np.int64)
    assert np.array_equal(got_u, jout.astype(np.int64) & mask)
    if jmx - jmn < 16:
        assert np.array_equal(got_u, np.sort(u))
