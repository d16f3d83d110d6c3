"""The port's stable partition (K5, ops/cuda_partition.py) and packed uint8
run fill (K6, ops/cuda_hist.fill_runs_packed), through their plain versions
on the CPU, against the JAX package's Pallas kernels in interpret mode,
exactly.

The JAX `fill_runs_packed` (scripts/u8_attack.py) runs only on a TPU (no
interpret flag, scalar prefetch); that script holds it against
`pallas_hist.fill_runs(h, n, 0, uint8)`, which is what K6 is held against
here.  chip_smoke.py holds both CUDA kernels against these plain versions
on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from simd_radix_sort_tpu.ops import pallas_hist
from simd_radix_sort_tpu.ops import pallas_partition as jpp
from simd_radix_sort_tpu_torch.ops import cuda_hist
from simd_radix_sort_tpu_torch.ops import cuda_partition as cp
from simd_radix_sort_tpu_torch.utils import common, interop

MASKS = ["random", "all False", "all True", "alternating", "every third"]


def _t(a):
    if a.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(a))
    return interop.from_numpy(a, "cpu")


def _np(t):
    return interop.to_numpy(t)


def _mask(kind, n, rng):
    i = np.arange(n)
    return {"random": rng.integers(0, 2, n) == 1, "all False": i < 0,
            "all True": i >= 0, "alternating": i % 2 == 1,
            "every third": i % 3 == 0}[kind]


def _jax_partition(arrays, mask):
    """The JAX kernel on streams of any dtype, through its word transport."""
    words, metas = [], []
    for a in arrays:
        w, meta = jpp.to_words(jnp.asarray(a))
        metas.append((len(words), meta))
        words.extend(w)
    out = jpp.partition_pass(words, jnp.asarray(mask), block=128,
                             interpret=True)
    return [np.asarray(jpp.from_words(out[i:i + meta[1]], meta))
            for i, meta in metas]


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n", [1, 100, 129, 1300])
def test_partition_pass_matches_pallas(n, kind):
    rng = np.random.default_rng(n)
    streams = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    mask = _mask(kind, n, rng)
    want = _jax_partition(streams, mask)
    got = cp.partition_pass([_t(s) for s in streams], _t(mask))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)
    order = np.argsort(mask, kind="stable")
    assert np.array_equal(_np(got[0]), streams[0][order])


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64,
                                   np.float32, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_partition_pass_moves_words_as_they_are(dtype):
    """8-byte words move whole in the port and as (hi, lo) u32 halves in
    the JAX kernel; the bits come out the same.  Float streams carry NaN
    payloads and -0.0 through untouched."""
    rng = np.random.default_rng(5)
    n = 300
    w = np.dtype(dtype).itemsize
    a = rng.integers(0, 256, n * w, dtype=np.uint8).view(dtype)
    mask = rng.integers(0, 2, n) == 1
    (want,) = _jax_partition([a], mask)
    (got,) = cp.partition_pass([_t(a)], _t(mask))
    assert got.dtype == common.torch_dtype(dtype)
    assert np.array_equal(_np(got).view(np.uint8), want.view(np.uint8))


def test_partition_pass_is_stable_under_duplicates():
    n = 640
    rng = np.random.default_rng(8)
    dup = rng.integers(0, 4, n).astype(np.int64)  # few distinct values
    tag = np.arange(n, dtype=np.int32)             # the input order
    mask = dup >= 2
    want = _jax_partition([dup, tag], mask)
    got = cp.partition_pass([_t(dup), _t(tag)], _t(mask))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)
    left = _np(got[1])[:int((~mask).sum())]
    assert np.all(np.diff(left) > 0)


@pytest.mark.parametrize("dtype", list(common.KEY_DTYPES),
                         ids=lambda d: np.dtype(d).name)
def test_words_round_trip_and_match_the_jax_words(dtype):
    rng = np.random.default_rng(3)
    w = np.dtype(dtype).itemsize
    a = rng.integers(0, 256, 50 * w, dtype=np.uint8).view(dtype)
    words, meta = cp.to_words(_t(a))
    assert len(words) == 1 and words[0].element_size() in (4, 8)
    back = cp.from_words(words, meta)
    assert back.dtype == common.torch_dtype(dtype)
    assert np.array_equal(_np(back).view(np.uint8), a.view(np.uint8))
    jwords, _ = jpp.to_words(jnp.asarray(a))
    if w == 8:  # the JAX package's (hi, lo) halves of the same word
        lo_hi = _np(words[0]).view(np.uint32).reshape(-1, 2)
        assert np.array_equal(lo_hi[:, 1], np.asarray(jwords[0]))
        assert np.array_equal(lo_hi[:, 0], np.asarray(jwords[1]))
    else:       # zero-extended to 32 bits, as the JAX package does
        assert np.array_equal(_np(words[0]).view(np.uint32),
                              np.asarray(jwords[0]))


def test_partition_pass_checks_its_inputs():
    s = torch.arange(8, dtype=torch.int32)
    m = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        cp.partition_pass([s], m.to(torch.uint8))
    with pytest.raises(TypeError):
        cp.partition_pass([s.to(torch.int16)], m)
    with pytest.raises(ValueError):
        cp.partition_pass([s[:4]], m)
    with pytest.raises(ValueError):
        cp.partition_pass([s[::2]], m[:4])
    with pytest.raises(ValueError):
        cp.partition_pass([], m)
    with pytest.raises(ValueError):
        cp.partition_pass([s], m, block=300)
    assert cp.partition_pass([s[:0]], m[:0])[0].numel() == 0


def test_plain_versions_do_not_count_as_launches():
    cp.reset_launches()
    cuda_hist.reset_launches()
    cp.partition_pass([torch.arange(10)], torch.arange(10) % 2 == 0)
    cuda_hist.fill_runs_packed(torch.full((4,), 2, dtype=torch.int32), 8)
    assert cp.LAUNCHES == {"partition_pass": 0}
    assert cuda_hist.LAUNCHES["fill_runs_packed"] == 0


@pytest.mark.parametrize("hist_kind,n", [
    ("uniform", 4), ("uniform", 1024),
    ("uniform", pallas_hist.FILL_BLOCK + 12),
    ("one bucket", 4096), ("halving", 8192), ("empty buckets", 8)])
def test_fill_runs_packed_matches_pallas_fill_runs(hist_kind, n):
    rng = np.random.default_rng(n)
    if hist_kind == "uniform":
        hist = np.bincount(rng.integers(0, 256, n), minlength=256)
    elif hist_kind == "one bucket":
        hist = np.zeros(256, np.int64)
        hist[200] = n
    elif hist_kind == "halving":
        hist = np.array([n >> (b + 1) for b in range(255)] + [0])
        hist[-1] = n - hist.sum()
    else:
        hist = np.array([0, 5, 0, 0, 3, 0])
    hist = hist.astype(np.int32)
    got = _np(cuda_hist.fill_runs_packed(_t(hist), n))
    want = np.asarray(pallas_hist.fill_runs(jnp.asarray(hist), n, 0,
                                            jnp.uint8, interpret=True))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.repeat(np.arange(hist.size), hist))
    assert np.array_equal(got, _np(cuda_hist.fill_runs(_t(hist), n, 0,
                                                       torch.uint8)))


def test_fill_runs_packed_checks_its_inputs():
    h = torch.full((4,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_hist.fill_runs_packed(h, 6)
    with pytest.raises(ValueError):
        cuda_hist.fill_runs_packed(torch.ones(257, dtype=torch.int32), 260)
    with pytest.raises(TypeError):
        cuda_hist.fill_runs_packed(h.to(torch.int64), 8)
