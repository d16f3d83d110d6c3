"""The xla engine's one-payload route (cub's pair sort on the card,
ops/cuda_sort.py; its plain version here) against the JAX package's
`xla_sort.sort_arrays`, on the CPU, and which calls take the route; the
bit window cub is given (K8's plain version, `window`, the windowed plain
sort) against NumPy and the full-width sort, and the size floor's rule.

Stable: keys and payloads bit for bit.  Not stable: keys bit for bit and
every (key, payload) row kept.  Every key dtype, payload widths 1/2/4/8,
both directions, n = 0, 1, 2 and a ragged 2^16 + 3; float keys carry +-0.0,
NaNs of both signs and +-inf; keys are drawn from n / 16 values, so most
tie.  The inputs are `pair_inputs` of the card's tests.
"""

import collections
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu.ops import xla_sort as jxla
from simd_radix_sort_tpu_torch.ops import cuda_sort, hashagg, hashjoin
from simd_radix_sort_tpu_torch.ops import xla_sort as txla
from simd_radix_sort_tpu_torch.utils import (common, interop, profiling,
                                             transforms)
from test_torch_sort_pairs_card import (KEY_DTYPES, RAGGED, SIZES,
                                        VALUE_DTYPES, pair_inputs)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(common.unsigned_of(a.dtype))


def _rows(k, v) -> np.ndarray:
    """(key bits, value bits) rows in one order, for a comparison of sets."""
    kb, vb = _bits(k).astype(np.uint64), _bits(v).astype(np.uint64)
    order = np.lexsort((vb, kb))
    return np.stack([kb[order], vb[order]])


def _check(key_dtype, width, n, ascending, stable, seed):
    k, v = pair_inputs(key_dtype, width, n, seed)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tk, (tv,) = txla.sort_arrays(interop.from_numpy(k, "cpu"),
                                     (interop.from_numpy(v, "cpu"),),
                                     ascending=ascending, stable=stable)
    assert profiling.COUNTERS["xla.pairs_calls"] == 1
    jk, (jv,) = jxla.sort_arrays(jnp.asarray(k), (jnp.asarray(v),),
                                 ascending=ascending, stable=stable)
    tk, tv = interop.to_numpy(tk), interop.to_numpy(tv)
    jk, jv = np.asarray(jk), np.asarray(jv)
    assert tk.dtype == jk.dtype == k.dtype and tv.dtype == jv.dtype == v.dtype
    assert np.array_equal(_bits(tk), _bits(jk))
    if stable:
        assert np.array_equal(_bits(tv), _bits(jv))
    else:
        assert np.array_equal(_rows(tk, tv), _rows(jk, jv))
    assert np.array_equal(_rows(tk, tv), _rows(k, v))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("width", sorted(VALUE_DTYPES))
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_ragged_matches_jax(key_dtype, width, ascending, stable):
    _check(key_dtype, width, RAGGED, ascending, stable, seed=width)


@pytest.mark.parametrize("n", [s for s in SIZES if s < RAGGED])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_tiny_matches_jax(key_dtype, ascending, n):
    for width in sorted(VALUE_DTYPES):
        _check(key_dtype, width, n, ascending, True, seed=n)


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_signed_zeros_and_nans_keep_their_total_order(dtype, ascending):
    """cub's own float path would sort -0.0 and +0.0 as one key; the
    carrier keeps IEEE totalOrder: -NaN < -inf < -0.0 < +0.0 < +inf < NaN,
    and ties in input order."""
    keys = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                     0.0, -0.0], dtype)
    pay = np.arange(len(keys), dtype=np.int32)
    tk, (tp,) = txla.sort_arrays(interop.from_numpy(keys, "cpu"),
                                 (interop.from_numpy(pay, "cpu"),),
                                 ascending=ascending)
    order = [5, 3, 1, 7, 0, 6, 2, 4]  # -NaN, -inf, -0.0 x2, +0.0 x2, ...
    if not ascending:
        order = [4, 2, 0, 6, 1, 7, 3, 5]
    assert interop.to_numpy(tp).tolist() == order
    assert _bits(interop.to_numpy(tk)).tolist() == \
        _bits(keys[order]).tolist()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("srs.xla."))


@pytest.mark.parametrize("streams", [0, 1, 2, 5])
def test_only_one_payload_takes_the_pair_sort(streams):
    g = torch.Generator().manual_seed(streams)
    keys = torch.randint(0, 50, (999,), generator=g).to(torch.uint32)
    pays = tuple(torch.randint(0, 1 << 30, (999,), generator=g)
                 for _ in range(streams))
    spans = _traced(lambda: txla.sort_arrays(keys, pays, ascending=False))
    if streams == 1:
        assert profiling.COUNTERS["xla.pairs_calls"] == 1
        assert spans == {"srs.xla.pairs": 1}
    else:
        assert "xla.pairs_calls" not in profiling.COUNTERS
        assert spans["srs.xla.sort"] == 1 and "srs.xla.pairs" not in spans
        assert spans["srs.xla.gather"] == (1 if streams else 0)


def test_over_max_items_keeps_torch_sort(monkeypatch):
    monkeypatch.setattr(cuda_sort, "MAX_ITEMS", 10)
    keys = torch.arange(11, 0, -1)
    spans = _traced(lambda: txla.sort_arrays(keys, (keys * 2,)))
    assert "xla.pairs_calls" not in profiling.COUNTERS
    assert "srs.xla.pairs" not in spans and spans["srs.xla.sort"] == 1
    with pytest.raises(ValueError, match="at most 10 pairs"):
        cuda_sort.sort_pairs(keys, keys)


def test_operators_route_their_one_payload_sorts():
    """sort() on xla, group_aggregate of one stream and a lookup join of one
    payload each take the pair sort once; argsort never."""
    g = torch.Generator().manual_seed(1)
    keys = torch.randint(0, 1 << 40, (3000,), generator=g)

    def calls():
        tsrs.sort(keys, torch.arange(3000), method="xla", device="cpu")
        hashagg.group_aggregate(keys % 5, torch.rand(3000, generator=g,
                                                     dtype=torch.float64),
                                aggs=("sum",))
        hashjoin.lookup_join(keys % 900, torch.arange(1000),
                             (torch.arange(1000, dtype=torch.int8),))
        tsrs.argsort(keys, device="cpu")
    spans = _traced(calls)
    assert profiling.COUNTERS["xla.pairs_calls"] == 3
    assert spans == {"srs.xla.pairs": 3}


@pytest.mark.parametrize("bad,err", [
    (lambda: (torch.zeros(4, dtype=torch.bool), torch.zeros(4)), TypeError),
    (lambda: (torch.zeros(4, dtype=torch.float32), torch.zeros(4)),
     TypeError),
    (lambda: (torch.zeros(4, dtype=torch.int32),
              torch.zeros(4, dtype=torch.complex128)), TypeError),
    (lambda: (torch.zeros(4, dtype=torch.int32), torch.zeros(5)),
     ValueError),
    (lambda: (torch.zeros((4, 2), dtype=torch.int32),
              torch.zeros((4, 2))), ValueError),
    (lambda: (torch.zeros(8, dtype=torch.int32)[::2], torch.zeros(4)),
     ValueError)])
def test_wrapper_refuses_what_cub_does_not_take(bad, err):
    with pytest.raises(err):
        cuda_sort.sort_pairs(*bad())


def test_plain_leaves_inputs_and_keeps_ties_in_order():
    keys = torch.tensor([3, 1, 3, 2, 1, 3], dtype=torch.int16)
    vals = torch.arange(6, dtype=torch.float64)
    for desc, order in ((False, [1, 4, 3, 0, 2, 5]),
                        (True, [0, 2, 5, 3, 1, 4])):
        k, v = cuda_sort.sort_pairs(keys, vals, desc)
        assert v.tolist() == order and k.tolist() == keys[order].tolist()
    assert keys.tolist() == [3, 1, 3, 2, 1, 3]


# the bit window

WINDOW_N = 5000  # more than cuda_sort.SAMPLE: some rows lie outside the sample
WINDOW_KINDS = ("negative", "mixed sign", "one key", "all equal", "bit 0",
                "top bit", "narrow", "sample misses")


def _unsampled(n):
    """Two rows that K8's sample of n > SAMPLE keys skips."""
    sampled = {j * (n - 1) // (cuda_sort.SAMPLE - 1)
               for j in range(cuda_sort.SAMPLE)}
    rows = [r for r in range(n) if r not in sampled]
    return rows[len(rows) // 3], rows[-1]


def window_keys(key_dtype, kind, seed=0) -> np.ndarray:
    """Keys of `key_dtype` (made as their bits) for one window case, drawn
    from WINDOW_N / 16 values so that most tie:
    "negative", the top bit set over the low half of the bits; "mixed
    sign", the low half of the bits with the top bit set or not; "one key";
    "all equal"; "bit 0" and "top bit", equal keys but one unsampled row
    differing in that bit; "narrow", the low half of the bits at a seeded
    offset; "sample misses", narrow keys whose unsampled rows differ in
    the top bit (a window that only the whole read finds)."""
    kd = np.dtype(key_dtype)
    ud = common.unsigned_of(kd)
    nbits = 8 * kd.itemsize
    top, half = 1 << (nbits - 1), (1 << (nbits // 2)) - 1
    rng = np.random.default_rng(seed)
    n = 1 if kind == "one key" else WINDOW_N

    def draw(hi):
        pool = rng.integers(0, hi, max(n // 16, 1), dtype=np.uint64,
                            endpoint=True)
        return pool[rng.integers(0, len(pool), n)]

    base = int(rng.integers(0, 1 << nbits, dtype=np.uint64, endpoint=False))
    if kind == "negative":
        bits = draw(half) | np.uint64(top)
    elif kind == "mixed sign":
        bits = draw(half) | (rng.integers(0, 2, n).astype(np.uint64)
                             << np.uint64(nbits - 1))
    elif kind == "narrow":
        bits = (draw(half) + np.uint64(base)) & np.uint64((1 << nbits) - 1)
    elif kind == "sample misses":
        bits = draw(half)
        for r in _unsampled(n):
            bits[r] |= np.uint64(top)
    else:
        bits = np.full(n, base, dtype=np.uint64)
        if kind in ("bit 0", "top bit"):
            bits[_unsampled(n)[0]] ^= np.uint64(1 if kind == "bit 0" else top)
    return bits.astype(ud).view(kd)


def _np_or(keys: np.ndarray) -> int:
    b = keys.view(common.unsigned_of(keys.dtype)).astype(np.uint64)
    return int(np.bitwise_or.reduce(b ^ b[0]))


def _carrier(keys: np.ndarray) -> torch.Tensor:
    """What cuda_sort.sort_pairs is handed: integer keys as they are, float
    keys as their signed carrier (xla_sort._sort_pairs)."""
    t = interop.from_numpy(keys, "cpu")
    return transforms.to_sortable(t, True) if keys.dtype.kind == "f" else t


@pytest.mark.parametrize("kind", WINDOW_KINDS)
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_plain_key_bits_is_the_or_of_keys_xor_the_first(key_dtype, kind):
    """K8's plain words against NumPy: [0] the OR of k ^ k[0] over the
    sample's rows, [1] over every row where the sample's window needs fewer
    passes than the key has, else the sample's; the window of either is
    the window of the whole OR."""
    keys = window_keys(key_dtype, kind, seed=len(kind))
    w = keys.dtype.itemsize
    words = cuda_sort.key_bits_plain(interop.from_numpy(keys, "cpu"))
    sample, word = (int(x) % (1 << 64) for x in words)
    n = len(keys)
    m = min(n, cuda_sort.SAMPLE)
    assert sample == _np_or(keys[[j * (n - 1) // max(m - 1, 1)
                                  for j in range(m)]])
    whole = _np_or(keys)
    gated = cuda_sort.passes(*cuda_sort._span(sample)) == w
    assert word == (sample if gated else whole)
    assert cuda_sort.window(word, w) == cuda_sort.window(whole, w)
    if kind in ("bit 0", "top bit", "sample misses"):
        assert sample != whole
        assert gated == (w == 1 and kind == "sample misses")


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", WINDOW_KINDS)
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_window_sort_equals_full_sort(key_dtype, kind, descending):
    """The stable sort of the carrier on only its window's bits, mapped
    back, equals the full-width plain sort bit for bit: keys, and values
    in their ties' input order."""
    keys = window_keys(key_dtype, kind, seed=len(kind) + 1)
    c = _carrier(keys)
    vals = torch.arange(c.numel(), dtype=torch.int32)
    bits = cuda_sort.window(int(cuda_sort.key_bits_plain(c)[1]) % (1 << 64),
                            c.element_size())
    got = cuda_sort.sort_pairs_plain(c, vals, descending, bits)
    want = cuda_sort.sort_pairs_plain(c, vals, descending)
    for a, b in zip(got, want):
        assert torch.equal(common.as_signed(a), common.as_signed(b))


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_sample_gate_never_narrows_the_window(width, seed):
    """Equal keys with a few seeded rows changed in seeded bits, some
    inside the sample and some outside: K8's window is never narrower than
    the window of the whole OR; it is that window."""
    rng = np.random.default_rng(seed)
    ud = np.dtype(f"u{width}")
    n = int(rng.integers(cuda_sort.SAMPLE - 5, 3 * cuda_sort.SAMPLE))
    bits = np.full(n, rng.integers(0, 1 << (8 * width), dtype=np.uint64),
                   dtype=np.uint64)
    for _ in range(int(rng.integers(1, 6))):
        bits[rng.integers(0, n)] ^= np.uint64(
            1 << int(rng.integers(0, 8 * width)))
    keys = bits.astype(ud)
    word = int(cuda_sort.key_bits_plain(interop.from_numpy(keys, "cpu"))[1])
    got = cuda_sort.window(word % (1 << 64), width)
    want = cuda_sort.window(_np_or(keys), width)
    assert got == want


HOST_READ = os.path.join(os.path.dirname(__file__), "..", "bench_out_h100",
                         "host_read.json")


def test_host_read_is_the_measured_one():
    """HOST_READ_S is the median read of bench_out_h100/host_read.json
    (workloads/kernel_ab.host_read_timings on an H100), to 0.1 us."""
    with open(HOST_READ) as f:
        rec = json.load(f)
    assert "H100" in rec["card"]
    assert round(rec["us"], 1) == round(cuda_sort.HOST_READ_S * 1e6, 1)


@pytest.mark.parametrize("value_bytes", [1, 2, 4, 8])
@pytest.mark.parametrize("key_bytes", [1, 2, 4, 8])
def test_window_floor_follows_its_rule(key_bytes, value_bytes):
    """The floor is the smallest n at which one pass over the pairs, 2 n
    (k + v) bytes at 3.35 TB/s, outlasts one host read."""
    r = key_bytes + value_bytes
    f = cuda_sort.window_floor(r)

    def pass_outlasts_read(n):
        return 2 * n * r / 3.35e12 > cuda_sort.HOST_READ_S

    assert cuda_sort.HBM_BYTES_PER_S == 3.35e12
    assert pass_outlasts_read(f) and not pass_outlasts_read(f - 1)
    assert f == math.floor(cuda_sort.HOST_READ_S * 3.35e12 / (2 * r)) + 1


def _floor_at(monkeypatch, rows, row_bytes):
    """HOST_READ_S set so that pairs of `row_bytes` reach the floor at
    `rows`."""
    monkeypatch.setattr(cuda_sort, "HOST_READ_S",
                        (rows - 0.5) * 2 * row_bytes
                        / cuda_sort.HBM_BYTES_PER_S)
    assert cuda_sort.window_floor(row_bytes) == rows


@pytest.mark.parametrize("n,reads", [(999, False), (1000, True)])
def test_sorts_read_their_window_from_the_floor(monkeypatch, n, reads):
    _floor_at(monkeypatch, 1000, 16)
    keys = torch.arange(n, 0, -1) * 8 + (1 << 40)
    spans = _traced(lambda: txla.sort_arrays(keys, (keys,)))
    assert profiling.COUNTERS["xla.pairs_calls"] == 1
    if reads:
        assert spans == {"srs.xla.pairs": 1, "srs.xla.bits": 1}
        assert profiling.COUNTERS["host_syncs.xla.bits"] == 1
        assert profiling.COUNTERS["xla.pairs_narrowed"] == 1
        assert profiling.COUNTERS["xla.pairs_passes"] == 2  # bits 3 to 12
    else:
        assert spans == {"srs.xla.pairs": 1}
        assert "host_syncs.xla.bits" not in profiling.COUNTERS
        assert "xla.pairs_narrowed" not in profiling.COUNTERS
        assert profiling.COUNTERS["xla.pairs_passes"] == 8


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_windowed_route_matches_jax(monkeypatch, key_dtype, ascending):
    """Every pair sort reads its window (the floor at one row): the route
    still equals the JAX package's sort bit for bit, on narrow keys."""
    monkeypatch.setattr(cuda_sort, "HOST_READ_S", 0.0)
    keys = window_keys(key_dtype, "narrow", seed=3)
    vals = np.arange(len(keys), dtype=np.int64)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tk, (tv,) = txla.sort_arrays(interop.from_numpy(keys, "cpu"),
                                     (interop.from_numpy(vals, "cpu"),),
                                     ascending=ascending)
    assert profiling.COUNTERS["host_syncs.xla.bits"] == 1
    jk, (jv,) = jxla.sort_arrays(jnp.asarray(keys), (jnp.asarray(vals),),
                                 ascending=ascending, stable=True)
    assert np.array_equal(_bits(interop.to_numpy(tk)), _bits(np.asarray(jk)))
    assert np.array_equal(interop.to_numpy(tv), np.asarray(jv))


def test_all_equal_keys_are_copied(monkeypatch):
    monkeypatch.setattr(cuda_sort, "HOST_READ_S", 0.0)
    keys = torch.full((300,), -7, dtype=torch.int64)
    vals = torch.arange(300, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]):
        k, v = cuda_sort.sort_pairs(keys, vals, True)
    assert profiling.COUNTERS["xla.pairs_passes"] == 0
    assert profiling.COUNTERS["xla.pairs_narrowed"] == 1
    assert torch.equal(k, keys) and torch.equal(v, vals)
