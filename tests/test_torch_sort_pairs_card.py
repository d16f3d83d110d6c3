"""cub's pair sort (csrc/sort_pairs*.cu, ops/cuda_sort.py) on the card
against its plain version (`cuda_sort.sort_pairs_plain`, run on the same
card tensors), and the xla engine's one-payload route through it against
the same route on the CPU; K8, the key bits that set cub's bit window
(csrc/key_bits.cu), against its plain version, and sorts by narrow windows
against the full-width `torch.sort` path.  The library call and K8 have no
CPU version here, so every test here skips where there is no CUDA card.
On the card:

    python -m pytest tests/test_torch_sort_pairs_card.py -q -p no:cacheprovider --noconftest

(`--noconftest`: the suite's conftest sets JAX up, and nothing here needs
it).  Every output is held bit for bit: the sort is stable, so the order of
equal keys is fixed too.  `pair_inputs` also makes the CPU tests' inputs
(tests/test_torch_sort_pairs.py).
"""

import numpy as np
import pytest
import torch

from simd_radix_sort_tpu_torch.ops import _build, cuda_sort, xla_sort
from simd_radix_sort_tpu_torch.utils import common, interop, profiling

pytestmark = pytest.mark.card

KEY_DTYPES = common.KEY_DTYPES
VALUE_DTYPES = {1: np.dtype(np.uint8), 2: np.dtype(np.int16),
                4: np.dtype(np.float32), 8: np.dtype(np.uint64)}
RAGGED = (1 << 16) + 3
SIZES = (0, 1, 2, RAGGED)
# IEEE bit patterns planted among float keys: +0.0, -0.0, NaNs of both
# signs (two payloads each), +inf, -inf
SPECIALS = {
    4: (0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7FC00001,
        0xFFC00003, 0x7F800000, 0xFF800000),
    8: (0, 0x8000000000000000, 0x7FF8000000000000, 0xFFF8000000000000,
        0x7FF8000000000001, 0xFFF8000000000003, 0x7FF0000000000000,
        0xFFF0000000000000),
}


def pair_inputs(key_dtype, width: int, n: int, seed: int):
    """n seeded keys of `key_dtype` drawn from n / 16 distinct values (so
    most keys tie), float keys with every SPECIALS pattern planted up to
    three times, and n values of `width` bytes of random bits (numpy)."""
    kd = np.dtype(key_dtype)
    rng = np.random.default_rng(seed)
    ud = common.unsigned_of(kd)
    pool = rng.integers(0, 1 << (8 * kd.itemsize), max(n // 16, 1),
                        dtype=ud, endpoint=False)
    bits = pool[rng.integers(0, len(pool), n)]
    if kd.kind == "f" and n:
        sp = np.array(SPECIALS[kd.itemsize], dtype=ud)
        at = rng.choice(n, size=min(n, 3 * len(sp)), replace=False)
        bits[at] = np.resize(sp, len(at))
    values = rng.integers(0, 256, n * width, dtype=np.uint8)
    return bits.view(kd), values.view(VALUE_DTYPES[width])


def same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(common.as_signed(got).cpu(),
                       common.as_signed(want).cpu())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cub's pair sort runs on the card only")
    return torch.device("cuda")


def _on(card, key_dtype, width, n, seed):
    k, v = pair_inputs(key_dtype, width, n, seed)
    return interop.from_numpy(k, card), interop.from_numpy(v, card)


INT_KEYS = [dt for dt in KEY_DTYPES if dt.kind != "f"]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("width", sorted(VALUE_DTYPES))
@pytest.mark.parametrize("key_dtype", INT_KEYS, ids=str)
def test_entry_matches_plain(card, key_dtype, width, descending, n):
    k, v = _on(card, key_dtype, width, n, seed=n + width)
    k0, v0 = k.clone(), v.clone()
    cuda_sort.reset_launches()
    got = cuda_sort.sort_pairs(k, v, descending)
    torch.cuda.synchronize()
    assert cuda_sort.LAUNCHES["sort_pairs"] == (1 if n else 0)
    want = cuda_sort.sort_pairs_plain(k, v, descending)
    for a, b in zip(got, want):
        assert a.device == k.device
        same_bits(a, b)
    same_bits(k, k0)  # the inputs are left as they are
    same_bits(v, v0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("width", sorted(VALUE_DTYPES))
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_xla_route_matches_cpu(card, key_dtype, width, ascending, n):
    """sort_arrays with one payload on the card (cub, floats as carriers)
    against the same call on the CPU (the plain version), counted."""
    k, v = _on(card, key_dtype, width, n, seed=2 * n + width)
    cuda_sort.reset_launches()
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gk, (gv,) = xla_sort.sort_arrays(k, (v,), ascending=ascending)
        torch.cuda.synchronize()
    assert profiling.COUNTERS["xla.pairs_calls"] == 1
    assert cuda_sort.LAUNCHES["sort_pairs"] == (1 if n else 0)
    wk, (wv,) = xla_sort.sort_arrays(k.cpu(), (v.cpu(),), ascending=ascending)
    same_bits(gk, wk)
    same_bits(gv, wv)


@pytest.mark.parametrize("key,value,descending", [
    (torch.uint64, torch.uint64, False),   # the headline sort's kinds
    (torch.int64, torch.int8, False),      # a join's build of a 1-byte payload
    (torch.int64, torch.float64, True),
    (torch.int32, torch.int32, True)])
def test_entry_at_1e7_rows(card, key, value, descending):
    n = 10_000_000
    g = torch.Generator(device=card).manual_seed(3)
    k = torch.randint(-2**62, 2**62, (n,), generator=g, device=card,
                      dtype=torch.int64)
    if key != torch.int64:
        k = k.view(torch.uint64) if key == torch.uint64 else \
            (k >> 40).to(key)
    v = torch.randint(-128, 128, (n,), generator=g, device=card,
                      dtype=torch.int64).to(value)
    cuda_sort.reset_launches()
    got = cuda_sort.sort_pairs(k, v, descending)
    assert cuda_sort.LAUNCHES["sort_pairs"] == 1
    want = cuda_sort.sort_pairs_plain(k, v, descending)
    for a, b in zip(got, want):
        same_bits(a, b)


def test_entry_refuses_a_value_width_it_has_not(card):
    k = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="srs_sort_pairs"):
        _build.launch("srs_sort_pairs", card, 5, 3, 0, k.data_ptr(),
                      k.data_ptr(), k.data_ptr(), k.data_ptr(), 4, 0, 32,
                      k.data_ptr(), 4)


@pytest.mark.parametrize("begin,end", [(0, 0), (4, 3), (-1, 8), (0, 33)])
def test_entry_refuses_a_window_outside_the_key(card, begin, end):
    k = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="srs_sort_pairs"):
        _build.launch("srs_sort_pairs", card, 5, 4, 0, k.data_ptr(),
                      k.data_ptr(), k.data_ptr(), k.data_ptr(), 4, begin,
                      end, k.data_ptr(), 4)


def test_sorts_on_the_current_stream(card):
    k, v = _on(card, np.uint32, 8, RAGGED, seed=5)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        got = cuda_sort.sort_pairs(k, v, True)
    torch.cuda.current_stream(card).wait_stream(side)
    want = cuda_sort.sort_pairs_plain(k, v, True)
    for a, b in zip(got, want):
        same_bits(a, b)


# K8 and the bit window

BIG = 1 << 24
RAGGED_VIEW = 1_000_003


def _random_bytes(card, n, width, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, width), generator=g, device=card,
                         dtype=torch.int64).to(torch.uint8)


def k8_keys(card, key_dtype, kind, seed):
    """Keys of `key_dtype` for K8: "full", random bits (the sample needs
    every pass: the full read is skipped); "narrow", random low half of
    the key's bytes under constant high bytes (a low nibble under a
    constant one for 1-byte keys); "ragged", narrow keys as a view one
    element into a larger tensor (its rows misaligned to 16 bytes), of
    RAGGED_VIEW rows; "planted", equal keys but for two rows outside the
    sample, one differing in the top bit and one in bit 0, in the same
    misaligned view."""
    td = common.torch_dtype(key_dtype)
    w = np.dtype(key_dtype).itemsize
    n = BIG if kind in ("full", "narrow") else RAGGED_VIEW + 1
    b = _random_bytes(card, n, w, seed)
    if kind != "full":
        if w == 1:
            b = (b & 0x0F) | 0xA0
        else:
            b[:, w // 2:] = torch.arange(w - w // 2, device=card).to(
                torch.uint8) * 37 + 5
    if kind == "planted":
        b[:] = b[0]
    keys = b.view(-1).view(td)
    if kind in ("full", "narrow"):
        return keys
    keys = keys[1:]
    if kind == "planted":
        m = RAGGED_VIEW
        step = (m - 1) / (cuda_sort.SAMPLE - 1)
        mid = int(50 * step) + int(step / 2)  # between sample rows 50, 51
        top = common.as_signed(keys)
        top[mid] = top[0] ^ -(1 << (8 * w - 1))
        top[m - 2] = top[0] ^ 1  # the row before the last, not sampled
    return keys


@pytest.mark.parametrize("kind", ["full", "narrow", "ragged", "planted"])
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=str)
def test_key_bits_matches_plain(card, key_dtype, kind):
    keys = k8_keys(card, key_dtype, kind, seed=KEY_DTYPES.index(key_dtype))
    cuda_sort.reset_launches()
    host = torch.full((1,), -1, dtype=torch.int64, pin_memory=True)
    got = cuda_sort.key_bits(keys, host)
    torch.cuda.current_stream(card).synchronize()
    assert cuda_sort.LAUNCHES["key_bits"] == 1
    want = cuda_sort.key_bits_plain(keys)
    assert got.device == keys.device
    assert torch.equal(got, want)
    assert int(host[0]) == int(want[1])  # the word copied behind the launches
    w = keys.element_size()
    if kind == "planted":
        assert int(want[0]) == 0
        assert int(want[1]) % (1 << 64) == (1 << (8 * w - 1)) | 1


def _int_keys(lo, hi, dtype=torch.int64):
    def make(card, n, g):
        return torch.randint(lo, hi, (n,), generator=g, device=card,
                             dtype=torch.int64).to(dtype)
    return make


def _float_keys(dtype):
    """Floats in [1, 1.5]: one exponent, so the window is the mantissa."""
    def make(card, n, g):
        return (1 + 0.5 * torch.rand(n, generator=g, device=card,
                                     dtype=torch.float64)).to(dtype)
    return make


# (label, keys(card, n, generator), ascending, the passes cub is given)
WINDOW_CASES = [
    ("int64 [1, 6e8]", _int_keys(1, 600_000_001), True, 4),
    ("int64 [1, 6e8] desc", _int_keys(1, 600_000_001), False, 4),
    ("int64 [-2^20, -1]", _int_keys(-(1 << 20), 0), True, 3),
    ("int64 [2^40, 2^40 + 2^16)", _int_keys(1 << 40, (1 << 40) + (1 << 16)),
     True, 2),
    ("int64 even [0, 2^21)",
     lambda card, n, g: _int_keys(0, 1 << 20)(card, n, g) * 2, True, 3),
    ("int64 all equal", lambda card, n, g: torch.full(
        (n,), -12345, dtype=torch.int64, device=card), True, 0),
    ("int32 [-1000, 1000] (both signs)", _int_keys(-1000, 1001, torch.int32),
     False, 4),
    ("uint8 [0, 16)", _int_keys(0, 16, torch.uint8), True, 1),
    ("uint16 [0, 256)", _int_keys(0, 256, torch.uint16), False, 1),
    ("uint32 [0, 2^20)", _int_keys(0, 1 << 20, torch.uint32), True, 3),
    ("uint64 [0, 2^33)", _int_keys(0, 1 << 33, torch.uint64), True, 5),
    ("float32 [1, 1.5]", _float_keys(torch.float32), True, 3),
    ("float32 [1, 1.5] desc", _float_keys(torch.float32), False, 3),
    ("float64 [1, 1.5]", _float_keys(torch.float64), True, 7),
]


@pytest.mark.parametrize("label,make,ascending,want_passes", WINDOW_CASES,
                         ids=[c[0] for c in WINDOW_CASES])
def test_window_sort_matches_torch_sort(card, label, make, ascending,
                                        want_passes):
    """sort_arrays with one payload (cub by the keys' bit window) against
    the same call with the payload twice (torch.sort of the full carrier
    and the gathers), bit for bit, and the window counted."""
    g = torch.Generator(device=card)
    g.manual_seed(len(label))
    keys = make(card, BIG, g)
    vals = torch.randint(-2**62, 2**62, (BIG,), generator=g, device=card)
    cuda_sort.reset_launches()
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gk, (gv,) = xla_sort.sort_arrays(keys, (vals,), ascending=ascending)
        torch.cuda.synchronize()
    counted = dict(profiling.COUNTERS)
    wk, (wv, _) = xla_sort.sort_arrays(keys, (vals, vals),
                                       ascending=ascending, stable=True)
    same_bits(gk, wk)
    same_bits(gv, wv)
    w = keys.element_size()
    assert counted.get("xla.pairs_passes") == want_passes
    assert counted.get("xla.pairs_narrowed", 0) == int(want_passes < w)
    assert counted.get("host_syncs.xla.bits") == 1
    assert cuda_sort.LAUNCHES["key_bits"] == 1
    assert cuda_sort.LAUNCHES["sort_pairs"] == int(want_passes > 0)


def _k8_full_read_us(keys):
    """Device us of K8's full kernel (not the sample's) over one call."""
    cuda_sort.key_bits(keys)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        cuda_sort.key_bits(keys)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "key_bits_kernel<" in e.name]
    assert us, "no K8 kernel in the trace"
    return sum(us)


def test_engages_on_order_keys_and_not_on_uniform_u64(card):
    """TPC-H-like order keys (1-7 rows an order, keys below 6e8, a float64
    value) narrow to 4 passes; Uniform u64 keys keep all 8, and there K8's
    full kernel returns at once: its time is a small share of a full
    read's at the same size."""
    g = torch.Generator(device=card)
    g.manual_seed(18)
    orders = torch.randint(1, 600_000_001, (BIG // 4,), generator=g,
                           device=card)
    rows = torch.randint(1, 8, (BIG // 4,), generator=g, device=card)
    lkeys = torch.repeat_interleave(orders, rows)
    u64 = torch.randint(-2**63, 2**63 - 1, (lkeys.numel(),), generator=g,
                        device=card).view(torch.uint64)
    for keys, narrowed, want in ((lkeys, 1, 4), (u64, 0, 8)):
        vals = torch.rand(keys.numel(), generator=g, device=card,
                          dtype=torch.float64)
        profiling.reset_counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            xla_sort.sort_arrays(keys, (vals,))
            torch.cuda.synchronize()
        assert profiling.COUNTERS["xla.pairs_narrowed"] == narrowed
        assert profiling.COUNTERS["xla.pairs_passes"] == want
    assert _k8_full_read_us(u64) < 0.2 * _k8_full_read_us(lkeys)


def test_below_the_floor_reads_nothing(card):
    n = cuda_sort.window_floor(16) - 1
    keys = torch.arange(n, device=card)
    cuda_sort.reset_launches()
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gk, (gv,) = xla_sort.sort_arrays(keys.flip(0), (keys,))
        torch.cuda.synchronize()
    assert cuda_sort.LAUNCHES == {"sort_pairs": 1, "key_bits": 0}
    assert "host_syncs.xla.bits" not in profiling.COUNTERS
    assert profiling.COUNTERS["xla.pairs_passes"] == 8
    same_bits(gk, keys)
    same_bits(gv, keys.flip(0))
