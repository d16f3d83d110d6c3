"""cub's pair sort (csrc/sort_pairs*.cu, ops/cuda_sort.py) on the card
against its plain version (`cuda_sort.sort_pairs_plain`, run on the same
card tensors), and the xla engine's one-payload route through it against
the same route on the CPU.  The library call has no CPU version, so every
test here skips where there is no CUDA card.  On the card:

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
                      k.data_ptr(), k.data_ptr(), k.data_ptr(), 4,
                      k.data_ptr(), 4)


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
