"""K9 on the card (`csrc/row_gather.cu`, `ops/cuda_rows.row_gather`): whole
rows by an index, byte for byte against the plain version, at row sizes
64, 24, 16, 12 and 9, on views off the 16-byte alignment and at ragged
row counts, and once past 2^32 output bytes (the 64-bit offsets); each
call one launch, in the vector width the wrapper picks.  Every test here
skips where there is no CUDA card.  On the card:

    python -m pytest tests/test_torch_row_gather_card.py -q -p no:cacheprovider --noconftest
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simd_radix_sort_tpu_torch.ops import cuda_rows
from simd_radix_sort_tpu_torch.utils import profiling

pytestmark = pytest.mark.card

N = 1 << 20
RAGGED = 1_000_003
BIG = (1 << 26) + 1003  # rows of 64 bytes: past 2^32 bytes written


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K9 is a hand-written kernel")
    return torch.device("cuda")


def random_bytes(count, card, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randint(0, 256, (count,), generator=g, dtype=torch.uint8,
                         device=card)


def index(n, rows, card, seed, repeats):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    if repeats:
        return torch.randint(0, rows, (n,), generator=g, device=card)
    return torch.randperm(rows, generator=g, device=card)[:n]


def held(rows, idx, width):
    """K9's rows[idx] against the plain version's; one launch, counted as
    `width` says."""
    assert cuda_rows.vector_width(rows.shape[1], rows.data_ptr(),
                                  1 << 21) == width
    cuda_rows.reset_launches()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = cuda_rows.row_gather(rows, idx)
    torch.cuda.synchronize()
    assert cuda_rows.LAUNCHES["row_gather"] == (1 if idx.numel() else 0)
    assert profiling.COUNTERS["row_gather.calls"] == (
        1 if idx.numel() else 0)
    assert profiling.COUNTERS["row_gather.narrow_calls"] == (
        1 if idx.numel() and width < 16 else 0)
    profiling.reset_counters()
    assert got.shape == (idx.numel(), rows.shape[1])
    assert torch.equal(got, cuda_rows.row_gather_plain(rows, idx))


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("n", [N, RAGGED])
@pytest.mark.parametrize("row_bytes,width", [(64, 16), (24, 8), (16, 16),
                                             (12, 4), (9, 1)])
def test_k9_equals_the_plain_version(card, row_bytes, width, n, repeats):
    rows = random_bytes(n * row_bytes, card, row_bytes).view(n, row_bytes)
    held(rows, index(n, n, card, n + row_bytes, repeats), width)


@pytest.mark.parametrize("offset,width", [(1, 1), (2, 2), (4, 4), (8, 8),
                                          (48, 16)])
@pytest.mark.parametrize("row_bytes", [64, 24])
def test_k9_on_views_off_the_alignment(card, row_bytes, offset, width):
    flat = random_bytes(RAGGED * row_bytes + 64, card, offset)
    rows = flat[offset:offset + RAGGED * row_bytes].view(RAGGED, row_bytes)
    held(rows, index(RAGGED - 5, RAGGED, card, offset, False),
         min(width, 8) if row_bytes == 24 else width)


def test_k9_on_no_rows(card):
    rows = random_bytes(64 * 10, card, 3).view(10, 64)
    held(rows, torch.empty(0, dtype=torch.int64, device=card), 16)


def test_k9_past_two_to_the_32_bytes(card):
    rows = random_bytes(BIG * 64, card, 5).view(BIG, 64)
    idx = index(BIG, BIG, card, 6, False)  # every row, read and written
    got = cuda_rows.row_gather(rows, idx)
    torch.cuda.synchronize()
    assert got.numel() > 1 << 32
    assert torch.equal(got, cuda_rows.row_gather_plain(rows, idx))
