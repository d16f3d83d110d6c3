"""K1-K6, the counting and partition kernels (csrc/hist_kernels.cu,
csrc/partition_kernels.cu), on the card against their plain versions
(ops/cuda_hist.py, ops/cuda_partition.py, run on the same card tensors),
exactly: each is an integer function.  The kernels have no interpret mode,
so every test here skips where there is no CUDA card.  On the card:

    python -m pytest tests/test_torch_kernels_card.py -q -p no:cacheprovider --noconftest

(`--noconftest`: the suite's conftest sets JAX up, and nothing here needs
it).  The main size N = 2^24 rows puts many waves of blocks on the card;
RAGGED rows are read from an offset, misaligned view.  K2 and K3 also run
at 10^8 rows of one residue, more than any per-thread counter holds.
K7 has its own file (test_torch_scan_card.py).
"""

import zlib

import pytest
import torch

from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                           cuda_partition as cp)
from simd_radix_sort_tpu_torch.workloads import kernel_ab
from simd_radix_sort_tpu_torch.workloads.common import signed

pytestmark = pytest.mark.card

N = 1 << 24
RAGGED = 1_000_003
BIG = 100_000_000  # rows of one residue in K2/K3's largest edge case
SEED = 42
SIZES = pytest.mark.parametrize("ragged", [False, True], ids=["n", "ragged"])
WIDTHS = pytest.mark.parametrize("width", [1, 2, 4])
KS = pytest.mark.parametrize("k", [16, 256, 1024])


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1-K6 run on the card only")
    return torch.device("cuda")


@pytest.fixture
def randint(card, request):
    """int64 draws on the card, seeded by the test's name."""
    gen = torch.Generator(device=card)
    gen.manual_seed(zlib.crc32(request.node.name.encode()))

    def draw(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=card,
                             dtype=torch.int64)
    return draw


@pytest.fixture(scope="module")
def zipf(card):
    """Zipf(1.1) ranks mod 1000 as int16, N + 1 of them: K1's skewed
    input."""
    keys = kernel_ab.k1_keys("int32", "zipf", N + 1, SEED)
    return torch.from_numpy(keys).to(device=card, dtype=torch.int16)


def as_width(v, width):
    """int64 values -> carrier of `width` bytes holding their low bits."""
    bits = v & ((1 << (8 * width)) - 1)
    half = 1 << (8 * width - 1)
    return torch.where(bits >= half, bits - 2 * half, bits).to(
        {1: torch.int8, 2: torch.int16, 4: torch.int32}[width])


def hold(got, want, what):
    """Each output of a kernel equal to its plain version's, as int64."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.reshape(-1).to(torch.int64), w.reshape(-1).to(torch.int64)
        assert g.shape == w.shape and torch.equal(g, w), \
            f"{what} output {i}: kernel differs from its plain version"


def rows(ragged):
    return RAGGED if ragged else N


def view(v, ragged):
    """The first N of N + 1 rows, or the RAGGED rows from offset 1 (a
    misaligned view)."""
    return v[1:] if ragged else v[:N]


def k1_inputs(size: int, k: int, zipf, randint, dev) -> dict:
    """label -> int64 offsets from a histogram's base, size + 1 of them
    (the misaligned view drops the first), that can break K1: every row in
    one bucket, two buckets, sorted and reverse-sorted runs, Zipf(1.1)
    ranks mod 1000 (`zipf`, int16, at least size + 1 of them), buckets
    holding exactly 255, 256 and 65,536 rows in runs, and values outside
    [0, k) on both sides, which must drop out."""
    m = size + 1
    edge = randint(-8, k + 8, m)
    exact = randint(0, k, m) % max(1, k - 3) + 3  # no row in buckets 0-2
    at = 1 + int(randint(0, max(1, m - 66_048), 1).item())
    runs = torch.repeat_interleave(
        torch.arange(3, device=dev),
        torch.tensor([255, 256, 65_536], device=dev))[:m - at]
    exact[at:at + runs.numel()] = runs
    return {"one value": torch.full((m,), k // 2, dtype=torch.int64,
                                    device=dev),
            "two values": randint(0, 2, m) * (k - 1),
            "sorted": torch.sort(edge).values,
            "reverse-sorted": torch.sort(edge, descending=True).values,
            "zipf": zipf[:m].to(torch.int64),
            "exactly 255, 256, 65536": exact,
            "outside [base, base + k)": randint(-2 * k, 3 * k, m)}


def k23_bare(v, flip: int, tile: int, dev):
    """K2, then K3's fill with a tile of `tile` bytes, as bare launches past
    the wrappers (and their launch counts): the stats and the output."""
    stats = torch.empty(ch.STATS_WORDS, dtype=torch.int32, device=dev)
    out = torch.empty_like(v)
    w, size = v.element_size(), v.numel()
    _build.launch("srs_minmax_hist16", dev, v.data_ptr(), w, size, flip,
                  stats.data_ptr())
    _build.launch("srs_fill16", dev, stats.data_ptr(), w, size, flip, tile,
                  out.data_ptr())
    return stats, out


def fill_at_tile(hist, size, base, dtype, tile, dev):
    """K4 launched with a tile of `tile` bytes, or K6 for dtype None, past
    the wrappers (and their launch counts)."""
    out = torch.empty(size, dtype=dtype or torch.uint8, device=dev)
    if dtype is None:
        _build.launch("srs_fill_runs_packed", dev, hist.data_ptr(),
                      hist.numel(), size, tile, out.data_ptr())
    else:
        w = out.element_size()
        _build.launch("srs_fill_runs", dev, hist.data_ptr(), hist.numel(),
                      size, base & ((1 << (8 * w)) - 1), w, tile,
                      out.data_ptr())
    return out


# ---- K1: histogram ---------------------------------------------------------


@SIZES
@KS
@WIDTHS
def test_k1_matches_plain(card, randint, width, k, ragged):
    size = rows(ragged)
    base = int(randint(0, 1 << (8 * width), 1).item())
    x = view(as_width(base + randint(-8, k + 8, size + 1), width), ragged)
    hold((ch.histogram(x, k, base),), (ch.histogram_plain(x, k, base),),
         f"w={width} k={k} n={size}")


@SIZES
@KS
@WIDTHS
def test_k1_on_inputs_that_could_break_its_counters(card, randint, zipf,
                                                    width, k, ragged):
    size = rows(ragged)
    base = int(randint(0, 1 << (8 * width), 1).item())
    for label, off in k1_inputs(size, k, zipf, randint, card).items():
        x = view(as_width(base + off, width), ragged)
        hold((ch.histogram(x, k, base),), (ch.histogram_plain(x, k, base),),
             f"{label} w={width} k={k} n={size}")


# ---- K2 and K3: min, max and residue histogram; the tiny-range sort -------

# (lo, carrier bytes, flip, span): windows straddling 2^31 and 2^32, a
# 2-byte carrier ordered through its sign flip, and one wide range (out of
# contract: the stats stay exact, the output is defined)
WINDOWS = ((0, 4, 0, 16), (2**31 - 5, 4, 0, 16), (2**32 - 16, 4, 0, 16),
           (0x7FF9, 2, 0x8000, 16), (0, 4, 0x80000000, 1 << 32))


@SIZES
@pytest.mark.parametrize("lo,width,flip,span", WINDOWS)
def test_k2_k3_match_plain(card, randint, lo, width, flip, span, ragged):
    size = rows(ragged)
    mask = (1 << (8 * width)) - 1
    u = (lo + randint(0, span, size)) & mask
    v = as_width(u ^ flip, width)
    hold(ch.minmax_hist16(v, flip), ch.minmax_hist16_plain(v, flip),
         f"minmax_hist16 lo={lo} n={size}")
    got = ch.tiny_sort16(v, flip)
    hold(got, ch.tiny_sort16_plain(v, flip), f"tiny_sort16 lo={lo} n={size}")
    if span <= 16:  # in contract: the output is the sorted input
        s = (signed(got[0]).to(torch.int64) & mask) ^ flip
        assert torch.equal(s, torch.sort(u).values), \
            f"tiny_sort16 lo={lo}: not sorted"


@pytest.mark.parametrize("width", [2, 4])
def test_k2_k3_on_every_path_of_their_kernels(card, width):
    """cuda_hist.k23_edge_cases with BIG rows of one residue: through the
    wrappers, and K3 also as bare launches at a 64-byte tile, where runs
    meet many tiles' edges."""
    for label, (c, flip, start) in ch.k23_edge_cases(width, BIG).items():
        v = torch.from_numpy(c).to(card)[start:]
        want = ch.minmax_hist16_plain(v, flip)
        hold(ch.minmax_hist16(v, flip), want, f"{label} w={width}")
        sorted_want = ch.tiny_sort16_plain(v, flip)
        hold(ch.tiny_sort16(v, flip), sorted_want, f"{label} w={width}")
        stats, out = k23_bare(v, flip, 64, card)
        hold((out, stats[:2].to(torch.int64) & 0xFFFFFFFF, stats[2:18]),
             (sorted_want[0], torch.stack(want[:2]), want[2]),
             f"{label} w={width} tile=64")


# ---- K4: the run fill -------------------------------------------------------


@pytest.mark.parametrize("ragged,k,dtype,base", [
    (False, 256, torch.int8, 0x80), (False, 1024, torch.int32, 77),
    (True, 1024, torch.int16, 0x7FF0)])
def test_k4_matches_plain(card, randint, ragged, k, dtype, base):
    size = rows(ragged)
    hist = torch.bincount(randint(0, k, size), minlength=k).to(torch.int32)
    hold((ch.fill_runs(hist, size, base, dtype),),
         (ch.fill_runs_plain(hist, size, base, dtype),), f"k={k} n={size}")


@pytest.mark.parametrize("hist_list,dtype", [
    ([3] * 512, torch.int32), ([0, 5, 0, 0, 2, 0], torch.uint8),
    ([0] * 100 + [None] + [0] * 100, torch.int16)],
    ids=["uniform", "empty buckets", "one bucket"])
def test_k4_on_skewed_and_empty_histograms(card, hist_list, dtype):
    hist_list = [N if c is None else c for c in hist_list]  # None: N rows
    hist = torch.tensor(hist_list, dtype=torch.int32, device=card)
    size = int(sum(hist_list))
    hold((ch.fill_runs(hist, size, 3, dtype),),
         (ch.fill_runs_plain(hist, size, 3, dtype),),
         f"k={len(hist_list)}")


@pytest.mark.parametrize("width,dtype,base", [
    (1, torch.int8, 0x80), (2, torch.int16, 0x7FF0), (4, torch.int32, 77)])
def test_k4_where_runs_meet_the_tiles_edges(card, width, dtype, base):
    """At the wrappers' tile and at a 64-byte tile, where most runs of
    cuda_hist.tile_edge_cases span whole tiles."""
    for label, (h, size) in ch.tile_edge_cases(width).items():
        hist = torch.from_numpy(h).to(card)
        want = (ch.fill_runs_plain(hist, size, base, dtype),)
        hold((ch.fill_runs(hist, size, base, dtype),), want,
             f"{label} {dtype} n={size}")
        hold((fill_at_tile(hist, size, base, dtype, 64, card),), want,
             f"{label} {dtype} n={size} tile=64")


# ---- K5: the stable two-way partition -------------------------------------

MASKS = ("all False", "all True", "alternating", "random")


def words(randint, size, width):
    """size random words of `width` bytes, from offset 1 of their
    buffer."""
    if width == 8:
        return randint(-(2**62), 2**62, size + 1)[1:]
    return randint(-(2**31), 2**31 - 1, size + 1).to(torch.int32)[1:]


def k5_mask(randint, pattern, ragged, dev):
    size = rows(ragged)
    idx = torch.arange(size + 1, device=dev)
    m = {"all False": lambda: idx < 0, "all True": lambda: idx >= 0,
         "alternating": lambda: idx % 2 == 1,
         "random": lambda: randint(0, 2, size + 1) == 1}[pattern]()
    return view(m, ragged)


@SIZES
@pytest.mark.parametrize("pattern", MASKS)
@pytest.mark.parametrize("widths", [(8,), (8, 4), (8, 4, 8, 4)],
                         ids=["1 stream", "2 streams", "4 streams"])
def test_k5_matches_plain(card, randint, widths, pattern, ragged):
    """1, 2 and 4 streams of 8- and 4-byte words; the ragged size reads a
    misaligned mask and also runs the smallest tile."""
    size = rows(ragged)
    streams = [words(randint, size, w) for w in widths]
    mk = k5_mask(randint, pattern, ragged, card)
    for block in (256, cp.PART_BLOCK) if ragged else (cp.PART_BLOCK,):
        hold(cp.partition_pass(streams, mk, block=block),
             cp.partition_pass_plain(streams, mk),
             f"{pattern} widths={widths} n={size} block={block}")


@pytest.mark.parametrize("pattern", MASKS)
def test_k5_moves_nine_streams_in_two_scatter_launches(card, randint,
                                                       pattern):
    """More streams than one scatter launch moves: the second launch's
    streams land beside the first's."""
    streams = [words(randint, RAGGED, w) for w in (8, 4) * 4 + (8,)]
    mk = k5_mask(randint, pattern, True, card)
    cp.reset_launches()
    got = cp.partition_pass(streams, mk)
    assert cp.LAUNCHES["partition_pass"] == 1
    hold(got, cp.partition_pass_plain(streams, mk),
         f"{pattern} 9 streams n={RAGGED}")


# ---- K6: the packed uint8 run fill ------------------------------------------


def test_k6_where_runs_meet_the_tiles_edges(card):
    """Against its plain version and K4's uint8 output, at the wrappers'
    tile and at a 64-byte tile."""
    for label, (h, size) in ch.tile_edge_cases(1, ch.MAX_PACKED_K).items():
        hist = torch.from_numpy(h).to(card)
        size -= size % 4
        want = (ch.fill_runs_packed_plain(hist, size),)
        got = ch.fill_runs_packed(hist, size)
        hold((got,), want, f"{label} n={size}")
        hold((got,), (ch.fill_runs(hist, size, 0, torch.uint8),),
             f"{label} n={size} against K4")
        hold((fill_at_tile(hist, size, 0, None, 64, card),), want,
             f"{label} n={size} tile=64")


@pytest.mark.parametrize("shape", ["uniform", "one bucket", "halving",
                                   "empty buckets", "ragged uniform"])
def test_k6_matches_plain_and_k4(card, randint, shape):
    """Uniform, skewed (one bucket; halving counts) and empty-bucket
    histograms."""
    n4 = N - N % 4
    halving = [n4 >> (b + 1) for b in range(255)]
    hist = {
        "uniform": lambda: torch.bincount(randint(0, 256, n4),
                                          minlength=256),
        "one bucket": lambda: torch.tensor([0] * 100 + [n4] + [0] * 155),
        "halving": lambda: torch.tensor(halving + [n4 - sum(halving)]),
        "empty buckets": lambda: torch.tensor([0, 5, 0, 0, 3, 0]),
        "ragged uniform": lambda: torch.bincount(
            randint(0, 256, RAGGED + 1), minlength=256),
    }[shape]().to(device=card, dtype=torch.int32)
    size = int(hist.sum().item())
    got = ch.fill_runs_packed(hist, size)
    hold((got,), (ch.fill_runs_packed_plain(hist, size),),
         f"{shape} n={size}")
    hold((got,), (ch.fill_runs(hist, size, 0, torch.uint8),),
         f"{shape} n={size} against K4")
