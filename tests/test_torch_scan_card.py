"""K7, the segmented-scan kernel (csrc/scan_kernels.cu), on the card against
its plain version (ops/cuda_scan.segmented_scans_plain, run on the same
card tensors).  The kernel has no interpret mode, so every test here skips
where there is no CUDA card.  On the card:

    python -m pytest tests/test_torch_scan_card.py -q -p no:cacheprovider --noconftest

(`--noconftest`: the suite's conftest sets JAX up, and nothing here needs
it).  Each output is held by `k7_hold`: minimum, maximum and the
integer carriers exactly (values, NaN equal to NaN); float32 and
float64 sums to the parity tests' rtol (test_torch_operators.py) relative
to the segment's running sum of magnitudes; 2-byte float sums exactly, on
values whose every partial sum is exact in either order.
"""

import pytest
import torch

from simd_radix_sort_tpu_torch.ops import cuda_scan, hashagg
from simd_radix_sort_tpu_torch.utils import profiling

pytestmark = pytest.mark.card

TILE = cuda_scan.TILE_ROWS
SPINE_ROUND = 1024 * 16 * TILE  # rows whose tiles one spine round scans
Q1_ROWS = 176_000_000           # Q1's rows at SF30, in 4 groups
FLOATS = (torch.float64, torch.float32, torch.float16, torch.bfloat16)
INTS = (torch.int64, torch.int32, torch.int16, torch.int8)
CASES = ([(dt, "sum") for dt in FLOATS] +
         [(dt, op) for dt in FLOATS + INTS for op in ("min", "max")])
KINDS = ("random", "one segment", "every row")
K7_RTOL = {"float32": 1e-5, "float64": 1e-12}  # the parity tests' rtol


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 runs on the card only")
    return torch.device("cuda")


def _starts(n, kind, g, device, segments=None):
    if kind == "every row":
        return torch.ones(n, dtype=torch.bool, device=device)
    s = torch.zeros(n, dtype=torch.bool)
    if kind == "random":
        if segments is None:
            s = torch.rand(n, generator=g) < 0.01
        else:
            s[torch.randperm(n, generator=g)[:segments - 1]] = True
    s[:1] = True
    return s.to(device)


def _values(dtype, op, n, g, device):
    """Seeded values with the dtype's special values planted: NaN, -0.0
    beside +0.0 and infinities for floats, the extremes for integers.  A
    2-byte float sum gets 100 ones among zeros."""
    if dtype in INTS:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (n,), generator=g,
                          dtype=torch.int64).to(dtype)
        special = torch.tensor([info.min, info.max, info.min, 0, info.max,
                                -1], dtype=torch.int64).to(dtype)
    elif op == "sum" and dtype.itemsize == 2:
        v = torch.zeros(n, dtype=dtype)
        v[torch.randperm(n, generator=g)[:100]] = 1
        return v.to(device)
    else:
        v = (torch.randn(n, generator=g) * 100).to(dtype)
        nan, inf = float("nan"), float("inf")
        special = torch.tensor([-0.0, 0.0, nan, 0.0, -0.0, inf, -inf, nan],
                               dtype=torch.float32).to(dtype)
        if op == "sum":
            special = special[:5]
    at = torch.randperm(max(n - len(special), 1), generator=g)[:min(4, n)]
    for a in at.tolist():
        take = special[:n - a]
        v[a:a + len(take)] = take
    return v.to(device)


def k7_hold(got, want, vals, starts, ops, what: str) -> None:
    """K7's outputs against its plain version's: integers, minimum and
    maximum exactly (NaN where NaN); float32 and float64 sums within the
    tests' rtol of the segment's running sum of magnitudes; 2-byte float
    sums exactly (on values whose partial sums are exact in any order).
    Row 0 must start a segment."""
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    first = torch.nonzero(starts).flatten()
    for q, (a, b, v, op) in enumerate(zip(got, want, vals, ops)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"K7 {what} stream {q}: {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        if not a.dtype.is_floating_point:
            same = torch.equal(a, b)
        else:
            x, y = a.to(torch.float64), b.to(torch.float64)
            same = torch.equal(x.isnan(), y.isnan())
            ok = ~y.isnan()
            if op != "sum" or a.dtype.itemsize == 2:
                same = same and torch.equal(x[ok], y[ok])
            else:
                inf = ok & y.isinf()
                fin = ok & ~inf
                m = torch.nan_to_num(v.to(torch.float64).abs(), nan=0.0,
                                     posinf=0.0)
                c = torch.cumsum(m, 0)
                run = c - (c - m)[first][seg.clamp_min(0)]
                rtol = K7_RTOL[str(a.dtype).split(".")[1]]
                same = same and torch.equal(x[inf], y[inf]) and bool(
                    ((x - y).abs()[fin] <= rtol * run[fin]).all())
        if not same:
            raise AssertionError(f"K7 {what} stream {q} ({a.dtype} {op}): "
                                 "kernel differs from its plain version")


def _hold(got, want, v, starts, op):
    k7_hold([got], [want], [v], starts, [op], op)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 17, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 5, (1 << 20) + 3])
@pytest.mark.parametrize("dtype,op", CASES,
                         ids=[f"{dt}-{op}" for dt, op in CASES])
def test_k7_matches_plain(card, dtype, op, n, kind):
    g = torch.Generator().manual_seed(n * 3 + KINDS.index(kind))
    starts = _starts(n, kind, g, card)
    v = _values(dtype, op, n, g, card)
    (got,) = cuda_scan.segmented_scans([v], starts, [op])
    (want,) = cuda_scan.segmented_scans_plain([v], starts, [op])
    _hold(got, want, v, starts, op)


@pytest.mark.parametrize("dtype,op", [(torch.int8, "max"),
                                      (torch.float32, "sum")])
def test_k7_over_more_than_one_spine_round(card, dtype, op):
    n = SPINE_ROUND + TILE + 1
    g = torch.Generator().manual_seed(9)
    starts = _starts(n, "random", g, card, segments=5)
    v = _values(dtype, op, n, g, card)
    (got,) = cuda_scan.segmented_scans([v], starts, [op])
    (want,) = cuda_scan.segmented_scans_plain([v], starts, [op])
    _hold(got, want, v, starts, op)


def test_k7_streams_of_mixed_dtypes_share_launches(card):
    n = 5 * TILE + 7
    g = torch.Generator().manual_seed(2)
    starts = _starts(n, "random", g, card)
    specs = [(torch.float64, "sum"), (torch.int16, "max"),
             (torch.float64, "sum"), (torch.float64, "min"),
             (torch.float64, "sum")] + [(torch.int32, "min")] * 9
    vals = [_values(dt, op, n, g, card) for dt, op in specs]
    ops = [op for _, op in specs]
    cuda_scan.reset_launches()
    got = cuda_scan.segmented_scans(vals, starts, ops)
    # f64 sums, i16 max, f64 min, then nine i32 mins in two launches
    assert cuda_scan.LAUNCHES["segmented_scan"] == 5
    want = cuda_scan.segmented_scans_plain(vals, starts, ops)
    for a, b, v, op in zip(got, want, vals, ops):
        _hold(a, b, v, starts, op)


def test_k7_at_q1_shape_and_bit_identical_run_to_run(card):
    """Q1 at SF30: 1.76e8 rows in 4 groups, five float64 sums, one launch."""
    g = torch.Generator(device=card).manual_seed(1)
    starts = torch.zeros(Q1_ROWS, dtype=torch.bool, device=card)
    starts[torch.tensor([0, 44_000_017, 88_000_003, 131_999_989])] = True
    vals = [torch.rand(Q1_ROWS, generator=g, dtype=torch.float64,
                       device=card) * 10 ** (k + 1) for k in range(5)]
    ops = ["sum"] * 5
    cuda_scan.reset_launches()
    first = cuda_scan.segmented_scans(vals, starts, ops)
    again = cuda_scan.segmented_scans(vals, starts, ops)
    assert cuda_scan.LAUNCHES["segmented_scan"] == 2
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    for a, v in zip(first, vals):
        (want,) = cuda_scan.segmented_scans_plain([v], starts, ["sum"])
        _hold(a, want, v, starts, "sum")
        del want


def test_k7_takes_misaligned_views(card):
    n = 3 * TILE + 11
    g = torch.Generator().manual_seed(4)
    base = _values(torch.float64, "min", n + 1, g, card)
    starts = _starts(n + 1, "random", g, card)[1:]
    v = base[1:]
    assert v.data_ptr() % 16 and starts.data_ptr() % 16
    (got,) = cuda_scan.segmented_scans([v], starts, ["min"])
    (want,) = cuda_scan.segmented_scans_plain([v], starts, ["min"])
    _hold(got, want, v, starts, "min")


@pytest.mark.parametrize("dtype,op", [
    (torch.int32, "sum"), (torch.uint8, "min"), (torch.bool, "max"),
    (torch.complex64, "sum")])
def test_k7_refuses_unsupported_dtypes(card, dtype, op):
    cuda_scan.reset_launches()
    with pytest.raises(TypeError, match="no segmented"):
        cuda_scan.segmented_scans(
            [torch.zeros(8, dtype=dtype, device=card)],
            torch.ones(8, dtype=torch.bool, device=card), [op])
    assert cuda_scan.LAUNCHES["segmented_scan"] == 0


def test_group_aggregate_scans_through_k7(card):
    """Q1's aggregate on the card: one K7 launch for its five float64 sums,
    counted while a profiler records, and the CPU's answer."""
    n = 1_000_003
    g = torch.Generator().manual_seed(6)
    keys = torch.randint(0, 4, (n,), generator=g, dtype=torch.int8)
    vals = [torch.rand(n, generator=g, dtype=torch.float64) * 1000
            for _ in range(5)]
    kw = dict(aggs=("sum", "mean", "count"),
              agg_streams=((0, 1, 2, 3), (0, 1, 4), ()), max_groups=6)
    cuda_scan.reset_launches()
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ng, gk, res = hashagg.group_aggregate(
            keys.to(card), tuple(v.to(card) for v in vals), **kw)
    assert cuda_scan.LAUNCHES["segmented_scan"] == 1
    assert profiling.COUNTERS["hashagg.scan.k7_launches"] == 1
    assert profiling.COUNTERS["hashagg.scan.k7_bytes"] == \
        cuda_scan.k7_bytes(n, 5, 8)
    assert not any(k.startswith("host_syncs.hashagg") for k in
                   profiling.COUNTERS)
    profiling.reset_counters()
    ng0, gk0, res0 = hashagg.group_aggregate(keys, tuple(vals), **kw)
    assert int(ng) == int(ng0) == 4
    assert torch.equal(gk.cpu()[:4], gk0[:4])
    for got, want in zip(res, res0):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            a, b = a.cpu()[:4], b[:4]
            if a.dtype.is_floating_point:
                assert torch.allclose(a, b, rtol=1e-12, atol=0)
            else:
                assert torch.equal(a, b)
