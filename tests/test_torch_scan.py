"""The segmented scans' plain version (ops/cuda_scan.segmented_scans on CPU
tensors) against the JAX package's `_segmented_scan`
(`jax.lax.associative_scan` over (start flag, value) pairs), and what the
wrapper refuses.  The kernel itself runs on the card only:
test_torch_scan_card.py holds it against this plain version there.

The cases: n = 0, 1 and the kernel's tile (4096 rows) and one either side;
segments drawn at random, one segment over every row, and every row its own
segment; every (dtype, op) that group_aggregate hands the scans, with NaN,
-0.0 beside +0.0 and infinities among the floats and each integer carrier's
extremes.  Minimum, maximum and the carriers are compared exactly (values,
NaN equal to NaN); sums to the parity tests' rtol (test_torch_operators.py)
relative to the segment's running sum of magnitudes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_radix_sort_tpu.ops import hashagg as jhashagg
from simd_radix_sort_tpu_torch.ops import cuda_scan

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
NS = [0, 1, cuda_scan.TILE_ROWS - 1, cuda_scan.TILE_ROWS,
      cuda_scan.TILE_ROWS + 1]
KINDS = ["random", "one segment", "every row"]
JNP_OPS = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}
FLOATS = [(np.float64, torch.float64), (np.float32, torch.float32),
          (np.float16, torch.float16), (jnp.bfloat16, torch.bfloat16)]
INTS = [(np.int64, torch.int64), (np.int32, torch.int32),
        (np.int16, torch.int16), (np.int8, torch.int8)]
CASES = ([(np_dt, t_dt, "sum") for np_dt, t_dt in FLOATS[:2]] +
         [(np_dt, t_dt, op) for np_dt, t_dt in FLOATS + INTS
          for op in ("min", "max")])


@functools.partial(jax.jit, static_argnums=2)
def _jax_scan(vals, starts, op):
    return jhashagg._segmented_scan(vals, starts, JNP_OPS[op])


def _starts(n, kind, rng):
    if kind == "every row":
        return np.ones(n, bool)
    s = np.zeros(n, bool) if kind == "one segment" else rng.random(n) < 0.01
    s[:1] = True
    return s


def _values(np_dt, n, rng):
    """Values of the dtype with its special values planted: NaN, -0.0 and
    +0.0 side by side and infinities for floats, the extremes for
    integers."""
    if np.dtype(np_dt).kind == "i":
        info = np.iinfo(np_dt)
        v = rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)
        special = np.array([info.min, info.max, info.min, 0, info.max, -1],
                           np_dt)
    else:
        v = rng.normal(scale=100, size=n).astype(np.float32).astype(np_dt)
        special = np.array([-0.0, 0.0, np.nan, 0.0, -0.0, np.inf, -np.inf,
                            np.nan], np.float32).astype(np_dt)
    for at in rng.choice(max(n - len(special), 1), min(4, n), replace=False):
        take = special[:n - at]
        v[at:at + len(take)] = take
    return v


def _torch(a, t_dt):
    if t_dt == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_float64(t):
    return t.to(torch.float64).numpy()


def _magnitudes(v, starts):
    """Running sum of |v| within each segment (NaN counted as 0)."""
    a = np.nan_to_num(np.abs(v.astype(np.float64)), nan=0.0, posinf=0.0)
    c = np.cumsum(a)
    seg = np.maximum.accumulate(np.where(starts, np.arange(len(a)), 0))
    return c - (c[seg] - a[seg])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("np_dt,t_dt,op", CASES,
                         ids=[f"{t}-{op}" for _, t, op in CASES])
def test_plain_scan_matches_jax(np_dt, t_dt, op, n, kind):
    rng = np.random.default_rng(n * 7 + KINDS.index(kind))
    starts = _starts(n, kind, rng)
    vals = _values(np_dt, n, rng)
    (got,) = cuda_scan.segmented_scans([_torch(vals, t_dt)],
                                       torch.from_numpy(starts), [op])
    assert got.dtype == t_dt and got.shape == (n,)
    want = np.asarray(_jax_scan(vals, starts, op))
    if not t_dt.is_floating_point:
        assert np.array_equal(got.numpy(), want)
        return
    g, w = _as_float64(got), want.astype(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    if op != "sum":
        assert np.array_equal(g, w, equal_nan=True)
        return
    ok = ~np.isnan(w)
    inf = ok & np.isinf(w)
    assert np.array_equal(g[inf], w[inf])
    fin = ok & ~inf
    tol = RTOL[t_dt] * _magnitudes(vals, starts)[fin]
    assert np.all(np.abs(g[fin] - w[fin]) <= tol)


def test_streams_of_mixed_dtypes_and_ops_in_one_call():
    """Each stream is scanned with its own op, whatever its neighbours'."""
    rng = np.random.default_rng(5)
    n = 3000
    starts = _starts(n, "random", rng)
    streams = [_values(np.float64, n, rng), _values(np.int16, n, rng),
               _values(np.float64, n, rng), _values(np.float32, n, rng)]
    ops = ["sum", "max", "min", "sum"]
    got = cuda_scan.segmented_scans(
        [torch.from_numpy(v) for v in streams], torch.from_numpy(starts), ops)
    for g, v, op in zip(got, streams, ops):
        (alone,) = cuda_scan.segmented_scans(
            [torch.from_numpy(v)], torch.from_numpy(starts), [op])
        assert torch.equal(g.view(torch.uint8), alone.view(torch.uint8))


@pytest.mark.parametrize("dtype,op", [
    (torch.int32, "sum"), (torch.int64, "sum"), (torch.uint8, "min"),
    (torch.bool, "max"), (torch.complex64, "sum"), (torch.float64, "mean")])
def test_refuses_what_the_kernel_does_not_take(dtype, op):
    assert not cuda_scan.supported(dtype, op)
    with pytest.raises(TypeError, match="no segmented"):
        cuda_scan.segmented_scans([torch.zeros(8, dtype=dtype)],
                                  torch.ones(8, dtype=torch.bool), [op])


def test_refuses_mismatched_inputs():
    starts = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError, match="bool"):
        cuda_scan.segmented_scans([torch.zeros(8)], starts.to(torch.uint8),
                                  ["sum"])
    with pytest.raises(ValueError, match="one op"):
        cuda_scan.segmented_scans([torch.zeros(8)], starts, [])
    with pytest.raises(ValueError, match="match"):
        cuda_scan.segmented_scans([torch.zeros(7)], starts, ["sum"])


def test_no_streams_scans_nothing():
    assert cuda_scan.segmented_scans([], torch.ones(5, dtype=torch.bool),
                                     []) == []


def test_plain_scan_runs_ceil_log2_n_passes(monkeypatch):
    """A fixed number of doubling passes, read from n alone: no host read
    of the flags decides when to stop."""
    passes = []
    real = torch.where

    def counting_where(*a, **k):
        passes.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch, "where", counting_where)
    for n, want in [(0, 0), (1, 0), (2, 1), (3, 2), (4096, 12), (4097, 13)]:
        passes.clear()
        cuda_scan.segmented_scans([torch.zeros(n)],
                                  torch.ones(n, dtype=torch.bool), ["sum"])
        assert len(passes) == want, n


def test_k7_bytes_rule():
    # Q1's shape: five float64 sums over 1.76e8 rows, one launch
    n = 176_000_000
    assert cuda_scan.k7_bytes(n, 5, 8) == 2 * n + 120 * n
    assert cuda_scan.k7_bytes(0, 3, 4) == 0
