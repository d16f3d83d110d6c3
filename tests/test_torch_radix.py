"""The port's radix engine (ops/radix.py) against the JAX package's, on the
CPU, byte for byte.

All three movers are stable LSD sorts, so each one's output is THE stable
sort by key: keys and payloads must equal the JAX package's exactly.  Each
mover of the port is held against the JAX `sort` mover (XLA's stable
variadic sort; cheap on the CPU) over every digit width, and also against
the JAX mover of its own kind where that runs in reasonable time: the JAX
`scatter` mover once per key dtype, the JAX `pallas` mover (interpret mode)
on two narrow-key cases.  The port's `pallas` mover runs K5's plain version
here; tests/test_torch_paths_card.py runs the kernel.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import simd_radix_sort_tpu as jsrs
import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu.ops import radix as jradix
from simd_radix_sort_tpu_torch import methods as tmethods
from simd_radix_sort_tpu_torch.ops import cuda_partition, radix
from simd_radix_sort_tpu_torch.utils import interop

KEY_DTYPES = [np.uint8, np.int16, np.uint32, np.int32, np.float32,
              np.uint64, np.int64, np.float64]
PAYLOAD_DTYPES = (np.uint8, np.int16, np.float32, np.uint64)  # 1, 2, 4, 8 B
N = 1000


def _np(t):
    return interop.to_numpy(t)


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _random_bits(rng, n, dtype):
    """Any bit pattern (NaN payloads and -0.0 for floats), with a run of
    duplicated keys so that stability shows."""
    w = np.dtype(dtype).itemsize
    a = rng.integers(0, 256, n * w, dtype=np.uint8).view(dtype).copy()
    a[n // 2:n // 2 + n // 5] = a[:n // 5]
    return a


def _data(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    keys = _random_bits(rng, n, dtype)
    pays = tuple(_random_bits(rng, n, p) for p in PAYLOAD_DTYPES)
    return keys, pays


def _port(keys, pays, **kw):
    k, ps = radix.sort_arrays(interop.from_numpy(keys, "cpu"),
                              tuple(interop.from_numpy(p, "cpu")
                                    for p in pays), **kw)
    return (_np(k),) + tuple(_np(p) for p in ps)


def _jax(keys, pays, **kw):
    k, ps = jradix.sort_arrays(jnp.asarray(keys),
                               tuple(jnp.asarray(p) for p in pays), **kw)
    return (np.asarray(k),) + tuple(np.asarray(p) for p in ps)


def _assert_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert _bytes_equal(g, w), (what, i)


@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("engine", radix.ENGINES)
def test_mover_matches_jax(engine, dtype):
    keys, pays = _data(dtype)
    digit_widths = (None,) if engine == "pallas" else (None, 8, 12)
    for asc in (True, False):
        want = _jax(keys, pays, ascending=asc)
        for db in digit_widths:
            got = _port(keys, pays, ascending=asc, digit_bits=db,
                        engine=engine)
            _assert_equal(got, want, (asc, db))
    if engine == "scatter":
        # against the JAX scatter mover too, with a chunk that does not
        # divide n, so the per-bucket counts carry across chunks
        got = _port(keys, pays, engine="scatter", block=97)
        _assert_equal(got, _jax(keys, pays, engine="scatter"), "scatter")


@pytest.mark.parametrize("dtype,n,asc", [(np.uint8, 300, False),
                                         (np.int16, 200, True)],
                         ids=["uint8-desc", "int16-asc"])
def test_pallas_mover_matches_jax_pallas_in_interpret_mode(dtype, n, asc):
    keys, pays = _data(dtype, n, seed=1)
    pays = pays[1:3]
    want = _jax(keys, pays, ascending=asc, engine="pallas", interpret=True)
    got = _port(keys, pays, ascending=asc, engine="pallas", block=256)
    _assert_equal(got, want, "pallas")


@pytest.mark.parametrize("dtype,passes", [(np.uint8, 1), (np.int16, 1),
                                          (np.float32, 2), (np.uint64, 2),
                                          (np.float64, 2)],
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_sort_mover_digit_width_follows_the_key_width(monkeypatch, dtype,
                                                      passes):
    """16-bit digits, 32-bit for 64-bit keys, capped at the key's width:
    the JAX package's pass counts, with a 64-bit key held as one word."""
    calls = []
    real = radix._sort_digit

    def spy(c, shift, b):
        calls.append((shift, b))
        return real(c, shift, b)

    monkeypatch.setattr(radix, "_sort_digit", spy)
    keys, _ = _data(dtype, 64)
    radix.sort_arrays(interop.from_numpy(keys, "cpu"), ())
    assert len(calls) == passes
    width = 8 * np.dtype(dtype).itemsize
    assert sum(b for _, b in calls) == width


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint64],
                         ids=lambda d: np.dtype(d).name)
def test_pallas_mover_runs_one_partition_per_key_bit(monkeypatch, dtype):
    calls = []
    real = cuda_partition.partition_pass

    def spy(streams, mask, **kw):
        calls.append(len(streams))
        return real(streams, mask, **kw)

    monkeypatch.setattr(cuda_partition, "partition_pass", spy)
    keys, pays = _data(dtype, 64)
    radix.sort_arrays(interop.from_numpy(keys, "cpu"),
                      (interop.from_numpy(pays[0], "cpu"),), engine="pallas")
    assert calls == [2] * (8 * np.dtype(dtype).itemsize)


def test_movers_take_empty_and_single_inputs():
    for engine in radix.ENGINES:
        for n in (0, 1):
            keys, pays = _data(np.int32, n)
            got = _port(keys, pays[:1], engine=engine)
            _assert_equal(got, (keys, pays[0]), (engine, n))


def test_engine_arguments_are_checked():
    keys = interop.from_numpy(np.arange(8, dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="digit_bits does not apply"):
        radix.sort_arrays(keys, (), engine="pallas", digit_bits=8)
    with pytest.raises(ValueError, match="unknown radix engine"):
        radix.sort_arrays(keys, (), engine="bogus")
    with pytest.raises(ValueError, match="digit_bits"):
        radix.sort_arrays(keys, (), engine="scatter", digit_bits=20)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64,
                                   np.int8, np.int16, np.int32, np.int64,
                                   np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_sort_method_radix_matches_jax(dtype):
    """sort(method="radix") through the registry, with and without
    payloads and with a SortConfig's digit width, against the JAX
    package's sort(method="radix"): stable, so byte for byte."""
    keys, pays = _data(dtype, seed=2)
    for asc in (True, False):
        for ps in ((), pays[2:], pays):
            want = jsrs.sort(keys, *ps, ascending=asc, method="radix")
            got = tsrs.sort(keys, *ps, ascending=asc, method="radix",
                            device="cpu")
            if not ps:
                want, got = (want,), (got,)
            _assert_equal([_np(g) for g in got], want, (asc, len(ps)))
    cfg = dict(method="radix", digit_bits=8, ascending=False)
    want = jsrs.sort(keys, pays[0], config=jsrs.SortConfig(**cfg))
    got = tsrs.sort(keys, pays[0], config=tsrs.SortConfig(**cfg),
                    device="cpu")
    _assert_equal([_np(g) for g in got], want, "config")


@pytest.mark.parametrize("key_dtype,payload_dtypes", [
    (np.uint8, ()), (np.int16, (np.uint8,)), (np.float32, (np.float64,)),
    (np.uint64, (np.uint64, np.int8)), (np.float64, (np.int32, np.uint16))])
def test_sort_packed_method_radix_matches_jax(key_dtype, payload_dtypes):
    rng = np.random.default_rng(4)
    keys = _random_bits(rng, N, key_dtype)
    packed = tsrs.pack_rows(keys, tuple(_random_bits(rng, N, d)
                                        for d in payload_dtypes))
    for asc in (True, False):
        want = np.asarray(jsrs.sort_packed(packed, key_dtype, ascending=asc,
                                           method="radix"))
        got = _np(tsrs.sort_packed(packed, key_dtype, ascending=asc,
                                   method="radix", device="cpu"))
        assert _bytes_equal(got, want), asc


def test_radix_is_registered():
    assert "radix" not in tmethods.NOT_YET_PORTED
    m = tmethods.resolve("radix", np.uint64, (np.uint64,), 10**8)
    assert m is tmethods.REGISTRY["radix"] and m.device
