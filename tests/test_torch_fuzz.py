"""Randomized differential fuzz of the port (mirrors
tests/test_fuzz_differential.py): every engine of the port's registry, on
the CPU, must pass the port's NumPy oracle (utils/data.check_data) on
random (dtype, distribution, size, direction, payload) workloads.  Seeds are
fixed, so a failure reproduces exactly; sizes stay below 5000 rows so that
the file runs in Tier-1."""

import numpy as np
import pytest

import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu_torch import methods
from simd_radix_sort_tpu_torch.utils import data as D
from simd_radix_sort_tpu_torch.utils import interop

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.uint64, np.int64, np.float32, np.float64]
PAYLOADS = [(), (np.uint32,), (np.uint64, np.uint8), (np.float32,),
            (np.int16, np.float64)]


@pytest.mark.parametrize("trial", range(16))
def test_random_workload_all_engines(trial):
    rng = np.random.default_rng(7000 + trial)
    kdt = DTYPES[rng.integers(len(DTYPES))]
    pdts = PAYLOADS[rng.integers(len(PAYLOADS))]
    dist = list(D.Distribution)[rng.integers(len(D.Distribution))]
    n = int(rng.integers(1, 5000))
    ascending = bool(rng.integers(2))
    keys = D.make_keys(n, kdt, dist, seed=int(rng.integers(1 << 30)))
    pays = D.make_payloads(keys, pdts, "fast")

    ran = []
    for name, m in methods.REGISTRY.items():
        if not m.supports(np.dtype(kdt), tuple(np.dtype(p) for p in pdts),
                          n):
            continue
        for stable in (False, True):
            out = tsrs.sort_with_payloads(keys, tuple(pays), method=name,
                                          ascending=ascending, stable=stable,
                                          device="cpu")
            err = D.check_data(interop.to_numpy(out[0]),
                               tuple(interop.to_numpy(p) for p in out[1]),
                               keys, ascending)
            assert err == "", (trial, name, stable, kdt, pdts, dist, n,
                               ascending, err)
        ran.append(name)
    assert {"xla", "radix", "quick", "seq", "torch", "cpp"} <= set(ran)
