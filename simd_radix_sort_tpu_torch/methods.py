"""Sort-method facade: a uniform registry over the sort engines.

Counterpart of simd_radix_sort_tpu/methods.py.  Each method exposes `name`,
`supports(key_dtype, payload_dtypes, n)`, `has_threshold`, `device` and a
`run(keys, payloads, *, ascending, stable, block_threshold, digit_bits)`
entry that takes and returns torch tensors.

Ported methods:
  * "xla"   — the comparison-sort engine (ops/xla_sort.py, `torch.sort`)
  * "radix" — LSD radix sort (ops/radix.py) with its default mover, a
              stable torch.sort per 16- or 32-bit digit
  * "count" — counting / histogram sort on the CUDA kernels
              (ops/counting.py), keys-only integer keys of <= 32 bits
  * "rank"  — stable O(n^2) rank sort for n <= 4096 (ops/rank_sort.py)
  * "quick" — device quicksort: sampled-splitter multiway partition +
              batched block sorts (ops/quick_sort.sort_arrays)
  * "quickseq" — host model with the reference's exact pivot/recursion
              semantics (ops/quick_sort.sort_np)
  * "torch" — torch.sort on the host (ops/torch_baseline.py; the external-
              comparison baseline)
  * "cpp"   — the native threaded C++ LSD byte radix on the host
              (utils/native.py over native/harness.cpp)
  * "seq"   — host NumPy stable-argsort model (differential baseline)
Special selectors: "auto" (static policy) and "autotune" (measured once per
workload shape and device, cached; autotune.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .utils import common, interop, transforms


@dataclasses.dataclass(frozen=True)
class SortMethod:
    name: str
    run: Callable  # (keys, payloads, *, ascending, stable, ...) -> (keys, payloads)
    supports: Callable  # (key_dtype, payload_dtypes, n) -> bool
    has_threshold: bool = False
    device: bool = True  # False for host-side differential baselines


def _supports_all(key_dtype, payload_dtypes, n) -> bool:
    return True


def _run_xla(keys, payloads, *, ascending=True, stable=False,
             block_threshold=None, digit_bits=None):
    from .ops import xla_sort
    return xla_sort.sort_arrays(keys, payloads, ascending=ascending,
                                stable=stable)


def _run_radix(keys, payloads, *, ascending=True, stable=False,
               block_threshold=None, digit_bits=None):
    from .ops import radix
    return radix.sort_arrays(keys, payloads, ascending=ascending,
                             stable=stable, digit_bits=digit_bits)


def _run_count(keys, payloads, *, ascending=True, stable=False,
               block_threshold=None, digit_bits=None):
    from .ops import counting
    if payloads:
        raise ValueError("the count engine sorts keys only")
    return counting.sort_keys(keys, ascending=ascending)


def _count_supports(key_dtype, payload_dtypes, n) -> bool:
    from .ops import counting
    return counting.supports(key_dtype, payload_dtypes, n)


def _run_rank(keys, payloads, *, ascending=True, stable=False,
              block_threshold=None, digit_bits=None):
    from .ops import rank_sort
    return rank_sort.sort_arrays(keys, payloads, ascending=ascending)


def _rank_supports(key_dtype, payload_dtypes, n) -> bool:
    from .ops import rank_sort
    return n is None or n <= rank_sort.MAX_RANK_SORT_N


def _run_quick(keys, payloads, *, ascending=True, stable=False,
               block_threshold=None, digit_bits=None):
    from .ops import quick_sort
    return quick_sort.sort_arrays(keys, payloads, ascending=ascending,
                                  stable=stable,
                                  block_threshold=block_threshold)


def _host_method(sort_fn, takes_threshold: bool = False):
    """Adapter for a host-side engine: the tensors go to NumPy, `sort_fn`
    sorts them there, and the results come back to the keys' device."""
    def run(keys, payloads, *, ascending=True, stable=False,
            block_threshold=None, digit_bits=None):
        host = [interop.to_numpy(t) for t in (keys, *payloads)]
        kw = ({"threshold": block_threshold}
              if takes_threshold and block_threshold is not None else {})
        out = sort_fn(host[0], *host[1:], ascending=ascending, **kw)
        back = [interop.from_numpy(a, keys.device) for a in out]
        return back[0], tuple(back[1:])
    return run


def _run_seq(keys, payloads, **kw):
    return _host_method(transforms.sort_np)(keys, payloads, **kw)


def _run_quickseq(keys, payloads, **kw):
    from .ops import quick_sort
    return _host_method(quick_sort.sort_np,
                        takes_threshold=True)(keys, payloads, **kw)


def _run_torch(keys, payloads, **kw):
    from .ops import torch_baseline
    return _host_method(torch_baseline.sort_np)(keys, payloads, **kw)


def _run_cpp(keys, payloads, **kw):
    # builds the native library at first use; a failed build raises with
    # the compiler's output
    from .utils import native
    return _host_method(native.sort_np)(keys, payloads, **kw)


REGISTRY: dict[str, SortMethod] = {}


def register(method: SortMethod):
    REGISTRY[method.name] = method


register(SortMethod("xla", _run_xla, _supports_all))
register(SortMethod("radix", _run_radix, _supports_all))
register(SortMethod("rank", _run_rank, _rank_supports))
register(SortMethod("count", _run_count, _count_supports))
register(SortMethod("quick", _run_quick, _supports_all, has_threshold=True))
register(SortMethod("quickseq", _run_quickseq, _supports_all,
                    has_threshold=True, device=False))
register(SortMethod("torch", _run_torch, _supports_all, device=False))
register(SortMethod("seq", _run_seq, _supports_all, device=False))
register(SortMethod("cpp", _run_cpp, _supports_all, device=False))

# Names the JAX package registers that have no port yet.
NOT_YET_PORTED = ()

# Engine crossovers of the static "auto" policy: the smallest n at which
# keys-only integer keys of each type go to count.  Each is the value
# that tests/test_torch_auto_policy.py's rule gives from the tables in
# bench_out_h100/ (NVIDIA H100 80GB HBM3 at 700.00 W; CARD.json there
# names the commands), each row's engines timed in turns.
# 1-byte keys: the smallest swept n from which count is <= 1.05x xla at
# every row of every 1-byte sweep to 2^27 (large_n/tpe-uint8-Uniform,
# -Zero, -Sorted, -ReverseSorted and tpe-int8-Uniform.dat).  Up to 2^23 a
# count call is host-bound and slower (1.10-1.17x xla at 2^23 on Zero,
# Sorted and ReverseSorted); from 2^24 it is 0.16-0.79x.  The TPU's value
# was 2^17.
COUNT_CROSSOVER_N_1BYTE = 1 << 24
# 2- and 4-byte keys, per key type: the policy rule (per workload, the median
# over the 8 distributions of count over the best engine <= 1.35) from the
# larger of the TPU's 2^21 and counting.SMALL_MIN_N (2^14), the engine's
# own branch gate.  The tables of 2^22-2^26 rows were measured again after
# K2's and K3's redesign.  int32 and uint32: medians 1.26-1.30 at
# 2^22, 1.07-1.21 above, so the floor is the base, 2^21 (2^22 before the
# redesign, when SMALL_MIN_N was the base).
COUNT_MIN_N_ADAPTIVE = 1 << 21
# int16: medians 1.52 and 1.36 at 2^22-2^23, 1.17-1.27 at 2^24-2^26 (2^26
# before the redesign).
COUNT_MIN_N_ADAPTIVE_2BYTE = 1 << 24
# uint16: 1.52 at 2^22, 1.14-1.33 at 2^23-2^26 (2^25 before the
# redesign).  One floor for both 2-byte types cannot meet the rule (int16's
# median is 1.36 at 2^23), so the TPU policy's one adaptive floor is split
# by key type.
COUNT_MIN_N_ADAPTIVE_UINT16 = 1 << 23


def count_floor(key_dtype) -> int:
    """The smallest n from which "auto" sends keys-only integer keys of
    `key_dtype` (at most 4 bytes) to count."""
    kdt = common.np_dtype(key_dtype)
    if kdt.itemsize == 1:
        return COUNT_CROSSOVER_N_1BYTE
    if kdt.itemsize == 2:
        return (COUNT_MIN_N_ADAPTIVE_UINT16 if kdt.kind == "u"
                else COUNT_MIN_N_ADAPTIVE_2BYTE)
    return COUNT_MIN_N_ADAPTIVE


def resolve(method: str, key_dtype, payload_dtypes: Sequence, n: int | None,
            device=None) -> SortMethod:
    """Pick a method; "auto" chooses the engine by key type, payloads and
    row count as the JAX package's static policy does, with a floor for
    each width and for each 2-byte type (count_floor); "autotune"
    measures the candidates on `device` (None means "cuda"), which only
    it reads."""
    kdt = common.np_dtype(key_dtype)
    pdts = tuple(common.np_dtype(d) for d in payload_dtypes)
    if method == "auto":
        if _count_supports(kdt, pdts, n):
            if n is None or n >= count_floor(kdt):
                return REGISTRY["count"]
        return REGISTRY["xla"]
    if method == "autotune":
        from . import autotune
        return REGISTRY[autotune.pick_method(kdt, pdts, n or (1 << 20),
                                             device=device)]
    m = REGISTRY.get(method)
    if m is None:
        raise ValueError(f"unknown sort method {method!r}; "
                         f"have {sorted(REGISTRY)}")
    if not m.supports(kdt, pdts, n):
        raise ValueError(
            f"method {method!r} does not support key={kdt} "
            f"payloads={pdts} n={n}")
    return m
