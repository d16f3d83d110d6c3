"""Empirical method selection with a persistent cache.

Counterpart of simd_radix_sort_tpu/autotune.py.  The reference tunes its
cmpSortThreshold per key type empirically and bakes the findings into its
benchmark configurations (thesis tex:3322-3340); this module tunes the
ENGINE per workload shape: measure every supported device method once on a
synthetic workload of the same (key dtype, payload dtypes, n-bucket) on the
device asked for, cache the winner, and let `sort(..., method="autotune")`
use it.

Cache entries key on (key dtype, payload dtypes, log2-size bucket, device
kind) and persist to SRS_TORCH_AUTOTUNE_CACHE (default
~/.cache/srs_torch_autotune.json) so the cost is paid once per machine.  The
device kind is the card's CUDA name without spaces, or "cpu", so an entry
measured on the CPU never answers for a card.

Two departures from the JAX module, both about correctness: each candidate
is measured with its output validated (a wrong engine must not win the
cache), and only a candidate's own refusal (a ValueError from a capability
or engine precondition) or a wrong output skips it.  Anything else, a
kernel that fails to build or launch above all, propagates: the winner is
never chosen around a broken kernel.
"""

from __future__ import annotations

import json
import math
import os
import warnings

from . import methods as methods_mod
from .utils import common
from .utils.profiling import device_name

_CACHE_PATH = os.environ.get(
    "SRS_TORCH_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache",
                 "srs_torch_autotune.json"))
_cache: dict[str, str] | None = None

# host baselines are never candidates: they exist for differential testing
_CANDIDATES = ("xla", "radix", "count", "rank", "quick")


def _bucket(n: int) -> int:
    return max(8, int(math.log2(max(n, 1))))


def _key(key_dtype, payload_dtypes, n: int, device=None) -> str:
    dev = common.resolve_device(device)
    kind = device_name(dev).replace(" ", "")
    pd = ",".join(common.np_dtype(p).name for p in payload_dtypes)
    return f"{common.np_dtype(key_dtype).name}|{pd}|2^{_bucket(n)}|{kind}"


def _load() -> dict:
    global _cache
    if _cache is None:
        try:
            with open(_CACHE_PATH) as f:
                _cache = json.load(f)
        except (OSError, ValueError):  # absent or unreadable: start afresh
            _cache = {}
    return _cache


def _store():
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        with open(_CACHE_PATH, "w") as f:
            json.dump(_cache, f, indent=1)
    except OSError:
        pass  # read-only environments just lose persistence


def pick_method(key_dtype, payload_dtypes=(), n: int = 1 << 20,
                reps: int = 3, refresh: bool = False, device=None) -> str:
    """Return the fastest registered device method for this workload shape
    on `device` (None means "cuda"), measuring once and caching."""
    dev = common.resolve_device(device)
    kdt = common.np_dtype(key_dtype)
    pdts = tuple(common.np_dtype(p) for p in payload_dtypes)
    cache = _load()
    k = _key(kdt, pdts, n, dev)
    if not refresh and k in cache:
        m = methods_mod.REGISTRY.get(cache[k])
        # cache entries are per size-BUCKET: a winner measured at the small
        # end may not support every n in the bucket (e.g. rank's cap)
        if m is not None and m.supports(kdt, pdts, n):
            return cache[k]

    from . import perf
    from .utils import data as D
    # candidates must support the whole bucket, not just this n, so the
    # cached winner is valid for every later query mapping to the bucket
    bucket_hi = 1 << (_bucket(n) + 1)
    best, best_ns = None, float("inf")
    for name in _CANDIDATES:
        m = methods_mod.REGISTRY[name]
        if not (m.supports(kdt, pdts, n) and m.supports(kdt, pdts, bucket_hi)):
            continue
        try:
            ns = perf.measure_ns_per_element(
                name, n, kdt, pdts, D.Distribution.UNIFORM, reps=reps,
                warmups=1, validate=True, device=dev)
        except (perf.WrongOutputError, ValueError) as e:
            warnings.warn(
                f"autotune: candidate {name!r} skipped for {k}: "
                f"{type(e).__name__}: {e}", RuntimeWarning)
            continue
        if ns < best_ns:
            best, best_ns = name, ns
    if best is None:
        raise RuntimeError(f"autotune: no candidate gave a valid output "
                           f"for {k}")
    cache[k] = best
    _store()
    return best
