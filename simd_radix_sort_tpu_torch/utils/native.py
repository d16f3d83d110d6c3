"""ctypes bindings for the native C++ harness (native/harness.cpp).

Counterpart of simd_radix_sort_tpu/utils/native.py.  The library plays the
reference harness's role at native speed: reference-exact datasets
(std::mt19937 and libstdc++ distributions for keys, the glibc rand payload
protocol), validation oracles fast enough for 10^8-row outputs, and the
threaded LSD byte radix argsort behind the "cpp" sort method.

The JAX package runs `make -C native`, which writes the library into
native/.  The port never writes there: at first use it compiles
native/harness.cpp itself, with the Makefile's flags, into
`build/srs_torch/` (ops/_build.py's directory), under a name that carries
a hash of the source, the compiler and the flags, renamed into place at the
end so that concurrent builds never see half a file.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR
from . import common, transforms

SOURCE = Path(__file__).resolve().parents[2] / "native" / "harness.cpp"
CXX_FLAGS = ("-std=c++20", "-O3", "-Wall", "-Wextra", "-fPIC", "-pthread",
             "-shared")

_TYPE_IDS = {np.dtype(d): i for i, d in enumerate(common.KEY_DTYPES)}
_I, _I32, _I64, _P = (ctypes.c_int, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_void_p)
_PP, _PI32 = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32)
# name -> (restype, argtypes)
_SIGNATURES = {
    "srs_make_keys": (_I, (_I, _I64, _I, _I64, _P)),
    "srs_make_payload_bytes": (_I, (_I, _P, _I64, _I32, _P)),
    "srs_check_payload_bytes": (_I64, (_I, _P, _I64, _I32, _P)),
    "srs_is_sorted": (_I, (_I, _P, _I64, _I)),
    "srs_same_multiset": (_I, (_I, _P, _P, _I64)),
    "srs_pack_rows": (_I, (_I, _PP, _PI32, _I64, _P)),
    "srs_unpack_rows": (_I, (_I, _PP, _PI32, _I64, _P)),
    "srs_radix_argsort": (_I, (_I, _P, _I64, _P)),
}


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join((_compiler(),) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsrsharness_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/harness.cpp unless a library for it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native harness build failed:\n"
                           + proc.stdout[-4000:])
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded harness library, built first if needed."""
    L = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(L, name)
        fn.restype, fn.argtypes = restype, argtypes
    return L


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def make_keys(num: int, dtype, distribution, seed: int = 0) -> np.ndarray:
    """Reference-exact keys (std::mt19937 and libstdc++ distributions), the
    reference's Data<K, ...> constructor protocol."""
    from . import data as D
    dtype = np.dtype(dtype)
    dist_id = list(D.Distribution).index(D.Distribution(distribution))
    out = np.empty(num, dtype=dtype)
    rc = lib().srs_make_keys(_TYPE_IDS[dtype], num, dist_id, seed, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"srs_make_keys failed: {rc}")
    return out


def make_payloads(keys: np.ndarray, payload_dtypes):
    """Reference-exact payloads (the glibc srand/rand protocol, as
    utils/data.make_payload_cpp) at native speed."""
    keys = np.ascontiguousarray(keys)
    dts = [np.dtype(d) for d in payload_dtypes]
    total = sum(d.itemsize for d in dts)
    packed = np.empty((len(keys), total), dtype=np.uint8)
    rc = lib().srs_make_payload_bytes(keys.dtype.itemsize, _ptr(keys),
                                      len(keys), total, _ptr(packed))
    if rc != 0:
        raise RuntimeError(f"srs_make_payload_bytes failed: {rc}")
    out, off = [], 0
    for d in dts:
        out.append(np.ascontiguousarray(packed[:, off:off + d.itemsize])
                   .reshape(-1).view(d))
        off += d.itemsize
    return tuple(out)


def check_payloads(keys: np.ndarray, payloads) -> int:
    """-1 if every payload regenerates from its key (the "cpp" protocol),
    else the first bad row."""
    keys = np.ascontiguousarray(keys)
    payloads = [np.asarray(p) for p in payloads]
    if not payloads:
        return -1
    packed = pack_rows(payloads[0], payloads[1:])
    return int(lib().srs_check_payload_bytes(
        keys.dtype.itemsize, _ptr(keys), len(keys), packed.shape[1],
        _ptr(packed)))


def is_sorted(keys: np.ndarray, ascending: bool = True) -> bool:
    keys = np.ascontiguousarray(keys)
    if keys.dtype.kind == "f":
        # floats are ordered by IEEE totalOrder bits (-0.0 < +0.0, NaNs by
        # bit pattern); a numeric compare would pass any NaN placement, so
        # the order-preserving carrier is checked instead
        keys = np.ascontiguousarray(transforms.to_sortable_np(keys,
                                                              ascending))
        ascending = True
    return bool(lib().srs_is_sorted(_TYPE_IDS[keys.dtype], _ptr(keys),
                                    len(keys), int(ascending)))


def same_multiset(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        raise ValueError(f"{a.dtype}{a.shape} and {b.dtype}{b.shape}")
    return bool(lib().srs_same_multiset(_TYPE_IDS[a.dtype], _ptr(a),
                                        _ptr(b), len(a)))


def _col_ptrs(cols):
    arr = (ctypes.c_void_p * len(cols))(*[c.ctypes.data for c in cols])
    sizes = (ctypes.c_int32 * len(cols))(*[c.dtype.itemsize for c in cols])
    return arr, sizes


def pack_rows(keys: np.ndarray, payloads=()) -> np.ndarray:
    """Columns to packed rows (the reference's convertToSingleArray),
    threaded: (n, sum of element sizes) uint8."""
    cols = [np.ascontiguousarray(c) for c in (keys, *payloads)]
    n = len(cols[0])
    stride = sum(c.dtype.itemsize for c in cols)
    out = np.empty(n * stride, dtype=np.uint8)
    ptrs, sizes = _col_ptrs(cols)
    if lib().srs_pack_rows(len(cols), ptrs, sizes, n, out.ctypes.data) \
            != stride:
        raise RuntimeError("srs_pack_rows failed")
    return out.reshape(n, stride)


def unpack_rows(packed: np.ndarray, key_dtype, payload_dtypes=()):
    """Packed rows back to columns (setFromSingleArray), threaded."""
    packed = np.ascontiguousarray(packed)
    n = packed.shape[0]
    cols = [np.empty(n, dtype=np.dtype(d))
            for d in (key_dtype, *payload_dtypes)]
    stride = sum(c.dtype.itemsize for c in cols)
    if packed.shape != (n, stride):
        raise ValueError(f"packed rows {packed.shape}, expected "
                         f"({n}, {stride})")
    ptrs, sizes = _col_ptrs(cols)
    if lib().srs_unpack_rows(len(cols), ptrs, sizes, n,
                             packed.ctypes.data) != stride:
        raise RuntimeError("srs_unpack_rows failed")
    return cols[0], tuple(cols[1:])


def radix_argsort(carrier: np.ndarray) -> np.ndarray:
    """Stable sorting permutation (int64) of an unsigned carrier array, by
    the native threaded LSD byte radix."""
    carrier = np.ascontiguousarray(carrier)
    if carrier.dtype.kind != "u":
        raise TypeError(f"radix_argsort takes an unsigned carrier, not "
                        f"{carrier.dtype}")
    perm = np.empty(carrier.shape[0], dtype=np.int64)
    rc = lib().srs_radix_argsort(carrier.dtype.itemsize, _ptr(carrier),
                                 carrier.shape[0], _ptr(perm))
    if rc != 0:
        raise RuntimeError(f"srs_radix_argsort failed ({rc})")
    return perm


def sort_np(keys: np.ndarray, *payloads: np.ndarray, ascending: bool = True):
    """Host sort by the native radix argsort of the keys' carrier (the
    "cpp" method): returns (keys_sorted, *payloads_sorted)."""
    keys = np.asarray(keys)
    perm = radix_argsort(transforms.to_sortable_np(keys, ascending))
    return (keys[perm],) + tuple(np.asarray(p)[perm] for p in payloads)
