"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled with nvcc for Hopper (`sm_90a`)
into one shared library with a plain C interface, at first use, into
`build/srs_torch/` beside the package.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  nvcc's report (registers, shared memory and spills per
kernel, from `-Xptxas -v`) is kept next to the library as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "hist_kernels.cu",)
BUILD_DIR = _PKG.parent / "build" / "srs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
# name -> argtypes; every entry returns a cudaError_t as int
_SIGNATURES = {
    "srs_histogram": (_P, _I, _LL, _U, _I, _P, _P),
    "srs_minmax_hist16": (_P, _I, _LL, _U, _P, _P),
    "srs_fill16": (_P, _I, _LL, _U, _P, _P),
    "srs_fill_runs": (_P, _I, _LL, _U, _I, _P, _P),
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "simd_radix_sort_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrs_hist_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.srs_error_string.argtypes = (ctypes.c_int,)
    lib.srs_error_string.restype = ctypes.c_char_p
    return lib
