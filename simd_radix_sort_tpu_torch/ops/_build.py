"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/` are compiled with nvcc for Hopper (`sm_90a`), one
nvcc process per source, all started together, and linked into one shared
library with a plain C interface, at first use, into `build/srs_torch/`
beside the package.  The library's name carries a hash of the sources, the
headers beside them and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  cub's pair sort (`sort_pairs*.cu`) is
spread over one source a key type, since nvcc takes longest over cub's
instantiations and the sources compile side by side.  nvcc's report
(registers, shared memory and spills per kernel, from `-Xptxas -v`) is kept
next to the library as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
SORT_PAIRS_KEYS = ("u8", "i8", "u16", "i16", "u32", "i32", "u64", "i64")
SOURCES = (_CSRC / "hist_kernels.cu", _CSRC / "partition_kernels.cu",
           _CSRC / "scan_kernels.cu", _CSRC / "key_bits.cu",
           _CSRC / "row_gather.cu", _CSRC / "column_gather.cu",
           _CSRC / "sort_pairs.cu",
           *(_CSRC / f"sort_pairs_{k}.cu" for k in SORT_PAIRS_KEYS))
HEADERS = (_CSRC / "sort_pairs.cuh",)
BUILD_DIR = _PKG.parent / "build" / "srs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_SZ, _PSZ = ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)
_PLL = ctypes.POINTER(ctypes.c_longlong)
# name -> argtypes; every entry returns a cudaError_t as int
_SIGNATURES = {
    "srs_histogram": (_P, _I, _LL, _U, _I, _P, _P),
    "srs_minmax_hist16": (_P, _I, _LL, _U, _P, _P),
    "srs_fill16": (_P, _I, _LL, _U, _I, _P, _P),
    "srs_fill_runs": (_P, _I, _LL, _U, _I, _I, _P, _P),
    "srs_fill_runs_packed": (_P, _I, _LL, _I, _P, _P),
    "srs_partition_count": (_P, _LL, _I, _P, _P),
    "srs_partition_scatter": (_P, _LL, _I, _P, _I, _PP, _PP, _PI, _P),
    "srs_segmented_scan": (_P, _LL, _I, _I, _I, _PP, _PP, _P, _P, _P),
    "srs_key_bits": (_P, _I, _LL, _P, _P, _P),
    "srs_row_gather": (_P, _P, _P, _LL, _LL, _I, _P),
    "srs_column_pack": (_PP, _PLL, _PI, _PI, _I, _P, _I, _LL, _P),
    "srs_column_gather": (_P, _LL, _I, _P, _I, _LL, _PP, _PI, _PI, _I, _P),
    "srs_sort_pairs_temp_bytes": (_I, _I, _I, _I, _I, _I, _PSZ, _P),
    "srs_sort_pairs": (_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _SZ, _P),
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
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    compilers = [subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    reports = [p.communicate()[0] for p in compilers]
    link = None
    if all(p.returncode == 0 for p in compilers):
        link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        reports.append(link.stdout)
    out.with_suffix(".log").write_text("".join(reports))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "".join(reports)[-4000:])
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


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry `entry` on `device`'s current stream; raise if it
    returns a CUDA error (a refused launch never runs)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: {lib.srs_error_string(err).decode()} "
                           f"(CUDA error {err})")
