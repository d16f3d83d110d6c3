"""Shared helpers of the workload scripts.

Counterpart of scripts/benchlib.py: the splitmix64 mixer the scripts make
their data with, the order-independent fingerprints their gates compare,
and the timer.  torch has few CUDA kernels for uint64, so 64-bit values are
held as their int64 carrier (the same bits): addition and multiplication
wrap alike in both, a constant above 2^63 is given as its signed value
(`wrap64`), and a logical right shift is an arithmetic one masked to the
bits that stay.
"""

from __future__ import annotations

import contextlib
import socket
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

M1 = 0x9E3779B97F4A7C15  # splitmix64's increment; odd, mixes key bits
M2 = 0xBF58476D1CE4E5B9
M3 = 0x94D049BB133111EB


def wrap64(x: int) -> int:
    """`x` mod 2^64 as a signed 64-bit value."""
    return (int(x) + 2**63) % 2**64 - 2**63


def signed(t: torch.Tensor) -> torch.Tensor:
    """The same-width signed view of a tensor."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 carrier."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 mixer of every element of an int64 carrier, bit for
    bit benchlib.splitmix64 of the same uint64 values."""
    z = x + wrap64(M1)
    z = (z ^ _lsr(z, 30)) * wrap64(M2)
    z = (z ^ _lsr(z, 27)) * wrap64(M3)
    return z ^ _lsr(z, 31)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 of a uint64 array on the host, with NumPy."""
    with np.errstate(over="ignore"):
        z = x + np.uint64(M1)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(M2)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(M3)
        return z ^ (z >> np.uint64(31))


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """The unsigned value of an int64 carrier mod `m` (0 < m < 2^31), as
    int64.  int64's `%` is wrong where the top bit is set, so the carrier
    is split into 32-bit halves: x = hi·2^32 + lo, every product < 2^62."""
    if not 0 < m < 2**31:
        raise ValueError(f"modulus {m} outside (0, 2^31)")
    hi, lo = _lsr(x, 32), x & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def xor_reduce(t: torch.Tensor) -> int:
    """xor of every element: torch has no xor reduction, so halves are
    folded, padded with a zero to even length."""
    while t.numel() > 1:
        if t.numel() % 2:
            t = torch.cat([t, t.new_zeros(1)])
        h = t.numel() // 2
        t = t[:h] ^ t[h:]
    return int(t.item()) if t.numel() else 0


def device_checksums(out) -> tuple:
    """bench.py's gate on the device: the sum and xor of the 64-bit keys and
    of the key-payload pair fingerprint (k·M1) ^ p, mod 2^64 as signed
    ints (independent of row order)."""
    ko, po = (signed(t) for t in out)
    pair = (ko * wrap64(M1)) ^ po
    return (int(ko.sum().item()), xor_reduce(ko),
            int(pair.sum().item()), xor_reduce(pair))


def host_checksums(keys: np.ndarray, pay: np.ndarray) -> tuple:
    """`device_checksums` of host uint64 arrays, from NumPy."""
    with np.errstate(over="ignore"):
        pair = (keys * np.uint64(M1)) ^ pay
        return (wrap64(keys.sum(dtype=np.uint64)),
                wrap64(np.bitwise_xor.reduce(keys)),
                wrap64(pair.sum(dtype=np.uint64)),
                wrap64(np.bitwise_xor.reduce(pair)))


def fence(device: torch.device) -> None:
    """Wait for the work queued on `device`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, args=(), reps: int = 5, warmup: int = 2,
           per_rep_fence: bool = False, device=None) -> float:
    """Seconds per call of `fn(*args)` on the host clock: warm up, queue
    `reps` calls back to back and wait once.  per_rep_fence=True waits after
    every call and drops the previous result first, for calls whose result
    is GBs."""
    device = torch.device("cpu") if device is None else torch.device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is None:  # warmup=0: prime once
        out = fn(*args)
    fence(device)
    t0 = time.perf_counter()
    if per_rep_fence:
        for _ in range(reps):
            del out
            out = fn(*args)
            fence(device)
    else:
        for _ in range(reps):
            out = fn(*args)
        fence(device)
    return (time.perf_counter() - t0) / reps


def host_syncs(fn):
    """(fn(), where it made the host wait for the card: one "file:line" of
    the Python call for each wait), as torch's sync debug mode reports
    them.  CUDA only."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A process group of this process alone (NCCL on a card, Gloo on the
    CPU) for the distributed entries, on an in-process store (no port to
    race for), destroyed on exit; a group that is already initialised is
    used as it is."""
    if dist.is_initialized():
        yield
        return
    kw = {"store": dist.HashStore(), "rank": 0, "world_size": 1}
    if device.type == "cuda":
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        dist.init_process_group("nccl", device_id=torch.device("cuda", index),
                                **kw)
    else:
        dist.init_process_group("gloo", **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()
