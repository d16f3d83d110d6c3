"""The `sort_thesis` configuration: the reference library's own benchmark.

Inputs follow jonicho/simd-radix-sort `src/data.hpp:64-170` (the eight
distributions) and `perf-thesis.cpp`'s key and payload types, rewritten in
torch from the rules of `simd_radix_sort_tpu_torch/utils/data.py` and made
on the card from the seed: a frozen copy, so that the inputs do not change
with the program.  A payload is a function of its key (splitmix64 of the
key's bits, as the reference's payloads are of theirs), so equal keys carry
equal payloads and an unstable sort has one right answer.

An input is named `<key dtype>.<distribution>`, with `+<payload dtype>`
for each payload stream (`uint64.Uniform+uint64`).  A mix may keep
several distinct inputs of one name resident (parameter `"copy"`: 0, 1,
..., each drawn from its own seed), as a pipeline holds many columns on the
card and sorts one after another.  The one operation, "sort", calls the port's
public `sort()` with the default `method="auto"`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os

import numpy as np
import torch

import simd_radix_sort_tpu_torch as srs
from benchmark import calls

SPANS = ("sort",)

DISTRIBUTIONS = ("Uniform", "Gaussian", "Zero", "ZeroOne", "Sorted",
                 "ReverseSorted", "AlmostSorted", "AlmostReverseSorted")
SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
M1, M2, M3 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
SALT = 0xA5A5A5A5A5A5A5A5


def _wrap64(x: int) -> int:
    return (x + 2**63) % 2**64 - 2**63


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def payload(keys: torch.Tensor, stream: int = 0) -> torch.Tensor:
    """Payload stream `stream` of each key as uint64: splitmix64 of the
    key's zero-extended bits xor (stream + 1) * SALT."""
    w = keys.element_size()
    bits = keys.view(SIGNED[w]).to(torch.int64)
    if w < 8:
        bits = bits & ((1 << (8 * w)) - 1)
    z = (bits ^ _wrap64((stream + 1) * SALT % 2**64)) + _wrap64(M1)
    z = (z ^ _lsr(z, 30)) * _wrap64(M2)
    z = (z ^ _lsr(z, 27)) * _wrap64(M3)
    return (z ^ _lsr(z, 31)).view(torch.uint64)


def _uniform_bits(w: int, n: int, g, device) -> torch.Tensor:
    if w == 8:
        hi, lo = (torch.randint(0, 2**32, (n,), generator=g, device=device)
                  for _ in range(2))
        return (hi << 32) | lo
    half = 1 << (8 * w - 1)
    return torch.randint(-half, half, (n,), generator=g, device=device,
                         dtype=SIGNED[w])


def _sort_bits(bits: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Sort signed-view bits in the order of the key's own type."""
    if not unsigned:
        return torch.sort(bits).values
    sign = -(1 << (8 * bits.element_size() - 1))
    return torch.sort(bits ^ sign).values ^ sign


def make_keys(dtype: torch.dtype, distribution: str, n: int, seed: int,
              device) -> torch.Tensor:
    """n keys of `dtype` drawn by data.hpp's rule for `distribution`."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {distribution!r}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w = torch.empty((), dtype=dtype).element_size()
    unsigned = not dtype.is_signed
    if distribution == "Zero":
        bits = torch.zeros(n, dtype=SIGNED[w], device=device)
    elif distribution == "ZeroOne":
        bits = torch.randint(0, 2, (n,), generator=g, device=device,
                             dtype=SIGNED[w])
    elif distribution == "Gaussian":
        # rounded N(0, 100); out-of-range draws wrap, as the reference's
        # double -> integer conversion does
        x = torch.randn(n, generator=g, device=device, dtype=torch.float64)
        bits = torch.round(x * 100).to(torch.int64).to(SIGNED[w])
    else:  # Uniform, and the sorted family starts from it
        bits = _uniform_bits(w, n, g, device)
        if distribution != "Uniform":
            bits = _sort_bits(bits, unsigned)
            if "Reverse" in distribution:
                bits = bits.flip(0)
            if distribution.startswith("Almost") and n > 1:
                # floor(2^log10(n)) swaps of two random positions, in turn
                swaps = int(math.exp2(math.log10(n)))
                ij = torch.randint(0, n, (swaps, 2), generator=g,
                                   device=device)
                for pair in ij:
                    bits[pair] = bits[pair.flip(0)]
    return bits.view(dtype)


@dataclasses.dataclass
class Input:
    keys: torch.Tensor
    payloads: tuple


@dataclasses.dataclass
class State:
    inputs: dict                  # (name, copy) -> Input


def parse_input(name: str):
    """`uint64.Uniform+uint64` -> (torch.uint64, "Uniform", [torch.uint64])."""
    head, *pays = name.split("+")
    dtype, distribution = head.split(".")
    return (getattr(torch, dtype), distribution,
            [getattr(torch, p) for p in pays])


def input_key(params: dict) -> tuple:
    """The resident input a call sorts: (name, copy)."""
    return params["input"], int(params.get("copy", 0))


def setup(cfg: dict, mix: dict, seed: int, ctx) -> State:
    n = int(cfg["rows_per_call"])
    wanted = sorted({input_key(p) for t in mix["calls"]
                     for p in calls.grid(t.get("params", {}))})
    inputs = {}
    for name, copy in wanted:
        dtype, dist, pays = parse_input(name)
        keys = make_keys(dtype, dist, n,
                         calls.derive(seed, "keys", name, copy), ctx.device)
        if any(p != torch.uint64 for p in pays):
            raise ValueError(f"{name}: payload streams are uint64")
        inputs[name, copy] = Input(keys, tuple(payload(keys, j)
                                               for j in range(len(pays))))
    return State(inputs)


def sort_op(state: State, params: dict, ctx):
    inp = state.inputs[input_key(params)]
    ascending = params.get("ascending", True)
    with ctx.span("sort"):
        out = srs.sort(inp.keys, *inp.payloads, ascending=ascending,
                       device=ctx.device)
    n = inp.keys.numel()
    row = sum(t.element_size() for t in (inp.keys, *inp.payloads))
    return out, {"rows": n, "sort": [{"n": n, "row_bytes": row}]}


OPS = {"sort": sort_op}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits on the host, in its NumPy dtype."""
    w = t.element_size()
    a = t.view(SIGNED[w]).cpu().numpy()
    return a.view(np.dtype(str(t.dtype).replace("torch.", "")))


def capture(state: State, call, out):
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(to_host(t) for t in outs)


def _differing(got: np.ndarray, want: np.ndarray) -> int:
    """Positions at which two answers differ, by their bits (all of them
    when the shapes differ)."""
    if got.shape != want.shape or got.dtype.itemsize != want.dtype.itemsize:
        return int(want.size)
    return int(np.count_nonzero(got.view(want.dtype) != want))


def _compare_input(state: State, key: tuple, recs: list, ref):
    """(keys differing, payloads differing, answers wrong) of the kept
    answers of one input."""
    keys = ref.sort_keys(to_host(state.inputs[key].keys))
    asc = (keys,) + tuple(ref.payload(keys, j)
                          for j in range(len(state.inputs[key].payloads)))
    bad_keys = bad_pays = wrong = 0
    for rec in recs:
        want = (asc if rec.call.params.get("ascending", True)
                else tuple(w[::-1] for w in asc))
        got, rec.answer = rec.answer, None
        if len(got) != len(want):  # streams missing: every row differs
            got = ()
        k = _differing(got[0], want[0]) if got else want[0].size
        p = sum(_differing(g, w) if got else w.size
                for g, w in zip(got[1:] or want[1:], want[1:]))
        bad_keys += k
        bad_pays += p
        wrong += bool(k or p)
    return bad_keys, bad_pays, wrong


def compare(state: State, kept, ref, ctx, cfg: dict):
    """Every kept answer against the reference's sort of the same input:
    the keys that differ, and the payloads that differ, position by
    position.  The reference sorts each input once, ascending; a descending
    answer is held to that order reversed.  Inputs are compared in
    parallel threads (NumPy's sorts and compares release the GIL).
    Returns (checks, the answers that differ)."""
    by_input = {}
    for rec in kept:
        by_input.setdefault(input_key(rec.call.params), []).append(rec)
    workers = max(1, min(8, os.cpu_count() or 1, len(by_input)))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        counts = list(pool.map(
            lambda item: _compare_input(state, *item, ref),
            by_input.items()))
    bad_keys, bad_pays, wrong = (sum(c) for c in zip(*counts or [(0, 0, 0)]))
    limits = cfg["limits"]
    checks = {"keys_differing": {"value": bad_keys,
                                 "limit": limits["keys_differing"]}}
    if any(state.inputs[input_key(r.call.params)].payloads for r in kept):
        checks["payloads_differing"] = {"value": bad_pays,
                                        "limit": limits["payloads_differing"]}
    return checks, wrong
