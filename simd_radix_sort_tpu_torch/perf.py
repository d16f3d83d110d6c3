"""Benchmark harness with reference-protocol parity.

Counterpart of simd_radix_sort_tpu/perf.py, which mirrors the C++
reference's perf.hpp:
  * measure_ns_per_element mirrors measureTimePerElement (perf.hpp:28-63):
    fresh datasets, staged to the device outside the timed region, the
    sort timed, and the final rep's output verified against the oracle
    (once per cell: reps are back-to-back launches of the same engine on
    cycling datasets);
  * repetition protocol: the JAX package's REPS_NUMERATOR / n measured
    runs (capped at 512) plus WARMUP_NUMERATOR / n warmups (capped at 64),
    over min(reps, 8) fresh datasets (perf.hpp:65-89);
  * experiment families writing whitespace .dat tables with the reference's
    header rows (perf.hpp:170-211, 383-385, 435), under the same file names
    as the JAX package's;
  * tables land in $SRS_TORCH_PERF_DIR, default ./bench_out_torch/ (never
    the JAX package's bench_out/, whose tables its tests read).

Timing on a card: CUDA events around the whole rep loop, then one
synchronize, so the loop is charged device time and launch overhead, not
a host round trip per rep.  An engine that reads the device mid-call (the
count engine's min/max, the quick engine's largest segment) is charged
that sync as part of its call: that is its real cost.  On the CPU the host
clock times the same loop.  Every entry point takes `device` (None means
"cuda" and raises without a card); host engines (`device=False` in the
registry) get CPU tensors wherever the cell runs, so they are not charged
transfers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import methods as methods_mod
from .utils import common, interop, transforms
from .utils import data as D
from .utils.profiling import elapsed_seconds

OUT_DIR = os.environ.get("SRS_TORCH_PERF_DIR", "bench_out_torch")

# The JAX package's numerators (perf.py:43-44), kept identical so that both
# harnesses run the same protocol: 2^26 / n reps (16x the reference's
# 2^22 / n) and 2^18 / n warmups.
REPS_NUMERATOR = 1 << 26
WARMUP_NUMERATOR = 1 << 18
MAX_REPS = 512
MAX_WARMUPS = 64
# host engines run on the CPU, seconds a call at large n: a few reps suffice
HOST_MAX_REPS = 3
HOST_MAX_WARMUPS = 1

MIX64 = np.uint64(0x9E3779B97F4A7C15)  # odd multiplier, mixes key bits


class WrongOutputError(AssertionError):
    """A measured cell's output failed its validation."""


def rep_counts(num: int) -> tuple[int, int]:
    """(reps, warmups) of the protocol for an n-row cell of a device
    engine: past a few hundred reps the mean is stable."""
    reps = min(MAX_REPS, max(1, REPS_NUMERATOR // max(num, 1)))
    warmups = max(1, min(MAX_WARMUPS, WARMUP_NUMERATOR // max(num, 1)))
    return reps, warmups


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _signed64(x: int) -> int:
    return (int(x) + 2**63) % 2**64 - 2**63


def _bits64_host(x: np.ndarray) -> np.ndarray:
    """Raw bits of a host stream widened to u64 (order-free fingerprints)."""
    if x.dtype.kind == "f":
        x = x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint64)
    return x.astype(np.uint64)


def _bits64(t: torch.Tensor) -> torch.Tensor:
    """A stream widened to int64 as `_bits64_host` widens it (signed
    integers sign-extended, the rest zero-extended), viewed as signed."""
    s = common.as_signed(t).reshape(-1)
    if s.element_size() == 8 or common.is_signed_int(t.dtype):
        return s.to(torch.int64)
    return s.to(torch.int64) & ((1 << (8 * s.element_size())) - 1)


def _xor_all(t: torch.Tensor) -> torch.Tensor:
    """xor of all elements, as a one-element tensor: torch has no xor
    reduction, so halves are folded, padded with a zero to even length."""
    if t.numel() == 0:
        return t.new_zeros(1)
    while t.numel() > 1:
        if t.numel() % 2:
            t = torch.cat([t, t.new_zeros(1)])
        h = t.numel() // 2
        t = t[:h] ^ t[h:]
    return t


def _device_validate(out, keys_host, pays_host, ascending) -> str:
    """On-device validation for cells too large to pull to the host: exact
    sortedness of the output keys in the carrier domain, key multiset
    conservation (sum and xor), and a key<->payload PAIR fingerprint per
    payload stream (any dropped, duplicated or decoupled row breaks at
    least one check with overwhelming probability).  Sums wrap mod 2^64 in
    int64 and are compared with the NumPy values viewed as signed.  The
    full host oracle (the default) stays on reference-size cells."""
    ko, pos = out[0], out[1]
    (w,) = transforms.key_operands(ko, ascending)
    sorted_ok = (w[1:] >= w[:-1]).all() if w.shape[0] else torch.tensor(
        True, device=w.device)
    k64 = _bits64(ko)
    sums = [k64.sum(), _xor_all(k64)]
    mix = _signed64(MIX64)
    for p in pos:
        pair = (k64 * mix) ^ _bits64(p)
        sums += [pair.sum(), _xor_all(pair)]
    got = torch.stack([sorted_ok.to(torch.int64).reshape(())]
                      + [s.reshape(()) for s in sums]).tolist()
    if not got[0]:
        return "output keys not sorted (device gate)"
    with np.errstate(over="ignore"):
        k64h = _bits64_host(keys_host)
        want = [k64h.sum(dtype=np.uint64), np.bitwise_xor.reduce(k64h)]
        for p in pays_host:
            pair = (k64h * MIX64) ^ _bits64_host(np.asarray(p))
            want += [pair.sum(dtype=np.uint64), np.bitwise_xor.reduce(pair)]
    labels = (["key sum", "key xor"]
              + [f"pair {i // 2} {'sum' if i % 2 == 0 else 'xor'}"
                 for i in range(2 * len(pays_host))])
    for g, wv, what in zip(got[1:], want, labels):
        if g != _signed64(wv):
            return f"{what} fingerprint mismatch (device gate)"
    return ""


def _stage(keys: np.ndarray, pays, device: torch.device):
    return (interop.from_numpy(keys, device),
            tuple(interop.from_numpy(p, device) for p in pays))


def measure_ns_per_element(method: str, num: int, key_dtype, payload_dtypes,
                           distribution=D.Distribution.UNIFORM,
                           ascending: bool = True, seed: int = 1,
                           validate=True, reps: int | None = None,
                           warmups: int | None = None,
                           device=None) -> float:
    """ns per element for one (method, workload) cell, reference protocol.

    validate: True/"host" = the full key-seeded payload oracle on the host
    (the reference protocol, perf.hpp:51-59); "device" = the on-device
    sortedness + fingerprint gate (for cells whose output is too large to
    pull to the host; host engines are checked on the host); False = skip.
    A wrong output raises WrongOutputError.

    float64 keys and payloads are staged as they are: the card stores them
    exactly, so the JAX package's f64-as-u64-bits staging has no
    counterpart."""
    dev = common.resolve_device(device)
    m = methods_mod.resolve(method, key_dtype, payload_dtypes, num,
                            device=dev)
    d_reps, d_warmups = rep_counts(num)
    reps = d_reps if reps is None else reps
    warmups = d_warmups if warmups is None else warmups
    if not m.device:
        reps, warmups = min(reps, HOST_MAX_REPS), min(warmups,
                                                      HOST_MAX_WARMUPS)
    on = dev if m.device else torch.device("cpu")

    def run(kd, pd):
        return m.run(kd, pd, ascending=ascending, stable=False,
                     block_threshold=None)

    # fresh data per dataset like the reference's clone per measurement
    # (perf.hpp:70-80), every dataset staged before the timed loop
    datasets = []
    for i in range(min(reps, 8)):
        keys = D.make_keys(num, key_dtype, distribution, seed + i)
        pays = D.make_payloads(keys, payload_dtypes, "fast")
        datasets.append((keys, pays, *_stage(keys, pays, on)))
    for w in range(warmups):
        run(*datasets[w % len(datasets)][2:])

    out = None

    def loop():
        nonlocal out
        for r in range(reps):
            # only the last output is kept alive
            out = run(*datasets[r % len(datasets)][2:])

    total = elapsed_seconds(on, loop)
    if validate and num and out is not None:
        keys, pays_host = datasets[(reps - 1) % len(datasets)][:2]
        if validate == "device" and m.device:
            err = _device_validate(out, keys, pays_host, ascending)
        else:
            err = D.check_data(interop.to_numpy(out[0]),
                               tuple(interop.to_numpy(p) for p in out[1]),
                               keys, ascending)
        if err:
            raise WrongOutputError(
                f"perf measurement produced wrong output ({err}) for "
                f"{method} {common.type_name(key_dtype)} n={num}")
    return total / reps / max(num, 1) * 1e9


def _workload_tag(key_dtype, payload_dtypes, *rest) -> str:
    return "-".join([common.type_name(key_dtype)]
                    + [common.type_name(p) for p in payload_dtypes]
                    + [str(r) for r in rest])


def table_name(key_dtype, payload_dtypes, distribution, num: int) -> str:
    """Canonical per-workload .dat file name (shared with resume logic)."""
    return _workload_tag(key_dtype, payload_dtypes, distribution.value,
                         num) + ".dat"


def _time_pipelined(fn, arg_sets, reps: int, device: torch.device,
                    warmups: int = 1, per_rep_fence: bool = False) -> float:
    """Seconds per call: launch `reps` calls back-to-back cycling over
    `arg_sets` and synchronize once (the shared timing protocol, see
    measure_ns_per_element).

    per_rep_fence=True releases the previous rep's output before each
    launch and synchronizes after it, so at most one result of GBs is
    alive at a time (the JAX package needed this at its 10^8-row packed
    tables); one synchronize costs microseconds against a sort of that
    size."""
    for w in range(warmups):
        fn(*arg_sets[w % len(arg_sets)])
    out = None

    def loop():
        nonlocal out
        for r in range(reps):
            if per_rep_fence:
                out = None  # release the previous result before launching
                out = fn(*arg_sets[r % len(arg_sets)])
                _sync(device)
            else:
                out = fn(*arg_sets[r % len(arg_sets)])

    return elapsed_seconds(device, loop) / reps


def _write_dat(name: str, header: str, rows) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in rows:
            f.write(" ".join(str(c) for c in row) + "\n")
    return path


def perf_test(methods, num: int, key_dtype, payload_dtypes,
              distribution=D.Distribution.UNIFORM, out_name: str | None = None,
              **kw) -> str:
    """Per-method ns/elem table for one workload (PerfTest::perfTest,
    perf.hpp:418-461; header perf.hpp:435)."""
    rows = []
    for m in methods:
        # capability-gate like the reference harness (isSupported, test.cpp:80)
        meth = methods_mod.REGISTRY.get(m)
        if meth is not None and not meth.supports(
                np.dtype(key_dtype),
                tuple(np.dtype(p) for p in payload_dtypes), num):
            continue
        ns = measure_ns_per_element(m, num, key_dtype, payload_dtypes,
                                    distribution, **kw)
        rows.append((m, f"{ns:.4f}"))
    return _write_dat(out_name or table_name(key_dtype, payload_dtypes,
                                             distribution, num),
                      "sort_method nanoseconds_per_element", rows)


def perf_test_num(methods, key_dtype, payload_dtypes,
                  distribution=D.Distribution.UNIFORM,
                  max_num: int = 1 << 22, min_num: int = 1, **kw) -> str:
    """n-scaling sweep, n = min_num, 2*min_num ... max_num
    (PerfTest::perfTestNum, perf.hpp:368-416; header perf.hpp:383-385)."""
    # a method must support EVERY size in the sweep to get a column
    # (size-capped methods like rank would otherwise crash mid-table);
    # selector names (auto/autotune) are not REGISTRY keys and always pass
    def _ok(m):
        meth = methods_mod.REGISTRY.get(m)
        return meth is None or meth.supports(
            np.dtype(key_dtype),
            tuple(np.dtype(p) for p in payload_dtypes), max_num)

    methods = [m for m in methods if _ok(m)]
    rows = []
    n = max(int(min_num), 1)
    while n <= max_num:
        row = [n]
        for m in methods:
            ns = measure_ns_per_element(m, n, key_dtype, payload_dtypes,
                                        distribution, **kw)
            row.append(f"{ns:.4f}")
        rows.append(row)
        n *= 2
    name = "tpe-" + _workload_tag(key_dtype, payload_dtypes,
                                  distribution.value) + ".dat"
    return _write_dat(name, "number_of_elements " + " ".join(methods), rows)


def perf_test_block(num: int, key_dtype, payload_dtypes,
                    digits=(4, 8, 16, 32),
                    distribution=D.Distribution.UNIFORM,
                    seed: int = 1, device=None) -> str:
    """Tuning-knob sweep: radix digit width, the engine's analogue of the
    reference's cmpSortThreshold sweep (perfTestThresh, perf.hpp:159-212):
    the knob that trades pass count against per-pass cost."""
    from .ops import radix
    dev = common.resolve_device(device)
    keys = D.make_keys(num, key_dtype, distribution, seed)
    kd, pays = _stage(keys, D.make_payloads(keys, payload_dtypes, "fast"),
                      dev)
    reps = rep_counts(num)[0]
    rows = []
    for b in digits:
        sec = _time_pipelined(
            lambda k, ps, b=b: radix.sort_arrays(k, ps, digit_bits=b),
            [(kd, pays)], reps, dev)
        rows.append((b, f"{sec / max(num, 1) * 1e9:.4f}"))
    name = "digits-" + _workload_tag(key_dtype, payload_dtypes,
                                     distribution.value, num) + ".dat"
    return _write_dat(name, "digitBits nanoseconds_per_element", rows)


def perf_test_thresh(num: int, key_dtype, payload_dtypes,
                     thresholds=(128, 256, 512, 1024, 2048, 4096),
                     distribution=D.Distribution.UNIFORM,
                     seed: int = 1, device=None) -> str:
    """cmpSortThreshold sweep (perfTestThresh, perf.hpp:159-212): the
    device quicksort's block_threshold sets the target segment size of the
    sampled-splitter partition, the same pass-count vs base-case-cost
    trade the reference's threshold controls."""
    from .ops import quick_sort
    dev = common.resolve_device(device)
    keys = D.make_keys(num, key_dtype, distribution, seed)
    kd, pays = _stage(keys, D.make_payloads(keys, payload_dtypes, "fast"),
                      dev)
    reps = min(256, rep_counts(num)[0])
    rows = []
    for t in thresholds:
        sec = _time_pipelined(
            lambda k, ps, t=t: quick_sort.sort_arrays(k, ps,
                                                      block_threshold=t),
            [(kd, pays)], reps, dev)
        rows.append((t, f"{sec / max(num, 1) * 1e9:.4f}"))
    name = "thresh-quick-" + _workload_tag(key_dtype, payload_dtypes,
                                           distribution.value, num) + ".dat"
    return _write_dat(name, "cmpThresh nanoseconds_per_element", rows)


def _payload_combo_for_factor(key_dtype, factor: int):
    """Payload streams totalling factor * sizeof(key) bytes, mirroring the
    reference's payload-size-factor studies (perfTestSpeedupAllKP,
    perf.hpp:214-362)."""
    size = np.dtype(key_dtype).itemsize * factor
    out = []
    while size >= 8:
        out.append(np.uint64)
        size -= 8
    for dt, b in ((np.uint32, 4), (np.uint16, 2), (np.uint8, 1)):
        while size >= b:
            out.append(dt)
            size -= b
    return tuple(out)


def perf_test_speedup(method_a: str, method_b: str, num: int,
                      key_dtypes=(np.uint32, np.int32, np.float32),
                      factors=(1, 2, 4, 8),
                      distribution=D.Distribution.UNIFORM, **kw) -> str:
    """Pairwise speedup table of method_a over method_b across key types
    and payload-size factors (perfTestSpeedup[AllKP/All],
    perf.hpp:214-362)."""
    rows = []
    for k in key_dtypes:
        row = [common.type_name(k)]
        for f in factors:
            ps = _payload_combo_for_factor(k, f)
            a = measure_ns_per_element(method_a, num, k, ps, distribution, **kw)
            b = measure_ns_per_element(method_b, num, k, ps, distribution, **kw)
            row.append(f"{b / a:.4f}")
        rows.append(row)
    name = (f"speedup-{method_a}-vs-{method_b}-{distribution.value}-{num}"
            ".dat")
    header = "key_type " + " ".join(f"factor{f}" for f in factors)
    return _write_dat(name, header, rows)


def perf_test_packed(num: int, key_dtype, payload_dtypes,
                     methods=("xla", "radix", "quick"),
                     distribution=D.Distribution.UNIFORM, seed: int = 1,
                     reps: int | None = None,
                     validate: bool = True, device=None) -> str:
    """Combined-layout ENGINE table: sort_packed(method=...) per device
    engine at one workload (reference combined entry
    src/radix_sort.hpp:314-332).  AoS conversion happens outside the timed
    region like the reference harness (perf.hpp:28-63); each engine's
    output is validated with the payload oracle."""
    from .ops import sort as sort_mod
    dev = common.resolve_device(device)
    reps = reps if reps is not None else rep_counts(num)[0]
    keys = D.make_keys(num, key_dtype, distribution, seed)
    pays = D.make_payloads(keys, payload_dtypes, "fast")
    packed = interop.from_numpy(sort_mod.pack_rows(keys, pays), dev)

    rows = []
    for m in methods:
        meth = methods_mod.REGISTRY.get(m)
        # pseudo payload streams of the packed transport: u32 words + u8 tail
        pbytes = sum(np.dtype(p).itemsize for p in payload_dtypes)
        pseudo = (np.dtype(np.uint32),) * (pbytes // 4) \
            + (np.dtype(np.uint8),) * (pbytes % 4)
        if meth is not None and not meth.supports(
                np.dtype(key_dtype), pseudo, num):
            continue

        def fn(p, m=m):
            return sort_mod.sort_packed(p, key_dtype, method=m, device=dev)

        sec = _time_pipelined(fn, [(packed,)], reps, dev,
                              per_rep_fence=num >= (1 << 25))
        if validate and num:
            out = interop.to_numpy(fn(packed))
            ko, po = sort_mod.unpack_rows(out, key_dtype, payload_dtypes)
            err = D.check_data(ko, po, keys, True)
            if err:
                raise WrongOutputError(
                    f"packed perf produced wrong output ({err}) for "
                    f"{m} {common.type_name(key_dtype)} n={num}")
        rows.append((m, f"{sec / max(num, 1) * 1e9:.4f}"))
    name = "packed-" + _workload_tag(key_dtype, payload_dtypes,
                                     distribution.value, num) + ".dat"
    return _write_dat(name, "sort_method nanoseconds_per_element", rows)


def perf_test_combined(num: int, key_dtype, payload_dtypes,
                       distribution=D.Distribution.UNIFORM, seed: int = 1,
                       reps: int | None = None, device=None) -> str:
    """Separate-stream vs combined-layout (AoS) cost for one workload, the
    reference's "+Combined" variant study (sort_methods.hpp:24-98).  The
    AoS<->SoA conversion happens outside the timed region, exactly like the
    reference harness (perf.hpp:28-63)."""
    from .ops import sort as sort_mod
    from .ops import xla_sort
    dev = common.resolve_device(device)
    reps = reps if reps is not None else rep_counts(num)[0]
    keys = D.make_keys(num, key_dtype, distribution, seed)
    pays = D.make_payloads(keys, payload_dtypes, "fast")

    rows = []
    sec = _time_pipelined(xla_sort.sort_arrays, [_stage(keys, pays, dev)],
                          reps, dev)
    rows.append(("separate", f"{sec / max(num, 1) * 1e9:.4f}"))

    packed = interop.from_numpy(sort_mod.pack_rows(keys, pays), dev)
    sec = _time_pipelined(
        lambda p: sort_mod.sort_packed(p, key_dtype, device=dev),
        [(packed,)], reps, dev)
    rows.append(("combined", f"{sec / max(num, 1) * 1e9:.4f}"))

    name = "combined-" + _workload_tag(key_dtype, payload_dtypes,
                                       distribution.value, num) + ".dat"
    return _write_dat(name, "layout nanoseconds_per_element", rows)
