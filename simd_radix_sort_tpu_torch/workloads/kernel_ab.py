"""Time the counting kernels of two or more checkouts in turns on one card.

    python -m simd_radix_sort_tpu_torch.workloads.kernel_ab \\
        --trees PARENT,CHANGE,CHANGE,PARENT [--n ROWS] [--out FILE]

Each entry of --trees is the root of a checkout of this repository (an
unpacked `git archive`, say); the same root may come more than once, so
that the versions alternate.  For each entry in order, one child process
runs from that root, with that root's package and `chip_smoke.py` on its
path: it builds that checkout's kernels, then records

  - K2 and K3 at chip_smoke's 22 shapes (`k23_shape_timings`: int32 and
    int16 keys at the eight reference distributions and S6-S8's draws, n
    rows each), each held against its plain version;
  - the device ms of bare launches of K1 (uint8 k = 256, int32 k = 1024),
    K4 (int8 k = 256, int32 k = 1024), K5 (two int64 streams, a random
    mask) and K6 (uint8 k = 256) at n rows, through entry points whose
    signatures every checkout since the tile-driven fills shares.

Then this process times each checkout's `minmax_hist16` and
`tiny_sort16` calls at 2^22 Uniform int32 and int16 keys, the checkouts'
packages imported side by side and timed in turns (CALL_ROUNDS rounds,
the order reversed every other round): a call at that size is host-bound,
and host times differ more between processes than between the versions,
so only one process can compare them.

The records go to --out (JSON: one per entry, in order, and the turns)
and a summary of each tree's medians to standard output.  Needs one CUDA
card; nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

CALL_N = 1 << 22
CALL_ROUNDS = 5


def _held(name, got, want, what):
    import torch

    for g, w in zip(got, want):
        if not torch.equal(g.to(torch.int64), w.to(torch.int64)):
            raise AssertionError(f"{name} {what}: kernel differs from its "
                                 "plain version")


def worker(n: int, seed: int, reps: int) -> dict:
    """One checkout's record; runs with that checkout on sys.path."""
    import torch

    import chip_smoke as cs
    from simd_radix_sort_tpu_torch.ops import (_build, cuda_hist as ch,
                                               cuda_partition as cp)

    dev = torch.device("cuda")
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rec = {"k23": cs.k23_shape_timings(n, seed, reps, dev, _held)}

    def ri(lo, hi, size, dtype):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=dtype)

    tile = ch.FILL_TILE_BYTES
    bare = {}
    u8 = ri(0, 256, n, torch.uint8)
    i32 = ri(0, 1000, n, torch.int32)
    h1 = torch.zeros(256, dtype=torch.int32, device=dev)
    h2 = torch.zeros(1024, dtype=torch.int32, device=dev)
    bare["K1 uint8 k=256"] = lambda: _build.launch(
        "srs_histogram", dev, u8.data_ptr(), 1, n, 0, 256, h1.data_ptr())
    bare["K1 int32 k=1024"] = lambda: _build.launch(
        "srs_histogram", dev, i32.data_ptr(), 4, n, 0, 1024, h2.data_ptr())
    h256 = torch.bincount(u8.to(torch.int64), minlength=256).to(torch.int32)
    h1024 = torch.bincount(i32.to(torch.int64), minlength=1024).to(
        torch.int32)
    o8 = torch.empty(n, dtype=torch.int8, device=dev)
    o32 = torch.empty(n, dtype=torch.int32, device=dev)
    bare["K4 int8 k=256"] = lambda: _build.launch(
        "srs_fill_runs", dev, h256.data_ptr(), 256, n, 0x80, 1, tile,
        o8.data_ptr())
    bare["K4 int32 k=1024"] = lambda: _build.launch(
        "srs_fill_runs", dev, h1024.data_ptr(), 1024, n, 0, 4, tile,
        o32.data_ptr())
    n4 = n - n % 4
    bare["K6 uint8 k=256"] = lambda: _build.launch(
        "srs_fill_runs_packed", dev, h256.data_ptr(), 256, n4, tile,
        o8.data_ptr())
    mask = ri(0, 2, n, torch.int64) == 1
    streams = [ri(-(2**62), 2**62, n, torch.int64) for _ in range(2)]
    outs = [torch.empty_like(s) for s in streams]
    block = cp.PART_BLOCK
    counts = torch.empty(-(-n // block), dtype=torch.int32, device=dev)
    _build.launch("srs_partition_count", dev, mask.data_ptr(), n, block,
                  counts.data_ptr())
    left_off = ch.prefix_counts(counts)
    import ctypes

    ptrs = ((ctypes.c_void_p * 2)(*(s.data_ptr() for s in streams)),
            (ctypes.c_void_p * 2)(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * 2)(8, 8))

    def k5():
        _build.launch("srs_partition_count", dev, mask.data_ptr(), n, block,
                      counts.data_ptr())
        _build.launch("srs_partition_scatter", dev, mask.data_ptr(), n,
                      block, left_off.data_ptr(), 2, *ptrs)

    bare["K5 2 x int64, random mask"] = k5
    rec["bare_device_ms"] = {
        label: [cs.event_device_ms([fn]) for _ in range(3)]
        for label, fn in bare.items()}
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return rec


def summary(tree: str, recs: list) -> dict:
    """Medians over a tree's records: K2/K3 device ms by shape, bare
    device ms."""
    out = {"tree": tree, "k23": {}, "bare_device_ms": {}}
    for r in recs:
        for row in r["k23"]:
            out["k23"].setdefault(f"{row['name']} {row['shape']}",
                                  []).append(row["device_ms"])
        for k, v in r["bare_device_ms"].items():
            out["bare_device_ms"].setdefault(k, []).extend(v)
    for part in ("k23", "bare_device_ms"):
        out[part] = {k: statistics.median(v) for k, v in out[part].items()}
    return out


def _package(tree: str, alias: str):
    """The checkout's package, imported under `alias` (its imports are
    relative, so two checkouts' packages live side by side)."""
    import importlib
    import importlib.util

    root = Path(tree, "simd_radix_sort_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def calls_in_turns(trees: list, seed: int, reps: int) -> dict:
    """{tree: {"<wrapper> <dtype>": [call ms of each round]}}: each tree's
    own minmax_hist16 and tiny_sort16 wrappers (its package imported
    under an alias, its library as its child built it) at CALL_N Uniform
    int32 and int16 keys, the trees in turns for CALL_ROUNDS rounds, the
    order reversed every other round; each output held equal to the plain
    version's."""
    import importlib

    import torch

    import chip_smoke as cs

    hists = {}
    for i, tree in enumerate(trees):
        _package(tree, f"kernel_ab_tree{i}")
        hists[tree] = importlib.import_module(
            f"kernel_ab_tree{i}.ops.cuda_hist")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = {d: cs.device_keys(d, "Uniform", CALL_N, gen, dev)
            for d in cs.K23_TYPES}
    out = {tree: {} for tree in trees}
    for r in range(CALL_ROUNDS):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            ch = hists[tree]
            for d, x in keys.items():
                flip = 1 << (8 * x.element_size() - 1)
                for name in ("minmax_hist16", "tiny_sort16"):
                    fn = getattr(ch, name)
                    _held(name, fn(x, flip),
                          getattr(ch, name + "_plain")(x, flip),
                          f"{tree} {d}")
                    out[tree].setdefault(f"{name} {d}", []).append(
                        cs.time_calls(lambda: fn(x, flip), 3 * reps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", required=True,
                    help="comma-separated checkout roots, timed in order")
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rec = worker(args.n, args.seed, args.reps)
        Path(args.out).write_text(json.dumps(rec))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in args.trees.split(",")]
    out = Path(args.out or "kernel_ab.json").resolve()
    records = []
    for i, tree in enumerate(trees):
        part = out.with_suffix(f".{i}.json")
        # -P: the checkout, not this file's directory, comes first on the
        # path, so the child imports that checkout's package
        env = {**os.environ, "PYTHONPATH": tree}
        subprocess.run([sys.executable, "-P", __file__, "--worker",
                        "--trees", tree, "--n", str(args.n), "--reps",
                        str(args.reps), "--seed", str(args.seed), "--out",
                        str(part)], cwd=tree, env=env, check=True)
        records.append({"tree": tree, **json.loads(part.read_text())})
        part.unlink()
        print(f"kernel_ab: {tree} done", flush=True)
    distinct = list(dict.fromkeys(trees))
    turns = calls_in_turns(distinct, args.seed, args.reps)
    summaries = [{**summary(t, [r for r in records if r["tree"] == t]),
                  "calls_in_turns": {k: statistics.median(v)
                                     for k, v in turns[t].items()}}
                 for t in distinct]
    out.write_text(json.dumps({"records": records, "summaries": summaries,
                               "calls_in_turns": turns}, indent=1))
    for s in summaries:
        print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
