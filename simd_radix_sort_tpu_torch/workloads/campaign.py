"""The measurement campaign that fills bench_out_h100/.

Runs the perf drivers' tiers, each as a child process with
SRS_TORCH_PERF_DIR pointing at --out, and the large-n count-vs-xla sweeps
that set the `auto` policy's crossovers, and appends to --out/CARD.json
what it ran: the card (`nvidia-smi` name and power limit), torch, CUDA,
the commit it was given, a digest of the port's sources, and each command
with its wall time, exit code and the tables it wrote.  A part that
reaches --deadline-s is stopped; run the same parts again and each driver
resumes where it stopped (--resume).

    python -m simd_radix_sort_tpu_torch.workloads.campaign --parts a,b,c,d
        [--out bench_out_h100] [--deadline-s 3000] [--commit SHA]

Parts:
  a  perf_suite --full --n 4194304: 11 combos x 8 distributions of method
     tables, sweeps, knobs, the quicksort study and speedups at 2^22 rows;
  b  perf_suite --tpe-breadth: sweeps 2^10..2^22 and the 10^8 anchors;
  c  knob_epoch at its default n;
  d  xla and count, 2^14..2^27 rows, keys-only: uint8 Uniform, int32
     Uniform, Zero and ZeroOne, into <out>/large_n/ (the device gate from
     2^24 rows up);
  e  perf_suite at 2^18 (default and --full), --int8, --packed, and
     remeasure_noise;
  f  the evidence past the 2- and 4-byte crossover: xla and count sweeps
     of int16 Uniform and Zero into <out>/large_n/, and method tables of
     the device engines for int16, int32 and uint32 keys-only at 2^23 and
     2^24 rows over the 8 distributions.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from .. import perf
from ..utils import common
from ..utils import data as D

PKG = Path(__file__).resolve().parent.parent
DRIVER = "simd_radix_sort_tpu_torch.workloads."

PARTS = {
    "a": [["perf_suite", "--full", "--n", "4194304", "--resume"]],
    "b": [["perf_suite", "--tpe-breadth", "--resume"]],
    "c": [["knob_epoch", "--resume"]],
    "d": [["campaign", "--sweep", "uint8-Uniform"],
          ["campaign", "--sweep", "int32-Uniform"],
          ["campaign", "--sweep", "int32-Zero"],
          ["campaign", "--sweep", "int32-ZeroOne"]],
    "e": [["perf_suite", "--resume"],
          ["perf_suite", "--full", "--resume"],
          ["perf_suite", "--int8", "--resume"],
          ["perf_suite", "--packed", "--resume"],
          ["remeasure_noise"]],
    "f": [["campaign", "--sweep", "int16-Uniform"],
          ["campaign", "--sweep", "int16-Zero"],
          ["campaign", "--tables", "int16"],
          ["campaign", "--tables", "int32"],
          ["campaign", "--tables", "uint32"]],
}

# part d: the sweep's rows, and where its validation moves to the device
LARGE_N_DIR = "large_n"
LARGE_N_METHODS = ["xla", "count"]
LARGE_N_MIN = 1 << 14
LARGE_N_DEVICE_GATE = 1 << 24
LARGE_N_MAX = 1 << 27
# part f: the sizes and engines of the 2- and 4-byte keys-only tables
ADAPTIVE_TABLE_NS = (1 << 23, 1 << 24)
DEVICE_METHODS = ["xla", "radix", "count", "quick"]


def large_n_sweep(key_dtype, distribution, device=None,
                  min_num: int = LARGE_N_MIN,
                  device_gate: int = LARGE_N_DEVICE_GATE,
                  max_num: int = LARGE_N_MAX) -> str:
    """One tpe table of xla and count, min_num..max_num rows, into
    perf.OUT_DIR: two perf_test_num sweeps, the host oracle below
    `device_gate` rows and the device gate from there, joined into one
    table under perf_test_num's name and header."""
    on = {"device": common.resolve_device(device)}
    low = perf.perf_test_num(LARGE_N_METHODS, key_dtype, (), distribution,
                             min_num=min_num, max_num=device_gate // 2,
                             **on)
    with open(low) as f:
        low_lines = f.read().splitlines()
    os.replace(low, low + ".low")
    high = perf.perf_test_num(LARGE_N_METHODS, key_dtype, (), distribution,
                              min_num=device_gate, max_num=max_num,
                              validate="device", **on)
    with open(high) as f:
        high_lines = f.read().splitlines()
    if high_lines[0] != low_lines[0]:
        raise AssertionError(f"{high}: headers differ: {low_lines[0]!r} "
                             f"and {high_lines[0]!r}")
    with open(high, "w") as f:
        f.write("\n".join(low_lines + high_lines[1:]) + "\n")
    os.remove(low + ".low")
    return high


def sources_digest() -> str:
    """sha256 over the port's Python and CUDA sources, in path order."""
    h = hashlib.sha256()
    for p in sorted(PKG.rglob("*")):
        if p.suffix in (".py", ".cu") and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(PKG)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _tables(out: Path) -> dict:
    return {str(p.relative_to(out)): p.stat().st_mtime
            for p in out.rglob("*.dat")}


def run_command(argv, out: Path, timeout_s: float, device=None) -> dict:
    """One driver as a child process writing into `out`; returns its
    record (stopped, not raised, at the timeout)."""
    cmd = [sys.executable, "-m", DRIVER + argv[0], *argv[1:]]
    if device is not None:
        cmd += ["--device", str(device)]
    env = {**os.environ, "SRS_TORCH_PERF_DIR": str(out)}
    before = _tables(out)
    t0 = time.perf_counter()
    try:
        rc = subprocess.run(cmd, env=env, timeout=max(timeout_s, 1)).returncode
        cut = False
    except subprocess.TimeoutExpired:
        rc, cut = None, True
    after = _tables(out)
    return {"command": " ".join(["python", *cmd[1:]]),
            "env": {"SRS_TORCH_PERF_DIR": str(out)},
            "seconds": time.perf_counter() - t0, "rc": rc,
            "cut_at_deadline": cut,
            "tables": sorted(k for k, v in after.items()
                             if before.get(k) != v)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="a,b,c,d")
    ap.add_argument("--out", default="bench_out_h100")
    ap.add_argument("--deadline-s", type=float, default=3000.0)
    ap.add_argument("--commit", default=None,
                    help="the commit the sources were checked out from")
    ap.add_argument("--sweep", default=None,
                    help="run one part-d sweep, <key type>-<distribution>, "
                         "into $SRS_TORCH_PERF_DIR/large_n")
    ap.add_argument("--tables", default=None,
                    help="run one part-f key type's method tables into "
                         "$SRS_TORCH_PERF_DIR")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)

    if args.tables:
        kdt = common.NAME_TO_DTYPE[args.tables]
        dev = common.resolve_device(args.device)
        for n in ADAPTIVE_TABLE_NS:
            for dist in D.ALL_DISTRIBUTIONS:
                name = perf.table_name(kdt, (), dist, n)
                if os.path.exists(os.path.join(perf.OUT_DIR, name)):
                    print("skip", name, flush=True)
                    continue
                print("wrote", perf.perf_test(DEVICE_METHODS, n, kdt, (),
                                              dist, device=dev), flush=True)
        return 0

    if args.sweep:
        type_name, dist = args.sweep.split("-")
        kdt = common.NAME_TO_DTYPE[type_name]
        perf.OUT_DIR = os.path.join(perf.OUT_DIR, LARGE_N_DIR)
        name = f"tpe-{args.sweep}.dat"
        if os.path.exists(os.path.join(perf.OUT_DIR, name)):
            print("skip", name, flush=True)
            return 0
        print("wrote", large_n_sweep(kdt, D.Distribution(dist), args.device),
              flush=True)
        return 0

    import torch
    dev = common.resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card_path = out / "CARD.json"
    card = (json.loads(card_path.read_text()) if card_path.exists()
            else {"calls": []})
    call = {"card": _card() if dev.type == "cuda" else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "commit": args.commit, "sources_sha256": sources_digest(),
            "started": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
            "commands": []}
    card["calls"].append(call)
    deadline = time.perf_counter() + args.deadline_s
    failed = False
    for part in args.parts.split(","):
        for cmd in PARTS[part]:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            rec = run_command(cmd, out, left,
                              None if dev.type == "cuda" else "cpu")
            rec["part"] = part
            call["commands"].append(rec)
            failed |= rec["rc"] not in (0, None)
            print("campaign:", json.dumps(rec), flush=True)
            card_path.write_text(json.dumps(card, indent=1) + "\n")
    card_path.write_text(json.dumps(card, indent=1) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
