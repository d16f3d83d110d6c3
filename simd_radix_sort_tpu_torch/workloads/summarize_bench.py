"""Summarize the port's campaign tables against the reference's numbers.

Counterpart of scripts/summarize_bench.py, with its columns, filters and
order: for every method table of a campaign directory (default
bench_out_h100/, workloads/campaign.py's tables), the best device engine
beside the reference's own RadixSIMD and its best competitor row from the
thesis' published tables of the same name, with speedups, and beside the
REF_HOST.json cells: the reference's C++ (RadixSIMD, RadixSeq, STLSort and
the vendored BlacherSort and BramasSort) timed on one core of the CPU that
file names, which is not the card's host.  Workloads without an anchor
print "—"; so do the thesis columns when no --ref-dir is given (the thesis
tables are not part of this repository).  The JAX script's last column,
device time from a TPU trace, has no counterpart here.

    python -m simd_radix_sort_tpu_torch.workloads.summarize_bench \
        [DIR] [--ref-dir THESIS_DATA_DIR]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
REF_HOST = REPO / "REF_HOST.json"

OUR_DEVICE_METHODS = ("xla", "radix", "count", "rank", "quick")
# the reference's own algorithm rows vs vendored competitor rows
REF_OWN = ("RadixSIMD",)
REF_SKIP = ("RadixSeq", "MoellerSeq", "STLSort")  # scalar baselines
SKIPPED_TABLES = ("tpe-", "digits-", "speedup-", "combined-", "thresh-",
                  "quickstudy-")


def parse(path) -> dict:
    """A table's {method: ns/element} rows; {} when it cannot be read."""
    rows = {}
    try:
        with open(path) as f:
            next(f)
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    rows[parts[0]] = float(parts[1])
    except (OSError, StopIteration):
        pass
    return rows


def load_ref_host(path=REF_HOST) -> tuple[str | None, dict]:
    """(the CPU it was timed on, {(combo, dist, n): {method: ns/elem}})."""
    try:
        with open(path) as f:
            report = json.load(f)
    except (OSError, ValueError):
        return None, {}
    out = {}
    for c in report["cells"]:
        out.setdefault((c["combo"], c["dist"], str(c["n"])), {})[
            c["method"]] = c["ns_per_elem"]
    return report.get("cpu"), out


def summary_tables(out_dir) -> list[str]:
    """The method tables the summary reads, in its order."""
    return [f for f in sorted(os.listdir(out_dir))
            if f.endswith(".dat") and not f.startswith(SKIPPED_TABLES)
            and any(m in OUR_DEVICE_METHODS
                    for m in parse(os.path.join(out_dir, f)))]


def header(host: dict, cpu: str | None) -> list[str]:
    host_hdr = (f" {'RadixSIMD':>14s} {'x':>6s} {'best':>16s}"
                if host else "")
    cols = (f"{'workload':44s} {'ours':>7s} {'engine':>7s} "
            f"{'RadixSIMD':>10s} {'x':>6s} {'best-other':>16s} {'x':>6s}")
    if not host:
        return [cols + host_hdr]
    group = f"{'':{len(cols)}s} REF_HOST.json, one core of {cpu}"
    return [group, cols + host_hdr]


def rows(out_dir, ref_dir=None, host=None) -> list[str]:
    """One line per method table of `out_dir`."""
    host = host or {}
    lines = []
    for fname in summary_tables(out_dir):
        stem = fname[:-4].split("-")
        key, dist, num = stem[0], stem[-2], stem[-1]
        pays = ",".join(stem[1:-2])
        got = {m: v for m, v in parse(os.path.join(out_dir, fname)).items()
               if m in OUR_DEVICE_METHODS}
        best_m, best = min(got.items(), key=lambda kv: kv[1])
        label = (f"{key}+{pays} {dist} n={num}" if pays
                 else f"{key} {dist} n={num}")

        combo = f"{key}+{pays}" if pays else key
        hc = host.get((combo, dist, num), {})
        h = hc.get("RadixSIMD")
        host_col = (f" {h:14.2f} {h / best:5.1f}x" if h is not None
                    else (f" {'—':>14s} {'—':>6s}" if host else ""))
        if host:
            if hc:
                hb_m, hb = min(hc.items(), key=lambda kv: kv[1])
                host_col += f" {hb:6.2f} ({hb_m[:9]:9s})"
            else:
                host_col += f" {'—':>16s}"

        ref_rows = parse(os.path.join(ref_dir, fname)) if ref_dir else {}
        r_own = ref_rows.get("RadixSIMD")
        others = {m: v for m, v in ref_rows.items()
                  if m not in REF_OWN + REF_SKIP}
        if r_own is not None:
            r_best_m, r_best = min(others.items(), key=lambda kv: kv[1]) \
                if others else ("-", r_own)
            lines.append(
                f"{label:44s} {best:7.2f} {best_m:>7s} "
                f"{r_own:10.2f} {r_own / best:5.1f}x "
                f"{r_best:6.2f} ({r_best_m[:9]:9s}) {r_best / best:5.1f}x"
                f"{host_col}")
        else:
            lines.append(f"{label:44s} {best:7.2f} {best_m:>7s} "
                         f"{'—':>10s} {'—':>6s} {'—':>16s}{host_col}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default=str(REPO / "bench_out_h100"))
    ap.add_argument("--ref-dir", default=None,
                    help="the thesis' published tables (its data/ folder)")
    args = ap.parse_args(argv)
    cpu, host = load_ref_host()
    for line in header(host, cpu) + rows(args.out_dir, args.ref_dir, host):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
