"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 also breakdown; build_s, the
seconds of set-up spent loading the port's kernels, nvcc's build included
where the checkout had none; and last the numbers compared with the
reference beside their limits, which are also the last lines of standard
error).  Without a card, with fewer cards than
the cell asks for, or with `jax` or the JAX package loaded by the end, it
prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import guard, harness

    bench = harness.load_benchmark()
    wl, _ = harness.cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), device, T0,
        bench=bench, log=log)
    bad = guard.forbidden_loaded()
    if bad:
        log(f"modules loaded that the port must not load: {bad}: no result")
        return 3
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
