"""The port's one-command gate: build, packaging, lint, tests and the entry
points, stopping at the first step that fails.

Counterpart of ci.sh, section by section:

    python -m simd_radix_sort_tpu_torch.gate [--quick] [--multiproc] \
        [--device cpu]

  native     the native harness (utils/native.build, g++) and, unless
             --device cpu, the CUDA kernels (ops/_build.library, nvcc);
  install    ci.sh's `pip install -e .` flags, as `pip wheel` into
             build/srs_torch/wheel/ (offline, no cache): the same packaging
             of the same pyproject.toml, checked to carry this package and
             its kernel sources, without changing the interpreter's
             installed packages;
  lint       ruff, else pyflakes, on this package and tests/test_torch_*.py;
             with neither installed, skipped with ci.sh's notice;
  tests      pytest on tests/test_torch_*.py (-m "not slow" with --quick);
  entry      entry.entry() and entry.dryrun_multichip(P): P the cards, or 8
             Gloo ranks with --device cpu;
  multiproc  with --multiproc, dryrun_multichip on 2 and 4 Gloo ranks.

ci.sh's golden A/B step is left out: it compiles the reference's own C++
header, which is not part of this repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import shutil
import subprocess
import sys
import time
import traceback
import zipfile
from pathlib import Path
from typing import Callable

import torch

from . import entry as entry_mod
from .ops import _build
from .utils import common, native

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent.name
WHEEL_DIR = _build.BUILD_DIR / "wheel"
LINT_SKIPPED = "  (ruff/pyflakes not installed; skipping lint)"


@dataclasses.dataclass(frozen=True)
class Step:
    """One section of the gate: `run()` raises when it fails.  `argv` is
    the command it runs, where it runs one."""
    name: str
    run: Callable[[], object]
    argv: tuple = ()


def _command(argv) -> Callable[[], int]:
    def run():
        return subprocess.run(list(argv), cwd=REPO, check=True).returncode
    return run


def port_tests() -> list[str]:
    return sorted(str(p.relative_to(REPO))
                  for p in (REPO / "tests").glob("test_torch_*.py"))


def lint_argv() -> tuple:
    """ruff's command, else pyflakes', else () (no linter installed)."""
    targets = [PACKAGE, *port_tests()]
    ruff = shutil.which("ruff")
    if ruff:
        return (ruff, "check", *targets)
    if importlib.util.find_spec("pyflakes"):
        return (sys.executable, "-m", "pyflakes", *targets)
    return ()


def _build_native(device) -> None:
    print(f"  native harness: {native.build()}")
    if device.type == "cuda":
        _build.library()
        print(f"  CUDA kernels: {_build.library_path()}")


def _wheel(argv) -> Path:
    """Build the wheel and check what it holds."""
    shutil.rmtree(WHEEL_DIR, ignore_errors=True)
    _command(argv)()
    (wheel,) = WHEEL_DIR.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    pkg = REPO / PACKAGE
    missing = [str(p.relative_to(REPO)) for p in
               [*pkg.rglob("*.py"), *pkg.glob("csrc/*.cu")]
               if str(p.relative_to(REPO)) not in names]
    if missing:
        raise AssertionError(f"{wheel.name} lacks {missing}")
    print(f"  {wheel.name}: {len(names)} files")
    return wheel


def _entry(device, ranks: int) -> dict:
    step, args = entry_mod.entry(device)
    keys, _ = step(*args)
    print(f"  entry: OK {tuple(keys.shape)} on {device}")
    rec = entry_mod.dryrun_multichip(ranks, device)
    print(f"  dryrun_multichip({ranks}): OK")
    return rec


def _multiproc() -> list:
    cpu = torch.device("cpu")
    return [entry_mod.dryrun_multichip(p, cpu) for p in (2, 4)]


def plan(quick: bool = False, multiproc: bool = False,
         device=None) -> list[Step]:
    """The gate's steps, in ci.sh's order (None is the cards)."""
    dev = common.resolve_device(device)
    wheel_argv = (sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                  "--no-build-isolation", "--no-index", "--no-cache-dir",
                  "--quiet", "--wheel-dir", str(WHEEL_DIR))
    test_argv = (sys.executable, "-m", "pytest", *port_tests(), "-q",
                 *(("-m", "not slow") if quick else ()))
    lint = lint_argv()
    ranks = entry_mod.default_ranks(dev)
    steps = [Step("native", lambda: _build_native(dev)),
             Step("install", lambda: _wheel(wheel_argv), wheel_argv),
             Step("lint", _command(lint) if lint else
                  lambda: print(LINT_SKIPPED), lint),
             Step("tests", _command(test_argv), test_argv),
             Step("entry", lambda: _entry(dev, ranks))]
    if multiproc:
        steps.append(Step("multiproc", _multiproc))
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help='tests with -m "not slow"')
    ap.add_argument("--multiproc", action="store_true",
                    help="also the dry run on 2 and 4 Gloo ranks")
    ap.add_argument("--device", default=None,
                    help="cpu: no CUDA build, Gloo ranks (default: the "
                         "cards)")
    args = ap.parse_args(argv)
    for step in plan(args.quick, args.multiproc, args.device):
        print(f"== {step.name} ==", flush=True)
        t0 = time.perf_counter()
        try:
            step.run()
        except Exception:  # the gate's boundary: report the step, stop
            traceback.print_exc()
            print(f"gate: {step.name} FAILED", flush=True)
            return 1
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    print("gate: all green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
