"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the comparison with the reference, the metrics.

The window is a closed loop with one caller, as a pipeline or a TPC-H
power-test stream calls the library: the next call starts when the
previous one has ended in `torch.cuda.synchronize()`.  Each call's latency
is taken by CUDA events around it (a host clock cannot resolve the
sub-millisecond calls of some cells).  The answers the mix keeps for the
comparison are copied to the host right after their call; that copy is the
benchmark's work, not the system's, and its time is taken out of the
window.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

from . import calls, trace

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCHMARK_JSON = REPO / "BENCHMARK.json"


def load_file_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py`, which may carry dots in its name."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"benchmark.{kind}.{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: dict, workload: str):
    """(the workload entry, its configuration entry)."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"no configuration {w['config']!r}")
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with the trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


class Context:
    """What a configuration's operations see of a run: the device, and
    spans that mark the layers in a traced stretch (free otherwise)."""

    def __init__(self, device):
        self.device = device
        self.tracing = False

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Record:
    """One call of the window."""
    call: calls.Call
    latency_ms: float = 0.0
    facts: dict = dataclasses.field(default_factory=dict)
    waits: int | None = None      # host waits, where counted
    traced: bool = False          # inside the profiled stretch
    answer: object = None         # the kept answer, on the host
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    workload: str
    records: list
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: object = None          # trace.Trace of the profiled stretch

    @staticmethod
    def work(operation: str):
        return load_file_module("work", operation)

    @property
    def done(self):
        return [r for r in self.records if r.error is None]

    @property
    def traced(self):
        return [r for r in self.done if r.traced]


class _Clock:
    """Latency of one call: CUDA events on the card, the host clock on the
    CPU (the tests' runs)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            import torch
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        self.t = time.perf_counter()

    def stop(self, ctx) -> float:
        if self.cuda:
            self.b.record()
            ctx.sync()
            return self.a.elapsed_time(self.b)
        ctx.sync()
        return (time.perf_counter() - self.t) * 1e3


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _load_kernels(device):
    """Seconds to load the port's kernel library, which includes nvcc's
    build when the checkout's cache (`build/srs_torch/`) has none yet;
    None where the port keeps no such library.  Part of `setup_s`, and
    reported apart so that a run that builds shows as one."""
    if device.type != "cuda":
        return None
    try:
        from simd_radix_sort_tpu_torch.ops import _build
        load = _build.library
    except (ImportError, AttributeError):
        return None
    t = time.perf_counter()
    load()
    return time.perf_counter() - t


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t0: float, bench: dict | None = None,
             config_override: dict | None = None,
             mix_override: dict | None = None, ops: dict | None = None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)):
    """Run one cell once.  Returns (result dict, checks dict), the result
    without its "checks" key.  `config_override` replaces keys of the
    configuration file, `mix_override` keys of the traffic mix, and `ops`
    the configuration's operations (the control, and the tests' faults)."""
    import torch

    from . import syncs

    bench = load_benchmark() if bench is None else bench
    wl, cfg_entry = cell_of(bench, workload)
    cfg = json.loads((REPO / cfg_entry["file"]).read_text())
    cfg.update(config_override or {})
    mix = dict(calls.load(wl["traffic"]), **(mix_override or {}))
    conf = load_file_module("configs", cfg_entry["name"])
    ref = load_file_module("reference", cfg_entry["name"])
    operations = dict(conf.OPS, **(ops or {}))

    def since_start():
        return f"{time.perf_counter() - t0:.3f} s"

    ctx = Context(device)
    log(f"set-up: imports and the device at {since_start()}")
    build_s = _load_kernels(device)
    if build_s is not None:
        log(f"set-up: the port's kernels loaded in {build_s:.3f} s")
    state = conf.setup(cfg, mix, seed, ctx)
    ctx.sync()
    log(f"set-up: data made at {since_start()}")
    for c in calls.warm_calls(mix):
        out = operations[c.op](state, c.params, ctx)
        del out
    ctx.sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    cuda = device.type == "cuda"
    # the profiled stretch leaves at least half the window for the host
    # waits and the answers kept for the comparison
    trace_s = min(float(mix.get("trace_seconds", seconds)), seconds / 2)
    span_names = set(conf.SPANS)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
    clock = _Clock(device)
    records, excluded = [], 0.0
    gen, keep = calls.stream(mix, seed), calls.Keeper(mix, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ctx.sync()
    # no collector pauses inside the window: the loop makes no cycles, and
    # a full collection over its growing records would stall the caller
    gc.collect()
    gc.disable()
    window_span = None
    profiling = False
    wait_sites = collections.Counter()
    if prof is not None:
        prof.start()
        profiling = ctx.tracing = True
        window_span = ctx.span(trace.WINDOW)
        window_span.__enter__()
    start = time.perf_counter()
    while time.perf_counter() - start - excluded < seconds:
        if profiling and time.perf_counter() - start - excluded >= trace_s:
            window_span.__exit__(None, None, None)
            prof.stop()
            profiling = ctx.tracing = False
        call = next(gen)
        # no copy for the comparison in the trace: put off past it
        kept = keep(call, now=not profiling)
        rec = Record(call, traced=profiling)
        fn = operations[call.op]
        count_waits = traced and not profiling and cuda
        try:
            with ctx.span(trace.CALL):
                clock.start()
                if count_waits:
                    (out, rec.facts), waits = syncs.host_syncs(
                        lambda: fn(state, call.params, ctx))
                    rec.waits = len(waits)
                    wait_sites.update(waits)
                else:
                    out, rec.facts = fn(state, call.params, ctx)
                rec.latency_ms = clock.stop(ctx)
        except Exception:  # a call that raises has failed; the loop goes on
            rec.error = traceback.format_exc(limit=4)
            log(f"call {call.index} {call.op} {call.params} failed:\n"
                f"{rec.error}")
            ctx.sync()
            records.append(rec)
            continue
        if kept:
            t = time.perf_counter()
            rec.answer = conf.capture(state, call, out)
            excluded += time.perf_counter() - t
        del out
        records.append(rec)
    window_s = time.perf_counter() - start - excluded
    gc.enable()
    if profiling:
        window_span.__exit__(None, None, None)
        prof.stop()
        ctx.tracing = False
    peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(workload, records, window_s, setup_s, peak)
    if prof is not None:
        run.trace = trace.from_profiler(prof, span_names)
        del prof
        for label, at, sec in run.trace.longest_gaps():
            log(f"idle gap {sec:.6f} s at {at:.6f} s: {label}")
    for site, count in wait_sites.most_common(10):
        log(f"host waits: {count} at {site}")
    log(f"window {window_s:.3f} s, {len(records)} calls")

    kept = [r for r in records if r.answer is not None]
    t = time.perf_counter()
    checks, wrong = conf.compare(state, kept, ref, ctx, cfg)
    failed = sum(r.error is not None for r in records) + wrong
    log(f"compared {len(kept)} answers with the reference in "
        f"{time.perf_counter() - t:.3f} s, {wrong} wrong")
    metrics = {}
    for m in metrics_of(bench, workload, traced):
        v = load_file_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    result = {"correct": failed == 0 and bool(kept)
              and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev, "build_s": build_s}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    return result, checks
