"""The port's entry points (simd_radix_sort_tpu_torch/entry.py) and
its one-command gate (gate.py) against the JAX repository's
__graft_entry__.py and ci.sh, on the CPU.

`entry()` against __graft_entry__.entry() under `jax.jit`: the same inputs,
the keys byte for byte, the payloads by the key/payload pairing, and
exactly under a stable sort in both packages.  `dryrun_multichip` on 2, 4
and 8 Gloo ranks (one spawn each; 8 is the gate's own entry step with
--device cpu) against the JAX `distributed_sort_sharded` on a P-device
mesh of conftest's virtual CPU devices with the same arguments: each
rank's count and sorted keys exactly, and the filter's, aggregate's and
join's totals and the join's hot-key statistics against the JAX entries';
from P = 4 the join must have flagged key 7 hot.  The gate's plan is held
to ci.sh's sections.  No test runs the gate's test step: that would run
pytest inside pytest.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from simd_radix_sort_tpu_torch import entry as tentry
from simd_radix_sort_tpu_torch import gate
from simd_radix_sort_tpu_torch.ops import xla_sort as txla
from simd_radix_sort_tpu_torch.utils import interop

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

import __graft_entry__ as jentry  # noqa: E402
from simd_radix_sort_tpu.ops import xla_sort as jxla  # noqa: E402

MIX = np.uint64(0x9E3779B97F4A7C15)


def _pairs(k, p):
    with np.errstate(over="ignore"):
        return np.sort((k.astype(np.uint64) * MIX) ^ p.astype(np.uint64))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------


def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    jk, jp = jax.jit(jfn)(*jargs)
    step, args = tentry.entry(device="cpu")
    for a, b in zip(args, jargs):
        _same(interop.to_numpy(a), b)
    tk, tp = step(*args)
    assert tk.device.type == "cpu" and tk.dtype == torch.uint32
    _same(interop.to_numpy(tk), jk)
    assert np.array_equal(_pairs(interop.to_numpy(tk), interop.to_numpy(tp)),
                          _pairs(np.asarray(jk), np.asarray(jp)))
    # stable in both packages: the payloads too, exactly
    sk, (sp,) = txla.sort_arrays(*args[:1], args[1:], stable=True)
    wk, (wp,) = jax.jit(functools.partial(jxla.sort_arrays, stable=True))(
        jargs[0], jargs[1:])
    _same(interop.to_numpy(sk), wk)
    _same(interop.to_numpy(sp), wp)


def test_entries_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tentry.entry(), lambda: tentry.dryrun_multichip(2),
                 lambda: gate.plan()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_dryrun_data_is_the_jax_files():
    """The draws of __graft_entry__.dryrun_multichip, in its order."""
    n = 4096 * 4
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    hot_vals = rng.integers(0, 2**64, 4, dtype=np.uint64)
    dup_at = rng.random(n) < 0.5
    keys[dup_at] = hot_vals[rng.integers(0, 4, int(dup_at.sum()))]
    pay = rng.integers(0, 2**64, n, dtype=np.uint64)
    pk = rng.integers(0, 4096, n).astype(np.uint32)
    pk[rng.random(n) < 0.4] = np.uint32(7)
    bk = (2 * (np.arange(n, dtype=np.uint32) % 2048)).astype(np.uint32)
    bk[:4] = np.uint32(7)
    d = tentry.dryrun_data(4)
    for got, want in zip((d["keys"], d["pay"], d["probe"], d["build"]),
                         (keys, pay, pk, bk)):
        _same(got, want)


# ---------------------------------------------------------------------------
# dryrun_multichip on Gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def records():
    """One spawn per rank count: 2 and 4 directly, 8 through the gate's
    entry step with --device cpu."""
    cpu = torch.device("cpu")
    out = {p: tentry.dryrun_multichip(p, cpu) for p in (2, 4)}
    steps = {s.name: s for s in gate.plan(quick=True, device="cpu")}
    out[8] = steps["entry"].run()
    return out


def _jax_dryrun(size):
    from simd_radix_sort_tpu.parallel import dist_ops as jops
    from simd_radix_sort_tpu.parallel import dist_sort as jds

    d = tentry.dryrun_data(size)
    keys, pay, n = d["keys"], d["pay"], d["keys"].shape[0]
    mesh = jds.make_mesh(size)
    sh = NamedSharding(mesh, PartitionSpec("x"))
    fn = jax.jit(functools.partial(
        jds.distributed_sort_sharded, mesh=mesh, capacity_factor=2.0,
        samples_per_device=32))
    out_k, _, counts, ov = fn(jax.device_put(jnp.asarray(keys), sh),
                              (jax.device_put(jnp.asarray(pay), sh),))
    counts, out_k = np.asarray(counts), np.asarray(out_k)
    per = out_k.shape[0] // size
    prefixes = [out_k[r * per:r * per + int(counts[r])]
                for r in range(size)]
    fcounts, _, _ = jops.distributed_filter(
        lambda k: k > jnp.uint64(2**63), keys, pay, mesh=mesh)
    small = (keys % 16).astype(np.int32)
    ng, _, sums = jops.distributed_group_aggregate(
        small, np.ones(n, np.int32), agg="sum", mesh=mesh)
    jc, _, _, _, jov, stats, _ = jops.distributed_join(
        d["probe"], (pay,), d["build"], (np.arange(n, dtype=np.int32),),
        mesh=mesh, capacity_factor=2.0, out_rows_per_device=8 * n,
        return_hot_stats=True)
    assert not np.asarray(ov).any() and not np.asarray(jov).any()
    return {"sort_counts": counts.tolist(), "prefixes": prefixes,
            "filter_rows": int(np.asarray(fcounts).sum()),
            "aggregate_groups": int(ng),
            "aggregate_sum": int(np.asarray(sums).sum()),
            "join_pairs": int(np.asarray(jc).sum()),
            "hot_probe_rows": np.asarray(
                stats["hot_probe_rows_per_device"]).reshape(-1).tolist(),
            "hot_build_rows": np.asarray(
                stats["hot_build_rows_per_device"]).reshape(-1).tolist(),
            "hot_flagged": int(np.asarray(
                stats["hot_key_slots_flagged"]).reshape(-1)[0])}


@pytest.mark.parametrize("size", [2, 4, 8])
def test_dryrun_multichip_matches_jax(records, size):
    rec, want = records[size], _jax_dryrun(size)
    assert rec["ranks"] == size and rec["rows"] == 4096 * size
    assert rec["sort_counts"] == want["sort_counts"]
    ends = np.cumsum([0] + rec["sort_counts"])
    for r in range(size):
        _same(rec["sorted_keys"][ends[r]:ends[r + 1]], want["prefixes"][r])
    for name in ("filter_rows", "aggregate_groups", "aggregate_sum",
                 "join_pairs"):
        assert rec[name] == want[name], name
    hot = rec["join_hot"]
    assert hot["probe_rows_per_rank"] == want["hot_probe_rows"]
    assert hot["build_rows_per_rank"] == want["hot_build_rows"]
    assert hot["key_slots_flagged"] == want["hot_flagged"]
    if size >= 4:
        # key 7 alone is flagged: every hot probe row is one of its rows
        pk = tentry.dryrun_data(size)["probe"]
        assert hot["key_slots_flagged"] == 1
        assert sum(hot["probe_rows_per_rank"]) == int((pk == 7).sum())
    h = rec["hierarchical"]
    assert h["groups"] == 16 and sum(h["sums"]) == rec["rows"]
    assert sum(h["sort_counts"]) == rec["rows"]
    assert rec["k5_launches"] == 0  # the CPU runs K5's plain version


def test_dryrun_on_one_rank_skips_the_hierarchical_steps():
    rec = tentry.dryrun_multichip(1, "cpu")
    assert rec["hierarchical"] is None and "hierarchical" not in rec[
        "seconds"]
    assert rec["sort_counts"] == [4096]
    assert rec["aggregate_sum"] == 4096


def test_dryrun_checks_the_group_size():
    from simd_radix_sort_tpu_torch.workloads.common import one_rank_group

    with one_rank_group(torch.device("cpu")):
        with pytest.raises(ValueError, match="not 2"):
            tentry.dryrun_multichip(2, "cpu")


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multiproc", [False, True])
@pytest.mark.parametrize("quick", [False, True])
def test_gate_plan_follows_ci_sh(quick, multiproc):
    steps = gate.plan(quick=quick, multiproc=multiproc, device="cpu")
    assert [s.name for s in steps] == (
        ["native", "install", "lint", "tests", "entry"]
        + (["multiproc"] if multiproc else []))
    by = {s.name: s for s in steps}
    files = [a for a in by["tests"].argv if a.endswith(".py")]
    want = sorted(f"tests/{f}" for f in os.listdir(os.path.join(REPO,
                                                                "tests"))
                  if f.startswith("test_torch_") and f.endswith(".py"))
    assert files == want and "tests/test_torch_entry.py" in files
    assert by["tests"].argv[1:3] == ("-m", "pytest")
    assert (by["tests"].argv[-2:] == ("-m", "not slow")) == quick
    install = by["install"].argv
    assert install[1:4] == ("-m", "pip", "wheel")
    assert {"--no-deps", "--no-build-isolation", "--no-index"} <= set(install)
    lint = by["lint"].argv
    assert lint == gate.lint_argv()
    if lint:
        assert {gate.PACKAGE, *gate.port_tests()} <= set(lint)
        assert not [a for a in lint if a.startswith("tests/")
                    and not a.startswith("tests/test_torch_")]


def test_gate_lint_without_a_linter_prints_ci_sh_notice(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(gate.shutil, "which", lambda name: None)
    monkeypatch.setattr(gate.importlib.util, "find_spec", lambda name: None)
    assert gate.lint_argv() == ()
    (lint,) = [s for s in gate.plan(device="cpu") if s.name == "lint"]
    lint.run()
    assert capsys.readouterr().out.strip() == gate.LINT_SKIPPED.strip()


def test_gate_stops_at_the_first_failed_step(monkeypatch, capsys):
    ran = []

    def fake_plan(quick, multiproc, device):
        def fail():
            raise AssertionError("broken")
        return [gate.Step("native", lambda: ran.append("native")),
                gate.Step("install", fail),
                gate.Step("lint", lambda: ran.append("lint"))]

    monkeypatch.setattr(gate, "plan", fake_plan)
    assert gate.main(["--device", "cpu"]) == 1
    assert ran == ["native"]
    assert "gate: install FAILED" in capsys.readouterr().out
