"""The port's workload scripts (simd_radix_sort_tpu_torch/workloads/)
against the JAX repository's scripts, on the CPU at small sizes.

The JAX scripts are imported with scripts/ on the path, as
tests/test_scripts.py imports them.  Everything here is exact: the hashes
and moduli bit for bit against NumPy and scripts/benchlib.py, the headline's
keys and pair fingerprints against `simd_radix_sort_tpu.sort`,
configuration 3's bytes and fingerprints against the JAX `gen_packed`,
`sort_packed` and `row_fingerprint`, configuration 4's group keys, sums and
counts against the JAX `run_pipeline`, and configuration 5's table makers
against the JAX script's.  Configuration 5's card leg runs on a Gloo group
of one with device="cpu", its Gloo leg on two spawned processes.
`summarize_bench`'s rows equal the JAX script's on the same directories,
with the JAX script's TPU-trace column left out.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_radix_sort_tpu_torch.utils import interop
from simd_radix_sort_tpu_torch.workloads import (combined_1e8, common,
                                                 config5_scale, headline,
                                                 pipeline_1e9,
                                                 summarize_bench)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import benchlib  # noqa: E402
import combined_1e8 as jax_combined  # noqa: E402
import config5_scale as jax_config5  # noqa: E402
import pipeline_1e9 as jax_pipeline  # noqa: E402
import summarize_bench as jax_summarize  # noqa: E402

import simd_radix_sort_tpu as jsrs  # noqa: E402

VALUES = {
    "edges": np.array([0, 2**63 - 1, 2**63, 2**64 - 1, 1, 2**32 - 1, 2**32],
                      dtype=np.uint64),
    "random": np.random.default_rng(5).integers(0, 2**64, 4096,
                                                dtype=np.uint64),
}


def carrier(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int64))


@pytest.mark.parametrize("name", sorted(VALUES))
def test_splitmix64_equals_numpy_and_benchlib(name):
    x = VALUES[name]
    got = common.splitmix64(carrier(x)).numpy().view(np.uint64)
    assert np.array_equal(got, np.asarray(benchlib.splitmix64(x)))
    assert np.array_equal(got, jax_config5.splitmix64_np(x))
    assert np.array_equal(common.splitmix64_np(x), got)


@pytest.mark.parametrize("m", [1, 3, 500, 1 << 20, 2**31 - 1])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_unsigned_modulo_equals_numpy(name, m):
    x = VALUES[name]
    got = common.umod(carrier(x), m).numpy()
    assert np.array_equal(got, (x % np.uint64(m)).astype(np.int64))


@pytest.mark.parametrize("m", [0, 2**31, -3])
def test_unsigned_modulo_rejects_moduli_outside_its_range(m):
    with pytest.raises(ValueError, match="outside"):
        common.umod(carrier(VALUES["edges"]), m)


@pytest.mark.parametrize("n", [0, 1, 7, 4097])
def test_fingerprints_equal_numpy(n):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    p = rng.integers(0, 2**64, n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        pair = (k * np.uint64(common.M1)) ^ p
        want = [int(v) for v in (k.sum(dtype=np.uint64),
                                 np.bitwise_xor.reduce(k),
                                 pair.sum(dtype=np.uint64),
                                 np.bitwise_xor.reduce(pair))]
    want = tuple(common.wrap64(v) for v in want)
    assert common.host_checksums(k, p) == want
    got = common.device_checksums((interop.from_numpy(k, "cpu"),
                                   interop.from_numpy(p, "cpu")))
    assert got == want


def test_timer_waits_for_each_rep_when_asked():
    calls = []
    sec = common.timeit(lambda: calls.append(1) or len(calls), reps=3,
                        warmup=2, per_rep_fence=True)
    assert len(calls) == 5 and sec >= 0
    common.timeit(lambda: calls.append(1), reps=2, warmup=0)
    assert len(calls) == 8  # warmup=0 primes once


# ---------------------------------------------------------------------------
# the headline (bench.py)
# ---------------------------------------------------------------------------


def test_headline_equals_the_jax_sort():
    keys, pay = headline.make_data(1 << 16)
    record, (ko, po) = headline.run(keys, pay, reps=1, device="cpu")
    jk, jp = (np.asarray(a) for a in jsrs.sort(keys, pay))
    assert np.array_equal(interop.to_numpy(ko), jk)
    assert common.device_checksums((ko, po)) == common.host_checksums(jk,
                                                                      jp)
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "n",
                           "method", "seconds_per_sort",
                           "hbm_roofline_rows_per_s", "roofline_frac",
                           "device"}
    assert (record["method"], record["n"], record["device"]) == (
        "xla", 1 << 16, "cpu")
    assert record["roofline_frac"] is None  # no roofline on the CPU


def test_headline_gate_catches_a_payload_that_left_its_key():
    keys, pay = headline.make_data(4096)
    _, call, gate = headline.case(keys, pay, device="cpu")
    ko, po = call()
    gate((ko, po))
    swapped = common.signed(po)[[1, 0, *range(2, 4096)]].view(po.dtype)
    with pytest.raises(AssertionError, match="pairing"):
        gate((ko, swapped))
    with pytest.raises(AssertionError, match="not sorted"):
        gate((common.signed(ko).flip(0).view(ko.dtype), po))


def test_headline_main_prints_one_json_line(capsys):
    assert headline.main(["--n", "4096", "--reps", "1", "--device",
                          "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"u64+u64 sort rows/s/chip"' in lines[0]


# ---------------------------------------------------------------------------
# configuration 3 (scripts/combined_1e8.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 20_000])
def test_gen_packed_equals_jax(n):
    got = combined_1e8.gen_packed(n, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (n, 24)
    assert np.array_equal(got.numpy(), np.asarray(jax_combined.gen_packed(n)))


def test_sort_packed_bytes_and_fingerprints_equal_jax():
    from simd_radix_sort_tpu.ops import sort as jax_sort

    packed = combined_1e8.gen_packed(20_000, "cpu")
    out = combined_1e8.sort(packed)
    want = np.asarray(jax_sort.sort_packed(jnp.asarray(packed.numpy()),
                                           np.uint64))
    assert np.array_equal(out.numpy(), want)
    for t, arr in ((packed, packed.numpy()), (out, want)):
        fs, fx = jax_combined.row_fingerprint(jnp.asarray(arr))
        assert combined_1e8.row_fingerprint(t) == (
            common.wrap64(int(fs)), common.wrap64(int(fx)))
    hi, lo = (np.asarray(w) for w in jax_combined.key_of(jnp.asarray(want)))
    keys = interop.to_numpy(combined_1e8.key_of(out))
    assert np.array_equal(keys, (hi.astype(np.uint64) << np.uint64(32))
                          | lo.astype(np.uint64))
    combined_1e8.gate(packed, out)


def test_combined_gate_catches_a_torn_row():
    call, gate = combined_1e8.case(4096, "cpu")
    out = call()
    gate(out)
    torn = out.clone()
    torn[7, 20] ^= 1  # one payload byte
    with pytest.raises(AssertionError, match="fingerprint"):
        gate(torn)
    with pytest.raises(AssertionError, match="not key-sorted"):
        gate(out.flip(0))


def test_combined_run_record():
    record = combined_1e8.run(4096, reps=1, device="cpu")
    assert record["n"] == 4096 and record["device"] == "cpu"
    assert record["metric"] == "combined u64+2xu64 (24B rows) sort rows/s/chip"


# ---------------------------------------------------------------------------
# configuration 4 (scripts/pipeline_1e9.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_pipeline_equals_jax(mode):
    _, jk, js, jc = jax_pipeline.run_pipeline(40_000, 4, 500, mode)
    _, tk, ts, tc = pipeline_1e9.run_pipeline(40_000, 4, 500, mode,
                                              device="cpu")
    for got, want in ((tk, jk), (ts, js), (tc, jc)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert tk.size == 500


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_pipeline_gate_and_main(mode, capsys):
    call, gate = pipeline_1e9.case(30_000, 3, 700, mode, "cpu")
    out = call()
    gate(out)
    bad = (out[0], out[1], out[2].copy(), out[3])
    bad[2][5] += np.uint64(1)
    with pytest.raises(AssertionError, match="sums"):
        gate(bad)
    assert pipeline_1e9.main(["--n", "30000", "--chunks", "3", "--groups",
                              "700", "--mode", mode, "--validate", "--reps",
                              "1", "--device", "cpu"]) == 0
    assert f'"mode": "{mode}"' in capsys.readouterr().out


def test_pipeline_rejects_indivisible_chunking():
    with pytest.raises(ValueError, match="does not divide"):
        pipeline_1e9.run_pipeline(1001, 4, 100, "fused", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        pipeline_1e9.run_pipeline(1000, 4, 100, "sorted", device="cpu")


def test_pipeline_partials_hold_only_their_rows():
    chunk = pipeline_1e9.make_chunk_fn(10_000, 50, "fused",
                                       torch.device("cpu"))
    for t in chunk(0):
        assert t.shape == (51,)
        assert t.untyped_storage().nbytes() == 51 * t.element_size()


# ---------------------------------------------------------------------------
# configuration 5 (scripts/config5_scale.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,seed", [(1.1, 41), (1.5, 9)])
def test_table_makers_equal_jax(a, seed):
    n = 1 << 14
    assert np.array_equal(config5_scale.zipf_ranks(n, a, 1000, seed),
                          jax_config5.zipf_ranks(n, a, 1000, seed))
    for got, want in zip(config5_scale.make_sort_table(n, a, seed),
                         jax_config5.make_sort_table(n, a, seed)):
        assert np.array_equal(got, want)
    keys = config5_scale.make_sort_table(n, a, seed)[0]
    assert config5_scale.skew_stats(keys) == jax_config5.skew_stats(keys)
    assert config5_scale.skew_stats_device(carrier(keys)) == \
        jax_config5.skew_stats(keys)
    # run_join's tables
    n_build = 1 << 10
    probe = jax_config5.splitmix64_np(jax_config5.zipf_ranks(n, a, n_build,
                                                             seed))
    build = np.random.default_rng(seed + 1).permutation(
        jax_config5.splitmix64_np(np.arange(1, n_build + 1,
                                            dtype=np.uint64)))
    want = (probe, jax_config5.splitmix64_np(
        probe ^ np.arange(n, dtype=np.uint64)), build,
        jax_config5.splitmix64_np(build ^ np.uint64(0xC0FFEE)))
    for got, w in zip(config5_scale.make_join_tables(n, n_build, a, seed),
                      want):
        assert np.array_equal(got, w)


def test_card_leg_on_one_gloo_rank():
    rec = config5_scale.leg_card(1 << 16, 1 << 16, 1 << 12, reps=1,
                                 device="cpu")
    assert rec["device"] == "cpu"
    labels = ["sort_sort", "sort_blocked"] + [
        label for label, *_ in config5_scale.CARD_JOINS]
    assert [k for k in rec if k != "device"] == labels
    for label in labels:
        assert rec[label]["run_s"] > 0
    assert rec["join_zipf15_hot"]["skew"]["top1_share"] > 0.3
    assert rec["join_zipf15_hot_off_ablation"]["hot_stats"][
        "hot_key_slots_flagged"] == [0]


def test_card_leg_gates_catch_broken_outputs():
    cpu = torch.device("cpu")
    with common.one_rank_group(cpu):
        cases = config5_scale.card_cases(1 << 12, 1 << 12, 1 << 8, cpu)
        by_label = {c[0]: c for c in cases}
        _, _, _, call, gate = by_label["sort_sort"]
        out = call()
        gate(out)
        k = common.signed(out[0])
        keys = torch.cat([k[1:2], k[:1], k[2:]]).view(out[0].dtype)
        with pytest.raises(AssertionError, match="key order"):
            gate((keys,) + tuple(out[1:]))
        _, _, _, call, gate = by_label["join_zipf11"]
        out = call()
        gate(out)
        bp = common.signed(out[3][0]).clone()
        bp[0] ^= 1
        bp = bp.view(out[3][0].dtype)
        with pytest.raises(AssertionError, match="build payload"):
            gate(out[:3] + ((bp,),) + out[4:])


def test_gloo_leg_on_two_processes(tmp_path):
    rec = config5_scale.leg_gloo(1 << 14, 1 << 13, 1 << 10, procs=(2,),
                                 work_dir=tmp_path)
    two = rec["2proc"]
    assert two["ranks"] == 2 and two["n_sort"] == 1 << 14
    for label, a, _, hot in config5_scale.GLOO_JOINS:
        assert (two[label]["zipf_a"], two[label]["hot_keys"]) == (a, hot)
        assert two[label]["hot_stats"]["overflow_parts_probe_build_coldout"
                                       "_hotout_hotcap"] == [[0] * 5]


def test_workloads_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, pay = headline.make_data(16)
    for call in (lambda: headline.run(keys, pay),
                 lambda: combined_1e8.gen_packed(16),
                 lambda: pipeline_1e9.run_pipeline(16, 2, 4, "fused"),
                 lambda: config5_scale.leg_card(16, 16, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _jax_summary(monkeypatch, capsys, out_dir, ref_dir):
    """The JAX script's rows, without its TPU-trace column."""
    monkeypatch.setattr(jax_summarize, "LOSING_TRACE", os.devnull)
    monkeypatch.setattr(jax_summarize, "REF_DIR", str(ref_dir))
    monkeypatch.setattr(sys, "argv", ["summarize_bench.py", str(out_dir)])
    capsys.readouterr()
    jax_summarize.main()
    return capsys.readouterr().out.splitlines()[1:]


def test_summarize_bench_rows_equal_the_jax_scripts(monkeypatch, capsys,
                                                    tmp_path):
    cpu, host = summarize_bench.load_ref_host()
    assert cpu and host
    h100 = os.path.join(os.path.dirname(__file__), "..", "bench_out_h100")
    want = _jax_summary(monkeypatch, capsys, h100, tmp_path / "none")
    got = summarize_bench.rows(h100, None, host)
    assert got == want and len(got) == len(summarize_bench.summary_tables(
        h100)) > 200
    # thesis tables present: their columns too; skipped families, tables
    # without a device engine and unreadable ones drop out alike
    ours, ref = tmp_path / "ours", tmp_path / "thesis"
    ours.mkdir()
    ref.mkdir()
    for name, body in (
            ("int32-Uniform-262144.dat", "method ns\nxla 0.9\ncount 0.5\n"),
            ("uint64-uint64-Zero-1024.dat", "method ns\nradix 2.5\n"),
            ("tpe-int32-Uniform-262144.dat", "method ns\nxla 0.1\n"),
            ("float-Sorted-262144.dat", "method ns\nseq 9.0\n"),
            ("double-Uniform-262144.dat", "")):
        (ours / name).write_text(body)
    (ref / "int32-Uniform-262144.dat").write_text(
        "method ns\nRadixSIMD 2.0\nBlacherSort 1.5\nSTLSort 9.0\n")
    (ref / "uint64-uint64-Zero-1024.dat").write_text(
        "method ns\nRadixSIMD 4.0\n")
    want = _jax_summary(monkeypatch, capsys, ours, ref)
    got = summarize_bench.rows(ours, ref, host)
    assert got == want and len(got) == 2
    assert summarize_bench.main([str(ours), "--ref-dir", str(ref)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert cpu in out[0] and out[2:] == got
