"""Rules the PyTorch port keeps: it stands alone, it never runs on the CPU
unasked, and its data interop is bit-exact."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simd_radix_sort_tpu as jsrs
import simd_radix_sort_tpu_torch as tsrs
from simd_radix_sort_tpu_torch.models import roofline
from simd_radix_sort_tpu_torch.ops import _build
from simd_radix_sort_tpu_torch.utils import common, interop

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import os, pkgutil, sys
import simd_radix_sort_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "simd_radix_sort_tpu",
                                    "benchlib"))
# nothing of the JAX repository's scripts either (scripts/, examples/)
jax_dirs = tuple(os.path.join(os.getcwd(), d) + os.sep
                 for d in ("scripts", "examples"))
bad += sorted(name for name, mod in list(sys.modules.items())
              if (getattr(mod, "__file__", None) or "").startswith(jax_dirs))
print(len([m for m in sys.modules if m.startswith(pkg.__name__)]), bad)
# the entry layer is among what was imported
need = [pkg.__name__ + m for m in (".entry", ".gate",
                                   ".workloads.summarize_bench")]
missing = [m for m in need if m not in sys.modules]
print("missing", missing)
sys.exit(1 if bad or missing else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    # a fresh interpreter: this one has jax loaded by conftest already
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    # parallel/ brought 4 (the package, dist_sort, dist_ops, multihost),
    # the host engines 3 (ops/torch_baseline, utils/cpp_rng, utils/native),
    # the measurement layer 4 (perf, autotune, utils/profiling,
    # models/scaling), the workload scripts 6 (workloads/ and its common,
    # headline, combined_1e8, pipeline_1e9, config5_scale) and the
    # examples 3 (examples/ and its query_pipeline, distributed_pipeline)
    # and the measurement drivers 5 (workloads' perf_suite, knob_epoch,
    # remeasure_noise, run_test_matrix, campaign) and the entry
    # layer 3 (entry, gate, workloads' summarize_bench)
    assert n_modules >= 52, proc.stdout


def test_no_cuda_means_raise_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(16, dtype=np.int32)[::-1].copy()
    for call in (lambda: tsrs.sort(keys),
                 lambda: tsrs.argsort(keys),
                 lambda: tsrs.sort_batched(keys.reshape(2, 8)),
                 lambda: tsrs.sort_multi((keys,)),
                 lambda: tsrs.sort_packed(tsrs.pack_rows(keys, ()),
                                          np.int32),
                 lambda: interop.from_numpy(keys)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = tsrs.sort(keys, device="cpu")
    assert out.device.type == "cpu"
    assert np.array_equal(interop.to_numpy(out), np.arange(16))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_kernel_sources_and_build_flags():
    pairs = [f"sort_pairs_{k}.cu" for k in ("u8", "i8", "u16", "i16", "u32",
                                            "i32", "u64", "i64")]
    assert [s.name for s in _build.SOURCES] == [
        "hist_kernels.cu", "partition_kernels.cu", "scan_kernels.cu",
        "key_bits.cu", "sort_pairs.cu", *pairs]
    assert [h.name for h in _build.HEADERS] == ["sort_pairs.cuh"]
    assert all(src.is_file() for src in _build.SOURCES + _build.HEADERS)
    text = "".join(src.read_text() for src in _build.SOURCES)
    for entry in _build._SIGNATURES:
        assert text.count(f"int {entry}(") == 1
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "srs_torch")
    assert _build.library_path().parent == _build.BUILD_DIR


def _all_dtype_arrays(n=257, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for dt in common.KEY_DTYPES:
        raw = rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)
        if dt.kind == "f":
            ubits = np.array([0x7FC00001, 0xFFC00003, 0x80000000, 0]
                             if dt.itemsize == 4 else
                             [0x7FF8000000000001, 0xFFF8000000000003,
                              0x8000000000000000, 0],
                             dtype=common.unsigned_of(dt))
            raw = np.concatenate([raw, ubits.view(dt),
                                  np.array([np.inf, -np.inf], dt)])
        out.append(raw)
    return out


def test_interop_round_trips_every_dtype_bit_exactly():
    for arr in _all_dtype_arrays():
        t = interop.from_numpy(arr, "cpu")
        assert t.dtype == common.torch_dtype(arr.dtype)
        back = interop.to_numpy(t)
        assert back.dtype == arr.dtype
        assert np.array_equal(back.view(np.uint8), arr.view(np.uint8))
        two_d = interop.to_numpy(interop.from_numpy(arr[:256].reshape(16, 16),
                                                    "cpu"))
        assert two_d.shape == (16, 16)
        assert np.array_equal(two_d.reshape(-1).view(np.uint8),
                              arr[:256].view(np.uint8))
        assert np.array_equal(interop.to_numpy(t, np.uint8),
                              arr.view(np.uint8))


def test_one_dataset_through_both_packages():
    """NaN-payload floats, ±0.0 and ±inf as keys and as payloads: the
    port's result, carried back with interop, equals the JAX package's."""
    arrays = _all_dtype_arrays(n=301, seed=1)
    f64 = arrays[-1]
    f32 = arrays[-2][:f64.size]
    for keys in (f64, f32):
        want = jsrs.sort(keys, f32, f64, stable=True)
        got = tsrs.sort(interop.from_numpy(keys, "cpu"),
                        interop.from_numpy(f32, "cpu"),
                        interop.from_numpy(f64, "cpu"), stable=True,
                        device="cpu")
        for g, w in zip(got, want):
            assert np.array_equal(interop.to_numpy(g).view(np.uint8),
                                  np.asarray(w).view(np.uint8))


def test_config_from_jax():
    jcfg = jsrs.SortConfig(ascending=False, method="xla", stable=True,
                           block_threshold=64, digit_bits=8)
    cfg = interop.config_from_jax(dataclasses.asdict(jcfg))
    assert isinstance(cfg, tsrs.SortConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="no fields"):
        interop.config_from_jax({"ascending": True, "mesh": None})


def test_roofline_picks_the_h100_part_by_name():
    sxm = roofline.chip_for_name("NVIDIA H100 80GB HBM3")
    pcie = roofline.chip_for_name("NVIDIA H100 PCIe")
    assert (sxm.hbm_gbps, pcie.hbm_gbps) == (3350.0, 2000.0)
    assert roofline.stream_roofline_rows_per_s(4, chip=sxm) == \
        3350e9 / 8
    assert roofline.radix_sort_roofline_rows_per_s(16, 64, chip=sxm) == \
        3350e9 / (8 * 16 * 2)
    assert abs(roofline.bound_ms(3350e6, chip=sxm) - 1.0) < 1e-12


def test_public_surface_mirrors_the_jax_package():
    assert set(tsrs.__all__) == set(jsrs.__all__)
    assert set(tsrs.SORT_METHODS) == {"xla", "radix", "count", "rank",
                                      "quick", "quickseq", "seq", "torch",
                                      "cpp"}
    assert tsrs.methods.NOT_YET_PORTED == ()
    assert os.path.basename(tsrs.__file__) == "__init__.py"


@pytest.mark.parametrize("name,ported", [
    ("rank", True), ("quick", True), ("quickseq", True),
    ("torch", True), ("cpp", True), ("autotune", True)])
def test_which_jax_methods_are_ported(name, ported, monkeypatch, tmp_path):
    from simd_radix_sort_tpu_torch import autotune

    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "c.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    keys = np.arange(8, dtype=np.int32)[::-1].copy()
    if ported:
        out = tsrs.sort(keys, method=name, device="cpu")
        assert np.array_equal(interop.to_numpy(out), np.arange(8))
    else:
        with pytest.raises(ValueError, match="not yet ported"):
            tsrs.sort(keys, method=name, device="cpu")


def test_parallel_surface_mirrors_the_jax_package():
    import simd_radix_sort_tpu.parallel as jpar
    from simd_radix_sort_tpu_torch import parallel as tpar

    jax_names = {n for n in dir(jpar) if not n.startswith("_")}
    assert tpar.NOT_YET_PORTED == ()
    # make_mesh becomes make_group: a process group, not a device mesh;
    # make_hierarchical_mesh keeps its name beside make_hierarchical_groups
    want = (jax_names - {"make_mesh"}) | {"make_group",
                                          "make_hierarchical_groups"}
    assert set(tpar.__all__) == want
    assert all(hasattr(tpar, n) for n in tpar.__all__)
    assert tpar.make_hierarchical_mesh is tpar.make_hierarchical_groups


def _distributed_entries():
    from simd_radix_sort_tpu_torch import parallel as tpar

    keys = np.arange(16, dtype=np.int32)
    return [
        lambda d: tpar.distributed_sort(keys, keys, device=d),
        lambda d: tpar.distributed_sort_multi((keys, keys), device=d),
        lambda d: tpar.distributed_filter(lambda k: k > 3, keys, device=d),
        lambda d: tpar.distributed_group_aggregate(keys, keys, device=d),
        lambda d: tpar.distributed_join(keys, (), keys, (), device=d),
        lambda d: tpar.distributed_top_k(keys, k=2, device=d),
        lambda d: tpar.distributed_unique(keys, device=d),
        lambda d: tpar.hierarchical_sort(keys, keys, device=d),
        lambda d: tpar.hierarchical_group_aggregate(keys, keys, device=d),
        lambda d: tpar.multihost.distributed_sort_multihost(keys, device=d),
    ]


@pytest.mark.parametrize("entry", range(10))
def test_distributed_entries_need_a_card_and_a_group(monkeypatch, entry):
    import torch.distributed as dist

    call = _distributed_entries()[entry]
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(None)
    # the CPU asked for, but no process group: never one rank unasked
    with pytest.raises(RuntimeError, match="not initialised"):
        call("cpu")
