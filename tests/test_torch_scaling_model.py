"""The port's scaling model (models/scaling.py) on the CPU.

Parity: fed the JAX package's TPU constants (its v5e link, anchor,
collective latency and blocked-sort rate), every function equals the JAX
package's to rel=1e-12 over a grid of n, P, S, capacity_factor and both
final modes, so the form is the same.  Structure: the tests of
tests/test_scaling_model.py run on the H100 constants.  Predictions: the
numeric clauses the JAX tests pin are re-derived for the H100 constants;
where one no longer holds, the test pins what the model now says instead.
"""

import math

import pytest

from simd_radix_sort_tpu.models import scaling as jscaling
from simd_radix_sort_tpu_torch.models import scaling

ANCHOR = scaling.MEASURED_ANCHOR
LINK = scaling.LINKS["hgx-h100"]


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's module with the JAX package's TPU constants."""
    monkeypatch.setattr(scaling, "COLLECTIVE_LATENCY_S",
                        jscaling.COLLECTIVE_LATENCY_S)
    monkeypatch.setattr(scaling, "BLOCKED_SORT_ROWS_PER_S",
                        jscaling.BLOCKED_SORT_ROWS_PER_S)
    j = jscaling.LINKS["v5e"]
    return (scaling.LinkSpec(j.name, j.ici_gbps, j.ici_frac,
                             j.dcn_gbps_per_host, j.chips_per_host),
            j, dict(jscaling.MEASURED_ANCHOR))


def _same(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0)


@pytest.mark.parametrize("final_mode", ["sort", "blocked"])
@pytest.mark.parametrize("capacity_factor", [1.25, 2.0])
def test_equals_jax_under_jax_constants(jax_constants, final_mode,
                                        capacity_factor):
    tlink, jlink, anchor = jax_constants
    kw = dict(capacity_factor=capacity_factor, final_mode=final_mode)
    for n in (1e6, 1e8, 3.3e9):
        for p in (1, 2, 8, 64, 256):
            t = scaling.distributed_sort_phases(n, p, 16, tlink,
                                                anchor=anchor, **kw)
            j = jscaling.distributed_sort_phases(n, p, 16, jlink, **kw)
            for f in ("local_sort_s", "splitter_s", "exchange_s",
                      "final_sort_s", "total_s"):
                _same(getattr(t, f), getattr(j, f))
            t = scaling.distributed_sort_phases(
                n, p, 12, tlink, dcn_fraction_of_chips=0.5, anchor=anchor,
                **kw)
            j = jscaling.distributed_sort_phases(
                n, p, 12, jlink, dcn_fraction_of_chips=0.5, **kw)
            _same(t.total_s, j.total_s)
            for base in ("distributed_p1", "single_chip"):
                _same(scaling.scaling_efficiency(n, p, 16, tlink, base,
                                                 anchor=anchor, **kw),
                      jscaling.scaling_efficiency(n, p, 16, jlink, base,
                                                  **kw))
                _same(scaling.weak_scaling_efficiency(
                    n / p, p, 16, tlink, base, anchor=anchor, **kw),
                    jscaling.weak_scaling_efficiency(n / p, p, 16, jlink,
                                                     base, **kw))
            _same(scaling.projected_rows_per_s(n, p, 16, tlink,
                                               anchor=anchor, **kw),
                  jscaling.projected_rows_per_s(n, p, 16, jlink, **kw))
            for s in (1, 2, 4):
                t = scaling.hierarchical_sort_phases(n, s, p, 16, tlink,
                                                     anchor=anchor, **kw)
                j = jscaling.hierarchical_sort_phases(n, s, p, 16, jlink,
                                                      **kw)
                for f in ("local_sort_s", "splitter_s", "exchange_s",
                          "final_sort_s"):
                    _same(getattr(t, f), getattr(j, f))
    for t, j in zip(scaling.projection_table(link=tlink, anchor=anchor,
                                             **kw),
                    jscaling.projection_table(link=jlink, **kw),
                    strict=True):
        assert t.keys() == j.keys()
        for key in t:
            _same(t[key], j[key])
    for slices, target in ((2, 0.8), (4, 0.9), (2, 0.5)):
        _same(scaling.dcn_required_for_clause(
            num_slices=slices, target_eff=target, link=tlink,
            anchor=anchor, **kw),
            jscaling.dcn_required_for_clause(
                num_slices=slices, target_eff=target, link=jlink, **kw))


def test_anchor_and_constants_cite_the_card():
    for text in (ANCHOR["provenance"], scaling.MEASURED_COMM["provenance"]):
        assert "NVIDIA H100 80GB HBM3" in text and "700.00 W" in text
        assert "PERF.md §6" in text and "run 2" in text
    assert scaling.COLLECTIVE_LATENCY_S == \
        scaling.MEASURED_COMM["collective_latency_s_nccl"]
    # no TPU figure survives as the card's
    assert ANCHOR["rows_per_s"] != jscaling.MEASURED_ANCHOR["rows_per_s"]
    assert scaling.BLOCKED_SORT_ROWS_PER_S != \
        jscaling.BLOCKED_SORT_ROWS_PER_S
    for k in ("gloo_bytes_per_s_per_proc", "collective_latency_s_gloo"):
        assert scaling.MEASURED_COMM[k] != jscaling.MEASURED_COMM[k]
    assert set(scaling.LINKS) == {"hgx-h100"}


def test_sort_seconds_matches_anchor():
    t = scaling.sort_seconds(ANCHOR["n"])
    assert t == pytest.approx(ANCHOR["n"] / ANCHOR["rows_per_s"], rel=1e-9)


def test_sort_seconds_nlogn_shape():
    r = scaling.sort_seconds(2e8) / scaling.sort_seconds(1e8)
    assert 2.0 < r < 2.2
    assert scaling.sort_seconds(1) > 0


def test_exchange_bytes_accounting():
    """Uniform splitters ship exactly (P-1)/P of each shard's bytes."""
    for p in (2, 4, 8):
        ph = scaling.distributed_sort_phases(1e8 * p, p, row_bytes=16,
                                             link=LINK)
        want = (1e8 * 16 * (p - 1) / p) / LINK.ici_bytes_per_s
        assert ph.exchange_s == pytest.approx(want, rel=1e-9)


def test_p1_has_no_exchange_but_pays_padded_sort():
    ph = scaling.distributed_sort_phases(1e8, 1, capacity_factor=2.0)
    assert ph.exchange_s == 0.0
    assert ph.final_sort_s == pytest.approx(scaling.sort_seconds(2e8),
                                            rel=1e-9)


def test_capacity_factor_scales_final_sort():
    lo = scaling.distributed_sort_phases(8e8, 8, capacity_factor=1.25)
    hi = scaling.distributed_sort_phases(8e8, 8, capacity_factor=2.0)
    assert lo.final_sort_s < hi.final_sort_s
    assert lo.local_sort_s == hi.local_sort_s


def test_hierarchical_dcn_crossed_once():
    ph2 = scaling.hierarchical_sort_phases(16e8, 2, 8, link=LINK)
    flat = scaling.distributed_sort_phases(8e8, 8, link=LINK)
    want = 1e8 * 16 * (2 - 1) / 2 / LINK.dcn_bytes_per_s_per_chip
    assert ph2.exchange_s - flat.exchange_s == pytest.approx(
        want, rel=1e-6, abs=1e-9)


def test_hierarchical_slices_monotone_dcn_cost():
    prev = 0.0
    for s in (1, 2, 4):
        ph = scaling.hierarchical_sort_phases(8e8 * s, s, 8)
        assert ph.exchange_s >= prev
        prev = ph.exchange_s


def test_link_spec_is_the_hgx_h100_specification():
    assert (LINK.ici_gbps, LINK.dcn_gbps_per_host, LINK.chips_per_host) \
        == (7200.0, 3200.0, 8)
    assert LINK.ici_bytes_per_s == pytest.approx(900e9 * LINK.ici_frac)
    assert LINK.dcn_bytes_per_s_per_chip == pytest.approx(50e9)
    assert LINK.ici_bytes_per_s > 5 * LINK.dcn_bytes_per_s_per_chip


def test_multiproc_exchange_reproduces_the_fit():
    mc = scaling.MEASURED_COMM
    pred = scaling.multiproc_exchange_seconds(1 << 22, 2)
    assert pred == pytest.approx((1 << 22) * 16
                                 / mc["gloo_bytes_per_s_per_proc"])
    assert scaling.multiproc_exchange_seconds(1 << 22, 4) == \
        pytest.approx(3 * pred)


def test_projection_table_shape():
    rows = scaling.projection_table(n_per_chip=1e8)
    assert [r["chips"] for r in rows] == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert rows[0]["weak_eff"] == pytest.approx(1.0)
    assert rows[0]["comm_share"] == 0.0
    for r in rows:
        assert r["total_s"] > 0 and r["rows_per_s"] > 0
        assert r["rows_per_s"] == pytest.approx(r["chips"] * 1e8
                                                / r["total_s"])
    # an anchor passed in replaces the measured one
    half = dict(ANCHOR, rows_per_s=ANCHOR["rows_per_s"] / 2)
    slow = scaling.projection_table(n_per_chip=1e8, anchor=half)
    # both sorts take twice as long; the 3 splitter collectives do not
    assert slow[0]["total_s"] == pytest.approx(
        2 * rows[0]["total_s"] - 3 * scaling.COLLECTIVE_LATENCY_S, rel=1e-9)
    assert math.isfinite(scaling.dcn_required_for_clause(anchor=half))


# The JAX tests' numeric predictions, re-derived for the H100 constants.
# Still hold: >= 0.8 strong efficiency through 8 GPUs, weak efficiency in
# [0.9, 1] on NVLink, >= 0.95 at 2 GPUs, the single-card tax near
# 1/(1 + capacity_factor).  No longer hold: comm share < 0.05 at 256
# GPUs, blocked mode > 0.7 of one card, >= 0.8 at two hosts at the NDR
# specification; each is pinned below at what the model now says.


def test_strong_scaling_efficiency_bounds():
    for p in (2, 4, 8):
        eff = scaling.scaling_efficiency(8e8, p)
        assert 0.8 <= eff <= 1.25, (p, eff)


def test_weak_scaling_efficiency_near_one_on_nvlink():
    for p in (2, 4, 8, 64):
        eff = scaling.weak_scaling_efficiency(1e8, p)
        assert 0.9 <= eff <= 1.0, (p, eff)


def test_single_chip_baseline_shows_the_padded_sort_tax():
    eff = scaling.weak_scaling_efficiency(1e8, 8, baseline="single_chip")
    assert 0.25 <= eff <= 0.40, eff


def test_projection_prediction():
    rows = scaling.projection_table(n_per_chip=1e8)
    assert rows[1]["weak_eff"] >= 0.95
    # the card sorts ~38x faster than the TPU did while NVLink carries
    # ~2.3x the v5e's ICI, so the exchange's share grows: 0.073 at 256
    # GPUs, not the TPU's < 0.05
    assert 0.05 < rows[-1]["comm_share"] < 0.1


def test_blocked_final_mode_on_the_card():
    """A radix sort is linear in n, so the blocked pass is no faster per
    row than one sort: it lifts efficiency vs one card above the sort
    mode's (the padded second sort costs about the same as the first),
    but not above 0.7 as the TPU's 6x faster block sorts did."""
    sort = scaling.weak_scaling_efficiency(1e8, 8, baseline="single_chip")
    blocked = scaling.weak_scaling_efficiency(1e8, 8,
                                              baseline="single_chip",
                                              final_mode="blocked")
    assert sort < blocked < 0.7, (sort, blocked)


def test_two_host_prediction():
    """Two HGX hosts (8 GPUs each) over NDR InfiniBand vs one host, weak
    scaling at 1e8 rows per GPU: just below 0.8 at the specification."""
    one_host = scaling.distributed_sort_phases(8e8, 8)
    two_hosts = scaling.hierarchical_sort_phases(16e8, 2, 8)
    eff = one_host.total_s / two_hosts.total_s
    assert 0.75 <= eff < 0.8, eff


def test_dcn_threshold_restates_the_clause():
    """The >= 0.80-at-2-hosts clause needs slightly MORE than the NDR
    specification's 50e9 B/s/GPU (within 1.2x: a real two-host run can
    settle it), and far more than the measured Gloo software floor."""
    thr = scaling.dcn_required_for_clause()
    spec = LINK.dcn_bytes_per_s_per_chip
    assert spec < thr < 1.2 * spec, (thr, spec)
    assert thr > 10 * scaling.MEASURED_COMM["gloo_bytes_per_s_per_proc"]
    assert scaling.dcn_required_for_clause(target_eff=0.9) > thr
