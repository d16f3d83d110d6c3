"""The port's main paths on the card: `sort()` through the engines, the
radix movers, the query operators, the distributed tier on an NCCL group
of one and the entry points, each gated on an answer the code under test
does not give, and the kernels each path must launch.  The paths launch
hand-written kernels, which have no interpret mode, so every test here
skips where there is no CUDA card.  On the card:

    python -m pytest tests/test_torch_paths_card.py -q -p no:cacheprovider --noconftest

(`--noconftest`: the suite's conftest sets JAX up, and nothing here needs
it).  Cases, lettered as the port's records name them:

  (a)-(e)  `sort(method="auto")`: u64 + u64 on `xla`; uint8, int32 Zero and
           ZeroOne, int32 [-500, 500), int16 Gaussian descending on `count`;
  (f)-(j)  the radix movers and K1 + K6, equal byte for byte to the stable
           comparison sort; (j2) `sort_packed` of u64 + u64 rows, both
           directions, through cub's pair sort and K9; (j3) `sort_multi`
           of two keys and five payloads, its output by K10's groups;
  (k)-(p)  the operators and the quick and rank engines over a TPC-H-shaped
           table, on the CPU and on the card, which must agree (integers
           exactly, float sums to 1e-12);
  (q)-(w)  the distributed tier on an NCCL group of one against a Gloo
           group of the same rank on the CPU;
  then entry() and dryrun_multichip(1) against their CPU runs, and last
  the check that every kernel K1-K10 launched on these paths (it reads the
  launches of the tests before it, so it runs after them, in file order).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import simd_radix_sort_tpu_torch as srs
from simd_radix_sort_tpu_torch import entry as E, methods
from simd_radix_sort_tpu_torch import parallel as par
from simd_radix_sort_tpu_torch.ops import (cuda_columns as ccol,
                                           cuda_hist as ch,
                                           cuda_partition as cp,
                                           cuda_rows as crows,
                                           cuda_scan as cs,
                                           cuda_sort as csort, filter as filt,
                                           hashagg, hashjoin, quick_sort,
                                           radix, topk)
from simd_radix_sort_tpu_torch.utils import data as D, interop, transforms
from simd_radix_sort_tpu_torch.workloads.common import (
    device_checksums, fence, free_port, host_checksums, signed)

pytestmark = pytest.mark.card

N = 1 << 24  # rows of (a)-(h): at every `count` floor (methods.count_floor)
SCATTER_N = 1 << 22  # rows of (i)
SMALL_N = 1_000_000  # lineitems of (k)-(w); quick's blocked path runs there
SEED = 42
KERNELS = ("histogram", "minmax_hist16", "tiny_sort16", "fill_runs",
           "partition_pass", "fill_runs_packed", "segmented_scan",
           "key_bits", "row_gather", "column_pack", "column_gather")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paths launch hand-written "
                    "kernels")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def launched():
    """Kernel launches over this module's path cases, by kernel."""
    return dict.fromkeys(KERNELS, 0)


def count_launches(fn, launched, device):
    """fn()'s output and the kernel launches it made, which also join
    `launched`."""
    ch.reset_launches()
    cp.reset_launches()
    cs.reset_launches()
    csort.reset_launches()
    crows.reset_launches()
    ccol.reset_launches()
    out = fn()
    fence(device)
    launches = {**ch.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES,
                "key_bits": csort.LAUNCHES["key_bits"], **crows.LAUNCHES,
                **ccol.LAUNCHES}
    for name, count in launches.items():
        launched[name] += count
    return out, launches


def as_tuple(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    keys, rest = out[0], out[1:]
    if len(rest) == 1 and isinstance(rest[0], tuple):
        rest = rest[0]  # radix.sort_arrays: (keys, payloads)
    return (keys, *rest)


def sorted_carrier(out, asc):
    c = srs.to_sortable(out, asc)
    return bool((c[1:] >= c[:-1]).all())


def equal_to_stable_sort(label, out, kd, pd, asc):
    """`out` equals the stable comparison sort of its input byte for
    byte, keys and payloads."""
    want = as_tuple(srs.sort(kd, *pd, ascending=asc, method="xla",
                             stable=True))
    assert len(out) == len(want) and all(
        g.dtype == w.dtype and torch.equal(signed(g), signed(w))
        for g, w in zip(out, want)), \
        f"{label}: differs from the stable comparison sort of its input"


# ---- (a)-(j): sort() and the radix movers ----------------------------------


@pytest.fixture(scope="module")
def u64_pair(card):
    """bench.py's data: N uint64 Uniform keys and their payloads on the
    card, with its checksums."""
    keys = D.make_keys(N, np.uint64, D.Distribution.UNIFORM, SEED)
    (pay,) = D.make_payloads(keys, [np.uint64])
    return (interop.from_numpy(keys, card), interop.from_numpy(pay, card),
            host_checksums(keys, pay))


def check_bench(label, out, sums):
    assert sorted_carrier(out[0], True), f"{label}: not sorted"
    assert device_checksums(out) == sums, f"{label}: checksums differ"


def test_a_auto_sorts_u64_pairs_on_xla(card, u64_pair, launched):
    k64, p64, sums = u64_pair
    assert methods.resolve("auto", k64.dtype, [p64.dtype], N).name == "xla"
    out, _ = count_launches(lambda: as_tuple(srs.sort(k64, p64)), launched,
                            card)
    check_bench("a", out, sums)


# (label, key dtype, distribution (None: uniform in [-500, 500)), ascending)
COUNT_CASES = (("b uint8 Uniform", "uint8", "Uniform", True),
               ("b2 uint8 Zero", "uint8", "Zero", True),
               ("b3 uint8 ReverseSorted", "uint8", "ReverseSorted", True),
               ("c int32 Zero", "int32", "Zero", True),
               ("c int32 ZeroOne", "int32", "ZeroOne", True),
               ("d int32 [-500,500)", "int32", None, True),
               ("e int16 Gaussian desc", "int16", "Gaussian", False))


@pytest.mark.parametrize("label,dtype,dist,asc", COUNT_CASES,
                         ids=[c[0] for c in COUNT_CASES])
def test_b_to_e_auto_sorts_narrow_keys_on_count(card, launched, label,
                                                dtype, dist, asc):
    """The engine `auto` resolves to, the kernels of count's branch for the
    keys' range, and the output equal to the comparison sort's."""
    keys = (np.random.default_rng(SEED).integers(-500, 500, N,
                                                 dtype=np.int32)
            if dist is None else
            D.make_keys(N, np.dtype(dtype), D.Distribution(dist), SEED))
    assert methods.resolve("auto", keys.dtype, [], N).name == "count"
    u = transforms.to_sortable_np(keys)
    span = int(u.max()) - int(u.min())
    if keys.dtype.itemsize == 1:
        expect = ["histogram", "fill_runs"]
    elif 16 <= span < 1024:
        expect = ["minmax_hist16", "tiny_sort16", "histogram", "fill_runs"]
    else:
        expect = ["minmax_hist16", "tiny_sort16"]
    kd = interop.from_numpy(keys, card)
    (out,), launches = count_launches(
        lambda: as_tuple(srs.sort(kd, ascending=asc)), launched, card)
    ref = srs.sort(kd, ascending=asc, method="xla")
    assert torch.equal(signed(out), signed(ref)), \
        f"{label}: differs from the comparison sort of its input"
    assert sorted_carrier(out, asc), f"{label}: not sorted"
    missing = [k for k in expect if launches[k] < 1]
    assert not missing, f"{label}: kernels {missing} not launched"


def test_f_radix_sorts_u64_pairs_stably(card, u64_pair, launched):
    """The radix engine's default mover: 2 passes of 32-bit digits."""
    k64, p64, sums = u64_pair
    out, _ = count_launches(
        lambda: as_tuple(srs.sort(k64, p64, method="radix")), launched, card)
    equal_to_stable_sort("f", out, k64, (p64,), True)
    check_bench("f", out, sums)


def test_g_radix_pallas_moves_u64_pairs_by_k5(card, u64_pair, launched):
    """One K5 partition per key bit."""
    k64, p64, sums = u64_pair
    out, launches = count_launches(
        lambda: as_tuple(radix.sort_arrays(k64, (p64,), engine="pallas")),
        launched, card)
    equal_to_stable_sort("g", out, k64, (p64,), True)
    check_bench("g", out, sums)
    assert launches["partition_pass"] == 64


def test_h_radix_pallas_descending_int32_with_uint16(card, launched):
    """K5 with a widened payload and the top-bit flip of a descending
    signed key."""
    keys = D.make_keys(N, np.int32, D.Distribution.UNIFORM, SEED)
    kh = interop.from_numpy(keys, card)
    ph = tuple(interop.from_numpy(p, card)
               for p in D.make_payloads(keys, [np.uint16]))
    out, launches = count_launches(
        lambda: as_tuple(radix.sort_arrays(kh, ph, ascending=False,
                                           engine="pallas")),
        launched, card)
    equal_to_stable_sort("h", out, kh, ph, False)
    assert launches["partition_pass"] == 32


def test_i_radix_scatter_sorts_int32_pairs(card, launched):
    """The scatter mover, the semantic model."""
    keys = D.make_keys(SCATTER_N, np.int32, D.Distribution.UNIFORM, SEED)
    ki = interop.from_numpy(keys, card)
    pi = tuple(interop.from_numpy(p, card)
               for p in D.make_payloads(keys, [np.int32]))
    out, _ = count_launches(
        lambda: as_tuple(radix.sort_arrays(ki, pi, engine="scatter")),
        launched, card)
    equal_to_stable_sort("i", out, ki, pi, True)


def test_j_uint8_through_k1_and_k6(card, launched):
    """A histogram of the raw bytes, then the packed run fill:
    scripts/u8_attack.py's path."""
    n4 = N - N % 4
    kj = interop.from_numpy(
        D.make_keys(n4, np.uint8, D.Distribution.UNIFORM, SEED), card)
    out, launches = count_launches(
        lambda: (ch.fill_runs_packed(ch.histogram(kj, 256), n4),),
        launched, card)
    equal_to_stable_sort("j", out, kj, (), True)
    assert launches["histogram"] == launches["fill_runs_packed"] == 1


@pytest.mark.parametrize("asc", [True, False])
def test_j2_sort_packed_assembles_rows_by_k9(card, u64_pair, launched, asc):
    """The combined layout: 16-byte rows of the u64 key and its payload,
    sorted whole by `sort_packed`, equal to the pair sort's columns."""
    k64, p64, _ = u64_pair
    packed = torch.cat([signed(k64).view(torch.uint8).view(N, 8),
                        signed(p64).view(torch.uint8).view(N, 8)], dim=1)
    (out,), launches = count_launches(
        lambda: (srs.sort_packed(packed, np.uint64, ascending=asc),),
        launched, card)
    keys, pay = srs.sort(k64, p64, ascending=asc)
    assert torch.equal(out[:, :8].contiguous().view(torch.int64).view(-1),
                       signed(keys))
    assert torch.equal(out[:, 8:].contiguous().view(torch.int64).view(-1),
                       signed(pay))
    assert launches["row_gather"] == 1 and launches["key_bits"] == 1


def test_j3_sort_multi_assembles_columns_by_k10(card, u64_pair, launched):
    """ORDER BY a, b DESC of the u64 data, carrying five payloads of 8, 8,
    4, 2 and 1 bytes: equal to each column gathered by the stable sort of
    one composite key, and assembled by K10 (a pack and a gather a group)."""
    k64, p64, _ = u64_pair
    a = signed(k64) % 997
    b = signed(p64).to(torch.int32)
    pays = (signed(k64), signed(p64).view(torch.float64),
            signed(p64).to(torch.float32), signed(k64).to(torch.int16),
            (signed(p64) & 255).to(torch.uint8))
    (got,), launches = count_launches(
        lambda: (srs.sort_multi((a, b), *pays, ascending=(True, False)),),
        launched, card)
    # a in [0, 997) high, b descending as its complement low: unique order
    composite = (a << 32) | ((1 << 31) - 1 - b.to(torch.int64))
    perm = torch.sort(composite, stable=True).indices
    for g, col in zip(got[0] + got[1], (a, b) + pays):
        assert torch.equal(signed(g), signed(col).index_select(0, perm))
    groups = ccol.plan_groups(N, [t.element_size() for t in (a, b) + pays])
    assert launches["column_gather"] == len(groups) == 3
    assert launches["column_pack"] == sum(g.staged for g in groups) == 3


# ---- (k)-(p): the operators and the quick and rank engines -----------------

# TPC-H (specification v3): dates as day numbers since 1970-01-01
STARTDATE, ENDDATE = 8035, 10591  # 1992-01-01, 1998-12-31
CURRENTDATE = 9298  # 1995-06-17
Q6_FROM, Q6_TO = 8766, 9131  # 1994-01-01, 1995-01-01
Q6_COLUMNS = ("l_shipdate", "l_quantity", "l_extendedprice", "l_discount")


def lineitem_orders(n_orders: int, extra: int, seed: int) -> dict:
    """`orders` and its `lineitem`s on the CPU, shaped by TPC-H's rules
    (4.2.3): sparse order keys (the first 8 of every 32), 1-7 lineitems an
    order in key order, l_quantity 1-50, l_extendedprice quantity x a price
    of 900.00-2098.99, l_discount 0.00-0.10 (float64, each also kept as
    exact integers for the gates), l_shipdate 1-121 days after the order;
    `l_rfls` is Q1's group (A/F 0, N/F 1, N/O 2, R/F 3) and `q6` Q6's
    predicate.  Plus `extra` rows of (o)'s and (p)'s keys: u64 keys and
    payloads, int32 keys with many ties and with 1% distinct."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_orders)
    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    odate = rng.integers(STARTDATE, ENDDATE - 150, n_orders).astype(np.int32)
    t = {"o_orderkey": (i // 8) * 32 + i % 8 + 1, "o_orderdate": odate,
         "o_totalprice": rng.integers(85_700, 55_558_628, n_orders) / 100,
         "o_lines": lines}
    t["l_orderkey"] = np.repeat(t["o_orderkey"], lines)
    t["l_orderdate"] = np.repeat(odate, lines)
    t["l_rowid"] = np.arange(n)
    qty = t["qty_units"] = rng.integers(1, 51, n)
    t["price_cents"] = qty * rng.integers(90_000, 209_900, n)
    disc = t["disc_hundredths"] = rng.integers(0, 11, n)
    t["l_quantity"] = qty.astype(np.float64)
    t["l_extendedprice"] = t["price_cents"] / 100
    t["l_discount"] = disc / 100
    ship = t["l_shipdate"] = t["l_orderdate"] + rng.integers(
        1, 122, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    # returnflag N once received after CURRENTDATE, else A or R;
    # linestatus O once shipped after it (which makes the flag N)
    flag = np.where(receipt > CURRENTDATE, 1, 3 * rng.integers(0, 2, n))
    t["l_rfls"] = np.where(ship > CURRENTDATE, 2, flag).astype(np.int32)
    t["q6"] = ((ship >= Q6_FROM) & (ship < Q6_TO) & (disc >= 5)
               & (disc <= 7) & (qty < 24))
    t["u64"], t["u64_pay"] = (rng.integers(0, 2**64, extra, dtype=np.uint64)
                              for _ in range(2))
    t["ties"] = rng.integers(0, 1000, extra).astype(np.int32)
    t["uniq"] = rng.integers(0, max(1, extra // 100), extra).astype(np.int32)
    t["uniq_row"] = np.arange(extra, dtype=np.int32)
    return {k: (interop.from_numpy(v, "cpu") if v.dtype == np.uint64
                else torch.from_numpy(v)) for k, v in t.items()}


@pytest.fixture(scope="module")
def tables(card):
    """The same tables on the CPU and on the card."""
    cpu = lineitem_orders(SMALL_N // 4, SMALL_N, SEED)
    return cpu, {k: signed(v).to(card).view(v.dtype) for k, v in cpu.items()}


def flat(out):
    """The tensors of a nested output, in order."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [x for o in out for x in flat(o)]


def agree(label, cpu_out, card_out):
    """The same outputs on the CPU and on the card: integers exactly,
    floats to the tests' float64 tolerance (sums in another order)."""
    for i, (a, b) in enumerate(zip(flat(cpu_out), flat(card_out),
                                   strict=True)):
        b = signed(b).cpu().view(b.dtype)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label} output {i}: {a.dtype} "
                                 f"{tuple(a.shape)} on the CPU, {b.dtype} "
                                 f"{tuple(b.shape)} on the card")
        if a.dtype.is_floating_point:
            same = torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            same = torch.equal(signed(a), signed(b))
        if not same:
            raise AssertionError(f"{label} output {i}: the CPU and the "
                                 "card differ")


def take(x, idx):
    return signed(x).index_select(0, idx)


def eq(label, got, want):
    if got.shape != want.shape or not torch.equal(signed(got), signed(want)):
        raise AssertionError(f"{label}: differs from its gate")


def close(label, got, want):
    # the tests' float64 tolerance: sums in another order
    if not torch.allclose(got, want, rtol=1e-12, atol=0):
        err = ((got - want).abs() / want.abs()).max().item()
        raise AssertionError(f"{label}: relative error {err}")


def pair_fp(k, p):
    """A sum over key-payload pairs: equal for any order of the pairs."""
    return ((signed(k) * 0x7FFFFFFF) ^ signed(p)).sum()


def operator_cases(quick_n: int):
    """Cases (k)-(p) over tables `t` given at run time: each (label,
    run(t), gate(t, out), kernels that must launch, K5 launches,
    canon(out)).  `gate` holds the output against an answer that the code
    under test does not give: one known by construction, or other torch
    calls.  `canon` is what of the output must agree between the CPU and
    the card (rows past a count are padding; where the port sorts
    unstably, a sum over pairs stands for their order)."""
    cases = []
    q6 = Q6_COLUMNS

    # (k) filter, Q6's predicate
    def gate_k(t, out):
        sel, rest = (torch.nonzero(t["q6"]).squeeze(1),
                     torch.nonzero(~t["q6"]).squeeze(1))
        if int(out[0]) != sel.numel():
            raise AssertionError("(k) count")
        for col, o in zip(q6, out[1:]):
            eq("(k) " + col, o, torch.cat([take(t[col], sel),
                                           take(t[col], rest)]))

    cases.append(("k filter_rows Q6",
                  lambda t: filt.filter_rows(t["q6"], *(t[c] for c in q6)),
                  gate_k, ["partition_pass"], 1, lambda out: out))

    # (l) Q1's group-by; (m) by l_orderkey
    def groupby_ref(t, key, cols):
        uk, inv, cnt = torch.unique(t[key], sorted=True,
                                    return_inverse=True, return_counts=True)
        sums = [torch.zeros(uk.numel(), dtype=torch.int64,
                            device=uk.device).index_add_(0, inv, t[c])
                for c in cols]
        return uk, cnt, sums

    exact = {"l_quantity": ("qty_units", 1), "l_extendedprice":
             ("price_cents", 100), "l_discount": ("disc_hundredths", 100)}

    def group_gate(label, key, cols, aggs):
        def gate(t, out):
            ng, gk, res = out
            uk, cnt, sums = groupby_ref(t, key, [exact[c][0] for c in cols])
            g = uk.numel()
            if int(ng) != g:
                raise AssertionError(f"{label}: {int(ng)} groups, not {g}")
            eq(label + " keys", gk[:g], uk)
            want_sum = [s.double() / exact[c][1] for s, c in zip(sums, cols)]
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r[:g], cnt.to(torch.int32))
                    continue
                for c, got, s in zip(cols, r, want_sum):
                    close(f"{label} {agg} {c}", got[:g],
                          s if agg == "sum" else s / cnt)
        return gate

    def group_canon(aggs):
        def canon(out):
            ng, gk, res = out
            g = int(ng)
            return [ng, gk[:g]] + [x[:g] for agg, r in zip(aggs, res)
                                   for x in ((r,) if agg == "count" else r)]
        return canon

    q1_cols = ("l_quantity", "l_extendedprice", "l_discount")
    q1_aggs = ("sum", "mean", "count")
    for label, kw in (("l Q1 group_aggregate max_groups=4",
                       {"max_groups": 4}),
                      ("l Q1 group_aggregate", {})):
        cases.append((
            label,
            lambda t, kw=kw: hashagg.group_aggregate(
                t["l_rfls"], tuple(t[c] for c in q1_cols), aggs=q1_aggs,
                **kw),
            group_gate("(l)", "l_rfls", q1_cols, q1_aggs),
            ["partition_pass", "segmented_scan"], 1, group_canon(q1_aggs)))
    m_cols, m_aggs = ("l_extendedprice",), ("sum", "count")
    cases.append((
        "m group_aggregate by l_orderkey",
        lambda t: hashagg.group_aggregate(
            t["l_orderkey"], (t["l_extendedprice"],), aggs=m_aggs),
        group_gate("(m)", "l_orderkey", m_cols, m_aggs),
        ["partition_pass", "segmented_scan"], 1, group_canon(m_aggs)))

    # (n) joins of lineitem and orders
    def gate_lookup(t, out):
        found, counts, (date, price) = out
        if not bool(found.all()) or not bool((counts == 1).all()):
            raise AssertionError("(n) lookup: a lineitem lost its order")
        eq("(n) lookup o_orderdate", date, t["l_orderdate"])
        eq("(n) lookup o_totalprice", price,
           torch.repeat_interleave(t["o_totalprice"], t["o_lines"]))

    cases.append(("n lookup_join lineitem->orders",
                  lambda t: hashjoin.lookup_join(
                      t["l_orderkey"], t["o_orderkey"],
                      (t["o_orderdate"], t["o_totalprice"])),
                  gate_lookup, [], 0, lambda out: out))

    def gate_semi(t, out):
        if int(out[0]) != t["l_orderkey"].numel():
            raise AssertionError("(n) semi_join count")
        eq("(n) semi keys", out[1], t["l_orderkey"])
        eq("(n) semi price", out[2], t["l_extendedprice"])

    cases.append(("n semi_join lineitem in orders",
                  lambda t: hashjoin.semi_join(
                      t["l_orderkey"], (t["l_extendedprice"],),
                      t["o_orderkey"]),
                  gate_semi, ["partition_pass"], 1, lambda out: out))

    def check_pairs(label, total, ok, n_l):
        """As many pairs as lineitems, each joining equal keys."""
        if int(total) != n_l:
            raise AssertionError(f"{label}: total {int(total)} != {n_l}")
        if not bool(ok.all()):
            raise AssertionError(f"{label}: a pair joins different keys")

    def gate_expand(t, out):
        total, pidx, pk, (pdate,), (rowid,) = out
        check_pairs("(n) inner_join_expand", total,
                    take(t["l_orderkey"], rowid) == pk,
                    t["l_orderkey"].numel())
        eq("(n) expand probe keys", pk, t["l_orderkey"])
        eq("(n) expand probe dates", pdate, t["l_orderdate"])
        eq("(n) expand rows", torch.sort(rowid).values, t["l_rowid"])

    def expand_canon(out):
        total, pidx, pk, pps, (rowid,) = out
        return [total, pidx, pk, *pps,
                torch.sort(pidx.to(torch.int64) * rowid.numel()
                           + rowid).values]

    cases.append(("n inner_join_expand orders x lineitem",
                  lambda t: hashjoin.inner_join_expand(
                      t["o_orderkey"], (t["o_orderdate"],), t["l_orderkey"],
                      (t["l_rowid"],), t["l_orderkey"].numel()),
                  gate_expand, [], 0, expand_canon))

    def gate_merge(t, out):
        total, pidx, bidx = out
        check_pairs("(n) merge_join_indices", total,
                    take(t["o_orderkey"], pidx)
                    == take(t["l_orderkey"], bidx),
                    t["l_orderkey"].numel())
        eq("(n) merge rows", torch.sort(bidx.to(torch.int64)).values,
           t["l_rowid"])

    cases.append(("n merge_join_indices",
                  lambda t: hashjoin.merge_join_indices(
                      (srs.to_sortable(t["o_orderkey"]),),
                      t["o_orderkey"].numel(),
                      (srs.to_sortable(t["l_orderkey"]),),
                      t["l_orderkey"].numel(), t["l_orderkey"].numel()),
                  gate_merge, ["partition_pass"], 1, lambda out: out))

    # (o) top_k and unique
    def topk_gate(label, key, pay):
        def gate(t, out):
            order = torch.sort(srs.to_sortable(t[key], False),
                               stable=True).indices[:100]
            eq(label + " keys", out[0], take(t[key], order))
            if pay:
                eq(label + " payload", out[1], take(t[pay], order))
        return gate

    cases.append(("o top_k k=100 u64+u64",
                  lambda t: topk.top_k(t["u64"], t["u64_pay"], k=100),
                  topk_gate("(o) top_k u64", "u64", "u64_pay"), [], 0,
                  lambda out: out))
    cases.append(("o top_k k=100 int32 ties",
                  lambda t: topk.top_k(t["ties"], t["uniq_row"], k=100),
                  topk_gate("(o) top_k ties", "ties", "uniq_row"), [], 0,
                  lambda out: out))

    def gate_unique(t, out):
        count, ku, first, mult = out
        uk, inv, cnt = torch.unique(t["uniq"], sorted=True,
                                    return_inverse=True, return_counts=True)
        g = uk.numel()
        if int(count) != g:
            raise AssertionError("(o) unique count")
        eq("(o) unique keys", ku[:g], uk)
        eq("(o) unique multiplicity", mult[:g], cnt.to(torch.int32))
        want = torch.full((g,), t["uniq"].numel(), dtype=torch.int32,
                          device=uk.device).scatter_reduce_(
            0, inv, t["uniq_row"], "amin")
        eq("(o) unique first rows", first[:g], want)

    cases.append(("o unique int32",
                  lambda t: topk.unique(t["uniq"], t["uniq_row"]),
                  gate_unique, ["partition_pass"], 1, lambda out: out))

    # (p) the engines and the pivot partition
    def quick(t, stable):
        quick_sort.reset_paths()
        return srs.sort(t["u64"][:quick_n], t["u64_pay"][:quick_n],
                        method="quick", stable=stable,
                        device=t["u64"].device)

    def quick_gate(stable):
        def gate(t, out):
            if quick_sort.PATHS["blocked"] != 1:
                raise AssertionError(f"(p) quick took {quick_sort.PATHS}")
            k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
            want = srs.sort(k, p, method="xla", stable=True,
                            device=k.device)
            eq("(p) quick keys", out[0], want[0])
            if stable:
                eq("(p) quick payload", out[1], want[1])
            elif int(pair_fp(*out)) != int(pair_fp(k, p)):
                raise AssertionError("(p) quick: a payload left its key")
        return gate

    for stable in (True, False):
        cases.append((f"p sort quick stable={stable}",
                      lambda t, s=stable: quick(t, s), quick_gate(stable),
                      [], 0,
                      (lambda out: out) if stable else
                      (lambda out: [out[0], pair_fp(*out)])))

    def pivot_of(t):
        return t["u64"][quick_n // 2]

    def gate_partition(t, out):
        k, p = t["u64"][:quick_n], t["u64_pay"][:quick_n]
        c = srs.to_sortable(k)
        le = c <= srs.to_sortable(pivot_of(t).reshape(1))
        left, right = (torch.nonzero(le).squeeze(1),
                       torch.nonzero(~le).squeeze(1))
        order = torch.cat([left, right])
        eq("(p) partition keys", out[0], take(k, order))
        eq("(p) partition payload", out[1][0], take(p, order))
        if int(out[2]) != left.numel():
            raise AssertionError("(p) partition split")
        ends = torch.sort(c).values
        eq("(p) partition kmin", srs.to_sortable(out[3].reshape(1)),
           ends[:1])
        eq("(p) partition kmax", srs.to_sortable(out[4].reshape(1)),
           ends[-1:])

    cases.append(("p quick_sort.partition u64+u64",
                  lambda t: quick_sort.partition(
                      t["u64"][:quick_n], (t["u64_pay"][:quick_n],),
                      pivot_of(t)),
                  gate_partition, ["partition_pass"], 1, lambda out: out))

    def gate_rank(t, out):
        want = srs.sort(t["u64"][:4096], t["u64_pay"][:4096], method="xla",
                        stable=True, device=t["u64"].device)
        eq("(p) rank keys", out[0], want[0])
        eq("(p) rank payload", out[1], want[1])

    cases.append(("p sort rank n=4096",
                  lambda t: srs.sort(t["u64"][:4096], t["u64_pay"][:4096],
                                     method="rank", device=t["u64"].device),
                  gate_rank, [], 0, lambda out: out))
    return {c[0]: c for c in cases}


OPERATOR_CASES = operator_cases(SMALL_N)


@pytest.mark.parametrize("label", list(OPERATOR_CASES))
def test_k_to_p_operators_on_the_card_agree_with_the_cpu(card, tables,
                                                         launched, label):
    """Each case gated on the CPU and on the card, its kernels and K5
    launches counted on the card, and the two outputs in agreement."""
    cpu, dev = tables
    _, run, gate, expect, k5, canon = OPERATOR_CASES[label]
    out_cpu = run(cpu)
    gate(cpu, out_cpu)
    out_card, launches = count_launches(lambda: run(dev), launched, card)
    gate(dev, out_card)
    missing = [k for k in expect if launches[k] < 1]
    assert not missing, f"{label}: kernels {missing} not launched"
    assert launches["partition_pass"] == k5
    agree(label, canon(out_cpu), canon(out_card))


@pytest.mark.parametrize("dt", [torch.int8, torch.int16])
def test_narrow_carriers_agree(card, tables, dt):
    """torch.searchsorted on 1- and 2-byte carriers: the quick engine's
    bucket ids and a join's probes."""
    outs = [(srs.sort(k, method="quick", device=k.device),
             hashjoin.lookup_join(k, k[:1000])[:2])
            for k in (t["ties"].to(dt) for t in tables)]
    agree(f"narrow {dt}", *outs)


# ---- (q)-(w): the distributed tier -----------------------------------------


def distributed_cases(t, world: int, group, device):
    """Cases (q)-(w), the distributed tier (simd_radix_sort_tpu_torch/
    parallel/) on `world` ranks over the tables `t`, which every rank holds
    whole (the entries keep the rank's block of rows): each (label, run(),
    gate(out), K5 launches at P = 1, canon(out)).  Each gate assembles the
    whole result on every rank (gather_*) and holds it against single-card
    torch calls on the whole input; `canon` is what must agree between the
    CPU and the card."""
    kw = {"group": group, "device": device}
    n_l = t["l_orderkey"].numel()
    cases = []

    def no_overflow(label, ov):
        if int(ov.max()):
            raise AssertionError(f"{label}: overflow flagged")

    # (q) the splitter sort of u64 keys; gate: torch.sort, the checksums
    k64, p64 = t["u64"], t["u64_pay"]

    def q_gather(out):
        gk, (gp,) = par.gather_result(out[0], out[1], out[2], group)
        return gk, gp

    def q_canon(out):
        gk, gp = q_gather(out)
        return [gk, pair_fp(gk, gp)]

    def q_gate(label):
        def gate(out):
            no_overflow(label, out[3])
            gk, gp = q_gather(out)
            eq(label + " keys", gk, srs.sort(k64, method="xla",
                                             device=k64.device))
            if device_checksums((gk, gp)) != device_checksums((k64, p64)):
                raise AssertionError(f"{label}: checksums differ")
        return gate

    for mode in ("sort", "blocked"):
        label = f"q distributed_sort final_mode={mode} u64+u64"
        cases.append((
            label,
            lambda mode=mode: par.distributed_sort(k64, p64, final_mode=mode,
                                                   **kw),
            q_gate(label), 0, q_canon))

    # (r) ORDER BY l_shipdate, l_orderkey DESC carrying l_extendedprice;
    # gate: sort_multi(stable=True) column by column (the payload exactly
    # at P = 1, where the distributed sort is stable; else by fingerprint)
    cols = (t["l_shipdate"], t["l_orderkey"])
    price = t["l_extendedprice"]

    def r_gather(out):
        return par.gather_result_multi(out[0], out[1], out[2], group)

    def r_canon(out):
        (g1, g2), (gp,) = r_gather(out)
        return [g1, g2, pair_fp(g2, gp)]

    def r_gate(out):
        no_overflow("(r)", out[3])
        (g1, g2), (gp,) = r_gather(out)
        (w1, w2), (wp,) = srs.sort_multi(cols, price, ascending=(True, False),
                                         stable=True, device=price.device)
        eq("(r) l_shipdate", g1, w1)
        eq("(r) l_orderkey", g2, w2)
        if world == 1:
            eq("(r) l_extendedprice", gp, wp)
        elif int(pair_fp(g2, gp)) != int(pair_fp(w2, wp)):
            raise AssertionError("(r) a payload left its row")

    cases.append((
        "r distributed_sort_multi l_shipdate,l_orderkey desc",
        lambda: par.distributed_sort_multi(cols, price,
                                           ascending=(True, False), **kw),
        r_gate, 0, r_canon))

    # (s) Q6's filter; gate as (k), on the gathered rows
    mask = t["q6"]

    def s_gather(out):
        gk, gp = par.gather_filtered(*out, group=group)
        return [gk, *gp]

    def s_gate(out):
        got = s_gather(out)
        sel = torch.nonzero(mask).squeeze(1)
        if got[0].numel() != sel.numel():
            raise AssertionError("(s) count")
        for col, o in zip(Q6_COLUMNS, got):
            eq("(s) " + col, o, take(t[col], sel))

    cases.append(("s distributed_filter Q6",
                  lambda: par.distributed_filter(
                      mask, *(t[c] for c in Q6_COLUMNS), **kw),
                  s_gate, 1, s_gather))

    # (t) Q1's groups and l_orderkey's; gate: torch.unique + index_add_ of
    # the exact integer cents
    def t_gate(label, key, aggs):
        def gate(out):
            ng, gk, res = out
            uk, inv, cnt = torch.unique(t[key], sorted=True,
                                        return_inverse=True,
                                        return_counts=True)
            cents = torch.zeros(uk.numel(), dtype=torch.int64,
                                device=uk.device).index_add_(
                0, inv, t["price_cents"])
            if ng != uk.numel():
                raise AssertionError(f"{label}: {ng} groups, not "
                                     f"{uk.numel()}")
            eq(label + " keys", gk, uk)
            for agg, r in zip(aggs, res):
                if agg == "count":
                    eq(label + " count", r, cnt.to(torch.int32))
                else:
                    want = cents.double() / 100
                    close(f"{label} {agg}", r,
                          want if agg == "sum" else want / cnt)
        return gate

    for label, key, aggs in (
            ("t Q1 distributed_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("t distributed_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label,
            lambda key=key, aggs=aggs: par.distributed_group_aggregate(
                t[key], price, aggs, **kw),
            t_gate(label, key, aggs), 2,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))

    # (u) lineitem x orders, uniform and with one order's key on every
    # fourth lineitem (hot: flagged by the sample, joined by broadcast);
    # gate: every lineitem matched once, its order's payload as a
    # searchsorted lookup finds it
    okey = t["o_orderkey"]
    build = (t["o_orderdate"], t["o_totalprice"])
    hot = t["l_orderkey"].clone()
    hot[::4] = okey[okey.numel() // 3]
    cap_out = min(2 * n_l // world, n_l)

    def u_gather(out):
        gk, (rowid,), (date, tprice) = par.gather_joined(
            out[0], out[1], out[2], out[3], group)
        order = torch.argsort(rowid)
        return [x.index_select(0, order) for x in (gk, rowid, date, tprice)]

    def u_gate(label, keys, is_hot):
        def gate(out):
            no_overflow(label, out[4])
            gk, rowid, date, tprice = u_gather(out)
            eq(label + " rows", rowid, t["l_rowid"])
            eq(label + " keys", gk, keys)
            at = torch.searchsorted(okey, gk)
            eq(label + " o_orderdate", date, take(build[0], at))
            eq(label + " o_totalprice", tprice, take(build[1], at))
            if is_hot and int(out[5]["hot_key_slots_flagged"]) < 1:
                raise AssertionError(f"{label}: no hot key flagged")
        return gate

    for label, keys, extra in (
            ("u distributed_join uniform", t["l_orderkey"], {}),
            ("u distributed_join hot key", hot, {"hot_min_count": 16})):
        cases.append((
            label,
            lambda keys=keys, extra=extra: par.distributed_join(
                keys, (t["l_rowid"],), okey, build,
                out_rows_per_device=cap_out, return_hot_stats=True,
                **extra, **kw),
            u_gate(label, keys, bool(extra)), 5,
            lambda out: [*u_gather(out),
                         out[5]["hot_key_slots_flagged"]]))

    # (v) top_k of the u64 keys; unique of 1%-distinct int32 keys; gates as
    # (o)
    def v_topk_gate(out):
        order = torch.sort(srs.to_sortable(k64, False),
                           stable=True).indices[:100]
        eq("(v) top_k keys", out[0], take(k64, order))
        eq("(v) top_k payload", out[1], take(p64, order))

    cases.append(("v distributed_top_k k=100 u64+u64",
                  lambda: par.distributed_top_k(k64, p64, k=100, **kw),
                  v_topk_gate, 0, list))

    def v_unique_gate(out):
        ng, gk, mult = out
        uk, cnt = torch.unique(t["uniq"], sorted=True, return_counts=True)
        if ng != uk.numel():
            raise AssertionError("(v) unique count")
        eq("(v) unique keys", gk, uk)
        eq("(v) unique multiplicity", mult, cnt.to(torch.int32))

    cases.append(("v distributed_unique int32",
                  lambda: par.distributed_unique(t["uniq"], **kw),
                  v_unique_gate, 2,
                  lambda out: [torch.tensor(out[0]), out[1], out[2]]))

    # (w) the hierarchical tier on an S x C mesh of the ranks: (1, 1) at
    # P = 1, (2, 1) at P = 2, (2, 2) at P = 4; gated as (q) and (t).  At
    # P = 1 the sort is one local sort and each aggregate is tier 0 alone
    # (the one-slice shortcut): one K5 launch each
    slices = 1 if world == 1 else 2
    label = "w hierarchical_sort exchange_chunks=2 u64+u64"
    cases.append((
        label,
        lambda: par.hierarchical_sort(k64, p64, num_slices=slices,
                                      exchange_chunks=2, **kw),
        q_gate(label), 0, q_canon))
    for label, key, aggs in (
            ("w Q1 hierarchical_group_aggregate", "l_rfls",
             ("sum", "mean", "count")),
            ("w hierarchical_group_aggregate by l_orderkey", "l_orderkey",
             ("sum", "count"))):
        cases.append((
            label,
            lambda key=key, aggs=aggs: par.hierarchical_group_aggregate(
                t[key], price, aggs, num_slices=slices, **kw),
            t_gate(label, key, aggs), 1,
            lambda out: [torch.tensor(out[0]), out[1], *out[2]]))
    return {c[0]: c for c in cases}


DISTRIBUTED_CASES = list(distributed_cases(lineitem_orders(8, 8, SEED), 1,
                                           None, "cpu"))


class TestDistributedOnOneNcclRank:
    @pytest.fixture(scope="class")
    def gloo(self, card):
        """An NCCL group of this process alone, the default group, and a
        Gloo group of the same rank for the CPU."""
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1, device_id=card)
        try:
            yield dist.new_group(backend="gloo")
        finally:
            dist.destroy_process_group()

    @pytest.mark.parametrize("label", DISTRIBUTED_CASES)
    def test_q_to_w_agree_with_gloo(self, card, gloo, tables, launched,
                                    label):
        """Each case gated on Gloo on the CPU and on NCCL on the card, its
        K5 launches counted on the card, and the two outputs in
        agreement."""
        cpu, dev = tables
        _, run_cpu, gate_cpu, _, canon_cpu = distributed_cases(
            cpu, 1, gloo, "cpu")[label]
        _, run, gate, k5, canon = distributed_cases(dev, 1, None,
                                                    card)[label]
        out_cpu = run_cpu()
        gate_cpu(out_cpu)
        out_card, launches = count_launches(run, launched, card)
        gate(out_card)
        assert launches["partition_pass"] == k5
        agree(label, canon_cpu(out_cpu), canon(out_card))


# ---- the entry points ------------------------------------------------------


def test_entry_on_the_card_matches_the_cpu(card, launched):
    """Keys exactly; payloads by the key<->payload pairing (the sort is
    unstable)."""
    step, args = E.entry(card)
    (keys, pay), _ = count_launches(lambda: step(*args), launched, card)
    cpu_step, cpu_args = E.entry("cpu")
    cpu_keys, cpu_pay = (interop.to_numpy(t) for t in cpu_step(*cpu_args))
    keys, pay = interop.to_numpy(keys), interop.to_numpy(pay)
    assert np.array_equal(keys, cpu_keys)
    wide = np.uint64
    assert np.array_equal(
        E.pair_prints(keys.astype(wide), pay.astype(wide)),
        E.pair_prints(cpu_keys.astype(wide), cpu_pay.astype(wide)))


def test_dryrun_on_one_nccl_rank_matches_gloo(card, launched):
    """Every step gated inside the dry run, then its record equal to the
    same dry run's on a Gloo rank on the CPU."""
    rec = E.dryrun_multichip(1)
    cpu = E.dryrun_multichip(1, "cpu")
    for key in ("sort_counts", "filter_rows", "aggregate_groups",
                "aggregate_sum", "join_pairs", "join_hot", "hierarchical"):
        assert rec[key] == cpu[key], key
    assert np.array_equal(rec["sorted_keys"], cpu["sorted_keys"])
    assert rec["k5_launches"], "the dry run launched K5 no time"
    launched["partition_pass"] += rec["k5_launches"]


def test_every_kernel_launched_on_the_main_paths(card, launched):
    """Each of K1-K10 launched at least once by the cases above."""
    idle = [name for name, count in launched.items() if count < 1]
    assert not idle, f"kernels never launched on the main path: {idle}"
