"""The traffic generator: the same calls from the same seed, every
parameter inside its specification's range, every grid point once a
round, and warm-up covering every shape."""

import itertools

from benchmark import calls


def first(mix, seed, k):
    return list(itertools.islice(calls.stream(mix, seed), k))


def test_same_seed_same_calls_other_seed_other_order():
    mix = calls.load("q1_q6_stream")
    seed = 2**31 + 12345  # seeds may exceed 32 signed bits
    a, b = first(mix, seed, 400), first(mix, seed, 400)
    assert a == b
    c = first(mix, seed + 1, 400)
    assert c != a
    # the same work in another order: Q1's first round of deltas
    def round_of(got):
        return sorted([x.params["delta"] for x in got if x.op == "q1"][:61])
    assert round_of(a) == round_of(c) == list(range(60, 121))


def test_q1_q6_parameters_follow_qgen():
    got = first(calls.load("q1_q6_stream"), 7, 2 * 400)
    assert [x.op for x in got[:4]] == ["q1", "q6", "q1", "q6"]
    for x in got:
        if x.op == "q1":
            assert 60 <= x.params["delta"] <= 120
        else:
            assert 1993 <= x.params["year"] <= 1997
            assert 2 <= x.params["discount"] <= 9
            assert x.params["quantity"] in (24, 25)
    deltas = [x.params["delta"] for x in got if x.op == "q1"]
    assert sorted(deltas[:61]) == list(range(60, 121))  # one round


def test_q12_parameters_follow_qgen():
    modes = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
    got = first(calls.load("q12_stream"), 11, 300)
    for x in got:
        m1, m2 = x.params["shipmodes"]
        assert m1 in modes and m2 in modes and m1 != m2
        assert 1993 <= x.params["year"] <= 1997
    pairs = {(tuple(x.params["shipmodes"]), x.params["year"])
             for x in got[:105]}
    assert len(pairs) == 105  # 21 pairs x 5 years, each once a round


def test_sort_mixes():
    narrow = calls.load("narrow_keys")
    got = first(narrow, 3, 576 * 2)
    calls_of_round = {(x.params["input"], x.params["ascending"],
                       x.params["copy"]) for x in got[:576]}
    assert len(calls_of_round) == 576  # 48 shapes x 12 copies, once each
    for x in got:
        dtype, dist = x.params["input"].split(".")
        assert dtype in ("uint8", "int8", "int16", "uint16", "int32",
                         "uint32")
        if dtype not in ("uint8", "int8"):
            assert dist in ("Zero", "ZeroOne")
        assert 0 <= x.params["copy"] < 12
    u64 = first(calls.load("u64_pay_uniform"), 3, 36)
    assert {x.params["input"] for x in u64} == {"uint64.Uniform+uint64"}
    assert sorted(x.params["copy"] for x in u64) == list(range(36))


def test_warm_calls_cover_every_shape():
    narrow = calls.load("narrow_keys")
    shapes = {(c.params["input"], c.params["ascending"])
              for c in calls.warm_calls(narrow)}
    assert len(shapes) == 48
    q = calls.warm_calls(calls.load("q1_q6_stream"))
    assert sorted(c.op for c in q) == ["q1", "q1", "q6", "q6"]
    assert {c.params["delta"] for c in q if c.op == "q1"} == {60, 120}


def keeps(mix, seed, k, now=lambda i: True):
    keeper = calls.Keeper(mix, seed)
    return [keeper(c, now(c.index)) for c in first(mix, seed, k)]


def test_keeper_keeps_the_first_of_each_shape_and_at_most_max():
    narrow = dict(calls.load("narrow_keys"),
                  check={"share": 0.5, "max": 3})
    calls_ = first(narrow, 5, 2000)
    keep = keeps(narrow, 5, 2000)
    shapes = [calls.shape_of(narrow, c) for c in calls_]
    firsts = {shapes.index(s) for s in set(shapes)}
    assert len(firsts) == 48
    assert all(keep[i] for i in firsts)
    assert sum(keep) == 48 + 3
    assert keeps({"calls": narrow["calls"]}, 5, 10) == [True] * 10


def test_keeper_puts_off_what_falls_in_the_trace():
    mix = dict(calls.load("narrow_keys"), check={"share": 0.01, "max": 8})
    traced = 1000  # the first 1000 calls are profiled
    keep = keeps(mix, 9, 3000, now=lambda i: i >= traced)
    assert not any(keep[:traced])
    shapes = {calls.shape_of(mix, c)
              for c, k in zip(first(mix, 9, 3000), keep) if k}
    assert len(shapes) == 48  # every shape still kept once after the trace
    assert sum(keep) > 48  # and the draws put off
