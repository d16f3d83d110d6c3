"""The one traffic generator: a mix's parameters -> the calls of a run.

A mix is `traffic/<mix>.json`:

    {"calls": [{"op": "<operation>", "params": {"<name>": <spec>, ...}}, ...],
     "check": {"share": <0..1>, "max": <calls>},
     "trace_seconds": <seconds>}

A template may name the parameters that change the shape of the work
(`"shape": [...]`, default all of them): warm-up runs each shape with the
first and the last value of every other parameter.

A parameter spec is a value, {"int": [lo, hi]} (every integer from lo to
hi), {"choice": [v, ...]}, or {"subsets": [k, [v, ...]]} (every k-subset of
the values, as a sorted list).  Each call template runs its parameters'
whole grid in rounds, each round in an order drawn from the seed, so every
seed does the same work in another order.  The templates take turns in the
order listed (Q1, Q6, Q1, ...).  `check` says which calls keep their answer
for the comparison with the reference: the first of each shape always,
every other call with probability `share`, at most `max` of those.
`trace_seconds` is how long a traced run profiles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Call:
    index: int
    op: str
    params: dict

    def key(self) -> tuple:
        """The call's operation and parameters, hashable."""
        return (self.op, json.dumps(self.params, sort_keys=True))


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (a column, the call
    order), so that each use draws its own numbers whatever else is made."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def load(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def values(spec) -> list:
    """Every value a parameter spec allows, in a fixed order."""
    if not isinstance(spec, dict):
        return [spec]
    (kind, arg), = spec.items()
    if kind == "int":
        lo, hi = arg
        return list(range(int(lo), int(hi) + 1))
    if kind == "choice":
        return list(arg)
    if kind == "subsets":
        k, pool = arg
        return [sorted(c) for c in itertools.combinations(pool, int(k))]
    raise ValueError(f"unknown parameter spec {spec!r}")


def grid(params: dict) -> list[dict]:
    """The cartesian product of a template's parameter values."""
    names = sorted(params)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(values(params[n])
                                             for n in names))]


def stream(mix: dict, seed: int):
    """The calls of a run, without end."""
    rng = np.random.default_rng(derive(seed, "calls"))
    templates = mix["calls"]
    grids = [grid(t.get("params", {})) for t in templates]
    decks = [[] for _ in templates]
    for index in itertools.count():
        j = index % len(templates)
        if not decks[j]:
            decks[j] = [grids[j][i] for i in rng.permutation(len(grids[j]))]
        yield Call(index, templates[j]["op"], decks[j].pop())


def warm_calls(mix: dict) -> list[Call]:
    """Calls that run every shape the mix can send: each shape with the
    first and the last value of the parameters that do not set it."""
    out = []
    for t in mix["calls"]:
        params = t.get("params", {})
        shape = t.get("shape", sorted(params))
        fixed = {n: params[n] for n in shape}
        rest = [n for n in params if n not in shape]
        for p in grid(fixed):
            for end in (0, -1):
                q = dict(p, **{n: values(params[n])[end] for n in rest})
                out.append(Call(-1, t["op"], q))
    return out


def shape_of(mix: dict, call: Call) -> tuple:
    """The call's operation and the parameters that set its shape."""
    for t in mix["calls"]:
        if t["op"] == call.op:
            names = t.get("shape", sorted(t.get("params", {})))
            return (call.op, json.dumps({n: call.params[n] for n in names},
                                        sort_keys=True))
    raise KeyError(f"no template for operation {call.op!r}")


class Keeper:
    """Which calls keep their answer for the comparison: the first of each
    shape, and every other call with probability `share`, at most `max` of
    those, drawn from the seed."""

    def __init__(self, mix: dict, seed: int):
        spec = mix.get("check", {})
        self.mix = mix
        self.share = float(spec.get("share", 1.0))
        self.most = int(spec.get("max", 1 << 62))
        self.rng = np.random.default_rng(derive(seed, "check"))
        self.seen = set()   # shapes with an answer kept
        self.owed = 0       # drawn while keeping was put off
        self.drawn = 0

    def __call__(self, call: Call, now: bool = True) -> bool:
        """Whether to keep this call's answer.  While `now` is false (a
        traced stretch) nothing is kept; what would have been is kept at
        the first calls after it: the first of each shape still unseen,
        and one more call for each draw put off."""
        draw = bool(self.rng.random() < self.share)
        if not now:
            self.owed += draw
            return False
        shape = shape_of(self.mix, call)
        if shape not in self.seen:
            self.seen.add(shape)
            return True
        if (draw or self.owed) and self.drawn < self.most:
            self.owed -= not draw
            self.drawn += 1
            return True
        return False
