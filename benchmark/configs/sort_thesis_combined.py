"""The `sort_thesis_combined` configuration: the reference library's
combined layout, 64-byte rows of a uint64 key and seven uint64 fields.

jonicho/simd-radix-sort sorts the payload shape u64 x 7 in its Separate
and its Combined layout (`src/test.cpp:100-153`); in the Combined one each
row is one `DataElement<uint64, uint64 x 7>` (`src/data.hpp:25-53`), a
64-byte record.  Here a table is an (n, 64) uint8 matrix on the card, the
key's bytes first, then field 0 to 6, each little-endian, as the port's
`pack_rows` lays rows out.  Keys are made as `sort_thesis` makes them, and
field j of a row is `sort_thesis`'s payload stream j of its key, so equal
keys carry equal rows and an unstable sort has one right answer.

An input is named as in `sort_thesis` (`uint64.Uniform+uint64+...`, one
`+uint64` a field); a mix keeps several tables of one name resident
(parameter `"copy"`), as a row store holds its partitions and sorts one
after another.  The one operation, "sort_packed", calls the port's public
`sort_packed()` with the default `method="auto"`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

import simd_radix_sort_tpu_torch as srs
from benchmark import calls, harness

thesis = harness.load_file_module("configs", "sort_thesis")

SPANS = ("sort",)


@dataclasses.dataclass
class State:
    tables: dict                  # (name, copy) -> (n, row_bytes) uint8
    key: np.dtype                 # the key's dtype, in each row's first bytes


def make_rows(cfg: dict, name: str, n: int, seed: int, device):
    """n rows of input `name` as an (n, row_bytes) uint8 matrix: the keys
    drawn by `sort_thesis.make_keys`, then each field of its key."""
    dtype, dist, fields = thesis.parse_input(name)
    want = [getattr(torch, f) for f in cfg["fields"]]
    if dtype != getattr(torch, cfg["key"]) or fields != want:
        raise ValueError(f"{name}: the configuration's rows are a "
                         f"{cfg['key']} key and fields {cfg['fields']}")
    keys = thesis.make_keys(dtype, dist, n, seed, device)
    words = torch.empty((n, 1 + len(fields)), dtype=torch.int64,
                        device=device)
    words[:, 0] = keys.view(torch.int64)
    for j in range(len(fields)):
        words[:, 1 + j] = thesis.payload(keys, j).view(torch.int64)
    rows = words.view(torch.uint8)
    if rows.shape[1] != int(cfg["row_bytes"]):
        raise ValueError(f"{name}: {rows.shape[1]}-byte rows, not "
                         f"{cfg['row_bytes']}")
    return rows


def setup(cfg: dict, mix: dict, seed: int, ctx) -> State:
    n = int(cfg["rows_per_call"])
    wanted = sorted({thesis.input_key(p) for t in mix["calls"]
                     for p in calls.grid(t.get("params", {}))})
    tables = {}
    for name, copy in wanted:  # one table at a time: little beside them
        tables[name, copy] = make_rows(
            cfg, name, n, calls.derive(seed, "keys", name, copy), ctx.device)
    return State(tables, np.dtype(cfg["key"]))


def sort_packed_op(state: State, params: dict, ctx):
    rows = state.tables[thesis.input_key(params)]
    with ctx.span("sort"):
        out = srs.sort_packed(rows, state.key,
                              ascending=params.get("ascending", True),
                              device=ctx.device)
    n, e = rows.shape
    return out, {"rows": n, "sort": [{"n": n, "row_bytes": e}],
                 "packed": [{"n": n, "row_bytes": e,
                             "key_bytes": state.key.itemsize}]}


OPS = {"sort_packed": sort_packed_op}


def packed_control(state: State, params: dict, ctx):
    """The control: the rows ordered by the upper half of their keys' bits
    only (a 32-bit sort of 64-bit keys), stably, every byte beside its key;
    plain torch, which the comparison has to find not correct.  Run it in
    the program's place with `harness.run_cell(..., ops=CONTROL)`."""
    rows = state.tables[thesis.input_key(params)]
    keys = rows.view(torch.int64)[:, 0]
    if state.key.kind == "u":  # unsigned: the order of the flipped sign
        keys = keys ^ -(1 << 63)
    top = keys >> 32
    if not params.get("ascending", True):
        top = -top
    out = rows.index_select(0, torch.argsort(top, stable=True))
    n, e = rows.shape
    return out, {"rows": n, "sort": [{"n": n, "row_bytes": e}]}


CONTROL = {"sort_packed": packed_control}


def capture(state: State, call, out):
    return out.cpu().numpy()


def _input_keys(state: State, key: tuple) -> np.ndarray:
    """The resident table's keys on the host, in the key's dtype."""
    rows = state.tables[key]
    col = rows.view(torch.int64)[:, 0].contiguous()
    return col.cpu().numpy().view(state.key)


BLOCK = 1 << 18  # rows a comparison task holds: 16 MiB of an answer's rows


def _block_differs(answers: list, ordered: np.ndarray, lo: int, hi: int,
                   ref) -> list:
    """For each answer of one table (its words in the order of the sorted
    keys: reversed where it is descending), (the keys that differ, the
    rows that differ) among rows lo to hi of the reference's sorted table,
    worked out a column at a time while the block stays in the cache."""
    keys = ordered[lo:hi]
    bad = [np.zeros(keys.size, dtype=bool) for _ in answers]
    bad_keys = [0] * len(answers)
    for c in range(answers[0].shape[1]):
        want = ref.column(keys, c).view(np.uint64)
        for i, words in enumerate(answers):
            differ = words[lo:hi, c] != want
            if c == 0:
                bad_keys[i] = int(np.count_nonzero(differ))
            bad[i] |= differ
    return [(k, int(np.count_nonzero(b))) for k, b in zip(bad_keys, bad)]


def compare(state: State, kept, ref, ctx, cfg: dict):
    """Every kept answer against the reference's sort of the same table:
    the keys that differ from the sorted keys, and the rows whose bytes
    differ anywhere (every row where the shapes differ).  The reference
    sorts each table's keys once, ascending, and works out the sorted table
    a block of rows and a column at a time; a descending answer is held to
    that order reversed.  The tables' sorts, then every (table, block), run
    in parallel threads (NumPy's sorts and ufuncs release the GIL).
    Returns (checks, the answers that differ)."""
    by_input, bad_keys, bad_rows, wrong = {}, 0, 0, 0
    for rec in kept:
        got, rec.answer = ref.row_words(rec.answer), None
        table = state.tables[thesis.input_key(rec.call.params)]
        if got is None or got.shape != (table.shape[0], table.shape[1] // 8):
            bad_keys, bad_rows, wrong = (bad_keys + table.shape[0],
                                         bad_rows + table.shape[0], wrong + 1)
            continue
        ascending = rec.call.params.get("ascending", True)
        by_input.setdefault(thesis.input_key(rec.call.params), []).append(
            got if ascending else got[::-1])
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        ordered = dict(zip(by_input, pool.map(
            lambda key: ref.sort_keys(_input_keys(state, key)), by_input)))
        tasks = [(key, lo) for key in by_input
                 for lo in range(0, ordered[key].size, BLOCK)]
        found = list(pool.map(
            lambda t: _block_differs(by_input[t[0]], ordered[t[0]], t[1],
                                     t[1] + BLOCK, ref), tasks))
    per_answer = {}
    for (key, _), counts in zip(tasks, found):
        for i, (k, r) in enumerate(counts):
            keys_rows = per_answer.setdefault((key, i), [0, 0])
            keys_rows[0] += k
            keys_rows[1] += r
    for k, r in per_answer.values():
        bad_keys, bad_rows, wrong = bad_keys + k, bad_rows + r, wrong + bool(r)
    limits = cfg["limits"]
    checks = {"keys_differing": {"value": bad_keys,
                                 "limit": limits["keys_differing"]},
              "rows_differing": {"value": bad_rows,
                                 "limit": limits["rows_differing"]}}
    return checks, wrong
