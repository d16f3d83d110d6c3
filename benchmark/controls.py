"""The controls: the reference put in the program's place at the next lower
precision, which the comparison has to find not correct.

  * sorts: keys ordered by the upper half of their bits only (a 32-bit sort
    of 64-bit keys, 4 bits of 8-bit keys), stably, payloads beside them;
  * Q1 and Q6: the aggregates in float32, the precision below the
    configuration's float64;
  * Q12 (integers only): the join on float32 copies of the 64-bit order
    keys, the precision a 32-bit key column would give.

Each is plain torch, on the card, and answers in the program's layout.
Run them, or the program, over several seeds in one process:

    python3 -m benchmark.controls --workload <name> --seeds 1,2,3 --seconds 5 [--program]

One JSON line a seed: the seed, correct, and the numbers compared.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _value_order(keys: torch.Tensor) -> torch.Tensor:
    """int64 numbers whose order is the keys' order (integer keys)."""
    w = keys.element_size()
    s = keys.view(SIGNED[w]).to(torch.int64)
    if not keys.dtype.is_signed:
        s = s ^ -(1 << 63) if w == 8 else s & ((1 << (8 * w)) - 1)
    return s


def sort_control(state, params, ctx):
    inp = state.inputs[_file("configs", "sort_thesis").input_key(params)]
    keys = inp.keys
    top = _value_order(keys) >> (4 * keys.element_size())
    if not params.get("ascending", True):
        top = -top
    order = torch.argsort(top, stable=True)
    out = tuple(t.view(SIGNED[t.element_size()]).index_select(0, order)
                .view(t.dtype) for t in (keys, *inp.payloads))
    n = keys.numel()
    facts = {"rows": n, "sort": [{"n": n, "row_bytes": sum(
        t.element_size() for t in (keys, *inp.payloads))}]}
    return (out if inp.payloads else out[0]), facts


def _file(kind: str, config: str = "tpch_sf30"):
    from benchmark import harness
    return harness.load_file_module(kind, config)


def _groups_f32(key, mask, cols, n_keys):
    """Per present group key: (count, float32 sums of each column)."""
    found = []
    for g in range(n_keys):
        mg = mask & (key == g)
        cnt = int(mg.sum())
        if cnt:
            found.append((g, cnt, [c[mg].sum() for c in cols]))
    return found


def _layout(found, dev, key_dtype):
    """(num_groups, keys, results) as the port's group_aggregate gives
    them."""
    g = torch.tensor([f[0] for f in found], dtype=key_dtype, device=dev)
    ng = torch.tensor(len(found), dtype=torch.int32, device=dev)
    k = len(found[0][2]) if found else 0
    sums = tuple(torch.stack([f[2][j] for f in found]).double()
                 for j in range(k))
    return ng, g, sums


def q1_control(state, p, ctx):
    t = state.t
    mask = t["l_shipdate"] <= _file("configs").Q1_BASE - p["delta"]
    key = t["l_returnflag"].to(torch.int64) * 2 + t["l_linestatus"]
    qty, price, disc, tax = (t[c].float() for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp = price * (1 - disc)
    ch = dp * (1 + tax)
    found = _groups_f32(key, mask, (qty, price, dp, ch, disc), 6)
    ng, g, (s_qty, s_price, s_dp, s_ch, s_disc) = _layout(
        found, key.device, torch.int8)
    cnt = torch.tensor([f[1] for f in found], dtype=torch.int32,
                       device=key.device)
    c32 = cnt.float()
    means = tuple((s.float() / c32).double() for s in (s_qty, s_price,
                                                       s_disc))
    out = (ng, g, ((s_qty, s_price, s_dp, s_ch), means, cnt))
    return out, {"rows": state.n}


def q6_control(state, p, ctx):
    conf = _file("configs")
    t = state.t
    d = p["discount"]
    price, disc = t["l_extendedprice"].float(), t["l_discount"].float()
    mask = ((t["l_shipdate"] >= conf.day(p["year"]))
            & (t["l_shipdate"] < conf.day(p["year"] + 1))
            & (t["l_discount"] > (d - 1.5) / 100)
            & (t["l_discount"] < (d + 1.5) / 100)
            & (t["l_quantity"] < p["quantity"]))
    return (price[mask] * disc[mask]).sum().double(), {"rows": state.n}


def q12_control(state, p, ctx):
    conf, ref = _file("configs"), _file("reference")
    t = state.t
    if "control_table" not in state.cache:
        state.cache["control_table"] = ref.priority_by_key(t)
    table = state.cache["control_table"]
    m1, m2 = (conf.SHIPMODES.index(m) for m in p["shipmodes"])
    mode, rec, com = t["l_shipmode"], t["l_receiptdate"], t["l_commitdate"]
    mask = (((mode == m1) | (mode == m2)) & (com < rec)
            & (t["l_shipdate"] < com) & (rec >= conf.day(p["year"]))
            & (rec < conf.day(p["year"] + 1)))
    key = t["l_orderkey"][mask].float().to(torch.int64)  # 32-bit keys
    ok = (key >= 0) & (key < table.numel())
    pr = torch.where(ok, table[key.clamp(0, table.numel() - 1)], -1)
    mo = mode[mask].to(torch.int64)
    high = torch.bincount(mo[(pr >= 0) & (pr <= 1)], minlength=7)
    low = torch.bincount(mo[pr >= 2], minlength=7)
    present = [m for m in range(7) if int(high[m]) + int(low[m]) > 0]
    ng = torch.tensor(len(present), dtype=torch.int32, device=key.device)
    g = torch.tensor(present, dtype=torch.int8, device=key.device)
    idx = torch.tensor(present, dtype=torch.int64, device=key.device)
    return (ng, g, ((high[idx], low[idx]),)), {"rows": state.n}


CONTROLS = {"sort_thesis": {"sort": sort_control},
            "tpch_sf30": {"q1": q1_control, "q6": q6_control,
                          "q12": q12_control}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", action="store_true",
                    help="run the program instead of the control")
    args = ap.parse_args(argv)

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = harness.load_benchmark()
    _, cfg_entry = harness.cell_of(bench, args.workload)
    ops = None if args.program else CONTROLS[cfg_entry["name"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(
            args.workload, seed, args.seconds, False, device,
            time.perf_counter(), bench=bench, ops=ops)
        print(json.dumps({"seed": seed, "impl": "program" if ops is None
                          else "control", "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"], "checks": checks}),
              flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
