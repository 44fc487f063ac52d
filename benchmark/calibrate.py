"""The two readings each correctness limit is set from, on the card.

    python -m benchmark.calibrate --workload <cell> --seeds 12 --control-seeds 3 [--first-seed N]

For each of ``--seeds`` seeds: the cell's tables, one solve by the program
as the window runs it, the float64 reference's solve, and the compared
numbers (``compare.check``). For each of ``--control-seeds`` seeds: the
control, the reference computed in float32 with TF32 inputs to its matrix
products (the precision below the configuration's float32 with TF32 off),
put in the program's place. One JSON line a seed, then the lower reading
(the largest over the program's seeds) and the upper (the smallest over the
control's) of each number. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, spec
from benchmark.reference import ba as reference
from benchmark.reference import geometry as geo

NO_LIMITS = {n: float("inf") for n in compare.NAMES}


def readings(cell: dict, seed: int, control: bool, device="cuda") -> dict:
    """The compared numbers of one seed: the program's solve, or the
    control's, against the float64 reference."""
    drv = spec.driver(cell).Driver(cell, seed, device)
    t0 = time.perf_counter()
    ref = reference.solve(drv.tables, drv.settings)
    ref_s = time.perf_counter() - t0
    if control:
        got = reference.solve(drv.tables, drv.settings, geo.Precision(torch.float32, tf32=True))
        answer, ok, cost = got, got["ok"], float(got["cost"])
    else:
        res, ok, cost = drv.solve()
        answer = res._asdict()
    checks, _ = compare.check(drv.tables, ref, [cost], [ok], {0: answer}, NO_LIMITS,
                              drv.settings["cheirality_eps"])
    return {"seed": seed, "side": "control" if control else "program", "reference_s": ref_s,
            **{k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    rows = []
    for i in range(a.seeds + a.control_seeds):
        r = readings(cell, a.first_seed + i, i >= a.seeds)
        print(json.dumps(r), flush=True)
        rows.append(r)
        torch.cuda.empty_cache()
    for name in compare.NAMES:
        prog = [r[name] for r in rows if r["side"] == "program"]
        ctl = [r[name] for r in rows if r["side"] == "control"]
        print(json.dumps({"number": name, "lower": max(prog, default=None),
                          "upper": min(ctl, default=None), "limit": cell["limits"][name]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
