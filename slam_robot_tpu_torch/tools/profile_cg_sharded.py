"""Sharded large-map CG: validation of the sharded solve and a per-card
projection.

Port of the JAX package's ``tools/profile_cg_sharded.py``.
``ba_cg.solve_sharded`` splits the observation table in D row blocks
(``ops/obs_shards.ObsShards``) and adds the blocks' [P,4] landmark sums
and [W,6] reduced camera system through the shards' seam. The tool does
two things:

1. VALIDATE the sharded solve with 1, 2, 4 and 8 shards, all on one
   device, against the one-shard solve (``ba_cg.solve``): cost and
   trajectory agreement. The shards share one device, so their wall times
   are not a scaling figure, and none is reported.
2. PROJECT GN iters/s per card for D cards from a rate measured in this
   run: ``ba_cg.solve`` at ``bench_suite`` config 5 (10k frames, 500k
   points, 1M observations; ``--small``: its CI shape), or ``--measured``.
   Per GN iteration the solve streams the observation table once to
   assemble and twice per CG product; sharding cuts that stream 1/D a card
   while each CG product adds one [P,4] sum across cards, and each GN
   iteration one [P,4,4] and one [W,6,6]. An observation row's bytes are
   the element sizes of the shard table's columns
   (``obs_frame``, ``obs_point``, ``obs_px``, ``obs_ok``).

    python -m slam_robot_tpu_torch.tools.profile_cg_sharded [--small] [--measured X]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no result line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops import ba_cg
from slam_robot_tpu_torch.ops.obs_shards import ObsShards
from slam_robot_tpu_torch.parallel import mesh as mesh_mod
from slam_robot_tpu_torch.tools import profile_cg, profiling
from slam_robot_tpu_torch.utils import synthetic

NOTE = ("the shards share one device, so their wall times are not a scaling figure "
        "and none is reported")


def problem(small: bool, dev: torch.device) -> tuple:
    """The validation problem (64 / 2000 / 40 with ``small``, else 256 /
    8000 / 60 frames, points, observations a frame), in ``ba_cg.solve``'s
    argument order."""
    nf, npts, opf = (64, 2000, 40) if small else (256, 8000, 60)
    prob = synthetic.build_large_problem(nf, npts, obs_per_frame=opf, device=dev)
    return tuple(prob[k] for k in profile_cg.KEYS)


def validate(solve_args: tuple, cgc: ba_cg.CGConfig, dev: torch.device, shards,
             emit=print) -> list:
    """One row per shard count: the sharded solve (all shards on ``dev``)
    against ``ba_cg.solve``."""
    ref = ba_cg.solve(*solve_args, cgc)
    ref_cost = float(ref.cost)
    ref_trans = ref.frame_trans.cpu().numpy()
    rows = []
    for d in shards:
        msh = mesh_mod.make_mesh({"model": d}, devices=[dev] * d)
        res = ba_cg.solve_sharded(msh, *solve_args, cfg=cgc)
        cost = float(res.cost)
        dtr = float(np.max(np.abs(res.frame_trans.cpu().numpy() - ref_trans)))
        rows.append({
            "devices": d,
            "cost": round(cost, 4),
            "cost_rel_err": round(abs(cost - ref_cost) / max(ref_cost, 1e-9), 8),
            "trans_max_diff_mm": round(dtr, 5),
            "ok": bool(res.ok),
        })
        emit(json.dumps(rows[-1]))
    return rows


def obs_row_bytes(solve_args: tuple) -> int:
    """Bytes of one row of the shard table that ``ba_cg`` streams."""
    table = ObsShards.whole(*solve_args[6:10]).tables[0]
    return sum(t.element_size() * t[0].numel() for t in table.values())


def projection(rate: float, row_b: int, O: int, P: int, W: int, cg_iters: int) -> tuple:
    """(basis, rows) of GN iters/s per card for D cards from the one-card
    ``rate``."""
    passes_per_gn = 1 + 2 * cg_iters     # assembly + 2 streams per CG product
    stream_b = O * row_b * passes_per_gn
    psum_b = cg_iters * P * 4 * 4 + P * 16 * 4 + W * 36 * 4  # products' u + blocks
    proj = []
    for d in (2, 4, 8, 16, 64):
        per_dev = stream_b / d
        # the summed tensors are small next to the stream until stream/D
        # approaches them
        eff = per_dev / (per_dev + psum_b)
        proj.append({"devices": d,
                     "projected_gn_iters_per_s": round(rate * d * eff, 2),
                     "per_device_stream_MB_per_gn": round(per_dev / 1e6, 1),
                     "psum_MB_per_gn": round(psum_b / 1e6, 1)})
    basis = {"measured_single_chip_gn_iters_per_s": round(rate, 4),
             "bound": "the observation table's stream, at the rate ba_cg.solve measured "
                      "in this run",
             "obs_row_bytes": row_b, "passes_per_gn": passes_per_gn}
    return basis, proj


def run(dev: torch.device, shards=(1, 2, 4, 8), small: bool = False,
        measured: float | None = None, big: tuple | None = None, emit=print) -> dict:
    """The validation over ``shards`` and the projection. Its basis is
    ``measured`` GN iters/s, else ``ba_cg.solve`` timed here on ``big``
    (config 5's problem, ``profile_cg.problem``; built here unless given).
    Emits each validation row, then the result as one JSON object, and
    returns it."""
    solve_args = problem(small, dev)
    cgc = ba_cg.CGConfig(max_free_frames=solve_args[0].shape[0], gn_iters=3, cg_iters=12,
                         precond="diag")
    rows = validate(solve_args, cgc, dev, shards, emit)

    # the projection's basis: config 5 (5 GN x 20 CG, diag) on this device
    big = big if big is not None else profile_cg.problem(small, dev)
    big_cfg = ba_cg.CGConfig(max_free_frames=big[0].shape[0], gn_iters=5, cg_iters=20,
                             precond="diag")
    rate = measured if measured is not None else profile_cg.solve_rate(big, big_cfg, dev)[2]
    basis, proj = projection(rate, obs_row_bytes(big), big[6].shape[0], big[4].shape[0],
                             big[0].shape[0], big_cfg.cg_iters)
    out = {"validation": rows, "projection_basis": basis, "projection": proj, "note": NOTE}
    emit(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="CI-sized problems")
    ap.add_argument("--devices", default="1,2,4,8", help="shard counts to validate")
    ap.add_argument("--measured", type=float, default=None,
                    help="one-card GN iters/s at config 5 (default: measured in this run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    a = ap.parse_args(argv)
    dev = profiling.open_device(a.device, "profile_cg_sharded")
    if dev is None:
        return 1
    print(f"device: {profiling.device_line(dev)}", flush=True)
    run(dev, [int(x) for x in a.devices.split(",")], a.small, a.measured,
        emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
