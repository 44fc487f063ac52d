"""Stored-vs-fresh observation-error audit on the bench workload.

Port of the JAX package's ``tools/probe_errfresh.py``. The map's stored
``obs_err`` rows are refreshed only by the windowed reproject, while the
polish and the slow and xslow solves move older frames and points, so rows
outside every recent window keep errors measured against geometry that has
since moved. This probe replays the bench's warm and one scan pass
(``bench.bootstrap`` and ``bench.run_scan``, all 96 warm steps with their
polish), recomputes every observation row's error against the final
geometry, and prints stored and fresh quantiles of the enabled rows, of the
enabled rows of slam-usable points, and the frames that own the stale rows,
as one JSON line with the original's keys.

    python -m slam_robot_tpu_torch.tools.probe_errfresh [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.ops import projection as proj


def fresh_err(m: lm.MapState, cfg: SlamConfig):
    """Every observation row projected against the map's current frames,
    cameras and points, batched over rows: (|projected - observed| px [O],
    cheirality validity [O])."""
    f = m.obs_frame.clamp(min=0).long()
    p = m.obs_point.clamp(min=0).long()
    k = m.cam_k[m.frame_cam[f].long()]
    px, valid = proj.project_point(m.frame_quat[f], m.frame_trans[f], k, m.point_loc[p],
                                   cfg.cheirality_eps)
    return torch.linalg.norm(px - m.obs_px, dim=-1), valid


def audit(m: lm.MapState, cfg: SlamConfig) -> dict:
    """The probe's JSON line for a final map."""
    fresh, valid = fresh_err(m, cfg)
    no = int(m.n_obs)
    fresh = fresh[:no].cpu().numpy()
    valid = valid[:no].cpu().numpy()
    stored = np.linalg.norm(m.obs_err[:no].cpu().numpy(), axis=1)
    dis = m.obs_disabled[:no].cpu().numpy()
    mask = m.obs_mask[:no].cpu().numpy()
    en = mask & ~dis & valid
    # obs of points no longer slam-usable stay "enabled" in the table but
    # feed no solve (localmap.slam_usable; localmap.cpp:328-356)
    pu = (lm.slam_usable(m.point_flags) & m.point_mask).cpu().numpy()
    op = m.obs_point[:no].cpu().numpy().clip(0)
    en_usable = en & pu[op]

    def q(a, p):
        return round(float(np.quantile(a, p)), 3) if a.size else 0.0

    def stats(a):
        return {"p50": q(a, 0.5), "p90": q(a, 0.9), "p99": q(a, 0.99),
                "mean": round(float(a.mean()), 3)}

    # which frames own the stale mass: rows whose stored and fresh errors differ
    stale = np.abs(stored - fresh) > 0.5
    of = m.obs_frame[:no].cpu().numpy()
    return {
        "n_obs": no,
        "n_enabled": int(en.sum()),
        "stored_enabled": stats(stored[en]),
        "fresh_enabled": stats(fresh[en]),
        "stale_rows_enabled": int((stale & en).sum()),
        "stale_frame_range": [int(of[stale & en].min()), int(of[stale & en].max())]
        if (stale & en).any() else [],
        "fresh_enabled_gt3px": int((fresh[en] > 3.0).sum()),
        "stored_enabled_gt3px": int((stored[en] > 3.0).sum()),
        "n_enabled_usable": int(en_usable.sum()),
        "fresh_usable": stats(fresh[en_usable]),
        "fresh_usable_gt3px": int((fresh[en_usable] > 3.0).sum()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    from slam_robot_tpu_torch import bench
    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.utils.benchscene import make_frames

    dev = default_device(args.device)
    cfg = SlamConfig()
    n_warm, n_timed = 96, 64
    frames = make_frames(cfg, n_warm + n_timed, device=dev)
    ps, _, _ = bench.bootstrap(cfg, frames, n_warm, dev, n_eager=0)
    ps2, _ = bench.run_scan(ps, torch.stack(frames[n_warm:]), cfg)
    print(json.dumps(audit(ps2.map, cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
