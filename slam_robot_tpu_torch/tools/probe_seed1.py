"""The per-frame match economy of one bench-scene seed.

Port of the JAX package's ``tools/probe_seed1.py``. Seed 1 of the bench
sweep is a hard texture draw (few matches a frame, keyframe storms); this
probe steps any seed's sweep (``step`` + ``maybe_polish``) and prints one
JSON row a frame: matches, keyframe, points added, map points, live
feature lanes, lanes with a stored view, lanes backed off after failing,
live points and the reprojection error; at a keyframe, also how many
corners the detector accepted on the frame and how many survived the
occupancy grid of the frame's matches. Then the final trajectory's error
by 16-frame segment, a gauge decomposition (a global scale fit, then a
rotation and scale fit about the origin) and a summary line.

The rotation fit's reflection sign is +1 or -1 (``dump.reflection_sign``):
the original's ``np.sign(det)`` would give 0 for a zero determinant.

    python -m slam_robot_tpu_torch.tools.probe_seed1 --seed 1 [--frames 160] [--device cpu]
    python -m slam_robot_tpu_torch.tools.probe_seed1 --seed 1 --set "min_matches=48"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import host
from slam_robot_tpu_torch.ops import corners
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.utils.dump import reflection_sign


def parse_set(cfg: SlamConfig, spec: str) -> SlamConfig:
    """``cfg`` with ``key=val[;key=val...]`` overrides (a tuple as ``AxB``)."""
    kv = {}
    for pair in filter(None, spec.split(";")):
        k, v = pair.split("=")
        ftype = type(getattr(cfg, k))
        if ftype is bool:
            kv[k] = v == "True"
        elif ftype is tuple:
            kv[k] = tuple(int(t) for t in v.split("x"))
        else:
            kv[k] = ftype(v)
    return dataclasses.replace(cfg, **kv)


def frame_row(i: int, ps, met: dict) -> dict:
    """Frame ``i``'s row after its step, read on the host in one sync."""
    ms = ps.matcher
    live = ms.feat_point >= 0
    has_view = ms.feat_valid.any(dim=1)
    vals = host(torch.stack([
        met["n_matches"].double(), met["is_keyframe"].double(), met["n_added"].double(),
        met["n_points"].double(), live.sum().double(), (live & has_view).sum().double(),
        (live & (ms.feat_fail > 0)).sum().double(), ps.map.point_mask.sum().double(),
        met["mean_reproj_err"].double()]))
    return {
        "f": i,
        "matches": int(vals[0]),
        "kf": bool(vals[1]),
        "added": int(vals[2]),
        "pts": int(vals[3]),
        "lanes_live": int(vals[4]),
        "lanes_viewed": int(vals[5]),
        "lanes_failing": int(vals[6]),
        "pts_live": int(vals[7]),
        "err": round(vals[8], 3),
    }


def corner_economy(img: torch.Tensor, met: dict, cfg: SlamConfig) -> dict:
    """The keyframe detector run again on ``img``: corners it accepts, and
    those left after suppression by the occupancy grid of the frame's
    matches."""
    g = pyr.build_pyramid(img, 1, cfg.blur_sigma0).data[0, pyr.PAD:-pyr.PAD, pyr.PAD:-pyr.PAD]
    cpts, cval = corners.detect(g, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    occ = corners.occupancy_grid(met["feat_px"], met["feat_matched"], cfg.image_width,
                                 cfg.image_height, cfg.suppress_grid)
    kept = corners.suppress_by_grid(cpts, cval, occ, cfg.image_width, cfg.image_height,
                                    cfg.suppress_grid)
    n_det, n_kept = host(torch.stack([cval.sum(), kept.sum()]))
    return {"corners_detected": int(n_det), "corners_after_grid": int(n_kept)}


def gauge(est_t: np.ndarray, true_t: np.ndarray) -> dict:
    """How much of the trajectory error is a global scale (weakly observable:
    only the 150 mm frame-distance prior pins it), a rotation, or residual
    shape: a scale-only fit, then rotation + scale (Kabsch about the origin,
    frame 0 being the anchor)."""
    perr = np.sqrt(((est_t - true_t) ** 2).sum(1))
    num = float((est_t * true_t).sum())
    den = float((est_t * est_t).sum())
    s_fit = num / max(den, 1e-9)
    perr_s = np.sqrt((((s_fit * est_t) - true_t) ** 2).sum(1))
    H = est_t.T @ true_t
    U, S, Vt = np.linalg.svd(H)
    d = reflection_sign(U, Vt)
    Rk = Vt.T @ np.diag([1, 1, d]) @ U.T
    sr = float((S * [1, 1, d]).sum()) / max(den, 1e-9)
    perr_rs = np.sqrt((((sr * (Rk @ est_t.T).T) - true_t) ** 2).sum(1))
    return {
        "scale_fit": round(s_fit, 4),
        "ate_mm_raw": round(float(perr.mean()), 2),
        "ate_mm_after_scale": round(float(perr_s.mean()), 2),
        "ate_mm_after_rot_scale": round(float(perr_rs.mean()), 2),
        "rot_angle_deg": round(float(np.degrees(np.arccos(
            np.clip((np.trace(Rk) - 1) / 2, -1, 1)))), 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--set", default="", help="key=val[;key=val...] overrides")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils import benchscene

    dev = default_device(args.device)
    cfg = parse_set(SlamConfig(), args.set)
    frames = benchscene.make_frames(cfg, args.frames, seed=args.seed, device=dev)
    ps = pipeline.init(cfg, device=dev)

    rows = []
    for i in range(args.frames):
        ps, met = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        row = frame_row(i, ps, met)
        if row["kf"]:
            row.update(corner_economy(frames[i], met, cfg))
        rows.append(row)
        print(json.dumps(row), flush=True)

    nf = int(ps.map.n_frames)
    true_t = np.stack([benchscene.sweep_pose(i)[1] for i in range(nf)])
    est_t = ps.map.frame_trans[:nf].cpu().numpy()
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    # where along the trajectory the final error lives (early segments
    # locked in by windowed BA against tail drift)
    perr = np.sqrt(((est_t - true_t) ** 2).sum(1))
    for lo in range(0, nf, 16):
        seg = perr[lo:lo + 16]
        print(json.dumps({"seg": [lo, min(lo + 16, nf)],
                          "mean_err_mm": round(float(seg.mean()), 2),
                          "max_err_mm": round(float(seg.max()), 2)}), flush=True)
    print(json.dumps({"gauge": gauge(est_t, true_t)}), flush=True)

    kfs = [r for r in rows if r["kf"]]
    tail = rows[96:]
    print(json.dumps({"summary": {
        "seed": args.seed,
        "ate_pct_of_path": round(100.0 * ate / max(path, 1e-9), 2),
        "keyframes_total": len(kfs),
        "keyframes_in_scan_window": sum(r["kf"] for r in tail),
        "mean_matches_scan": round(float(np.mean([r["matches"] for r in tail])), 1),
        "min_matches_cfg": cfg.min_matches,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
