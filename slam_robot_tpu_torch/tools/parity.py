"""Trajectory parity: replay the JAX package's four frozen sequences
through the port's SLAM step and gate them against its golden trajectories.

Port of ``tools/parity.py``. The sequences, their configurations and the
gates are the original's; the goldens in ``tests/fixtures/`` are the JAX
package's trajectories (its own float order on XLA:CPU) and are only read
here, never written. Per sequence (and per seed of production_defaults):

- drift against the golden of at most max(1.5 mm, 1 % of path);
- the truth-ATE cap (``truth_pct`` % of path); unlike the original's
  single-sequence report, whose ``ok`` leaves this gate to its test, the
  cap is part of ``ok`` here;
- the median enabled reprojection error at most the golden's + 0.1 px;
- for production_defaults, the 3-seed median truth ATE at most 1.6 %.

Each report also holds what the replay cost: wall time, the median step,
and the kernel launches it made (counted only where a kernel runs, on the
card).

    python -m slam_robot_tpu_torch.tools.parity [--seq a,b] [--out F] [--device cuda|cpu]

prints one JSON report per sequence and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from slam_robot_tpu_torch.config import REFERENCE_EXACT_KW, SlamConfig
from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.io import sources
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.ops import tracker_fused
from slam_robot_tpu_torch.ops.cuda import blur as blur_kernels
from slam_robot_tpu_torch.ops.cuda import newton as newton_kernels
from slam_robot_tpu_torch.utils import dump as dump_util

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"

# tools/parity.py:60-120, held equal to it by tests/test_torch_parity.py
_SMALL = dict(
    image_width=320, image_height=240, pyramid_depth=5, levels_unsure=5,
    max_features=192, max_corners=96, min_matches=20,
    max_points=512, max_obs=8192, max_obs_per_point=16,
)

SEQUENCES = {
    "forward_yaw": dict(
        seq=dict(n_frames=24, seed=7, n_points=700, step_mm=15.0, yaw_rate=0.004),
        cfg=dict(_SMALL, max_frames=32, **REFERENCE_EXACT_KW),
        golden="golden_trajectory.json",
        truth_pct=1.0,
    ),
    "rotation_heavy": dict(
        # production resolution, ~0.57 deg of yaw a frame pair
        seq=dict(n_frames=40, seed=11, n_points=1400, step_mm=4.0, yaw_rate=0.02),
        cfg=dict(max_frames=64, **REFERENCE_EXACT_KW),
        golden="golden_rotation.json",
        truth_pct=2.5,
    ),
    "long_forward": dict(
        seq=dict(n_frames=100, seed=3, n_points=900, step_mm=12.0, yaw_rate=0.006),
        cfg=dict(_SMALL, max_frames=128, **REFERENCE_EXACT_KW),
        golden="golden_long.json",
        truth_pct=1.0,
    ),
    "production_defaults": dict(
        # rotation_heavy's scene family under the shipped defaults, three
        # texture draws: per-seed drift and cap, and the median's bar
        seq=dict(n_frames=40, seed=11, n_points=1400, step_mm=4.0, yaw_rate=0.02),
        seeds=[11, 12, 13],
        cfg=dict(max_frames=64),
        golden="golden_production.json",
        truth_pct=2.8,
        truth_pct_median=1.6,
    ),
}


def _launches() -> dict:
    return {"pyramid_flat": blur_kernels.PYRAMID.launches,
            "newton_track": newton_kernels.KERNEL.launches,
            "sep5_reflect101": blur_kernels.KERNEL.launches,
            "sweeps": tracker_fused.SWEEPS.n}


def run_sequence(name: str = "forward_yaw", seed: int | None = None, device=None):
    """Replay one sequence through ``pipeline.step`` and ``maybe_polish`` on
    ``device`` (default: the CUDA card). Returns (est [N,3], true [N,3],
    stats)."""
    dev = default_device(device)
    spec = SEQUENCES[name]
    seq_kw = dict(spec["seq"])
    if seed is not None:
        seq_kw["seed"] = seed
    cfg = SlamConfig(**spec["cfg"])
    src = sources.SyntheticSource(cfg, device=dev, **seq_kw)
    frames = [src.get(i % 2, i) for i in range(seq_kw["n_frames"])]
    ps = pipeline.init(cfg, [src.k.cpu().numpy()] * 2, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    launches0 = _launches()
    step_ms = []
    t_run = time.perf_counter()
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        ps, _ = pipeline.step(ps, torch.as_tensor(img, device=dev), cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        sync()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    wall_s = time.perf_counter() - t_run
    est = dump_util.trajectory(ps.map)
    true = src.true_trans.cpu().numpy()

    m = ps.map
    no = int(m.n_obs)
    errn = np.linalg.norm(m.obs_err[:no].cpu().numpy(), axis=1)
    dis = m.obs_disabled[:no].cpu().numpy()
    stats = {
        "median_enabled_err_px": (
            round(float(np.median(errn[~dis])), 4) if (~dis).any() else 0.0),
        "n_obs": no,
        "n_points": int(m.n_points),
        "finite": bool(np.isfinite(est).all()),
        "wall_s": wall_s,
        "median_step_ms": statistics.median(step_ms),
        "launches": {k: v - launches0[k] for k, v in _launches().items()},
    }
    return est, true, stats


def gate_mm(path_mm: float) -> float:
    """Drift gate: 1% of path, floored at 1.5 mm for very short paths."""
    return max(1.5, 0.01 * path_mm)


def _golden(spec) -> dict:
    with open(FIXTURES / spec["golden"]) as f:
        golden = json.load(f)
    assert golden["sequence"] == spec["seq"], f"{spec['golden']}: fixture mismatch"
    return golden


def _gates(spec, est, true, gold, golden_median, stats) -> dict:
    """One draw's figures against its golden trajectory and the caps."""
    path = float(np.linalg.norm(true[-1] - true[0]))
    ate_g = dump_util.ate(est, gold)
    ate_t = dump_util.ate(est, true)
    g = gate_mm(path)
    pct = 100.0 * ate_t / path
    rep = {
        "ate_vs_golden_mm": round(ate_g, 3),
        "ate_vs_ground_truth_mm": round(ate_t, 3),
        "ate_pct_of_path": round(pct, 3),
        "path_mm": round(path, 1),
        "gate_mm": round(g, 2),
        "truth_gate_pct": spec["truth_pct"],
        "median_enabled_err_px": stats["median_enabled_err_px"],
        "golden_median_px": golden_median,
        "drift_ok": bool(ate_g <= g),
        "cap_ok": bool(pct <= spec["truth_pct"]),
        "median_ok": bool(golden_median is None
                          or stats["median_enabled_err_px"] <= golden_median + 0.1),
        **{k: stats[k] for k in ("finite", "n_obs", "n_points", "wall_s", "median_step_ms",
                                 "launches")},
    }
    rep["ok"] = all(rep[k] for k in ("drift_ok", "cap_ok", "median_ok", "finite"))
    return rep


def compare(name: str, est, true, stats) -> dict:
    """A single-seed sequence's report against its golden."""
    spec = SEQUENCES[name]
    golden = _golden(spec)
    gold = np.asarray(golden["trajectory"], np.float32)
    return {"sequence": name, **_gates(spec, est, true, gold,
                                       golden.get("median_enabled_err_px"), stats),
            "golden_commit": golden.get("commit", "unrecorded")}


def evaluate(name: str, device=None) -> dict:
    """Replay and gate one sequence; a multi-seed one draw by draw, each
    against its own golden, plus the median truth ATE's bar."""
    spec = SEQUENCES[name]
    seeds = spec.get("seeds")
    if not seeds:
        return compare(name, *run_sequence(name, device=device))

    golden = _golden(spec)
    assert golden.get("seeds") == seeds, f"{name}: fixture seed-set mismatch"
    per = []
    for sd in seeds:
        est, true, stats = run_sequence(name, seed=sd, device=device)
        g = golden["per_seed"][str(sd)]
        per.append({"seed": sd, **_gates(spec, est, true, np.asarray(g["trajectory"], np.float32),
                                         g.get("median_enabled_err_px"), stats)})
    med = float(np.median([r["ate_pct_of_path"] for r in per]))
    return {
        "sequence": name,
        "seeds": seeds,
        "per_seed": per,
        "median_truth_pct": round(med, 3),
        "median_gate_pct": spec["truth_pct_median"],
        "per_seed_cap_pct": spec["truth_pct"],
        "golden_commit": golden.get("commit", "unrecorded"),
        "ok": bool(all(r["ok"] for r in per) and med <= spec["truth_pct_median"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", default="", help="comma-separated sequence names (default: all)")
    ap.add_argument("--out", default="", help="write the JSON report")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    names = args.seq.split(",") if args.seq else list(SEQUENCES)
    reports = []
    for name in names:
        rep = evaluate(name, device=args.device)
        reports.append(rep)
        print(json.dumps(rep), flush=True)
    report = {"sequences": reports, "ok": all(r["ok"] for r in reports)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
