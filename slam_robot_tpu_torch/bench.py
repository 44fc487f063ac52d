"""Headline benchmark: the full SLAM step (track + match + BA) at 640x480
with a 1k-landmark map on one CUDA card.

Port of the JAX package's ``bench.py``, with its protocol, keys and
rounding. The bench sweep (``utils/benchscene``) is rendered on the
device; 96 frames warm the map up (the last 8 of them timed one by one as
the eager rate), then the next 64 frames run three ways from the same warm
state:

- the scan: a Python loop of ``pipeline.step`` over the frames stacked on
  the device, keeping each frame's reprojection error and dropped-row
  counts as device tensors (the loop adds no host read to the step's own).
  The first pass is ``scan_compile_s``; ``n_reps`` more passes, each from
  the warm state (``step`` leaves its input state untouched), give
  ``scan_step_ms`` (their mean) and ``scan_step_ms_reps`` (each pass);
- eager: the warm's last 8 steps, ``eager_step_ms``;
- live: ``pipeline.step_live_ring`` with an f32[8, LIVE_WIDTH] telemetry
  ring read on the host once every 8 frames, as ``run_replay --live`` does.

Then the accuracy figures on the scan's final map (observation errors
split by disabled and slam-usable rows, the raw and Sim(3)-aligned ATE
against the sweep's ground truth) and, for seeds 1 and 2, one more render,
warm and scan pass each for the 3-seed medians.

    python -m slam_robot_tpu_torch.bench                # on the card
    python -m slam_robot_tpu_torch.bench --device cpu   # hours at this size

Prints one JSON line: ``{"metric", "value" (fps), "unit", "vs_baseline"
(fps / 60), "detail"}``. Without a CUDA device (and without ``--device
cpu``) it exits non-zero and prints no line. ``run`` takes smaller sizes
for tests and a starting state for a caller that has stepped the sweep's
first frames already.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import SYNCS, default_device, host
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.ops import tracker_fused
from slam_robot_tpu_torch.ops.cuda import blur, build, newton
from slam_robot_tpu_torch.utils.benchscene import make_frames, sweep_pose
from slam_robot_tpu_torch.utils.dump import ate_aligned

METRIC = "SLAM fps (track+match+BA) 640x480, 1k-landmark map, 1 chip"
# the warm's last steps, timed one by one as the eager rate
N_EAGER = 8
# live loop: frames per ring read on the host
RING = 8


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def counts() -> dict:
    """Host syncs and kernel launches so far (each a running count)."""
    return {"syncs": SYNCS.n, "pyramid_flat": blur.PYRAMID.launches,
            "newton_track": newton.KERNEL.launches, "sep5_reflect101": blur.KERNEL.launches,
            "sweeps": tracker_fused.SWEEPS.n}


def _since(before: dict) -> dict:
    now = counts()
    return {k: now[k] - v for k, v in before.items()}


def bootstrap(cfg: SlamConfig, frames, n_warm: int, device=None, start=None,
              n_eager: int = N_EAGER, run_slam: bool = True):
    """The warm: ``step`` + ``maybe_polish`` over frames up to ``n_warm -
    n_eager``, then ``n_eager`` steps without a polish, each with
    ``run_slam``. ``start`` is ``(state, i)`` to go on from a state that has
    stepped frames ``0..i-1`` this way; by default a fresh state from frame
    0. Returns ``(state, compile_s, eager_ms)``: the first step's wall time
    (the kernels' build or load included) and the eager steps' mean ms (None
    without them)."""
    dev = default_device(device)
    ps, i0 = (pipeline.init(cfg, device=dev), 0) if start is None else start
    n_polish = n_warm - n_eager
    if not i0 < n_polish:
        raise ValueError(f"start frame {i0} is not before the eager steps ({n_polish})")
    t0 = time.perf_counter()
    ps, _ = pipeline.step(ps, frames[i0], cfg, run_slam)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    ps = pipeline.maybe_polish(ps, i0, cfg, run_slam)
    for i in range(i0 + 1, n_polish):
        ps, _ = pipeline.step(ps, frames[i], cfg, run_slam)
        ps = pipeline.maybe_polish(ps, i, cfg, run_slam)
    _sync(dev)
    eager_ms = None
    if n_eager:
        t0 = time.perf_counter()
        for i in range(n_polish, n_warm):
            ps, _ = pipeline.step(ps, frames[i], cfg, run_slam)
        _sync(dev)
        eager_ms = (time.perf_counter() - t0) / n_eager * 1000
    return ps, compile_s, eager_ms


def run_scan(ps, imgs: torch.Tensor, cfg: SlamConfig, run_slam: bool = True, keep=()):
    """``step`` (with ``run_slam``) over the frames of ``imgs`` [T, H, W]
    from ``ps``. Returns (final state, (mean_reproj_err [T], dropped obs
    rows [T], then metric k [T] for each name k of ``keep``)), all stacked
    on the device."""
    errs, drops = [], []
    kept = {k: [] for k in keep}
    for img in imgs:
        ps, met = pipeline.step(ps, img, cfg, run_slam)
        errs.append(met["mean_reproj_err"])
        drops.append(met["fast_obs_dropped"] + met["slow_obs_dropped"]
                     + met["reproject_obs_dropped"])
        for k in keep:
            kept[k].append(met[k])
    return ps, (torch.stack(errs), torch.stack(drops), *(torch.stack(v) for v in kept.values()))


def live(ps, frames, cfg: SlamConfig):
    """The live robot loop over ``frames`` from ``ps``: the first step timed
    alone (``live_compile_s``), then ``len(frames) - 1`` steps, the ring
    read once every RING frames. Returns (final state, figures)."""
    dev = ps.map.device
    ring = torch.zeros((RING, pipeline.LIVE_WIDTH), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    ps, ring = pipeline.step_live_ring(ps, ring, frames[0], cfg)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    n_live = len(frames) - 1
    fetched = []
    group = []
    t0 = time.perf_counter()
    for i in range(1, 1 + n_live):
        ps, ring = pipeline.step_live_ring(ps, ring, frames[i], cfg)
        group.append(i)
        if len(group) == RING:
            fetched.extend(zip(group, host(ring)[-len(group):]))
            group = []
    if group:
        fetched.extend(zip(group, host(ring)[-len(group):]))
    live_ms = (time.perf_counter() - t0) / n_live * 1000
    if len(fetched) != n_live:
        raise AssertionError(f"live telemetry: {len(fetched)} of {n_live} frames arrived")
    ix = pipeline.LIVE_IDX
    drops = int(sum(row[ix["fast_obs_dropped"]] + row[ix["slow_obs_dropped"]]
                    + row[ix["reproject_obs_dropped"]] for _, row in fetched))
    canary = float(max(row[ix["normalize_canary_px"]] for _, row in fetched))
    if drops:
        raise AssertionError(f"live segment dropped {drops} obs rows")
    return ps, {"live_ms": live_ms, "live_compile_s": compile_s, "live_drops": drops,
                "live_canary_max": canary, "n_live": n_live}


def err_split(m: lm.MapState):
    """Observation errors of the map's rows on the host: the median over
    enabled rows, and their split into disabled rows, enabled rows and
    enabled rows of slam-usable points (the solver's true input). Returns
    (median px, split dict)."""
    n_obs = int(m.n_obs)
    errn = np.linalg.norm(m.obs_err[:n_obs].cpu().numpy(), axis=1)
    dis = m.obs_disabled[:n_obs].cpu().numpy()
    median_err = float(np.median(errn[~dis])) if (~dis).any() else 0.0

    def q(a, p):
        return float(np.quantile(a, p)) if a.size else 0.0

    pu = (lm.slam_usable(m.point_flags) & m.point_mask).cpu().numpy()
    usable = (~dis) & pu[m.obs_point[:n_obs].cpu().numpy().clip(0)]
    split = {
        "pct_disabled": round(100.0 * float(dis.mean()), 1),
        "mean_enabled_px": round(float(errn[~dis].mean()), 3) if (~dis).any() else 0.0,
        "mean_disabled_px": round(float(errn[dis].mean()), 3) if dis.any() else 0.0,
        "enabled_quantiles_px": {
            "p50": round(q(errn[~dis], 0.5), 3),
            "p90": round(q(errn[~dis], 0.9), 3),
            "p99": round(q(errn[~dis], 0.99), 3),
        },
        "n_enabled_usable": int(usable.sum()),
        "usable_quantiles_px": {
            "p50": round(q(errn[usable], 0.5), 3),
            "p90": round(q(errn[usable], 0.9), 3),
            "p99": round(q(errn[usable], 0.99), 3),
        },
    }
    return median_err, split


def trajectory_error(m: lm.MapState):
    """The map's frame positions against the sweep's ground truth (the same
    poses for every seed): (raw ATE in mm, the mean position error; raw ATE
    as % of the path; Sim(3)-aligned ATE as % of the path)."""
    nf = int(m.n_frames)
    true_t = np.stack([sweep_pose(i)[1] for i in range(nf)])
    est_t = m.frame_trans[:nf].cpu().numpy()
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    return (ate, 100.0 * ate / max(path, 1e-9),
            100.0 * ate_aligned(est_t, true_t) / max(path, 1e-9))


def _device_fields(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    out = {"device": torch.cuda.get_device_name(dev)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        line = res.stdout.strip().splitlines()[dev.index or 0]
        out["power_limit"] = line.rsplit(",", 1)[1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def run(cfg: SlamConfig, n_warm: int = 96, n_timed: int = 64, seeds=(0, 1, 2),
        n_reps: int = 2, device=None, start=None, results: dict | None = None) -> dict:
    """The whole protocol; returns the JSON line's dict. ``start`` is
    ``(state, i)``: seed ``seeds[0]``'s warm goes on from a state that has
    stepped that seed's frames ``0..i-1`` as the warm does. ``results``, when
    given, receives the warm state, each scan pass's final state, the live
    segment's final state, and the counts (``counts``) over the timed scan
    passes and over the live segment, with their frame numbers."""
    dev = default_device(device)
    out = {} if results is None else results
    build_files = sum(len(fs) for _, _, fs in os.walk(build.BUILD_DIR))
    frames = make_frames(cfg, n_warm + n_timed, seed=seeds[0], device=dev)
    ps, compile_s, eager_ms = bootstrap(cfg, frames, n_warm, dev, start=start)
    out["warm_state"] = ps

    imgs = torch.stack(frames[n_warm:])
    t0 = time.perf_counter()
    ps2, (errs, drops) = run_scan(ps, imgs, cfg)
    _sync(dev)
    scan_compile_s = time.perf_counter() - t0
    out["scan_states"] = [ps2]
    rep_ms = []
    before = counts()
    for _ in range(n_reps):
        t0 = time.perf_counter()
        ps2, (errs, drops) = run_scan(ps, imgs, cfg)
        _sync(dev)
        rep_ms.append((time.perf_counter() - t0) / n_timed * 1000)
        out["scan_states"].append(ps2)
    out["scan_window"] = dict(_since(before), frames=n_reps * n_timed)
    scan_ms = sum(rep_ms) / n_reps
    fps = 1000.0 / scan_ms
    err = float(errs[-1])
    obs_dropped_total = int(drops.sum())

    before = counts()
    ps_l, lv = live(ps, frames[n_warm:], cfg)
    out["live_window"] = dict(_since(before), frames=n_timed)
    out["live_state"] = ps_l

    m2 = ps2.map
    median_err, split = err_split(m2)
    ate, ate_pct, ate_al_pct = trajectory_error(m2)
    seed_pcts = {seeds[0]: round(ate_pct, 2)}
    seed_al_pcts = {seeds[0]: round(ate_al_pct, 2)}
    for sd in seeds[1:]:
        fr = make_frames(cfg, n_warm + n_timed, seed=sd, device=dev)
        ps_s, _, _ = bootstrap(cfg, fr, n_warm, dev, n_eager=0)
        ps_s2, (_errs, drops_s) = run_scan(ps_s, torch.stack(fr[n_warm:]), cfg)
        _, pct, al_pct = trajectory_error(ps_s2.map)
        seed_pcts[sd] = round(pct, 2)
        seed_al_pcts[sd] = round(al_pct, 2)
        obs_dropped_total += int(drops_s.sum())
    ate_pct_median3 = float(np.median(list(seed_pcts.values())))
    ate_al_median3 = float(np.median(list(seed_al_pcts.values())))
    return {
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 3),
        "detail": {
            "scan_step_ms": round(scan_ms, 2),
            "scan_step_ms_reps": [round(t, 2) for t in rep_ms],
            "eager_step_ms": round(eager_ms, 2),
            "eager_fps": round(1000.0 / eager_ms, 2),
            "live_step_ms": round(lv["live_ms"], 2),
            "live_fps": round(1000.0 / lv["live_ms"], 2),
            "live_compile_s": round(lv["live_compile_s"], 1),
            "compile_s": round(compile_s, 1),
            "compile_cache_entries_before": build_files,
            "scan_compile_s": round(scan_compile_s, 1),
            "mean_reproj_err_px": round(err, 3),
            "median_enabled_err_px": round(median_err, 3),
            "err_split": split,
            "ate_mm": round(ate, 1),
            "ate_pct_of_path": round(ate_pct, 2),
            "ate_pct_per_seed": seed_pcts,
            "ate_pct_median3": round(ate_pct_median3, 2),
            "ate_pct_aligned_per_seed": seed_al_pcts,
            "ate_pct_aligned_median3": round(ate_al_median3, 2),
            "obs_dropped_total": obs_dropped_total,
            "live_obs_dropped": lv["live_drops"],
            "live_canary_max_px": round(lv["live_canary_max"], 4),
            "n_points": int(m2.n_points),
            "n_obs": int(m2.n_obs),
            **_device_fields(dev),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(run(SlamConfig(), device=dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
