"""Drive the PyTorch port's SLAM step on one CUDA card and check it.

Run from the repository root:

    python3 chip_smoke.py                         # all phases, 64 frames
    python3 chip_smoke.py --profile 8 --out DIR   # + torch.profiler tables

Phases, one line each:
  0. the card (nvidia-smi name and power limit) and the torch version;
     fails when torch sees no CUDA device
  1. build the hand-written kernels from slam_robot_tpu_torch/csrc with nvcc
  2. the blur kernel (B2) against its plain PyTorch version on every level
     shape of a 480x640 pyramid plus an odd shape, atol 1e-5, with times
  3. the Newton level kernel (B1) against its plain version for F=32 and
     F=256 lanes, windows cut from a rendered bench frame's pyramid with
     perturbed starts, every level (the coarsest window is 31x32), with times
  4. the main path: pipeline.init(SlamConfig()), then the bench sweep's
     first 64 frames rendered by the port, with maybe_polish; launch counters,
     NaN/Inf, map size, dropped rows, the normalize canary and the
     Sim(3)-aligned trajectory error against the sweep's ground truth
  5. with --profile K: torch.profiler over frames 64..63+K (device busy
     time, launches, host time by span); tables written to --out

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero without printing that line.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

# the main path's length: keyframes, slow windows, polish at 20, xslow at 48
MAIN_FRAMES = 64


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_blur(frame):
    """B2 kernel vs plain on the pyramid's shapes; returns the JSON entry."""
    import torch

    from slam_robot_tpu_torch.ops.cuda import blur as bk

    g11 = bk.gaussian_weights(1.1)
    g08 = bk.gaussian_weights(0.8)
    # the 11 calls of build_pyramid at 480x640, in order
    calls = [(frame.shape, g11, 1)]
    h, w = frame.shape
    for _ in range(5):
        calls.append(((h, w), bk.PYRDOWN_WEIGHTS, 2))
        h, w = (h + 1) // 2, (w + 1) // 2
        calls.append(((h, w), g08, 1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.rand(s, generator=gen, device="cuda") for s, _, _ in calls]
    inputs[0] = frame.contiguous()
    max_err = 0.0
    for x, (_, wts, stride) in zip(inputs, calls):
        got = bk.sep5(x, wts, stride)
        want = bk.sep5_plain(x, wts, stride)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (got.shape, want.shape)
        max_err = max(max_err, float((got - want).abs().max()))
    odd = torch.rand((47, 63), generator=gen, device="cuda")
    for stride in (1, 2):
        err = float((bk.sep5(odd, g08, stride) - bk.sep5_plain(odd, g08, stride)).abs().max())
        max_err = max(max_err, err)
    if not max_err <= 1e-5:
        raise AssertionError(f"blur kernel disagrees with its plain version: {max_err}")

    def run_kernel():
        for x, (_, wts, stride) in zip(inputs, calls):
            bk.sep5(x, wts, stride)

    def run_plain():
        for x, (_, wts, stride) in zip(inputs, calls):
            bk.sep5_plain(x, wts, stride)

    plain_ms = _time_ms(run_plain, 50)
    ms = _time_ms(run_kernel, 50)
    plain_ms2 = _time_ms(run_plain, 50)
    ms2 = _time_ms(run_kernel, 50)
    lvl0_ms = _time_ms(lambda: bk.sep5(inputs[0], g11, 1), 200)
    print(f"phase 2 blur: max_abs_err {max_err:.3e} (atol 1e-5) over 11 pyramid calls "
          f"+ 47x63; 11 calls kernel {ms:.4f}/{ms2:.4f} ms, plain {plain_ms:.4f}/"
          f"{plain_ms2:.4f} ms; 480x640 blur alone {lvl0_ms:.4f} ms", flush=True)
    return {"name": "sep5_reflect101", "route": "cuda",
            "source": "slam_robot_tpu_torch/csrc/blur.cu",
            "replaces": "slam_robot_tpu/ops/pallas/blur.py:35",
            "max_abs_err": max_err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "timed": "the 11 build_pyramid calls at 480x640, per frame"}


def phase_newton(frames):
    """B1 kernel vs plain on real windows; returns the JSON entry."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.ops import corners, patch, pyramid, tracker_fused
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    cfg = SlamConfig()
    pa = pyramid.build_pyramid(frames[0], 6)
    pb = pyramid.build_pyramid(frames[2], 6)
    grey = pa.data[0, pyramid.PAD:-pyramid.PAD, pyramid.PAD:-pyramid.PAD]
    cpts, cval = corners.detect(grey, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    pts = cpts[cval]
    wmask = patch.radial_mask(13, 15.0, device="cuda")
    dims = pyramid.level_dims(480, 640, 6)
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    n_status_diff = 0
    timing = {}
    for F in (32, 256):
        idx = torch.arange(F, device="cuda") % pts.shape[0]
        p0 = pts[idx]
        stacks = tracker_fused.get_patch_stacks(pa, p0, 13)
        start = p0 + 3.0 * (torch.rand((F, 2), generator=gen, device="cuda") - 0.5)
        active = (torch.rand((F,), generator=gen, device="cuda") > 0.1).to(torch.float32)
        for lvl in range(6):
            h, w = dims[lvl]
            wh, ww = min(32, h + 16), min(32, w + 16)
            pos0 = (start / 2.0 ** lvl).contiguous()
            if lvl == 5:
                pos0[:4] = torch.tensor([[0.2, 5.0], [19.5, 7.0], [3.0, 0.3], [10.0, 14.8]],
                                        device="cuda")
            win, org = tracker_fused._gather_windows(pb, lvl, pos0, wh, ww)
            args = (win, pos0, org, stacks.data[:, lvl].contiguous(),
                    stacks.valid[:, lvl].to(torch.float32).contiguous(),
                    stacks.mean[:, lvl].contiguous(), stacks.sumsq[:, lvl].contiguous(),
                    active, wmask,
                    torch.tensor([float(w), float(h)], device="cuda").expand(F, 2).contiguous())
            pos_k, st_k = nk.newton_level(*args, threshold=cfg.track_threshold,
                                          max_iters=cfg.track_max_iters)
            pos_p, st_p = nk.newton_window_steps(*args, cfg.track_threshold,
                                                 cfg.track_max_iters)
            torch.cuda.synchronize()
            err = (pos_k - pos_p).abs().max(dim=1).values
            max_err = max(max_err, float(err.max()))
            # a status may flip only for a lane ending within 2e-3 px of the margin
            x, y = pos_p[:, 0], pos_p[:, 1]
            near = torch.minimum(torch.minimum(x - 0.01, y - 0.01),
                                 torch.minimum(w - 0.01 - x, h - 0.01 - y)).abs() < 2e-3
            diff = (st_k != st_p) & ~near
            n_status_diff += int(diff.sum())
            if lvl in (0, 5):
                k_ms = _time_ms(lambda: nk.newton_level(*args, threshold=cfg.track_threshold,
                                                        max_iters=cfg.track_max_iters), 100)
                p_ms = _time_ms(lambda: nk.newton_window_steps(
                    *args, cfg.track_threshold, cfg.track_max_iters), 20)
                timing[(F, lvl, wh, ww)] = (k_ms, p_ms)
    # tolerance: convergence threshold 1e-3 px; a lane whose last step lands
    # near it may take one more or one fewer step in another summation order
    if not max_err <= 2e-3:
        raise AssertionError(f"newton kernel pos disagrees: max_abs_err {max_err}")
    if n_status_diff:
        raise AssertionError(f"newton kernel status disagrees on {n_status_diff} lanes")
    tline = ", ".join(f"F={F} L{lvl} {wh}x{ww}: kernel {k:.4f} ms plain {p:.4f} ms"
                      for (F, lvl, wh, ww), (k, p) in timing.items())
    print(f"phase 3 newton: pos max_abs_err {max_err:.3e} (atol 2e-3), status equal; "
          f"{tline}", flush=True)
    k_ms, p_ms = timing[(256, 0, 32, 32)]
    return {"name": "newton_level", "route": "cuda",
            "source": "slam_robot_tpu_torch/csrc/newton.cu",
            "replaces": "slam_robot_tpu/ops/pallas/newton.py:338",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "timed": "one level-0 launch, F=256 lanes, 32x32 windows, 6 iterations",
            "all_timings": {f"F{F}_L{lvl}_{wh}x{ww}": {"ms": k, "plain_ms": p}
                            for (F, lvl, wh, ww), (k, p) in timing.items()}}


def phase_main(frames):
    """Drive pipeline.step over ``frames``; returns (counts, summary, state)."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.device import SYNCS
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.ops.cuda import blur as bk
    from slam_robot_tpu_torch.ops.cuda import newton as nk
    from slam_robot_tpu_torch.utils.benchscene import sweep_pose
    from slam_robot_tpu_torch.utils.dump import ate_aligned

    cfg = SlamConfig()
    ps = pipeline.init(cfg, device="cuda")
    torch.cuda.synchronize()
    bk.KERNEL.launches = 0
    nk.KERNEL.launches = 0
    sync0 = SYNCS.n
    step_ms = []
    kfs = 0
    dropped = 0
    canary_max = 0.0
    n_frames = len(frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        ps, met = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
        kfs += int(met["is_keyframe"])
        dropped += int(met["fast_obs_dropped"] + met["slow_obs_dropped"]
                       + met["reproject_obs_dropped"])
        canary_max = max(canary_max, float(met["normalize_canary_px"]))
    counts = {"sep5_reflect101": bk.KERNEL.launches, "newton_level": nk.KERNEL.launches}
    syncs = (SYNCS.n - sync0) / n_frames

    if counts["sep5_reflect101"] != 11 * n_frames:
        raise AssertionError(f"blur launches {counts} != 11 per frame")
    if counts["newton_level"] <= 0:
        raise AssertionError("the Newton kernel never ran on the main path")
    m = ps.map
    for name, t in list(m._asdict().items()) + list(ps.matcher._asdict().items()):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in state field {name}")
    n_live = int(m.point_mask.sum())
    nf = int(m.n_frames)
    true_t = np.stack([sweep_pose(i)[1] for i in range(nf)])
    est_t = m.frame_trans[:nf].cpu().numpy()
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    ate_pct = 100.0 * ate_aligned(est_t, true_t) / max(path, 1e-9)
    tail = step_ms[-16:]
    summary = {"frames": n_frames, "n_points": int(m.n_points), "live_points": n_live,
               "keyframes": kfs, "obs_dropped": dropped, "canary_max_px": canary_max,
               "ate_aligned_pct": ate_pct, "median_step_ms_last16": statistics.median(tail),
               "host_syncs_per_frame": syncs, "launches": counts}
    print(f"phase 4 main path: {n_frames} frames, median step {summary['median_step_ms_last16']:.2f} "
          f"ms over the last {len(tail)}, {syncs:.1f} host syncs/frame, launches {counts}, "
          f"n_points {summary['n_points']} (live {n_live}), keyframes {kfs}, dropped {dropped}, "
          f"canary max {canary_max:.4f} px, Sim(3)-aligned ATE {ate_pct:.3f} % of path",
          flush=True)
    if summary["n_points"] <= 300:
        raise AssertionError(f"map too small: n_points {summary['n_points']}")
    if dropped:
        raise AssertionError(f"{dropped} obs rows dropped by the fixed windows")
    if not canary_max < 0.1:
        raise AssertionError(f"normalize canary {canary_max} px >= 0.1")
    if not ate_pct < 5.0:
        raise AssertionError(f"aligned ATE {ate_pct:.2f} % of path >= 5 %")
    if not math.isfinite(ate_pct):
        raise AssertionError("ATE is not finite")
    return counts, summary, ps


def phase_profile(ps, frames, start: int, out_dir: str, step_ms: float):
    """torch.profiler over frames[start:]: device busy time, host time by
    span, launches. ``step_ms`` is the unprofiled median step, against
    which the device's idle share is taken (the profiler itself slows the
    host several-fold). Writes the tables to ``out_dir``; returns a summary."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import pipeline

    cfg = SlamConfig()
    n = len(frames) - start
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, len(frames)):
            ps, _ = pipeline.step(ps, frames[i], cfg)
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    events = prof.key_averages()
    def self_dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    spans = ("matcher", "pyramid", "track_sweep", "keyframe", "slam", "ba_solve",
             "reproject", "clean", "epipolar", "normalize")
    # a span also shows as a device-side annotation row covering its
    # kernels: leave those out of the kernel sum and read spans host-side
    dev_us = sum(self_dev(e) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in spans)
    by_span = {}
    for e in events:
        if e.key in spans:
            by_span[e.key] = max(by_span.get(e.key, 0.0), e.cpu_time_total / 1000.0 / n)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_device.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    with open(os.path.join(out_dir, "profile_host.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=60))
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    busy_ms = dev_us / 1000.0 / n
    summary = {"frames": n, "profiled_wall_ms_per_frame": wall_ms / n,
               "device_busy_ms_per_frame": busy_ms,
               "device_idle_share": 1.0 - busy_ms / step_ms,
               "kernel_launches_per_frame": launches / n,
               "host_ms_per_frame_by_span": by_span}
    print(f"phase 5 profile: {json.dumps(summary)}", flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="K",
                    help="after the main path, profile K more frames of the sweep")
    ap.add_argument("--out", default="build/profile", help="directory for profile tables")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 0: torch sees no CUDA device")
    card = _card_line()
    print(f"phase 0 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from slam_robot_tpu_torch.ops.cuda import build

    t0 = time.time()
    lib_path = build.build(verbose=True)
    build.load_library()
    print(f"phase 1 build: {time.time() - t0:.2f} s ({lib_path.name})", flush=True)

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.utils.benchscene import make_frames

    n_render = MAIN_FRAMES + args.profile
    t0 = time.time()
    frames = make_frames(SlamConfig(), n_render, device="cuda")
    torch.cuda.synchronize()
    print(f"rendered {n_render} bench frames in {time.time() - t0:.2f} s", flush=True)

    entries = [phase_blur(frames[0]), phase_newton(frames)]
    counts, summary, ps = phase_main(frames[:MAIN_FRAMES])
    if args.profile:
        summary["profile"] = phase_profile(ps, frames, MAIN_FRAMES, args.out,
                                           summary["median_step_ms_last16"])
    for e in entries:
        e["launches"] = counts[e["name"]]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"main_path": summary}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
