"""Per-stage timing of the pipeline step on the bench's mid-sweep state.

Port of the JAX package's ``tools/profile_step.py``. ``profile_tpu`` times
stages on a small synthetic state; this tool times them on the state the
headline bench scans (``bench.bootstrap``: 96 warm frames of the bench
sweep), so the stages add up to the bench's ``scan_step_ms``.

The port has no jit, so each stage runs eagerly, as the step runs it. A
stage that reads the device on the host (the LM exit flag, a sweep's skip)
pays that sync inside its time; besides its ms each line prints the host
syncs (``device.SYNCS``) and hand-written kernel launches (``bench.counts``)
one call of the stage makes, which the JAX tool, whose step was one
program, could not read.

    python -m slam_robot_tpu_torch.tools.profile_step [--backoff N] [--device cuda|cpu] [--small]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no stage line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import matcher as matcher_mod
from slam_robot_tpu_torch.models import pipeline, slam
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.tools import profiling
from slam_robot_tpu_torch.utils import benchscene

STAGES = ("step (full, eager)", "pyramid", "matcher.track", "BA fast (2,5)",
          "BA slow (10,20)", "reproject", "clean", "epipolar", "normalize")
N_WARM = 96


def stages(ps: pipeline.PipelineState, img: torch.Tensor, cfg: SlamConfig) -> list:
    """(label, call, n) of every stage on state ``ps`` and the next frame
    ``img``: the calls the original's closures make, each returning what
    the original's returns, and the original's count of timed calls."""
    m = ps.map
    camera = ps.camera ^ 1
    nf = int(m.n_frames)
    # matcher.track on the mid-sweep state after add_frame (pyramid included)
    m2, frame_idx = lm.add_frame(m, camera, m.frame_quat[nf - 2], m.frame_trans[nf - 2])
    rw = cfg.reproject_window or None
    return [
        ("step (full, eager)", lambda: pipeline.step(ps, img, cfg)[0].map.n_obs, 10),
        ("pyramid", lambda: pyr.build_pyramid(img, cfg.pyramid_depth, cfg.blur_sigma0,
                                              cfg.blur_sigma_down).data, 20),
        ("matcher.track",
         lambda: matcher_mod.track(ps.matcher, m2, img, frame_idx, camera, cfg)[1].n_obs, 20),
        ("BA fast (2,5)", lambda: slam.solve_frames(
            m, cfg.solve_fast[0], cfg.solve_fast[1], cfg.ba_range, cfg,
            max_iters=cfg.ba_iters_fast, window_obs=cfg.window_obs_fast)[1].cost, 10),
        ("BA slow (10,20)", lambda: slam.solve_frames(
            m, cfg.solve_slow[0], cfg.solve_slow[1], cfg.ba_range, cfg,
            max_iters=cfg.ba_iters_slow)[1].cost, 10),
        ("reproject", lambda: lm.reproject(m, cfg.cheirality_eps, window=rw)[1], 20),
        ("clean", lambda: lm.clean(m, cfg.error_threshold, cfg)[0].n_obs, 20),
        ("epipolar", lambda: lm.apply_epipolar_constraint(m, cfg).n_obs, 20),
        ("normalize", lambda: lm.normalize(m).frame_trans, 20),
    ]


def line(label: str, ms: float, per_call: dict) -> str:
    return (f"{label + ':':22s}{ms:8.2f} ms {per_call['syncs']:7.2f} syncs "
            f"{per_call['pyramid_flat']:5.2f} pyramid_flat "
            f"{per_call['newton_track']:6.2f} newton_track")


def run(ps, img, cfg: SlamConfig, dev: torch.device, n_max: int | None = None,
        emit=print) -> dict:
    """Time every stage on ``ps``; returns {label: {"ms", "syncs",
    "pyramid_flat", "newton_track", ...}}, the counts a call. ``n_max`` caps
    each stage's timed calls (and its warmup at 1 call)."""
    out = {}
    for label, fn, n in stages(ps, img, cfg):
        warmup = 3
        if n_max is not None:
            n, warmup = min(n, n_max), 1
        ms, per_call = profiling.timeit(fn, dev, n, warmup)
        out[label] = dict(per_call, ms=ms)
        emit(line(label, ms, per_call))
    return out


def state_line(ps) -> str:
    m = ps.map
    return f"state: n_points={int(m.n_points)} n_obs={int(m.n_obs)} n_frames={int(m.n_frames)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backoff", type=int, default=0,
                    help="override find_fail_backoff (0 = config default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true",
                    help="160x120, depth 4, 96 features, 24 warm frames")
    args = ap.parse_args(argv)
    dev = profiling.open_device(args.device, "profile_step")
    if dev is None:
        return 1
    cfg = profiling.SMALL if args.small else SlamConfig()
    if args.backoff:
        cfg = dataclasses.replace(cfg, find_fail_backoff=args.backoff)
    n_warm = 24 if args.small else N_WARM
    frames = benchscene.make_frames(cfg, n_warm + 4, device=dev)
    print(f"device: {profiling.device_line(dev)}", flush=True)
    ps, _, _ = bench.bootstrap(cfg, frames, n_warm, dev, n_eager=0)
    print(state_line(ps), flush=True)
    run(ps, frames[n_warm], cfg, dev, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
