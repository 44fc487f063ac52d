"""Stage timing on the card: pyramid / render / step / BA / maintenance.

Port of the JAX package's ``tools/profile_tpu.py``: each stage of the
pipeline timed alone, steady state, on a rendered frame (an 800-point
world) and on a synthetic 20-frame map, with the original's labels and the
``n`` and warmup of each of its timings. Not a benchmark: see
``slam_robot_tpu_torch/bench.py`` for the headline figure. The port has no
jit, so every stage runs eagerly, as the step runs it.

    python -m slam_robot_tpu_torch.tools.profile_tpu [--device cuda|cpu] [--small]

``--small`` runs at 160x120, depth 4, 96 features (the CPU tests' size).
Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no stage line.
"""

from __future__ import annotations

import argparse
import sys

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import pipeline, renderer, slam
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.ops import quaternion as quat
from slam_robot_tpu_torch.tools import profiling
from slam_robot_tpu_torch.utils import synthetic

STAGES = ("pyramid", "render", "step (no slam)", "step (full)", "BA window (2,5)",
          "BA window (10,20)", "reproject", "clean", "epipolar")


def line(label: str, ms: float) -> str:
    return f"{label + ':':20s}{ms:8.2f} ms"


def run(cfg: SlamConfig, dev: torch.device, n_max: int | None = None, emit=print) -> dict:
    """Time every stage of :data:`STAGES` on ``dev``; returns {label: ms}.
    ``n_max`` caps each timing's call count (and its warmup at 1 call)."""
    out = {}

    def stage(label, fn, n=10, warmup=2):
        if n_max is not None:
            n, warmup = min(n, n_max), 1
        out[label], _ = profiling.timeit(fn, dev, n, warmup)
        emit(line(label, out[label]))

    k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device=dev)
    world, bright = (torch.as_tensor(a, device=dev) for a in renderer.make_world(800, seed=0))
    q0, t0 = quat.identity(device=dev), torch.zeros(3, device=dev)

    def render():
        return renderer.render(q0, t0, k, world, bright, height=cfg.image_height,
                               width=cfg.image_width)

    img = render()
    stage("pyramid", lambda: pyr.build_pyramid(img, cfg.pyramid_depth).data)
    stage("render", render)

    # full pipeline, tracking only, after a bootstrap keyframe
    ps = pipeline.init(cfg, device=dev)
    ps, _ = pipeline.step(ps, img, cfg, run_slam=False)
    stage("step (no slam)", lambda: pipeline.step(ps, img, cfg, run_slam=False)[0].map.n_obs,
          n=5)

    ps2 = pipeline.init(cfg, device=dev)
    for _ in range(3):
        ps2, _ = pipeline.step(ps2, img, cfg)
    stage("step (full)", lambda: pipeline.step(ps2, img, cfg)[0].map.n_obs, n=5)

    # BA windows on a synthetic map (800 points, or the map's capacity)
    scene = synthetic.build_scene(cfg, n_frames=20, n_points=min(800, cfg.max_points),
                                  pixel_noise=0.3, point_noise=30.0, device=dev)
    s = scene.state
    stage("BA window (2,5)", lambda: slam.solve_frames(s, 2, 5, 2.0, cfg)[1].cost, n=5)
    stage("BA window (10,20)", lambda: slam.solve_frames(s, 10, 20, 2.0, cfg)[1].cost, n=5)

    stage("reproject", lambda: lm.reproject(s)[1])
    stage("clean", lambda: lm.clean(s, 5.0, cfg)[0].n_obs)
    stage("epipolar", lambda: lm.apply_epipolar_constraint(s, cfg).n_obs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true", help="160x120, depth 4, 96 features")
    args = ap.parse_args(argv)
    dev = profiling.open_device(args.device, "profile_tpu")
    if dev is None:
        return 1
    print(f"device: {profiling.device_line(dev)}", flush=True)
    run(profiling.SMALL if args.small else SlamConfig(), dev,
        emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
