"""Closed-loop simulation driver (BASELINE config 4).

    python -m slam_robot_tpu_torch.run_sim --goals 8            # rollout fleet
    python -m slam_robot_tpu_torch.run_sim --slam               # SLAM in the loop
    python -m slam_robot_tpu_torch.run_sim --goals 64 --mesh    # shard over devices
    python -m slam_robot_tpu_torch.run_sim --goals 8 --device cpu

Port of ``slam_robot_tpu/run_sim.py``: the same flags, goals and JSON
summary, with ``--device`` (default ``cuda``) in place of ``--platform``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# run_sim --slam's SlamConfig (slam_robot_tpu/run_sim.py:44-50): 160x120,
# pyramid depth 4, 96 features
SLAM_LOOP = dict(
    image_width=160, image_height=120, pyramid_depth=4,
    levels_unsure=4, max_features=96, max_corners=48, min_matches=12,
    max_frames=64, max_points=384, max_obs=8192, max_obs_per_point=16,
    ba_max_iters=10, window_obs=2048,
)


def goal_batch(n: int, seed: int = 0):
    """The driver's goals: [n, 3] float32 numpy, x and y uniform in [2, 7] m,
    heading uniform in [-3.14, 3.14], from ``np.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.uniform(2, 7, (n, 2)), rng.uniform(-3.14, 3.14, (n, 1))], axis=1
    ).astype(np.float32)


def main(argv=None, results: dict | None = None) -> int:
    """Run the driver and print its JSON summary. ``results``, when given,
    receives the run's tensors: the fleet's ``goals``, ``traj`` and ``dist``,
    or the SLAM loop's ``traj``, ``est``, ``dist``, each step's wall
    ``step_ms`` (device synchronized) and the last ``pipeline`` state."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--goals", type=int, default=8, help="number of rollouts")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--slam", action="store_true", help="SLAM-in-the-loop (1 rollout)")
    ap.add_argument("--mesh", action="store_true", help="shard rollouts over devices")
    ap.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.models import sim
    from slam_robot_tpu_torch.utils import synthetic

    device = default_device(args.device)
    t0 = time.time()

    if args.slam:
        cfg = SlamConfig(**SLAM_LOOP)
        k = synthetic.reference_intrinsics(cfg)
        world = sim.make_world(400, seed=args.seed, device=device)
        goal = torch.tensor([3.0, 2.0, 0.0], device=device)
        on_step = None
        if results is not None:
            stamps = [time.perf_counter()]

            def on_step(i, vs, ps):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stamps.append(time.perf_counter())
                results["pipeline"] = ps

        traj, est, dist = sim.rollout_slam(
            goal, world, cfg, [k, k], n_steps=min(args.steps, 30), on_step=on_step
        )
        print(json.dumps({
            "mode": "slam_in_loop",
            "steps": int(traj.shape[0]),
            "final_dist_m": round(float(dist), 3),
            "est_final_mm": est[-1].cpu().numpy().round(1).tolist(),
            "wall_s": round(time.time() - t0, 1),
        }))
        if results is not None:
            results.update(traj=traj, est=est, dist=dist,
                           step_ms=[1e3 * (b - a) for a, b in zip(stamps, stamps[1:])])
        return 0

    goals = torch.as_tensor(goal_batch(args.goals, args.seed), device=device)
    if args.mesh:
        from slam_robot_tpu_torch.parallel import mesh as mesh_mod
        from slam_robot_tpu_torch.parallel import rollouts

        m = mesh_mod.make_mesh(devices=None if device.type == "cuda" else [device])
        traj, dist = rollouts.fleet(m, goals, n_steps=args.steps)
    else:
        traj, dist = sim.rollout(goals, n_steps=args.steps)
    d = dist.cpu().numpy()
    print(json.dumps({
        "mode": "fleet",
        "rollouts": args.goals,
        "steps": args.steps,
        "reached(<0.5m)": int((d < 0.5).sum()),
        "median_dist_m": round(float(np.median(d)), 3),
        "wall_s": round(time.time() - t0, 1),
    }))
    if results is not None:
        results.update(goals=goals, traj=traj, dist=dist)
    return 0


if __name__ == "__main__":
    sys.exit(main())
