"""The BASELINE.json benchmark configs, one JSON line each.

Port of ``tools/bench_suite.py`` (configs 1, 2, 4 and 5; same shapes,
seeds and JSON lines):

1. recorded monocular replay: tracking only, ~300 features, no BA
2. sliding-window BA: 10 keyframes x 500 landmarks
4. closed-loop sim: 64 batched rollouts
5. large-scale mapping: batched BA at 10k keyframes / 500k landmarks
   (implicit-Schur CG), the same on a four-shard mesh, plus a multi-robot
   shared-map solve

Config 3 is ``bench.py``'s headline, which the port does not have yet
(ROADMAP A18): asking for it exits with status 2.

    python -m slam_robot_tpu_torch.tools.bench_suite [--configs 1,2,4,5] [--device cpu]
    python -m slam_robot_tpu_torch.tools.bench_suite --small      # CI-sized shapes

``--device`` (default ``cuda``, the card) replaces the original's
``--platform``. A line's ``value`` is a rate over wall time on that
device, synchronized; ``detail`` holds the original's keys and a few more
(initial costs and errors) that the checks of a run read.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# config 5's sharded solve: the observation table in this many row blocks,
# over the visible devices in turn (all four on one card)
SHARDS = 4


def emit(name, value, unit, **detail):
    print(json.dumps({"config": name, "value": round(value, 3), "unit": unit,
                      "detail": detail}), flush=True)


def main(argv=None, results: dict | None = None) -> int:
    """Run the configs and print one JSON line per result. ``results``,
    when given, receives each line's inputs and outputs under its config
    (the tensors of config 5's problem and solves among them), with
    ``run``, a call that repeats the line's timed work once."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--configs", default="1,2,4,5")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    configs = {int(c) for c in args.configs.split(",")}
    if 3 in configs:
        print("bench_suite: config 3 is bench.py's headline, not ported yet (ROADMAP A18)",
              file=sys.stderr)
        return 2
    unknown = configs - {1, 2, 4, 5}
    if unknown:
        ap.error(f"no config {sorted(unknown)}: 1, 2, 4 or 5")

    import numpy as np
    import torch

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.models import pipeline, renderer, sim, slam
    from slam_robot_tpu_torch.ops import ba, ba_cg
    from slam_robot_tpu_torch.ops import quaternion as quat
    from slam_robot_tpu_torch.parallel import mesh as mesh_mod
    from slam_robot_tpu_torch.parallel import multi_robot
    from slam_robot_tpu_torch.utils import synthetic

    dev = default_device(args.device)
    small = args.small
    out = {} if results is None else results

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def frames_for(cfg, n, n_pts=600):
        k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device=dev)
        world, bright = (torch.as_tensor(a, device=dev)
                         for a in renderer.make_world(n_pts, seed=0))
        axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
        frames = []
        for i in range(n):
            pair = i // 2
            q = quat.from_axis_angle(axis, 0.004 * pair)
            t = torch.tensor([150.0 * (i % 2), 0.0, 15.0 * pair], device=dev)
            frames.append(renderer.render(q, t, k, world, bright, height=cfg.image_height,
                                          width=cfg.image_width))
        return frames

    # ---- config 1: replay, tracking only ----
    if 1 in configs:
        cfg = SlamConfig() if not small else SlamConfig(
            image_width=160, image_height=120, pyramid_depth=4,
            max_features=64, max_points=256, max_obs=4096)
        frames = frames_for(cfg, 10)
        ps = pipeline.init(cfg, device=dev)
        for i in range(3):
            ps, _ = pipeline.step(ps, frames[i], cfg, run_slam=False)
        n = 8

        def track(ps):
            for i in range(n):
                ps, _ = pipeline.step(ps, frames[(3 + i) % len(frames)], cfg, run_slam=False)
            return ps

        sync()
        t0 = time.perf_counter()
        end = track(ps)
        sync()
        dt = (time.perf_counter() - t0) / n
        emit("1_replay_track_only", 1.0 / dt, "fps", step_ms=round(dt * 1000, 2))
        out["1"] = dict(cfg=cfg, images=frames, steps=n + 3, run=lambda: track(end))

    # ---- config 2: sliding-window BA 10kf x 500 landmarks ----
    if 2 in configs:
        cfg = SlamConfig(max_frames=32, max_points=512, max_obs=8192, max_obs_per_point=32)
        scene = synthetic.build_scene(cfg, n_frames=20, n_points=500, pixel_noise=0.3,
                                      point_noise=30.0, device=dev)
        s = scene.state

        def run():
            return slam.solve_frames(s, 10, 20, 2.0, cfg)[1]

        run()
        run()
        sync()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            res = run()
        sync()
        dt = (time.perf_counter() - t0) / n
        iters = int(res.iters)
        emit("2_window_ba_10x500", 1.0 / dt, "solves/s", solve_ms=round(dt * 1000, 2),
             lm_iters=iters, iters_per_s=round(iters / dt, 1), cost=float(res.cost),
             cost0=float(res.cost0))
        out["2"] = dict(run=run)

    # ---- config 4: 64 rollouts ----
    if 4 in configs:
        n_roll = 16 if small else 64
        goals = torch.as_tensor(np.concatenate(
            [np.random.default_rng(2).uniform(2, 7, (n_roll, 2)), np.zeros((n_roll, 1))],
            axis=1).astype(np.float32), device=dev)
        sim.rollout(goals, n_steps=300)
        sync()
        t0 = time.perf_counter()
        _, dist = sim.rollout(goals, n_steps=300)
        sync()
        dt = time.perf_counter() - t0
        d = dist.cpu().numpy()
        emit("4_closed_loop_64_rollouts", n_roll * 300 / dt, "sim steps/s",
             wall_s=round(dt, 3), reached=int((d < 0.5).sum()), rollouts=n_roll)
        out["4"] = dict(goals=goals, dist=dist, run=lambda: sim.rollout(goals, n_steps=300))

    # ---- config 5: large-scale mapping ----
    if 5 in configs:
        nf, npts = (200, 5000) if small else (10000, 500000)
        prob = synthetic.build_large_problem(nf, npts, obs_per_frame=60 if small else 100,
                                             device=dev)
        cgc = ba_cg.CGConfig(max_free_frames=nf, gn_iters=5, cg_iters=20, precond="diag")
        keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
                "point_uncertainty", "obs_frame", "obs_point", "obs_px", "obs_ok",
                "present", "free_frame")
        args5 = tuple(prob[k] for k in keys)

        def ate(trans):
            return float(torch.sqrt(torch.mean(torch.sum((trans - prob["true_trans"]) ** 2,
                                                         dim=1))))

        def timed(solver, *extra):
            solver(*extra, *args5, cfg=cgc)
            sync()
            t0 = time.perf_counter()
            res = solver(*extra, *args5, cfg=cgc)
            sync()
            return res, time.perf_counter() - t0

        ate0 = ate(prob["frame_trans"])
        res, dt = timed(ba_cg.solve)
        emit("5_large_ba", cgc.gn_iters / dt, "GN iters/s",
             wall_s=round(dt, 2), frames=nf, landmarks=npts,
             obs=int(prob["obs_frame"].shape[0]), ate_mm=round(ate(res.frame_trans), 2),
             cost=float(res.cost), cost0=float(res.cost0), ate0_mm=round(ate0, 2),
             ok=bool(res.ok))

        # the same solve with the observation tables in SHARDS row blocks;
        # the landmark sums and the reduced camera system add over them
        cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                 if dev.type == "cuda" else [dev])
        msh = mesh_mod.make_mesh({"model": SHARDS},
                                 devices=[cards[i % len(cards)] for i in range(SHARDS)])
        res_s, dt_s = timed(ba_cg.solve_sharded, msh)
        emit("5_large_ba_sharded", cgc.gn_iters / dt_s, "GN iters/s",
             wall_s=round(dt_s, 2), devices=len(set(msh.devices.flat)), shards=SHARDS,
             frames=nf, landmarks=npts, obs=int(prob["obs_frame"].shape[0]),
             ate_mm=round(ate(res_s.frame_trans), 2), cost=float(res_s.cost),
             ok=bool(res_s.ok))
        out["5"] = dict(problem=prob, args=args5, cfg=cgc, result=res, wall_s=dt,
                        ate_mm=ate(res.frame_trans), ate0_mm=ate0,
                        run=lambda: ba_cg.solve(*args5, cfg=cgc))
        out["5_sharded"] = dict(result=res_s,
                                run=lambda: ba_cg.solve_sharded(msh, *args5, cfg=cgc))

        # multi-robot shared map (BASELINE config 5's second axis): R robots
        # on the same 24-frame trajectory, one shared table of 400 landmarks
        # perturbed by 60 mm
        R = 2 if small else 8
        mcfg = SlamConfig(max_frames=32, max_points=512, max_obs=16384, max_obs_per_point=32)
        scene = synthetic.build_scene(mcfg, n_frames=24, n_points=400, seed=0,
                                      pose_noise=0.005, device=dev)
        s5 = scene.state
        rng5 = np.random.default_rng(5)
        locs = s5.point_loc.clone()
        locs[:400, :3] += torch.as_tensor(
            rng5.normal(scale=60.0, size=(400, 3)).astype(np.float32), device=dev)
        free5, present5 = slam.window_masks(s5, 8, 24)
        ok5 = slam._obs_ok(s5, s5.n_frames - 24)
        pack = (s5.frame_quat, s5.frame_trans, s5.frame_cam, s5.obs_frame, s5.obs_point,
                s5.obs_px, ok5, present5, free5)
        st = [torch.stack([p] * R) for p in pack]
        args_mr = (st[0], st[1], st[2], s5.cam_k, locs, s5.point_uncertainty,
                   *st[3:])
        sweeps = 3
        mr_cfg = ba.BAConfig(max_iters=5, max_free_frames=8)

        def point_err(loc):
            pos = loc[:400, :3] / loc[:400, 3:]
            return float(torch.linalg.norm(pos - scene.true_points[:, :3], dim=1).mean())

        multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps)
        sync()
        t0 = time.perf_counter()
        locs5 = multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps)[2]
        sync()
        dt = time.perf_counter() - t0
        emit("5_multi_robot_shared_map", sweeps / dt, "GS sweeps/s",
             wall_s=round(dt, 2), robots=R, obs=R * int(s5.obs_frame.shape[0]),
             shared_landmarks=400, mean_point_err_mm=round(point_err(locs5), 2),
             mean_point_err0_mm=round(point_err(locs), 2))
        out["5_multi_robot"] = dict(
            point_err_mm=point_err(locs5), point_err0_mm=point_err(locs), args=args_mr,
            cfg=mr_cfg,
            run=lambda: multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
