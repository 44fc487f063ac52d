"""The BASELINE.json benchmark configs, one JSON line each.

Port of ``tools/bench_suite.py`` (configs 1-5; same shapes, seeds and
JSON lines):

1. recorded monocular replay: tracking only, ~300 features, no BA
2. sliding-window BA: 10 keyframes x 500 landmarks
3. the headline: the port's ``bench.main`` (``slam_robot_tpu_torch/bench.py``)
4. closed-loop sim: 64 batched rollouts
5. large-scale mapping: batched BA at 10k keyframes / 500k landmarks
   (implicit-Schur CG), the same on a four-shard mesh, plus a multi-robot
   shared-map solve

    python -m slam_robot_tpu_torch.tools.bench_suite [--configs 1,2,4,5] [--device cpu]
    python -m slam_robot_tpu_torch.tools.bench_suite --small --configs 1,2,4,5  # CI shapes

``--small`` cuts configs 1, 2, 4 and 5; config 3 is always the full bench.

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


def replay_track(dev, small: bool) -> dict:
    """Config 1's work: its config, its 10 rendered frames, the state after
    3 warm steps, and ``track(ps)``, ``N_TRACK`` steps from ``ps`` without BA
    (the state after them)."""
    import torch

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.models import pipeline, renderer
    from slam_robot_tpu_torch.ops import quaternion as quat
    from slam_robot_tpu_torch.utils import synthetic

    cfg = SlamConfig() if not small else SlamConfig(
        image_width=160, image_height=120, pyramid_depth=4,
        max_features=64, max_points=256, max_obs=4096)
    k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device=dev)
    world, bright = (torch.as_tensor(a, device=dev) for a in renderer.make_world(600, seed=0))
    axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
    frames = []
    for i in range(10):
        pair = i // 2
        q = quat.from_axis_angle(axis, 0.004 * pair)
        t = torch.tensor([150.0 * (i % 2), 0.0, 15.0 * pair], device=dev)
        frames.append(renderer.render(q, t, k, world, bright, height=cfg.image_height,
                                      width=cfg.image_width))
    ps = pipeline.init(cfg, device=dev)
    for i in range(3):
        ps, _ = pipeline.step(ps, frames[i], cfg, run_slam=False)

    def track(ps):
        for i in range(N_TRACK):
            ps, _ = pipeline.step(ps, frames[(3 + i) % len(frames)], cfg, run_slam=False)
        return ps

    return dict(cfg=cfg, images=frames, ps=ps, track=track)


def window_ba(dev):
    """Config 2's work: one solve of the 10-keyframe window over 500
    landmarks (a call; its result)."""
    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.models import slam
    from slam_robot_tpu_torch.utils import synthetic

    cfg = SlamConfig(max_frames=32, max_points=512, max_obs=8192, max_obs_per_point=32)
    s = synthetic.build_scene(cfg, n_frames=20, n_points=500, pixel_noise=0.3,
                              point_noise=30.0, device=dev).state
    return lambda: slam.solve_frames(s, 10, 20, 2.0, cfg)[1]


def fleet_goals(dev, small: bool):
    """Config 4's goals: [n, 3] float32, x and y uniform in [2, 7] m (seed 2),
    64 rollouts (16 with ``small``)."""
    import numpy as np
    import torch

    n_roll = 16 if small else 64
    return torch.as_tensor(np.concatenate(
        [np.random.default_rng(2).uniform(2, 7, (n_roll, 2)), np.zeros((n_roll, 1))],
        axis=1).astype(np.float32), device=dev)


def shard_mesh(dev):
    """Config 5's mesh of SHARDS row blocks over the visible devices in turn
    (all four on one card)."""
    import torch

    from slam_robot_tpu_torch.parallel import mesh as mesh_mod

    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    return mesh_mod.make_mesh({"model": SHARDS},
                              devices=[cards[i % len(cards)] for i in range(SHARDS)])


def multi_robot_problem(dev, small: bool) -> dict:
    """Config 5's multi-robot shared map: R robots on the same 24-frame
    trajectory, one shared table of 400 landmarks perturbed by 60 mm. Its
    ``args`` and ``cfg`` for ``multi_robot.solve_shared_map``, its sweeps,
    the perturbed locations and ``point_err(loc)`` (mean mm)."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.models import slam
    from slam_robot_tpu_torch.ops import ba
    from slam_robot_tpu_torch.utils import synthetic

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
    args = (st[0], st[1], st[2], s5.cam_k, locs, s5.point_uncertainty, *st[3:])

    def point_err(loc):
        pos = loc[:400, :3] / loc[:400, 3:]
        return float(torch.linalg.norm(pos - scene.true_points[:, :3], dim=1).mean())

    return dict(args=args, cfg=ba.BAConfig(max_iters=5, max_free_frames=8), sweeps=3, robots=R,
                obs=R * int(s5.obs_frame.shape[0]), locs=locs, point_err=point_err)


# config 1's timed steps
N_TRACK = 8


def busy_works(dev, small: bool, steps: int, goals: int, big: tuple) -> dict:
    """The work whose busy share a profile takes for each line
    (``profile_trace.busy_share_session``), by line: "1" config 1's
    N_TRACK timed steps, "2" one window solve, "4" ``steps`` steps of config
    4's fleet, "5_sharded" the solve on the SHARDS-shard mesh of ``big``
    (``profile_cg.problem``'s arguments), "5_multi_robot" one sweep of the
    shared map, and "fleet" ``steps`` steps of run_sim's fleet of ``goals``
    rollouts (goal seed 0). Config 5's own solve is ``profile_cg``'s."""
    import functools

    import torch

    from slam_robot_tpu_torch import run_sim
    from slam_robot_tpu_torch.models import sim
    from slam_robot_tpu_torch.ops import ba_cg
    from slam_robot_tpu_torch.parallel import multi_robot

    c1 = replay_track(dev, small)
    cgc = ba_cg.CGConfig(max_free_frames=big[0].shape[0], gn_iters=5, cg_iters=20,
                         precond="diag")
    mr = multi_robot_problem(dev, small)
    fleet = torch.as_tensor(run_sim.goal_batch(goals, 0), device=dev)
    return {"1": functools.partial(c1["track"], c1["track"](c1["ps"])),
            "2": window_ba(dev),
            "4": functools.partial(sim.rollout, fleet_goals(dev, small), n_steps=steps),
            "5_sharded": functools.partial(ba_cg.solve_sharded, shard_mesh(dev), *big, cfg=cgc),
            "5_multi_robot": functools.partial(multi_robot.solve_shared_map, *mr["args"],
                                               cfg=mr["cfg"], sweeps=1),
            "fleet": functools.partial(sim.rollout, fleet, n_steps=steps)}


def main(argv=None, results: dict | None = None) -> int:
    """Run the configs and print one JSON line per result. ``results``,
    when given, receives each line's inputs and outputs under its config
    (the tensors of config 5's problem and solves among them), with
    ``run``, a call that repeats the line's timed work once."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    configs = {int(c) for c in args.configs.split(",")}
    unknown = configs - {1, 2, 3, 4, 5}
    if unknown:
        ap.error(f"no config {sorted(unknown)}: 1, 2, 3, 4 or 5")

    import torch

    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.models import sim
    from slam_robot_tpu_torch.ops import ba_cg
    from slam_robot_tpu_torch.parallel import multi_robot
    from slam_robot_tpu_torch.utils import synthetic

    dev = default_device(args.device)
    small = args.small
    out = {} if results is None else results

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- config 1: replay, tracking only ----
    if 1 in configs:
        c1 = replay_track(dev, small)
        track = c1["track"]
        sync()
        t0 = time.perf_counter()
        end = track(c1["ps"])
        sync()
        dt = (time.perf_counter() - t0) / N_TRACK
        emit("1_replay_track_only", 1.0 / dt, "fps", step_ms=round(dt * 1000, 2))
        out["1"] = dict(cfg=c1["cfg"], images=c1["images"], steps=N_TRACK + 3,
                        run=lambda: track(end))

    # ---- config 2: sliding-window BA 10kf x 500 landmarks ----
    if 2 in configs:
        run = window_ba(dev)
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

    # ---- config 3: headline (bench.py) ----
    if 3 in configs:
        from slam_robot_tpu_torch import bench

        rc = bench.main(["--device", str(dev)])
        if rc:
            return rc

    # ---- config 4: 64 rollouts ----
    if 4 in configs:
        goals = fleet_goals(dev, small)
        n_roll = goals.shape[0]
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
        msh = shard_mesh(dev)
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

        # multi-robot shared map (BASELINE config 5's second axis)
        mr = multi_robot_problem(dev, small)
        args_mr, mr_cfg, sweeps = mr["args"], mr["cfg"], mr["sweeps"]
        multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps)
        sync()
        t0 = time.perf_counter()
        locs5 = multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps)[2]
        sync()
        dt = time.perf_counter() - t0
        point_err, locs = mr["point_err"], mr["locs"]
        emit("5_multi_robot_shared_map", sweeps / dt, "GS sweeps/s",
             wall_s=round(dt, 2), robots=mr["robots"], obs=mr["obs"],
             shared_landmarks=400, mean_point_err_mm=round(point_err(locs5), 2),
             mean_point_err0_mm=round(point_err(locs), 2))
        out["5_multi_robot"] = dict(
            point_err_mm=point_err(locs5), point_err0_mm=point_err(locs), args=args_mr,
            cfg=mr_cfg,
            run=lambda: multi_robot.solve_shared_map(*args_mr, cfg=mr_cfg, sweeps=sweeps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
