"""A multi-process dry run: the JAX package's ``__graft_entry__
.dryrun_multichip`` over ``torch.distributed``.

``dryrun_multichip(n)`` spawns ``n`` processes on the CPU, joined in one
gloo group at a free ``tcp://127.0.0.1`` port. The ranks form a
``data x model`` grid, ``model = 2`` when ``n`` is even, else 1 (rank =
data * model + model index):

- data parallel: each data rank runs one SLAM pipeline instance (the model
  ranks of a data rank run the same one) over T = 4 frames of
  ``SyntheticSource(seed=data rank)`` at a tiny configuration;
- model parallel: the model ranks of a data rank split a bundle-adjustment
  window's observation table in row blocks, and ``ops/ba.solve`` and the
  implicit-Schur CG solver sum every observation-derived block through
  ``all_reduce`` over their model group (``ops/obs_shards.ObsShards``).

Rank 0 then checks what the JAX package's dry run checks: a finite BA
cost, every data rank's map holds observations and matched after its first
frame, and the sharded CG solve is finite, ok and lowers its cost. The
sharded solves are also held against the same solves on the whole table
in one process (cost to 1e-4 relative).

    python -m slam_robot_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import math
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

T = 4  # frames per data rank: frame 0 keyframes and seeds, 1-3 track


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_cfg():
    from slam_robot_tpu_torch.config import SlamConfig

    # __graft_entry__.py:89-93
    return SlamConfig(
        image_width=64, image_height=48, pyramid_depth=3, levels_unsure=3,
        max_features=16, max_corners=8, min_matches=4,
        max_frames=8, max_points=32, max_obs=256, max_obs_per_point=8,
        ba_max_iters=3,
    )


def _ba_problem():
    """The model axis' BA window (__graft_entry__.py:125-133): a synthetic
    6-frame, 16-point scene with noisy points; returns the solver's
    arguments with the observation columns as a dict."""
    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.models import slam
    from slam_robot_tpu_torch.utils import synthetic

    scene = synthetic.build_scene(
        SlamConfig(max_frames=8, max_points=32, max_obs=256, max_obs_per_point=8),
        n_frames=6, n_points=16, point_noise=20.0, device="cpu")
    s = scene.state
    free, present = slam.window_masks(s, 4, 6)
    obs = dict(obs_frame=s.obs_frame, obs_point=s.obs_point, obs_px=s.obs_px,
               obs_ok=slam._obs_ok(s, s.n_frames - 6))
    state = (s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k, s.point_loc,
             s.point_uncertainty)
    return state, obs, present, free


def _worker(rank: int, n: int, port: int, out) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        _run(rank, n, out)
    finally:
        dist.destroy_process_group()


def _run(rank: int, n: int, out) -> None:
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.ops import ba, ba_cg
    from slam_robot_tpu_torch.ops.obs_shards import ObsShards
    from slam_robot_tpu_torch.utils import synthetic

    model = 2 if n % 2 == 0 else 1
    data = n // model
    d, m = divmod(rank, model)
    # every rank creates every model group, in the same order
    groups = [dist.new_group(list(range(g * model, (g + 1) * model))) for g in range(data)]

    # dp: a short SLAM run per data rank
    cfg = _tiny_cfg()
    k = synthetic.reference_intrinsics(cfg)
    ps = pipeline.init(cfg, [k, k], device="cpu")
    src = sources.SyntheticSource(cfg, n_frames=T, seed=d, n_points=200, step_mm=5.0,
                                  device="cpu")
    n_matches = []
    for i in range(T):
        ps, met = pipeline.step(ps, torch.as_tensor(src.get(i % 2, i)), cfg)
        n_matches.append(int(met["n_matches"]))

    # tp: this rank's row block of the window's observation table
    state, obs, present, free = _ba_problem()
    O = obs["obs_frame"].shape[0]
    rows = slice(m * O // model, (m + 1) * O // model)
    shards = ObsShards([{c: v[rows] for c, v in obs.items()}], "cpu", group=groups[d])
    bcfg = ba.BAConfig(max_iters=2, max_free_frames=8)
    res = ba.solve_shards(*state, shards, present, free, bcfg)
    cg_cfg = ba_cg.CGConfig(max_free_frames=8, gn_iters=2, cg_iters=6)
    res_cg = ba_cg.solve_shards(*state, shards, present, free, cg_cfg)
    # the same solves on the whole table, in this process alone
    ref = ba.solve(*state, *obs.values(), present, free, bcfg)
    ref_cg = ba_cg.solve(*state, *obs.values(), present, free, cg_cfg)

    row = dict(rank=rank, data=d, model=m, n_obs=int(ps.map.n_obs), n_matches=n_matches,
               ba_cost=float(res.cost), ba_cost_whole=float(ref.cost),
               cg_cost=float(res_cg.cost), cg_cost0=float(res_cg.cost0),
               cg_cost_whole=float(ref_cg.cost), cg_ok=bool(res_cg.ok))
    rows_all = [None] * n
    dist.all_gather_object(rows_all, row)
    if rank == 0:
        out.put(rows_all)


def check(rows: list[dict]) -> str:
    """The JAX package's asserts (__graft_entry__.py:168-190) over every
    rank's figures, plus the sharded solves against the whole-table ones;
    returns the summary line."""
    for r in rows:
        if not math.isfinite(r["ba_cost"]):
            raise AssertionError(f"multi-process BA cost not finite: {r}")
        if r["n_obs"] <= 0:
            raise AssertionError(f"data rank {r['data']} tracked nothing: {r}")
        if max(r["n_matches"][1:]) <= 0:
            raise AssertionError(f"data rank {r['data']} never matched: {r}")
        if not math.isfinite(r["cg_cost"]):
            raise AssertionError(f"sharded CG cost not finite: {r}")
        if not r["cg_ok"]:
            raise AssertionError(f"sharded CG reported not-ok: {r}")
        if not r["cg_cost"] <= r["cg_cost0"]:
            raise AssertionError(f"sharded CG did not reduce cost: {r}")
        for a, b in (("ba_cost", "ba_cost_whole"), ("cg_cost", "cg_cost_whole")):
            if not abs(r[a] - r[b]) <= 1e-4 * abs(r[b]):
                raise AssertionError(f"{a} {r[a]} differs from the whole table's {r[b]}")
    model = max(r["model"] for r in rows) + 1
    data = len(rows) // model
    by_data = [rows[d * model] for d in range(data)]
    return (f"dryrun_multichip ok: {len(rows)} gloo ranks, data={data} x model={model}, "
            f"n_obs={[r['n_obs'] for r in by_data]}, "
            f"last n_matches={[r['n_matches'][-1] for r in by_data]}, "
            f"ba cost={rows[0]['ba_cost']:.4f}, sharded-cg cost "
            f"{rows[0]['cg_cost0']:.4f}->{rows[0]['cg_cost']:.4f}")


def dryrun_multichip(n_devices: int, timeout: float = 120.0) -> str:
    """Run the dry run over ``n_devices`` gloo processes and check it.
    Raises ``TimeoutError`` (after ending every rank) when the ranks have
    not finished within ``timeout`` seconds; returns the summary line."""
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    procs = mp.start_processes(_worker, args=(n_devices, _free_port(), out),
                               nprocs=n_devices, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"dryrun_multichip({n_devices}) ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    return check(out.get())


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
