"""Closed-loop robot simulation: perceive -> plan -> act.

Port of ``slam_robot_tpu/models/sim.py``. A bicycle-model vehicle carries
the camera through a landmark world, frames are rendered, perception
estimates the pose (optionally the full SLAM step), the Dubins planner
replans to the goal, and a pure-pursuit controller issues Turn/Speed
commands with the same [-1,1] scaling the Pololu shim uses.

``rollout`` drives a whole batch of goals at once (BASELINE config 4's 64
parallel rollouts are one [64, 3] batch): a Python loop of ``n_steps`` over
batched tensors that reads nothing back to the host. ``rollout_slam`` is one
rollout with ``pipeline.step`` in the loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.models import pipeline as pipeline_mod
from slam_robot_tpu_torch.models import planner, renderer, vehicle
from slam_robot_tpu_torch.ops import quaternion as quat

F32 = torch.float32


class SimWorld(NamedTuple):
    points: torch.Tensor      # [P,4] homogeneous landmarks (mm)
    brightness: torch.Tensor  # [P]


def camera_pose(vstate: vehicle.VehicleState):
    """Vehicle ground pose (meters, heading from +X_2d) -> camera pose
    (mm, looking along the vehicle heading). 2D (x, y) maps to world
    (X, Z); yaw is about +Y."""
    z = dict(dtype=F32, device=vstate.pos.device)
    t = (torch.tensor([1000.0, 0.0, 0.0], **z) * vstate.pos[..., 0:1]
         + torch.tensor([0.0, 0.0, 1000.0], **z) * vstate.pos[..., 1:2])
    # camera forward (= R^-1 e_z) equals [cos h, 0, sin h] iff yaw = h - pi/2
    yaw = vstate.heading - math.pi / 2
    q = quat.from_axis_angle(torch.tensor([0.0, 1.0, 0.0], **z), yaw)
    return q, t


STOP_RADIUS = 0.3  # m: pure pursuit commands speed 0 within this distance of the goal


def pursuit_samples(pos, heading, p: planner.Path, lookahead: float = 1.0):
    """Pure pursuit's view of path ``p`` from (pos [..., 2], heading [...]):
    the path sampled every 0.25 m, each sample's score (-|distance -
    lookahead|, -1e9 where it is invalid or within 0.05 m) and the turn
    command toward it (heading error / 0.45, clamped to [-1, 1]). Returns
    (score [..., S], turn [..., S])."""
    pts, valid = planner.interpolate_path(pos, heading, p, 0.25, samples_per_seg=64)
    to = pts - pos[..., None, :]
    d = planner.norm(to)
    score = torch.where(valid & (d > 0.05), -torch.abs(d - lookahead),
                        torch.full_like(d, -1e9))
    err = planner.modpi(torch.atan2(to[..., 1], to[..., 0]) - heading[..., None])
    return score, torch.clamp(err / 0.45, -1.0, 1.0)


def pure_pursuit(vstate: vehicle.VehicleState, goal, lookahead: float = 1.0,
                 cruise: float = 0.3):
    """Plan a Dubins path to the goal and steer at the sample of
    ``pursuit_samples`` with the best score (the first on ties): turn
    command ~ heading error, speed ~ cruise until within ``STOP_RADIUS``.
    Returns (speed, turn, distance to goal), each [...]."""
    p, _, _ = planner.shortest_path(vstate.pos, vstate.heading, goal[..., :2], goal[..., 2])
    score, turns = pursuit_samples(vstate.pos, vstate.heading, p, lookahead)
    best = torch.argmax(score, dim=-1)
    turn = torch.gather(turns, -1, best[..., None])[..., 0]
    dist_goal = planner.norm(goal[..., :2] - vstate.pos)
    speed = torch.where(dist_goal > STOP_RADIUS, torch.full_like(dist_goal, cruise),
                        torch.zeros_like(dist_goal))
    return speed, turn, dist_goal


def _goals(goal, device):
    if isinstance(goal, torch.Tensor) and device is None:
        return goal.to(F32)
    return torch.as_tensor(goal, dtype=F32, device=default_device(device))


def rollout(goal, n_steps: int = 200, dt: float = 0.1,
            params: vehicle.VehicleParams = vehicle.VehicleParams(), device=None):
    """Drive to ``goal`` = [..., 3] (x, y, heading in meters/rad) from the
    origin. Returns the trajectory [..., n_steps, 2] and the final distance
    to goal [...] (measured before the last step, as the JAX package's).
    Perception-free control loop (ground-truth pose); the SLAM-in-the-loop
    variant is ``rollout_slam``. Runs on ``goal``'s device when it is a
    tensor, else on ``device`` (default: the CUDA card)."""
    goal = _goals(goal, device)
    vs = vehicle.init_state(batch=goal.shape[:-1], device=goal.device)
    traj = []
    dist = vs.speed
    for _ in range(n_steps):
        speed, turn, dist = pure_pursuit(vs, goal)
        vs = vehicle.step(vs, speed, turn, dt, params)
        traj.append(vs.pos)
    return torch.stack(traj, dim=-2), dist


def rollout_slam(goal, world: SimWorld, cfg: SlamConfig, intrinsics,
                 n_steps: int = 20, dt: float = 0.2,
                 params: vehicle.VehicleParams = vehicle.VehicleParams(), on_step=None):
    """Full closed loop on ``world``'s device: render -> SLAM pipeline ->
    plan from the SLAM pose estimate -> act. Expensive; use small SlamConfig
    capacities. ``on_step(i, vstate, pstate)``, when given, is called after
    each step.

    Returns (vehicle trajectory [n,2], estimated camera positions [n,3] mm,
    final distance to goal)."""
    dev = world.points.device
    goal = torch.as_tensor(goal, dtype=F32, device=dev)
    ps = pipeline_mod.init(cfg, intrinsics, device=dev)
    k0 = torch.as_tensor(intrinsics[0], dtype=F32, device=dev)
    vs = vehicle.init_state(device=dev)
    traj, est, dist = [], [], vs.speed
    for i in range(n_steps):
        q, t = camera_pose(vs)
        img = renderer.render(q, t, k0, world.points, world.brightness,
                              height=cfg.image_height, width=cfg.image_width)
        ps, _ = pipeline_mod.step(ps, img, cfg)
        # SLAM pose estimate of the newest frame (mm -> meters, X/Z plane),
        # indexed on the device
        newest = torch.clamp(ps.map.n_frames - 1, min=0).reshape(1).long()
        est_t = torch.index_select(ps.map.frame_trans, 0, newest)[0]
        est_vs = vehicle.VehicleState(
            pos=torch.stack([est_t[0], est_t[2]]) / 1000.0,
            heading=vs.heading,  # heading from odometry; SLAM yaw optional
            speed=vs.speed,
        )
        speed, turn, dist = pure_pursuit(est_vs, goal)
        vs = vehicle.step(vs, speed, turn, dt, params)
        traj.append(vs.pos)
        est.append(est_t)
        if on_step is not None:
            on_step(i, vs, ps)
    return torch.stack(traj), torch.stack(est), dist


def make_world(n_points: int = 300, seed: int = 0, device=None) -> SimWorld:
    """The seeded landmark field of ``renderer.make_world`` on ``device``
    (default: the CUDA card)."""
    dev = default_device(device)
    pts, bright = renderer.make_world(n_points, seed)
    return SimWorld(points=torch.as_tensor(pts, device=dev),
                    brightness=torch.as_tensor(bright, device=dev))
