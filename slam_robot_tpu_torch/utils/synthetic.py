"""Synthetic scenes: ground-truth trajectories, landmarks and observations.

Port of ``slam_robot_tpu/utils/synthetic.py``. Geometry mirrors the
reference's rig: two cameras on a 150 mm x-baseline, frames alternating
between them (main.cpp:474-507), y-flipped intrinsics, depths in
millimeters. Every random value comes from the same numpy draws, in the
same order, as the JAX package's, so a seed gives the same scene there and
here (integers exactly, floats to float32 rounding). Tensors are made on
``device`` (default: the CUDA card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import quaternion as quat

F32 = torch.float32


class Scene(NamedTuple):
    state: lm.MapState            # map populated with (possibly noisy) values
    true_quat: torch.Tensor       # [F,4] ground-truth frame rotations
    true_trans: torch.Tensor      # [F,3]
    true_points: torch.Tensor     # [P,4] homogeneous, w=1


def reference_intrinsics(cfg: SlamConfig) -> np.ndarray:
    """Zero-distortion k with the reference's negative fy (main.cpp:474-482),
    scaled with the image width (same field of view)."""
    s = cfg.image_width / 640.0
    return np.array(
        [0, 0, 0, cfg.focal * s, -cfg.focal * s,
         cfg.image_width / 2.0, cfg.image_height / 2.0],
        np.float32,
    )


def _yaw_quat(yaw, dev) -> torch.Tensor:
    axis = torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=dev)
    return quat.from_axis_angle(axis, torch.as_tensor(yaw, dtype=F32, device=dev))


def make_trajectory(n_frames: int, cfg: SlamConfig, yaw_rate: float = 0.01,
                    step_mm: float = 20.0, device=None):
    """Alternating-stereo trajectory: cameras 0/1 offset by the baseline
    along local x, slowly yawing and advancing in z. Returns ([F,4], [F,3])."""
    dev = default_device(device)
    pair = np.arange(n_frames) // 2
    q = _yaw_quat((yaw_rate * pair).astype(np.float32), dev)
    center = torch.zeros((n_frames, 3), dtype=F32, device=dev)
    center[:, 2] = torch.as_tensor((step_mm * pair).astype(np.float32), device=dev)
    off = torch.zeros((n_frames, 3), dtype=F32, device=dev)
    off[:, 0] = torch.as_tensor((cfg.baseline_mm * (np.arange(n_frames) % 2)).astype(np.float32),
                                device=dev)
    return q, center + quat.rotate_inverse(q, off)


def make_points(n_points: int, rng: np.random.Generator,
                depth_range=(1500.0, 4000.0), spread: float = 1200.0, device=None):
    """[P,4] homogeneous landmarks in front of the rig."""
    xy = rng.normal(scale=spread, size=(n_points, 2))
    z = rng.uniform(*depth_range, size=(n_points, 1))
    pts = np.concatenate([xy, z, np.ones((n_points, 1))], axis=1).astype(np.float32)
    return torch.as_tensor(pts, device=default_device(device))


def build_large_problem(
    n_frames: int,
    n_points: int,
    obs_per_frame: int = 100,
    seed: int = 0,
    point_noise: float = 30.0,
    pose_noise_mm: float = 10.0,
    pixel_noise: float = 0.3,
    cfg: SlamConfig | None = None,
    device=None,
):
    """Raw BA problem tables at mapping scale (BASELINE config 5: 10k
    keyframes / 500k landmarks / 1M observations): no MapState, the flat
    tables written directly. The draws run on the host (numpy); the
    projection runs on ``device``, where every table lands.

    Returns a dict of tensors and ground truth, ready for ops/ba_cg.solve.
    """
    cfg = cfg or SlamConfig()
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    k = torch.as_tensor(reference_intrinsics(cfg), device=dev)

    # a long survey trajectory over a large landmark field
    t_true = np.zeros((n_frames, 3), np.float32)
    t_true[:, 0] = np.cumsum(rng.normal(20.0, 5.0, n_frames))
    t_true[:, 2] = np.cumsum(rng.normal(15.0, 5.0, n_frames))
    yaw = np.cumsum(rng.normal(0.0, 0.002, n_frames)).astype(np.float32)
    q_true = _yaw_quat(yaw, dev)

    pts = np.zeros((n_points, 4), np.float32)
    pts[:, 0] = rng.uniform(t_true[:, 0].min() - 2000, t_true[:, 0].max() + 2000, n_points)
    pts[:, 1] = rng.normal(0.0, 800.0, n_points)
    pts[:, 2] = rng.uniform(t_true[:, 2].min() + 1500, t_true[:, 2].max() + 6000, n_points)
    pts[:, 3] = 1.0

    # each frame observes obs_per_frame random landmarks
    O = n_frames * obs_per_frame
    obs_frame = np.repeat(np.arange(n_frames, dtype=np.int32), obs_per_frame)
    obs_point = rng.integers(0, n_points, O).astype(np.int32)

    t_dev = torch.as_tensor(t_true, device=dev)
    pts_dev = torch.as_tensor(pts, device=dev)
    of = torch.as_tensor(obs_frame, device=dev).long()
    op = torch.as_tensor(obs_point, device=dev).long()
    px, valid = proj.project_point(q_true[of], t_dev[of], k, pts_dev[op])
    px = px + torch.as_tensor(rng.normal(0, pixel_noise, (O, 2)).astype(np.float32), device=dev)
    inb = (valid & (px[:, 0] > 0) & (px[:, 0] < cfg.image_width)
           & (px[:, 1] > 0) & (px[:, 1] < cfg.image_height))

    # noisy initial values (first two frames anchored)
    t0 = t_true + rng.normal(0, pose_noise_mm, (n_frames, 3)).astype(np.float32)
    t0[:2] = t_true[:2]
    p0 = pts.copy()
    p0[:, :3] += rng.normal(0, point_noise, (n_points, 3)).astype(np.float32)

    free = torch.ones(n_frames, dtype=torch.bool, device=dev)
    free[:2] = False
    return dict(
        frame_quat=q_true,
        frame_trans=torch.as_tensor(t0, device=dev),
        frame_cam=torch.zeros(n_frames, dtype=torch.int32, device=dev),
        cam_k=k[None],
        point_loc=torch.as_tensor(p0, device=dev),
        point_uncertainty=torch.full((n_points,), 1e8, dtype=F32, device=dev),
        obs_frame=of.to(torch.int32),
        obs_point=op.to(torch.int32),
        obs_px=px,
        obs_ok=inb,
        present=torch.ones(n_frames, dtype=torch.bool, device=dev),
        free_frame=free,
        true_trans=t_dev,
        true_points=pts_dev,
    )


def build_scene(
    cfg: SlamConfig,
    n_frames: int = 6,
    n_points: int = 40,
    seed: int = 0,
    pixel_noise: float = 0.0,
    pose_noise: float = 0.0,
    point_noise: float = 0.0,
    device=None,
) -> Scene:
    """Populate a MapState with projected observations of a true scene.

    Noise arguments perturb what goes *into the state* (initial guesses);
    the returned ground truth stays exact. All points are observed by all
    frames where the cheirality test passes.
    """
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    tq, tt = make_trajectory(n_frames, cfg, device=dev)
    pts = make_points(n_points, rng, device=dev)
    k = torch.as_tensor(reference_intrinsics(cfg), device=dev)

    state = lm.empty(cfg, dev)
    state = lm.set_camera(state, 0, k.cpu())
    state = lm.set_camera(state, 1, k.cpu())

    # initial (noisy) state values
    nq, nt = tq, tt
    if pose_noise:
        # leave the first two frames exact (gauge anchor, like the ref's
        # pose init at main.cpp:540-552)
        dq = torch.as_tensor(rng.normal(scale=pose_noise, size=(n_frames, 3)).astype(np.float32),
                             device=dev)
        dt = torch.as_tensor(
            rng.normal(scale=pose_noise * 1000, size=(n_frames, 3)).astype(np.float32), device=dev)
        keep = (torch.arange(n_frames, device=dev) < 2)[:, None]
        nq = quat.retract(tq, torch.where(keep, 0.0, dq))
        nt = tt + torch.where(keep, 0.0, dt)
    npts = pts
    if point_noise:
        dp = torch.as_tensor(rng.normal(scale=point_noise, size=(n_points, 3)).astype(np.float32),
                             device=dev)
        npts = torch.cat([pts[:, :3] + dp, pts[:, 3:]], dim=1)

    state, _ = lm.add_points(state, npts, torch.ones(n_points, dtype=torch.bool, device=dev))

    ids = torch.arange(n_points, dtype=torch.int32, device=dev)
    for f in range(n_frames):
        state, fi = lm.add_frame(state, f % 2, nq[f], nt[f])
        px, valid = proj.project_point(tq[f], tt[f], k, pts)
        if pixel_noise:
            px = px + torch.as_tensor(
                rng.normal(scale=pixel_noise, size=tuple(px.shape)).astype(np.float32), device=dev)
        state = lm.add_observations(state, fi, ids, px, valid)

    return Scene(state=state, true_quat=tq, true_trans=tt, true_points=pts)
