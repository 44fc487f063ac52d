"""The bench scene: a panoramic alternating-stereo sweep over a 360-degree
ring world (port of ``slam_robot_tpu/utils/benchscene.py``).

The world and the poses come from the same numpy draws as the JAX package,
so both render the same frames (to the renderer's ~1e-6 accumulation
order on a CUDA device).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.models import renderer
from slam_robot_tpu_torch.ops import quaternion as quat
from slam_robot_tpu_torch.utils import synthetic


def sweep_pose(i: int):
    """Ground-truth pose of sweep frame ``i`` (alternating stereo pair)."""
    pair = i // 2
    yaw = 0.03 * min(pair, 48) + 0.02 * max(pair - 48, 0)
    t = np.array([150.0 * (i % 2), 0.0, 10.0 * pair], np.float32)
    return yaw, t


def make_world(seed: int = 0, n_world: int = 14000):
    """(world [N,4] f32, brightness [N] f32) numpy arrays of the ring world."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_world)
    rad = rng.uniform(2500.0, 9000.0, n_world)
    wx = rad * np.sin(ang)
    wz = rad * np.cos(ang)
    wy = rng.uniform(-2500.0, 2500.0, n_world)
    world = np.stack([wx, wy, wz, np.ones(n_world)], -1).astype(np.float32)
    bright = rng.uniform(0.35, 0.75, n_world).astype(np.float32)
    return world, bright


def make_frames(cfg, n_frames: int, seed: int = 0, device=None,
                start: int = 0) -> list[torch.Tensor]:
    """Render the sweep's frames ``start`` to ``start + n_frames - 1`` on
    ``device`` (default: the CUDA card). Returns a list of [H,W] f32."""
    device = default_device(device)
    k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device=device)
    world_np, bright_np = make_world(seed)
    world = torch.as_tensor(world_np, device=device)
    bright = torch.as_tensor(bright_np, device=device)
    axis = torch.tensor([0.0, 1.0, 0.0], device=device)
    frames = []
    for i in range(start, start + n_frames):
        yaw, tnp = sweep_pose(i)
        q = quat.from_axis_angle(axis, torch.tensor(yaw, dtype=torch.float32, device=device))
        frames.append(renderer.render(q, torch.as_tensor(tnp, device=device), k, world,
                                      bright, height=cfg.image_height,
                                      width=cfg.image_width))
    return frames
