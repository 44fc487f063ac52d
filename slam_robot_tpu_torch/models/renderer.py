"""Synthetic camera renderer: images from a landmark world.

Port of ``slam_robot_tpu/models/renderer.py``: point landmarks splatted as
Gaussian sprites at their projected sub-pixel locations over a fixed
low-frequency background, and the seeded landmark field ``make_world``.
The sprites are summed with ``index_put_(accumulate=True)``; on a CUDA
device that sum is atomic, in no fixed order, so a frame rendered there
matches one rendered on the CPU to ~1e-6, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.ops import projection as proj

STAMP = 9  # sprite support (pixels), odd


def _background(height: int, width: int, device=None):
    """The fixed low-frequency background on ``device`` (default: the card)."""
    device = default_device(device)
    y = torch.linspace(0, 2.5 * math.pi, height, device=device)[:, None]
    x = torch.linspace(0, 2.5 * math.pi, width, device=device)[None, :]
    return 0.45 + 0.08 * torch.sin(x) * torch.cos(0.7 * y)


def render(q, t, k, world_points, brightness, height: int = 480, width: int = 640,
           sigma: float = 1.3) -> torch.Tensor:
    """[H,W] f32 image of homogeneous ``world_points`` [P,4] with
    per-point ``brightness`` [P] from camera pose (q, t), intrinsics k."""
    dev = world_points.device
    px, valid = proj.project_point(q, t, k, world_points)
    inb = (valid & (px[:, 0] > -STAMP) & (px[:, 1] > -STAMP)
           & (px[:, 0] < width + STAMP) & (px[:, 1] < height + STAMP))

    half = STAMP // 2
    x0 = torch.floor(px[:, 0]).to(torch.int32) - half
    y0 = torch.floor(px[:, 1]).to(torch.int32) - half
    fx = px[:, 0] - x0.to(torch.float32)
    fy = px[:, 1] - y0.to(torch.float32)

    g = torch.arange(STAMP, dtype=torch.float32, device=dev)
    dx = g[None, None, :] - fx[:, None, None]          # [P,1,S]
    dy = g[None, :, None] - fy[:, None, None]          # [P,S,1]
    stamp = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    stamp = stamp * (brightness * inb.to(torch.float32))[:, None, None]

    pad = STAMP
    img = torch.zeros((height + 2 * pad, width + 2 * pad), dtype=torch.float32, device=dev)
    ys = (y0 + pad).clamp(0, height + 2 * pad - STAMP).long()
    xs = (x0 + pad).clamp(0, width + 2 * pad - STAMP).long()
    rows = ys[:, None, None] + g.long()[None, :, None]
    cols = xs[:, None, None] + g.long()[None, None, :]
    rows, cols = torch.broadcast_tensors(rows, cols)
    img.index_put_((rows, cols), stamp, accumulate=True)
    img = img[pad:-pad, pad:-pad]
    return torch.clamp(_background(height, width, dev) + img, 0.0, 1.0)


def make_world(n_points: int = 400, seed: int = 0, extent: float = 6000.0,
               depth=(1500.0, 8000.0)):
    """Random landmark field in front of the origin looking +z: (world [P,4]
    f32, brightness [P] f32) numpy arrays, from the same numpy draws as the
    JAX package's ``renderer.make_world``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent, extent, size=(n_points, 2))
    z = rng.uniform(*depth, size=(n_points, 1))
    pts = np.concatenate([xy, z, np.ones((n_points, 1))], axis=1).astype(np.float32)
    bright = rng.uniform(0.25, 0.6, size=n_points).astype(np.float32)
    return pts, bright
