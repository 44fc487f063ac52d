"""Synthetic camera renderer: images from a landmark world.

Port of ``slam_robot_tpu/models/renderer.py``: point landmarks splatted as
Gaussian sprites at their projected sub-pixel locations over a fixed
low-frequency background. The sprites are summed with
``index_put_(accumulate=True)``; on a CUDA device that sum is atomic, in
no fixed order, so a frame rendered there matches one rendered on the CPU
to ~1e-6, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from slam_robot_tpu_torch.ops import projection as proj

STAMP = 9  # sprite support (pixels), odd


def _background(height: int, width: int, device=None):
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
