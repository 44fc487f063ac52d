"""Offline debug renderer: the DrawDebug overlay (main.cpp:101-148) without
a GUI, reading the port's map tensors. Port of
``slam_robot_tpu/utils/debug_draw.py``; produces an RGB numpy image with
the reference's color code:

- green cross: new point (single observation)
- red cross (+ trail line to the previous observation): tracked point
- white trail: the newest observation is disabled (bad match)
- blue cross: point seen in the previous frame but not this one

Also ``patch_strip``: the mouse-hover patch-history inspector
(main.cpp:207-254) as an offline contact sheet around each observation.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_robot_tpu_torch.models import localmap as lm

GREEN = (0, 255, 0)
RED = (255, 0, 0)
BLUE = (0, 128, 255)
WHITE = (255, 255, 255)
BLACK = (0, 0, 0)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _cross(img, x, y, size, color):
    h, w, _ = img.shape
    for d in range(-size, size + 1):
        for dx, dy in ((d, d), (d, -d)):
            xi, yi = int(round(x + dx)), int(round(y + dy))
            if 0 <= xi < w and 0 <= yi < h:
                img[yi, xi] = color


def _line(img, x0, y0, x1, y1, color):
    h, w, _ = img.shape
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    for i in range(n + 1):
        t = i / n
        xi = int(round(x0 + (x1 - x0) * t))
        yi = int(round(y0 + (y1 - y0) * t))
        if 0 <= xi < w and 0 <= yi < h:
            img[yi, xi] = color


def draw_debug(state: lm.MapState, frame_img, frame_idx: int | None = None) -> np.ndarray:
    """Overlay point state onto ``frame_img`` ([H,W] grey or [H,W,3])."""
    img = _host(frame_img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = np.ascontiguousarray(
        np.clip(img * 255 if img.max() <= 1.0 else img, 0, 255).astype(np.uint8)
    )

    fid = int(state.n_frames) - 1 if frame_idx is None else int(frame_idx)
    idx1 = _host(state.recent_obs_index(1))
    idx2 = _host(state.recent_obs_index(2))
    obs_frame = _host(state.obs_frame)
    obs_px = _host(state.obs_px)
    obs_dis = _host(state.obs_disabled)
    totals = _host(state.point_obs_total)

    for p in range(int(state.n_points)):
        o1 = idx1[p]
        if o1 < 0:
            continue
        f1 = obs_frame[o1]
        if f1 == fid - 1:
            _cross(img, obs_px[o1, 0], obs_px[o1, 1], 2, BLUE)
            continue
        if f1 != fid:
            continue
        if totals[p] == 1:
            _cross(img, obs_px[o1, 0], obs_px[o1, 1], 2, GREEN)
            continue
        o2 = idx2[p]
        if o2 >= 0 and obs_frame[o2] == fid - 1:
            color = WHITE if obs_dis[o1] else BLACK
            _line(img, obs_px[o2, 0], obs_px[o2, 1], obs_px[o1, 0], obs_px[o1, 1], color)
        _cross(img, obs_px[o1, 0], obs_px[o1, 1], 3, RED)
    return img


def patch_strip(frame_img, centers, size: int = 13, scale: int = 8) -> np.ndarray:
    """Contact sheet of ``size``x``size`` patches around each center,
    upscaled: the offline analog of the patch-history inspector."""
    img = _host(frame_img)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114])
    h, w = img.shape
    half = size // 2
    tiles = []
    for (x, y) in centers:
        xi, yi = int(round(x)), int(round(y))
        x0, y0 = np.clip(xi - half, 0, w - size), np.clip(yi - half, 0, h - size)
        patch = img[y0 : y0 + size, x0 : x0 + size]
        tiles.append(np.kron(patch, np.ones((scale, scale))))
    if not tiles:
        return np.zeros((size * scale, size * scale))
    return np.concatenate(tiles, axis=1)
