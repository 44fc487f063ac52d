"""Shi-Tomasi corner detection + spatial suppression.

Port of ``slam_robot_tpu/ops/corners.py``: goodFeaturesToTrack (120 corners
max, quality ratio 0.01, 20 px min distance; matcher.cpp:125-130) and the
30x30 occupancy grid that suppresses new corners near existing matches
(matcher.cpp:132-166).

The greedy min-distance walk over the response-ordered candidates is
inherently sequential (each acceptance depends on all earlier ones), so it
runs on the host over a 512x512 clash matrix copied once per keyframe.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam_robot_tpu_torch.device import SYNCS

_SOBEL_X = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8.0
_SOBEL_Y = _SOBEL_X.T
_BOX3 = np.ones((3, 3)) / 9.0


def _conv2(img, k):
    """3x3 correlation, zero-padded SAME, as shifted adds (row-major taps)."""
    H, W = img.shape
    x = F.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            kv = float(k[dy, dx])
            if kv != 0.0:
                out = out + kv * x[dy: dy + H, dx: dx + W]
    return out


def min_eig_response(img) -> torch.Tensor:
    """cornerMinEigenVal: smaller eigenvalue of the 3x3-summed structure
    tensor of Sobel gradients."""
    ix = _conv2(img, _SOBEL_X)
    iy = _conv2(img, _SOBEL_Y)
    a = _conv2(ix * ix, _BOX3)
    b = _conv2(ix * iy, _BOX3)
    c = _conv2(iy * iy, _BOX3)
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.5 * (a - c) * 0.5 * (a - c) + b * b, min=0.0))
    return half_tr - disc


def _greedy_accept(clash: np.ndarray, ok: np.ndarray, max_corners: int) -> np.ndarray:
    """Accept candidates in order unless they clash with an accepted one."""
    n = ok.shape[0]
    acc = np.zeros(n, bool)
    n_acc = 0
    for i in range(n):
        if n_acc >= max_corners:
            break
        if ok[i] and not np.any(acc & clash[i]):
            acc[i] = True
            n_acc += 1
    return acc


def detect(img, max_corners: int = 120, quality: float = 0.01,
           min_distance: float = 20.0, candidates: int = 512,
           border: int = 8):
    """goodFeaturesToTrack equivalent. Returns (pts[max_corners,2] f32 (x,y),
    valid[max_corners] bool), corners ordered by decreasing response.
    ``border`` pixels at the image edge are excluded."""
    h, w = img.shape
    dev = img.device
    r = min_eig_response(img)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    neg_inf = torch.full_like(r, -float("inf"))
    r = torch.where(inside, r, neg_inf)

    # 3x3 non-max suppression (max_pool2d pads with -inf) + quality threshold
    rmax = F.max_pool2d(r[None, None], 3, stride=1, padding=1)[0, 0]
    thresh = quality * torch.max(r)
    peak = (r >= rmax) & (r > thresh)
    score = torch.where(peak, r, neg_inf)

    # top-K candidates by response; a stable sort orders ties by index
    flat = score.reshape(-1)
    idx = torch.argsort(-flat, stable=True)[:candidates]
    vals = flat[idx]
    cy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    cx = (idx % w).to(torch.float32)
    cand = torch.stack([cx, cy], dim=1)
    cand_ok = torch.isfinite(vals)

    md2 = min_distance * min_distance
    d2 = torch.sum((cand[:, None, :] - cand[None, :, :]) ** 2, dim=-1)
    clash = d2 < md2
    SYNCS.n += 1
    acc_np = _greedy_accept(clash.cpu().numpy(), cand_ok.cpu().numpy(), max_corners)
    acc = torch.as_tensor(acc_np, device=dev)

    sel = torch.argsort((~acc).to(torch.int8), stable=True)[:max_corners]
    accepted = acc[sel]
    pts = torch.where(accepted[:, None], cand[sel], torch.zeros_like(cand[sel]))
    return pts, accepted


def _cell(px, extent: int, grid: int):
    return (px / extent * grid).to(torch.int32) + 1


def occupancy_grid(match_px, match_valid, width: int, height: int,
                   grid: int = 30) -> torch.Tensor:
    """30x30 occupancy of existing matches, 3x3 dilated (matcher.cpp:132-151).
    Returns bool[grid+2, grid+2] in the reference's 1-offset indexing.

    Cells outside the grid are dropped, as the reference's scatter drops
    them: dropped writes go to one extra scratch row that is sliced off."""
    n = grid + 2
    gx = _cell(match_px[:, 0], width, grid)
    gy = _cell(match_px[:, 1], height, grid)
    occ = torch.zeros((n + 1, n), dtype=torch.bool, device=match_px.device)
    ones = torch.ones_like(match_valid)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ix = (gx + dx).long()
            iy = (gy + dy).long()
            # negative indices wrap as in the reference's scatter
            ix = torch.where(ix < 0, ix + n, ix)
            iy = torch.where(iy < 0, iy + n, iy)
            keep = match_valid & (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
            occ = occ.index_put((torch.where(keep, ix, n), torch.where(keep, iy, 0)), ones)
    return occ[:n]


def suppress_by_grid(pts, valid, occ, width: int, height: int,
                     grid: int = 30) -> torch.Tensor:
    """Drop candidate corners whose (undilated) cell is occupied
    (matcher.cpp:153-166)."""
    gx = _cell(pts[:, 0], width, grid).clamp(0, grid + 1).long()
    gy = _cell(pts[:, 1], height, grid).clamp(0, grid + 1).long()
    return valid & ~occ[gx, gy]
