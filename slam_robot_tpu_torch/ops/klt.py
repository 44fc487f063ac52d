"""KLT patch tracker (klt.h rebuilt; the reference's alternate tracker).

Port of ``slam_robot_tpu/ops/klt.py``, batched over lanes as
``ops/tracker`` is. Forward-additive Lucas-Kanade with analytic spatial
gradients and gain/bias-compensated residuals, the "equation 15" system
klt.h builds (klt.h:294-331) before its ``#if 1`` block overrides it with
the numeric BruteHessian step:

    per iteration at position x:
        I  = patch(image, x), with gradients gx, gy (half-pixel central
             differences of the bilinear surface)
        e  = T - alpha*I - beta   (gain/bias compensated residual)
        G  = sum w [gx,gy][gx,gy]^T ;  b = sum w e [gx,gy] / alpha
        x += G^-1 b, clamped to unit norm, converged when |d| < threshold

Same level cascade, masking and loop rules as ``ops/tracker``: a Python
loop of ``max_iters`` trips with a per-lane done mask, no host read.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import tracker
from slam_robot_tpu_torch.ops.patch import Patch
from slam_robot_tpu_torch.ops.pyramid import FlatPyramid

_OOB = tracker.out_of_bounds


def _patch_and_grads(stack, index, width: int, height: int, pts, size: int = 13):
    """Bilinear patches [K, S, S] at ``pts`` plus their spatial gradients
    (half-pixel central differences of the sampled surface): the five
    extractions of the JAX package in one batched call."""
    K = pts.shape[0]
    hx, hy = 0.5 * torch.eye(2, dtype=torch.float32, device=pts.device)
    q = torch.cat([pts, pts + hx, pts - hx, pts + hy, pts - hy])
    idx = torch.as_tensor(index, dtype=torch.long, device=pts.device).expand(K).repeat(5)
    ex = patch_ops.extract(stack, idx, width, height, q, size)
    p0 = Patch(*(f[:K] for f in ex))
    d = ex.data[K:].reshape(4, K, size, size)
    return p0, d[0] - d[1], d[2] - d[3]


def track_level(stack, index, width: int, height: int, ref_patch: Patch, pts, weight,
                threshold: float = 0.001, max_iters: int = 10, size: int = 13,
                active=None):
    """KLT iterations of every lane against one pyramid level. Returns
    (new_pts [K,2], ok [K]); lanes with ``active`` False start done."""
    K = pts.shape[0]
    dev = pts.device
    active = tracker.active_mask(active, K, dev)
    xy = pts.to(torch.float32)
    ok = torch.ones((K,), dtype=torch.bool, device=dev)
    done = ~active
    wf, hf = float(width), float(height)
    for _ in range(max_iters):
        bad = _OOB(xy, wf, hf)
        cur, gx, gy = _patch_and_grads(stack, index, width, height, xy, size)
        alpha = torch.sqrt(ref_patch.sumsq / torch.clamp(cur.sumsq, min=1e-12))
        beta = ref_patch.mean - alpha * cur.mean
        e = ref_patch.data - cur.data * alpha[:, None, None] - beta[:, None, None]
        m = (ref_patch.valid & cur.valid).to(torch.float32) * weight
        gxx = torch.sum(m * gx * gx, dim=(1, 2))
        gxy = torch.sum(m * gx * gy, dim=(1, 2))
        gyy = torch.sum(m * gy * gy, dim=(1, 2))
        a = torch.clamp(alpha, min=1e-6)
        bx = torch.sum(m * e * gx, dim=(1, 2)) / a
        by = torch.sum(m * e * gy, dim=(1, 2)) / a
        det = gxx * gyy - gxy * gxy
        sdet = torch.where(torch.abs(det) > 1e-20, det, 1e-20)
        d = torch.stack([gyy * bx - gxy * by, gxx * by - gxy * bx], -1) / sdet[:, None]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        n = torch.linalg.norm(d, dim=-1, keepdim=True)
        d = torch.where(n > 1.0, d / torch.clamp(n, min=1e-20), d)
        new_xy = torch.where(bad[:, None], xy, xy + d)
        conv = (torch.abs(d[:, 0]) < threshold) & (torch.abs(d[:, 1]) < threshold)
        xy = torch.where(done[:, None], xy, new_xy)
        ok = ok & (done | ~bad)
        done = done | bad | conv
    return xy, ok & ~_OOB(xy, wf, hf)


def track_feature(pyr: FlatPyramid, patches: Patch, pts, lvls, weight,
                  threshold: float = 0.001, max_iters: int = 10, active=None):
    """Coarse-to-fine KLT with the contract of ``tracker.track_feature``."""
    dims = tracker.pyramid_dims(pyr)
    offs = tracker.lane_offsets(pyr, pts.shape[0], pts.device)
    S = int(weight.shape[0])

    def level(i, p, take):
        h, w = dims[i]
        return track_level(pyr.data, offs + i, w, h, tracker.level_patch(patches, i), p,
                           weight, threshold, max_iters, S, active=take)

    return tracker.cascade(pyr, pts, lvls, active, level)
