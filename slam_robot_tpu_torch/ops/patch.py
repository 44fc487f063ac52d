"""Sub-pixel patch extraction and photometric-invariant scoring.

Port of ``slam_robot_tpu/ops/patch.py`` (hessian.h:11-30, 54-93, 129-141):
an (S+1)x(S+1) support slice of an edge-padded pyramid plane plus a bilinear
mix, validity from the bilinear support inside the true image, and the
gain/bias-compensated weighted SSD. :func:`extract` is batched: one patch
per row of ``pts``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from slam_robot_tpu_torch.ops.pyramid import PAD


class Patch(NamedTuple):
    data: torch.Tensor    # [..., S, S] f32
    valid: torch.Tensor   # [..., S, S] bool
    mean: torch.Tensor    # [...] sum/S^2 (over all pixels, like the ref)
    sumsq: torch.Tensor   # [...] sum of squares / S^2


@functools.cache
def _radial_mask_np(size: int, bias: float):
    x = np.arange(size, dtype=np.float32)
    rx = 0.5 * size - x
    rr = rx[None, :] ** 2 + rx[:, None] ** 2
    m = 1.0 / (bias + rr)
    return m * (size * size / np.sum(m))


def radial_mask(size: int = 13, bias: float = 15.0, device=None) -> torch.Tensor:
    """1/(bias + r^2) about the (0.5*size) corner-offset center, normalized
    to mean 1 (hessian.h:11-30)."""
    return torch.tensor(_radial_mask_np(size, float(bias)), dtype=torch.float32,
                        device=device)


def bilinear_mix(sup: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                 size: int) -> torch.Tensor:
    """extract's elementwise mix of a [K, S+1, S+1] support (fx, fy: [K])."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    S = size
    return (
        (1 - fy) * (1 - fx) * sup[:, :S, :S]
        + (1 - fy) * fx * sup[:, :S, 1:]
        + fy * (1 - fx) * sup[:, 1:, :S]
        + fy * fx * sup[:, 1:, 1:]
    )


def support_valid(x0: torch.Tensor, y0: torch.Tensor, width, height,
                  size: int) -> torch.Tensor:
    """[K,S,S] bool: bilinear support inside the true image (x0, y0 are
    floor(pt) as int32, width/height scalars or [K])."""
    half = (size - 1) // 2
    ar = torch.arange(size, dtype=torch.float32, device=x0.device)
    w = torch.as_tensor(width, dtype=torch.float32, device=x0.device).reshape(-1, 1)
    h = torch.as_tensor(height, dtype=torch.float32, device=x0.device).reshape(-1, 1)
    gx = x0.to(torch.float32)[:, None] + ar[None, :] - half
    gy = y0.to(torch.float32)[:, None] + ar[None, :] - half
    vx = (gx >= 0) & (gx + 1 <= w)
    vy = (gy >= 0) & (gy + 1 <= h)
    return vy[:, :, None] & vx[:, None, :]


def extract(stack: torch.Tensor, index, width, height, pts: torch.Tensor,
            size: int = 13) -> Patch:
    """Patches of ``size``^2 centered at sub-pixel ``pts`` [K,2] (x, y).

    ``stack`` is [N, Hp, Wp] of edge-padded planes and ``index`` [K] (or an
    int) picks each row's plane; ``width``/``height`` (ints or [K] int
    tensors) are the plane's true extents. Equivalent to getRectSubPix with
    replicate border (hessian.h:77-83); the support slice is clamped inside
    the plane's padded extent like the reference.
    """
    K = pts.shape[0]
    dev = pts.device
    half = (size - 1) // 2
    x, y = pts[:, 0], pts[:, 1]
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)

    wt = torch.as_tensor(width, dtype=torch.int32, device=dev).expand(K)
    ht = torch.as_tensor(height, dtype=torch.int32, device=dev).expand(K)
    sy = torch.minimum(torch.clamp(y0 - half + PAD, min=0), ht + 2 * PAD - (size + 1))
    sx = torch.minimum(torch.clamp(x0 - half + PAD, min=0), wt + 2 * PAD - (size + 1))
    idx = torch.as_tensor(index, dtype=torch.long, device=dev).expand(K)
    ar = torch.arange(size + 1, device=dev)
    rows = sy.long()[:, None, None] + ar[None, :, None]
    cols = sx.long()[:, None, None] + ar[None, None, :]
    sup = stack[idx[:, None, None], rows, cols]          # [K, S+1, S+1]

    p = bilinear_mix(sup, fx, fy, size)
    valid = support_valid(x0, y0, wt, ht, size)
    n = size * size
    return Patch(
        data=p,
        valid=valid,
        mean=torch.sum(p, dim=(1, 2)) / n,
        sumsq=torch.sum(p * p, dim=(1, 2)) / n,
    )


def score(p1: Patch, p2: Patch, weight: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lighting-invariant weighted SSD (hessian.h:129-141)."""
    alpha = torch.sqrt(p1.sumsq / torch.clamp(p2.sumsq, min=eps))
    beta = p1.mean - alpha * p2.mean
    diff = p1.data - p2.data * alpha[..., None, None] - beta[..., None, None]
    ok = p1.valid & p2.valid
    return torch.sum(torch.where(ok, diff * diff * weight, torch.zeros_like(diff)),
                     dim=(-2, -1))
