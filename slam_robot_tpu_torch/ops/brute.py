"""Brute-force SAD template tracker (brute.h rebuilt; the reference's
alternate, unused matcher).

Port of ``slam_robot_tpu/ops/brute.py``, batched over lanes. Per pyramid
level a grid scan of gain/bias-normalized SAD over a +-window
(SearchBest, brute.h:96-117), coarse to fine with +-3 px / 1 px and +-1 px
/ 1/3 px scans at each level and a shrinking-step cascade (1 -> 1/81 px) at
level 0 (brute.h:144-158); a match whose final SAD exceeds
``sad_threshold`` is rejected (the reference's literal default of 100 is
inert on [0,1]-scaled patches; a well-matched textured patch lands around
0.3-1.0).

Each scan is one batched extract and SAD over every lane's (2h+1)^2
candidates. The best candidate is the first minimum in the scan's
row-major order, as ``jnp.argmin`` picks it, so a tie picks the same grid
point on every device. The matcher does not reach this tracker, in the
JAX package either: it is a library function.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import tracker
from slam_robot_tpu_torch.ops.patch import Patch
from slam_robot_tpu_torch.ops.pyramid import FlatPyramid

_SUBPIXEL_STEPS = (1.0, 1 / 3, 1 / 9, 1 / 27, 1 / 81)


def sad(p1: Patch, p2: Patch, eps: float = 1e-12) -> torch.Tensor:
    """Gain/bias-normalized sum of absolute differences (brute.h:82-94),
    over the patches' last two axes (leading axes broadcast)."""
    alpha = torch.sqrt(p1.sumsq / torch.clamp(p2.sumsq, min=eps))
    beta = p1.mean - alpha * p2.mean
    diff = torch.abs(p1.data - p2.data * alpha[..., None, None] - beta[..., None, None])
    ok = p1.valid & p2.valid
    return torch.sum(torch.where(ok, diff, torch.zeros_like(diff)), dim=(-2, -1))


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (a NaN counts as the
    minimum, as in ``jnp.argmin``), stated so on every device rather than
    left to a reduction's tie order."""
    key = torch.where(torch.isnan(x), float("-inf"), x)
    low = torch.amin(key, dim=-1, keepdim=True)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.amin(torch.where(key == low, pos, x.shape[-1]), dim=-1)


def search_best(stack, index, width: int, height: int, ref_patch: Patch, pts, step: float,
                half_steps: int = 3, size: int = 13):
    """Grid scan (SearchBest, brute.h:96-117): SAD of each lane's reference
    [K, S, S] on the (2h+1)^2 grid of offsets ``step`` apart around
    ``pts`` [K, 2], in plane ``index`` (int or [K]) of ``stack``. Returns
    (best_pts [K, 2], best_sad [K])."""
    K = pts.shape[0]
    dev = pts.device
    n = 2 * half_steps + 1
    offs = torch.arange(-half_steps, half_steps + 1, dtype=torch.float32, device=dev)
    offs = offs * torch.full((), step, dtype=torch.float32, device=dev)
    # meshgrid's "xy" order raveled: candidate r*n + c is (offs[c], offs[r])
    grid = torch.stack([offs.repeat(n), offs.repeat_interleave(n)], -1)
    cand = pts[:, None, :] + grid[None]                          # [K, n*n, 2]
    idx = torch.as_tensor(index, dtype=torch.long, device=dev).expand(K)
    cur = patch_ops.extract(stack, idx.repeat_interleave(n * n), width, height,
                            cand.reshape(-1, 2), size)
    cur = Patch(*(f.reshape((K, n * n) + f.shape[1:]) for f in cur))
    ref = Patch(*(f[:, None] for f in ref_patch))
    sads = sad(ref, cur)                                         # [K, n*n]
    best = first_argmin(sads)
    lanes = torch.arange(K, device=dev)
    return cand[lanes, best], sads[lanes, best]


def track_feature(pyr: FlatPyramid, patches: Patch, pts, lvls,
                  sad_threshold: float = 100.0, size: int = 13):
    """Coarse-to-fine cascade (brute.h:144-158): at every level from lvls-1
    down, a +-3 px scan at 1 px (brute.h:147) then a +-1 px scan at 1/3 px
    (brute.h:148), x2 between levels; then the sub-pixel cascade at level 0.
    ``patches`` [K, L, ...] are the reference stacks. Returns (pts, ok)."""
    dims = tracker.pyramid_dims(pyr)
    K = pts.shape[0]
    dev = pts.device
    offs = tracker.lane_offsets(pyr, K, dev)
    lvls = torch.as_tensor(lvls, dtype=torch.int32, device=dev).expand(K)
    p = pts.to(torch.float32) / (2.0 ** (lvls - 1)).to(torch.float32)[:, None]
    best_sad = torch.full((K,), float("inf"), dtype=torch.float32, device=dev)
    for i in range(pyr.depth - 1, -1, -1):
        active = i <= lvls - 1
        h, w = dims[i]
        rp = tracker.level_patch(patches, i)
        new_p, s = search_best(pyr.data, offs + i, w, h, rp, p, 1.0, size=size)
        new_p, s = search_best(pyr.data, offs + i, w, h, rp, new_p, 1.0 / 3.0, size=size)
        p = torch.where(active[:, None], new_p, p)
        if i == 0:
            best_sad = torch.where(active, s, best_sad)
        else:
            p = torch.where(active[:, None], p * 2.0, p)
    h, w = dims[0]
    rp = tracker.level_patch(patches, 0)
    for step in _SUBPIXEL_STEPS:
        p, best_sad = search_best(pyr.data, offs, w, h, rp, p, step, size=size)
    return p, best_sad <= sad_threshold
