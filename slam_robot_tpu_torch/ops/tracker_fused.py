"""Batched coarse-to-fine tracker driving the Newton track kernel.

Port of ``slam_robot_tpu/ops/tracker_fused.py`` (hessian.h:243-264 +
matcher.cpp:173-206). One tracking direction is one launch of the CUDA
kernel (``ops/cuda/newton.newton_track``): every pyramid level of every
lane, each lane's search window (<= 32x32, sized for the whole Newton
budget) cut from the level or read from the window cache, and, for the
forward pass, the backward reference stack sampled from those windows.

TPU-only structure is gone: the kernel runs on all F lanes with each
level's active mask (a done lane leaves its loop at once), so there is no
lane-bucket switch and no one-hot merge; windows are indexed directly from
the level instead of through a flat table and a one-hot column select.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.device import Counter, span
from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import tracker as tracker_ref
from slam_robot_tpu_torch.ops.cuda import newton as nk
from slam_robot_tpu_torch.ops.pyramid import PAD, FlatPyramid

WIN = nk.WIN

_static_dims = tracker_ref.pyramid_dims
_clean_pts = nk.clean_pts
_sample_from_windows = nk.sample_from_windows

# track_bidirectional_batch calls: each is one sweep, two kernel launches
SWEEPS = Counter()


def _gather_windows(pyr: FlatPyramid, level: int, pos, wh: int, ww: int):
    """Per-lane (wh x ww) windows around ``pos`` from one pyramid level:
    (win [F,wh,ww], org [F,2]) as ``newton.gather_windows``."""
    return nk.gather_windows(pyr.data, pyr.offset, level, _static_dims(pyr), pos, wh, ww)


def _extract_refs(ref_pyr: FlatPyramid, level: int, ref_pts, offs, size: int):
    """Per-lane reference patches for one level: extract at ref_pts / 2^level
    from ref_pyr (per-lane plane offs + level)."""
    h, w = _static_dims(ref_pyr)[level]
    return patch_ops.extract(ref_pyr.data, offs + level, w, h,
                             _clean_pts(ref_pts) / (2.0 ** level), size)


def pack_stacks(p: patch_ops.Patch) -> torch.Tensor:
    """Pack a per-level Patch stack [F, L, S, S] into [F, L, 2*S*S+2]
    (data | valid | mean | sumsq)."""
    F, L, S = p.data.shape[0], p.data.shape[1], p.data.shape[2]
    return torch.cat(
        [
            p.data.reshape(F, L, S * S),
            p.valid.to(torch.float32).reshape(F, L, S * S),
            p.mean[..., None],
            p.sumsq[..., None],
        ],
        dim=-1,
    )


def _extract_packed(ref_pyr: FlatPyramid, ref_pts, size: int) -> torch.Tensor:
    """The packed stacks [F, L, D] of every level, extracted at ref_pts."""
    F = ref_pts.shape[0]
    offs = torch.as_tensor(ref_pyr.offset, dtype=torch.long, device=ref_pts.device).expand(F)
    levels = [_extract_refs(ref_pyr, i, ref_pts, offs, size) for i in range(ref_pyr.depth)]
    return pack_stacks(patch_ops.Patch(*(torch.stack([getattr(p, f) for p in levels], 1)
                                         for f in patch_ops.Patch._fields)))


def track_feature_batch(pyr: FlatPyramid, pts, lvls, weight,
                        threshold: float = 0.001, max_iters: int = 10,
                        active=None, iters_coarse: int = 0,
                        ref_pyr: FlatPyramid | None = None, ref_pts=None,
                        packed=None, return_windows: bool = False,
                        win_cache=None, return_stack: bool = False):
    """Batched TrackFeature (hessian.h:243-264): coarse-to-fine cascade with
    per-lane dynamic level counts. pts [F,2].

    Reference patches come from ``packed`` (pack_stacks output [F, L, D])
    or ``ref_pyr``/``ref_pts`` (extracted per level, then packed). The
    search windows are cut from ``pyr`` or, with ``win_cache`` (wins
    [F, L, WIN, WIN], orgs [F, L, 2]), read from the cache. The JAX
    package's ``patches`` and ``packed_view_idx`` inputs have no caller on
    the port's path and are not ported.

    Returns (pos [F,2], ok [F] bool); with ``return_stack`` also the packed
    backward reference stack [F, L, D] sampled at pos from the windows
    (``newton.stack_from_windows``); with ``return_windows`` (CPU tensors:
    the plain path) the per-level (win [F,wh,ww], org [F,2]) list instead.
    """
    S = int(weight.shape[0])
    if max_iters > nk.MARGIN_PX - (S - 1) // 2:
        raise ValueError(
            f"max_iters={max_iters} exceeds the {WIN}x{WIN} window's Newton "
            f"budget ({nk.MARGIN_PX - (S - 1) // 2})"
        )
    if packed is None and (ref_pyr is None or ref_pts is None):
        raise ValueError("need packed or (ref_pyr, ref_pts)")
    if packed is None:
        packed = _extract_packed(ref_pyr, ref_pts, S)
    planes = None if win_cache is not None else pyr.data
    args = (pts, lvls, active, packed, weight, _static_dims(pyr), planes, pyr.offset,
            win_cache, threshold, max_iters, iters_coarse)
    if return_windows:
        if pts.is_cuda:
            raise ValueError("return_windows is the plain path's (CPU tensors)")
        return nk.track_levels(nk.newton_window_steps, *args, return_windows=True)
    return nk.newton_track(*args, stack=return_stack)


def get_patch_stacks(pyr: FlatPyramid, pts, size: int = 13) -> patch_ops.Patch:
    """Per-lane per-level reference patches: Patch with axes [F, L, ...]."""
    return tracker_ref.get_patch_stack(pyr, pts, size)


def get_patch_stacks_from_windows(pyr: FlatPyramid, pts, wins, orgs,
                                  size: int = 13) -> patch_ops.Patch:
    """get_patch_stacks read from the per-lane window cache
    (get_window_stacks at the SAME ``pts``) instead of the pyramid planes.

    The (S+1)^2 support is copied exactly out of the window (extract's
    clamped support start always lies inside the clamped window), then
    mixed with extract's own elementwise bilinear — the same values as
    plane extraction.
    """
    dims = _static_dims(pyr)
    K = pts.shape[0]
    S = size
    half = (S - 1) // 2
    dev = pts.device
    ar = torch.arange(S + 1, device=dev)
    out = []
    for i in range(pyr.depth):
        h, w = dims[i]
        org = orgs[:, i]
        p = _clean_pts(pts / (2.0 ** i))
        x, y = p[:, 0], p[:, 1]
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = x - x0.to(torch.float32)
        fy = y - y0.to(torch.float32)
        sy = torch.clamp(y0 - half + PAD, 0, h + 2 * PAD - (S + 1))
        sx = torch.clamp(x0 - half + PAD, 0, w + 2 * PAD - (S + 1))
        ry = (sy - (org[:, 1].to(torch.int32) + PAD)).long()
        rx = (sx - (org[:, 0].to(torch.int32) + PAD)).long()
        lanes = torch.arange(K, device=dev)[:, None, None]
        sup = wins[:, i][lanes, ry[:, None, None] + ar[None, :, None],
                         rx[:, None, None] + ar[None, None, :]]
        d = patch_ops.bilinear_mix(sup, fx, fy, S)
        valid = patch_ops.support_valid(x0, y0, w, h, S)
        n = S * S
        out.append(patch_ops.Patch(d, valid, torch.sum(d, dim=(1, 2)) / n,
                                   torch.sum(d * d, dim=(1, 2)) / n))
    return patch_ops.Patch(*(torch.stack([getattr(p, f) for p in out], 1)
                             for f in patch_ops.Patch._fields))


def get_window_stacks(pyr: FlatPyramid, pts):
    """Per-lane per-level search windows around ``pts`` (level-0 coords),
    zero-padded to [K, L, WIN, WIN], with origins [K, L, 2]."""
    dims = _static_dims(pyr)
    wins, orgs = [], []
    for i in range(pyr.depth):
        h, w = dims[i]
        wh, ww = min(WIN, h + 2 * PAD), min(WIN, w + 2 * PAD)
        win, org = _gather_windows(pyr, i, pts / (2.0 ** i), wh, ww)
        if wh < WIN or ww < WIN:
            win = torch.nn.functional.pad(win, (0, WIN - ww, 0, WIN - wh))
        wins.append(win)
        orgs.append(org)
    return torch.stack(wins, dim=1), torch.stack(orgs, dim=1)


@span("track_sweep")
def track_bidirectional_batch(pyr_from: FlatPyramid, pyr_to: FlatPyramid,
                              from_pt, init_to_pt, lvls, weight,
                              threshold: float = 0.001, max_iters: int = 10,
                              iters_coarse: int = 0,
                              roundtrip_px: float = 0.3,
                              min_variance: float = 1e-5,
                              active=None, p1_packed=None, bwd_lvls=None,
                              bwd_ref_from_window: bool = False,
                              bwd_win_cache=None):
    """Batched forward/backward consistency tracking (matcher.cpp:173-206).

    ``p1_packed`` [F, L, D] supplies packed reference stacks at ``from_pt``
    in ``pyr_from`` (the matcher's per-view cache); otherwise they are
    extracted. With ``bwd_ref_from_window`` the backward pass samples its
    reference patches from the forward pass's own windows (the forward
    launch's epilogue on the card); with ``bwd_win_cache`` it reads its
    search windows from the cache. Two kernel launches on the card.
    Returns (to_pt [F,2], ok [F] bool).
    """
    SWEEPS.n += 1
    F = from_pt.shape[0]
    dev = from_pt.device
    if active is None:
        active = torch.ones((F,), dtype=torch.bool, device=dev)
    S = int(weight.shape[0])
    packed_bwd = None
    if p1_packed is not None:
        fwd = track_feature_batch(
            pyr_to, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=active, packed=p1_packed,
            return_stack=bwd_ref_from_window,
        )
        if bwd_ref_from_window:
            to_pt, ok1, packed_bwd = fwd
        else:
            to_pt, ok1 = fwd
        tex_mean = p1_packed[:, 0, 2 * S * S]
        tex_sumsq = p1_packed[:, 0, 2 * S * S + 1]
    else:
        to_pt, ok1 = track_feature_batch(
            pyr_to, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=active, ref_pyr=pyr_from,
            ref_pts=from_pt,
        )
        offs = torch.as_tensor(pyr_from.offset, dtype=torch.long, device=dev).expand(F)
        p0 = _extract_refs(pyr_from, 0, from_pt, offs, S)
        tex_mean, tex_sumsq = p0.mean, p0.sumsq

    blvls = lvls if bwd_lvls is None else bwd_lvls
    if packed_bwd is not None:
        back_pt, ok2 = track_feature_batch(
            pyr_from, from_pt, blvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=ok1, packed=packed_bwd,
            win_cache=bwd_win_cache,
        )
    else:
        back_pt, ok2 = track_feature_batch(
            pyr_from, from_pt, blvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=ok1, ref_pyr=pyr_to, ref_pts=to_pt,
            win_cache=bwd_win_cache,
        )

    textured = (tex_sumsq - tex_mean ** 2) >= min_variance
    dist = torch.linalg.norm(from_pt - back_pt, dim=-1)
    ok = ok1 & ok2 & textured & (dist <= roundtrip_px)
    return to_pt, ok
