"""Batched coarse-to-fine tracker driving the fused Newton level kernel.

Port of ``slam_robot_tpu/ops/tracker_fused.py`` (hessian.h:243-264 +
matcher.cpp:173-206). Per pyramid level, every lane's search window
(<= 32x32, sized for the whole Newton budget) is cut ONCE from the level,
and all Newton iterations for all lanes run in ONE launch of the CUDA
kernel (``ops/cuda/newton``).

TPU-only structure is gone: the kernel runs on all F lanes with the
level's active mask (a done lane leaves its loop at once), so there is no
lane-bucket switch and no one-hot merge; windows are indexed directly from
the level instead of through a flat table and a one-hot column select.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.device import span
from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import tracker as tracker_ref
from slam_robot_tpu_torch.ops.cuda.newton import MARGIN_PX, newton_level
from slam_robot_tpu_torch.ops.pyramid import PAD, FlatPyramid

WIN = 32  # search window (>= 13 + 1 bilinear + 2 * Newton budget, cap 32)

_static_dims = tracker_ref.pyramid_dims


def _clean_pts(pts):
    return torch.clamp(torch.nan_to_num(pts, nan=0.0, posinf=1e6, neginf=-1e6), -1e6, 1e6)


def _gather_windows(pyr: FlatPyramid, level: int, pos, wh: int, ww: int):
    """Per-lane (wh x ww) windows around ``pos`` from one pyramid level.

    Returns (win [F,wh,ww], org [F,2] absolute level coords of win[0,0]).
    Window origins are clamped inside the level's padded extent, so edge
    windows stay flush with the padded border and the kernel's support
    clamp reproduces patch.extract's replicate-edge behavior.
    """
    h, w = _static_dims(pyr)[level]
    hp, wp = h + 2 * PAD, w + 2 * PAD
    F = pos.shape[0]
    dev = pos.device
    j = torch.as_tensor(pyr.offset, dtype=torch.long, device=dev).expand(F) + level
    p = _clean_pts(pos)
    ox = torch.clamp(torch.floor(p[:, 0]).to(torch.int32) - MARGIN_PX + PAD, 0, wp - ww)
    oy = torch.clamp(torch.floor(p[:, 1]).to(torch.int32) - MARGIN_PX + PAD, 0, hp - wh)
    rows = oy.long()[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    cols = ox.long()[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    win = pyr.data[j[:, None, None], rows, cols]
    org = torch.stack([ox - PAD, oy - PAD], -1).to(torch.float32)
    return win, org


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


def _unpack(pk, S: int):
    """Inverse of pack_stacks for one level: pk [C, 2*S*S+2]."""
    C = pk.shape[0]
    refd = pk[:, : S * S].reshape(C, S, S)
    refv = pk[:, S * S: 2 * S * S].reshape(C, S, S)
    return refd, refv, pk[:, 2 * S * S], pk[:, 2 * S * S + 1]


def _sample_from_windows(win, org, pt, w_img: float, h_img: float, size: int):
    """Bilinear S x S patch at level coords ``pt`` from per-lane windows.

    Mirrors patch.extract with the WINDOW as the pixel source: support
    clamps to the window extent; validity requires the bilinear support
    inside BOTH the true image and the window (support that drifted past
    the window margin is masked invalid).

    win [F,wh,ww], org [F,2], pt [F,2]. Returns (data [F,S,S],
    valid [F,S,S] f32, mean [F], sumsq [F]).
    """
    F, wh, ww = win.shape
    S = size
    half = (S - 1) // 2
    dev = win.device
    p = _clean_pts(pt)
    lx = p[:, 0] - org[:, 0]
    ly = p[:, 1] - org[:, 1]
    x0f = torch.floor(lx)
    y0f = torch.floor(ly)
    fx = (lx - x0f)[:, None, None]
    fy = (ly - y0f)[:, None, None]
    x0 = x0f.to(torch.int32) - half
    y0 = y0f.to(torch.int32) - half
    x0c = torch.clamp(x0, 0, ww - (S + 1)).long()
    y0c = torch.clamp(y0, 0, wh - (S + 1)).long()

    ar = torch.arange(S, device=dev)
    flat = ((y0c[:, None, None] + ar[None, :, None]) * ww
            + x0c[:, None, None] + ar[None, None, :]).reshape(F, S * S)
    wf = win.reshape(F, wh * ww)

    def tap(off):
        return torch.gather(wf, 1, flat + off).reshape(F, S, S)

    t0 = (1.0 - fy) * tap(0) + fy * tap(ww)
    t1 = (1.0 - fy) * tap(1) + fy * tap(ww + 1)
    data = (1.0 - fx) * t0 + fx * t1

    gx = (x0 + org[:, 0].to(torch.int32))[:, None] + ar[None, :]
    gy = (y0 + org[:, 1].to(torch.int32))[:, None] + ar[None, :]
    vx = (gx >= 0) & (gx.to(torch.float32) + 1.0 <= w_img)
    vy = (gy >= 0) & (gy.to(torch.float32) + 1.0 <= h_img)
    wx = (x0[:, None] + ar >= 0) & (x0[:, None] + ar + 1 <= ww)
    wyv = (y0[:, None] + ar >= 0) & (y0[:, None] + ar + 1 <= wh)
    valid = ((vy & wyv).to(torch.float32)[:, :, None]
             * (vx & wx).to(torch.float32)[:, None, :])
    mean = torch.mean(data, dim=(1, 2))
    sumsq = torch.mean(data * data, dim=(1, 2))
    return data, valid, mean, sumsq


def track_feature_batch(pyr: FlatPyramid, pts, lvls, weight,
                        threshold: float = 0.001, max_iters: int = 10,
                        active=None, iters_coarse: int = 0,
                        ref_pyr: FlatPyramid | None = None, ref_pts=None,
                        packed=None, return_windows: bool = False,
                        win_cache=None):
    """Batched TrackFeature (hessian.h:243-264): coarse-to-fine cascade with
    per-lane dynamic level counts. pts [F,2].

    Reference patches come from ``packed`` (pack_stacks output [F, L, D])
    or ``ref_pyr``/``ref_pts`` (extracted per level). ``win_cache``
    (wins [F, L, WIN, WIN], orgs [F, L, 2]) supplies pre-cut search
    windows. The JAX package's ``patches`` and ``packed_view_idx`` inputs
    have no caller on the port's path and are not ported.

    Returns (pos [F,2], ok [F] bool) and, with ``return_windows``, the
    per-level (win [F,wh,ww], org [F,2]) list as a third element.
    """
    S = int(weight.shape[0])
    if max_iters > MARGIN_PX - (S - 1) // 2:
        raise ValueError(
            f"max_iters={max_iters} exceeds the {WIN}x{WIN} window's Newton "
            f"budget ({MARGIN_PX - (S - 1) // 2})"
        )
    if packed is None and (ref_pyr is None or ref_pts is None):
        raise ValueError("need packed or (ref_pyr, ref_pts)")
    dims = _static_dims(pyr)
    L = pyr.depth
    F = pts.shape[0]
    dev = pts.device
    lvls = torch.as_tensor(lvls, dtype=torch.int32, device=dev).expand(F)
    if active is None:
        active = torch.ones((F,), dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    roffs = (torch.as_tensor(ref_pyr.offset, dtype=torch.long, device=dev).expand(F)
             if ref_pyr is not None else None)

    scale0 = torch.pow(2.0, (lvls - 1).to(torch.float32))
    pos = pts.to(torch.float32) / scale0[:, None]
    status = torch.zeros((F,), dtype=torch.float32, device=dev)
    windows = [None] * L

    for k in range(L):
        i = L - 1 - k
        h, w = dims[i]
        wh, ww = min(WIN, h + 2 * PAD), min(WIN, w + 2 * PAD)
        lvl_on = i <= lvls - 1
        take = lvl_on & (status == 0.0) & active

        if win_cache is not None:
            win = win_cache[0][:, i, :wh, :ww].contiguous()
            org = win_cache[1][:, i].contiguous()
        else:
            win, org = _gather_windows(pyr, i, pos, wh, ww)
        if return_windows:
            windows[i] = (win, org)
        if packed is not None:
            refd, refv, refm, refs = _unpack(packed[:, i], S)
        else:
            p = _extract_refs(ref_pyr, i, ref_pts, roffs, S)
            refd, refv, refm, refs = p.data, p.valid.to(torch.float32), p.mean, p.sumsq
        bounds = torch.tensor([float(w), float(h)], dtype=torch.float32,
                              device=dev).expand(F, 2).contiguous()
        iters = max_iters if i == 0 or not iters_coarse else min(iters_coarse, max_iters)
        new_pos, st = newton_level(
            win, pos.contiguous(), org, refd.contiguous(), refv.contiguous(),
            refm.contiguous(), refs.contiguous(), take.to(torch.float32),
            weight, bounds, threshold=float(threshold), max_iters=int(iters), size=S,
        )
        pos = torch.where(take[:, None], new_pos, pos)
        status = torch.where(take, st, status)
        if i > 0:
            pos = torch.where(lvl_on[:, None], pos * 2.0, pos)

    ok = (status == 0.0) & active
    if return_windows:
        return pos, ok, windows
    return pos, ok


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
    reference patches from the forward pass's own windows; with
    ``bwd_win_cache`` it reads its search windows from the cache.
    Returns (to_pt [F,2], ok [F] bool).
    """
    F = from_pt.shape[0]
    dev = from_pt.device
    if active is None:
        active = torch.ones((F,), dtype=torch.bool, device=dev)
    S = int(weight.shape[0])
    fwd_windows = None
    if p1_packed is not None:
        fwd = track_feature_batch(
            pyr_to, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=active, packed=p1_packed,
            return_windows=bwd_ref_from_window,
        )
        if bwd_ref_from_window:
            to_pt, ok1, fwd_windows = fwd
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
    if fwd_windows is not None:
        dims = _static_dims(pyr_to)
        cols = []
        for lv, (winl, orgl) in enumerate(fwd_windows):
            h, w = dims[lv]
            d, v, m, sq = _sample_from_windows(winl, orgl, to_pt / (2.0 ** lv),
                                               float(w), float(h), S)
            cols.append(torch.cat([d.reshape(F, S * S), v.reshape(F, S * S),
                                   m[:, None], sq[:, None]], dim=-1))
        packed_bwd = torch.stack(cols, dim=1)
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
