"""Coarse-to-fine Newton tracker: the CUDA kernel ``csrc/newton.cu`` and its
plain PyTorch versions.

Counterpart of ``slam_robot_tpu/ops/pallas/newton.py`` (``_kernel`` via
``newton_level``; math in ``_newton_iter``) and of the level loop of
``slam_robot_tpu/ops/tracker_fused.py`` around it. :func:`newton_track` runs
every pyramid level of one tracking direction in one launch (and, for the
forward pass, samples the backward reference stack); :func:`newton_level`
is one level of the same kernel on given windows. Their plain versions are
:func:`track_levels` (the per-level loop, parameterised by its level
solver) with :func:`newton_window_steps`, which runs the Newton iteration
vectorized over lanes with gathered bilinear taps. A CUDA tensor always
goes to the kernel; a CPU tensor always goes to the plain version. There is
no fallback.
"""

from __future__ import annotations

import functools

import torch

from slam_robot_tpu_torch.ops.cuda import build
from slam_robot_tpu_torch.ops.cuda.blur import PAD

KERNEL = build.Kernel("newton_track", "slam_robot_tpu_torch/csrc/newton.cu")

OK = 0.0
OUT_OF_BOUNDS = 2.0

_MARGIN = 0.01   # hessian.h:196
MARGIN_PX = 12   # window margin: 6 Newton px + 6 patch half + bilinear fits 32
SIZE = 13        # the kernel's compiled patch size (kWindowSize, matcher.cpp:27)
WIN = 32         # search window (>= 13 + 1 bilinear + 2 * Newton budget, cap 32)
MAX_LEVELS = 8   # csrc/newton.cu kMaxLevels


def _oob(x, y, width, height):
    return ((x < _MARGIN) | (y < _MARGIN)
            | (x + _MARGIN > width) | (y + _MARGIN > height))


def bilinear(a, b, c, d, fx, fy):
    """A bilinear patch from its taps a (i, j), b (i, j+1), c (i+1, j), d
    (i+1, j+1), rows first: (p2, d/dx, d/dy, d2/dxdy)."""
    t0 = (1.0 - fy) * a + fy * c
    t1 = (1.0 - fy) * b + fy * d
    s0 = c - a
    s1 = d - b
    return (1.0 - fx) * t0 + fx * t1, t1 - t0, (1.0 - fx) * s0 + fx * s1, s1 - s0


def score_terms(p2, u, v, puv, ref, w, r_mean, r_sumsq, eps: float = 1e-12):
    """The gain/bias-normalized SSD of each lane's patch and its exact
    derivatives in the patch position (x, y): (s, gx, gy, hxx, hxy, hyy),
    each [F].

    p2 [F,S,S] is the bilinear patch, u, v its d/dx, d/dy and puv its
    d2/dxdy (d2/dx2 = d2/dy2 = 0); alpha = sqrt(r_sumsq / max(mean(p2^2),
    eps)), beta = r_mean - alpha * mean(p2), means over all S*S pixels;
    s = sum(w (ref - alpha p2 - beta)^2).
    """
    F, S = p2.shape[0], p2.shape[1]
    n = S * S

    def mean2(t):
        return t.reshape(F, n).sum(1) / n

    m2 = mean2(p2)
    ss2 = mean2(p2 * p2)
    ss2s = torch.clamp(ss2, min=eps)
    gate = (ss2 > eps).to(torch.float32)
    m2x = mean2(u)
    m2y = mean2(v)
    m2xy = mean2(puv)
    ss2x = 2.0 * mean2(p2 * u) * gate
    ss2y = 2.0 * mean2(p2 * v) * gate
    ss2xx = 2.0 * mean2(u * u) * gate
    ss2yy = 2.0 * mean2(v * v) * gate
    ss2xy = 2.0 * mean2(u * v + p2 * puv) * gate

    alpha = torch.sqrt(r_sumsq / ss2s)
    rx = ss2x / ss2s
    ry = ss2y / ss2s
    ax = -0.5 * alpha * rx
    ay = -0.5 * alpha * ry
    axx = -0.5 * (ax * rx + alpha * (ss2xx / ss2s - rx * rx))
    ayy = -0.5 * (ay * ry + alpha * (ss2yy / ss2s - ry * ry))
    axy = -0.5 * (ay * rx + alpha * (ss2xy / ss2s - rx * ry))
    bx = -ax * m2 - alpha * m2x
    by = -ay * m2 - alpha * m2y
    bxx = -axx * m2 - 2.0 * ax * m2x
    byy = -ayy * m2 - 2.0 * ay * m2y
    bxy = -axy * m2 - ax * m2y - ay * m2x - alpha * m2xy
    beta = r_mean - alpha * m2

    def bc(s):
        return s[:, None, None]

    e = ref - bc(alpha) * p2 - bc(beta)
    ex = -bc(ax) * p2 - bc(alpha) * u - bc(bx)
    ey = -bc(ay) * p2 - bc(alpha) * v - bc(by)
    exx = -bc(axx) * p2 - 2.0 * bc(ax) * u - bc(bxx)
    eyy = -bc(ayy) * p2 - 2.0 * bc(ay) * v - bc(byy)
    exy = -bc(axy) * p2 - bc(ax) * v - bc(ay) * u - bc(alpha) * puv - bc(bxy)

    def sum2(t):
        return t.reshape(F, n).sum(1)

    return (sum2(w * e * e), 2.0 * sum2(w * e * ex), 2.0 * sum2(w * e * ey),
            2.0 * sum2(w * (ex * ex + e * exx)), 2.0 * sum2(w * (ex * ey + e * exy)),
            2.0 * sum2(w * (ey * ey + e * eyy)))


def _newton_iter(pos, status, done, win_flat, WW, org, ref, w_rv, r_mean,
                 r_sumsq, width, height, threshold: float, S: int, WH: int):
    """One Newton step for all lanes; done lanes pass through unchanged."""
    F = pos.shape[0]
    half = (S - 1) // 2
    x, y = pos[:, 0], pos[:, 1]
    oob = _oob(x, y, width, height)

    lx = x - org[:, 0]
    ly = y - org[:, 1]
    x0f = torch.floor(lx)
    y0f = torch.floor(ly)
    fx = (lx - x0f)[:, None, None]
    fy = (ly - y0f)[:, None, None]
    x0 = x0f.to(torch.int32) - half
    y0 = y0f.to(torch.int32) - half
    x0c = torch.clamp(x0, 0, WW - (S + 1)).long()
    y0c = torch.clamp(y0, 0, WH - (S + 1)).long()

    ar = torch.arange(S, device=pos.device)
    base = (y0c[:, None, None] + ar[None, :, None]) * WW \
        + x0c[:, None, None] + ar[None, None, :]              # [F,S,S]
    flat = base.reshape(F, S * S)

    def tap(off):
        return torch.gather(win_flat, 1, flat + off).reshape(F, S, S)

    p2, u, v, puv = bilinear(tap(0), tap(1), tap(WW), tap(WW + 1), fx, fy)

    gx = (x0 + org[:, 0].to(torch.int32))[:, None] + ar[None, :]
    gy = (y0 + org[:, 1].to(torch.int32))[:, None] + ar[None, :]
    vx = (gx >= 0) & (gx.to(torch.float32) + 1.0 <= width[:, None])
    vy = (gy >= 0) & (gy.to(torch.float32) + 1.0 <= height[:, None])
    valid2 = vy[:, :, None] & vx[:, None, :]
    w2 = torch.where(valid2, w_rv, torch.zeros_like(w_rv))

    _, gx_, gy_, hxx, hxy, hyy = score_terms(p2, u, v, puv, ref, w2, r_mean, r_sumsq)

    det = hxx * hyy - hxy * hxy
    tiny = torch.where(det >= 0, torch.full_like(det, 1e-20), torch.full_like(det, -1e-20))
    safe = torch.where(torch.abs(det) > 1e-20, det, tiny)
    dx = -(hyy * gx_ - hxy * gy_) / safe
    dy = -(-hxy * gx_ + hxx * gy_) / safe
    finite = (torch.abs(dx) < 1e20) & (torch.abs(dy) < 1e20)
    dx = torch.where(finite, dx, torch.zeros_like(dx))
    dy = torch.where(finite, dy, torch.zeros_like(dy))

    nrm = torch.sqrt(dx * dx + dy * dy)
    scale = torch.where(nrm > 1.0, 1.0 / torch.clamp(nrm, min=1e-20), torch.ones_like(nrm))
    dx = dx * scale
    dy = dy * scale
    sx = torch.clamp(dx, -1.0, 1.0)
    sy = torch.clamp(dy, -1.0, 1.0)
    converged = (torch.abs(dx) < threshold) & (torch.abs(dy) < threshold)

    move = (~oob) & ~done
    new_pos = torch.stack([torch.where(move, x + sx, x), torch.where(move, y + sy, y)], -1)
    new_status = torch.where(~done & oob, torch.full_like(status, OUT_OF_BOUNDS), status)
    new_done = done | oob | converged
    return new_pos, new_status, new_done


def newton_window_steps(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq,
                        active, wmask, bounds, threshold: float,
                        max_iters: int, size: int = SIZE):
    """Plain version: ``max_iters`` Newton steps for all lanes against their
    windows. Shapes as :func:`newton_level`. Returns (pos [F,2], status [F])."""
    F, WH, WW = win.shape
    width = bounds[:, 0]
    height = bounds[:, 1]
    pos = pos0
    status = torch.zeros((F,), dtype=torch.float32, device=pos0.device)
    done = ~((1.0 - active) < 0.5)
    win_flat = win.reshape(F, WH * WW)
    w_rv = wmask[None] * ref_valid
    for _ in range(int(max_iters)):
        pos, status, done = _newton_iter(
            pos, status, done, win_flat, WW, org, ref, w_rv, ref_mean,
            ref_sumsq, width, height, float(threshold), int(size), WH,
        )
    final_oob = _oob(pos[:, 0], pos[:, 1], width, height)
    status = torch.where(final_oob & (active > 0.5),
                         torch.full_like(status, OUT_OF_BOUNDS), status)
    return pos, status


def clean_pts(pts):
    """NaN to 0, then clamp to +-1e6 (window origins stay finite ints)."""
    return torch.clamp(torch.nan_to_num(pts, nan=0.0, posinf=1e6, neginf=-1e6), -1e6, 1e6)


def level_table(dims, max_iters: int, iters_coarse: int = 0) -> dict:
    """What the cascade reads per level i of a pyramid with level ``dims``
    [(h, w), ...]: the dims, the (wh, ww) search window (WIN, or the padded
    level where that is smaller: 31x32 at 15x20), and the Newton budget
    (``max_iters`` at level 0, ``min(iters_coarse, max_iters)`` above it
    when ``iters_coarse`` is set). Made once per set of arguments."""
    return _level_table(tuple(map(tuple, dims)), int(max_iters), int(iters_coarse))


@functools.cache
def _level_table(dims, max_iters: int, iters_coarse: int) -> dict:
    return dict(
        h=tuple(h for h, _ in dims), w=tuple(w for _, w in dims),
        wh=tuple(min(WIN, h + 2 * PAD) for h, _ in dims),
        ww=tuple(min(WIN, w + 2 * PAD) for _, w in dims),
        iters=tuple(max_iters if i == 0 or not iters_coarse else min(iters_coarse, max_iters)
                    for i in range(len(dims))))


def plane_index(offset, level: int, n: int, device) -> torch.Tensor:
    """[n] plane of each lane's ``level`` in a stack: ``offset`` (an int or a
    per-lane tensor) + level."""
    if isinstance(offset, int):
        return torch.full((n,), offset + level, dtype=torch.long, device=device)
    return offset.to(torch.long).expand(n) + level


def gather_windows(planes, offset, level: int, dims, pos, wh: int, ww: int):
    """Per-lane (wh x ww) windows around ``pos`` from one level of the
    edge-padded planes [P, Hp, Wp] (level ``level`` of each lane's pyramid at
    plane ``offset + level``, true size ``dims[level]``).

    Returns (win [F,wh,ww], org [F,2] absolute level coords of win[0,0]).
    Window origins are clamped inside the level's padded extent, so edge
    windows stay flush with the padded border and the Newton support clamp
    reproduces patch.extract's replicate-edge behavior.
    """
    h, w = dims[level]
    hp, wp = h + 2 * PAD, w + 2 * PAD
    F = pos.shape[0]
    dev = pos.device
    j = plane_index(offset, level, F, dev)
    p = clean_pts(pos)
    ox = torch.clamp(torch.floor(p[:, 0]).to(torch.int32) - MARGIN_PX + PAD, 0, wp - ww)
    oy = torch.clamp(torch.floor(p[:, 1]).to(torch.int32) - MARGIN_PX + PAD, 0, hp - wh)
    win = cut_windows(planes, j, ox, oy, wh, ww)
    org = torch.stack([ox - PAD, oy - PAD], -1).to(torch.float32)
    return win, org


def cut_windows(planes, j, ox, oy, wh: int, ww: int):
    """planes[j, oy:oy+wh, ox:ox+ww] per lane (padded-plane coordinates)."""
    dev = ox.device
    rows = oy.long()[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    cols = ox.long()[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    return planes[j[:, None, None], rows, cols]


def sample_from_windows(win, org, pt, w_img: float, h_img: float, size: int):
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
    p = clean_pts(pt)
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


def stack_from_windows(windows, pos, dims, size: int = SIZE):
    """The packed backward reference stack [F, L, 2*S*S+2] (data | valid |
    mean | sumsq) sampled at ``pos / 2^lv`` from the per-level windows
    [(win, org), ...] that the forward pass cut (the plain version of
    :func:`newton_track`'s epilogue)."""
    F = pos.shape[0]
    S = size
    cols = []
    for lv, (winl, orgl) in enumerate(windows):
        h, w = dims[lv]
        d, v, m, sq = sample_from_windows(winl, orgl, pos / (2.0 ** lv), float(w), float(h), S)
        cols.append(torch.cat([d.reshape(F, S * S), v.reshape(F, S * S),
                               m[:, None], sq[:, None]], dim=-1))
    return torch.stack(cols, dim=1)


def stack_at_origins(planes, offset, dims, pos, orgs, size: int = SIZE):
    """:func:`stack_from_windows` with each level's window cut at the given
    origins [F, L, 2] (level coords of win[0,0], as ``newton_track(...,
    origins=True)`` returns them): the epilogue's plain version on the
    kernel's own windows."""
    table = level_table(dims, 0)
    windows = []
    for lv, (wh, ww) in enumerate(zip(table["wh"], table["ww"])):
        org = orgs[:, lv]
        ox = org[:, 0].to(torch.int32) + PAD
        oy = org[:, 1].to(torch.int32) + PAD
        j = plane_index(offset, lv, pos.shape[0], pos.device)
        windows.append((cut_windows(planes, j, ox, oy, wh, ww), org.contiguous()))
    return stack_from_windows(windows, pos, dims, size)


def origin_mismatches(planes, dims, orgs, plain_orgs, starts, tol: float = 2e-3) -> int:
    """Lane-levels whose window origin in ``orgs`` [F, L, 2] (as
    ``newton_track(..., origins=True)`` returns them) differs from
    ``plain_orgs`` (the plain loop's) and is not the origin of a start
    within ``tol`` px of ``starts[lv]``, the plain loop's [F, 2] start at
    level lv: a start on a pixel boundary floors either way."""
    table = level_table(dims, 0)
    n = 0
    for lv, (start, wh, ww) in enumerate(zip(starts, table["wh"], table["ww"])):
        lo = gather_windows(planes, 0, lv, dims, start - tol, wh, ww)[1]
        hi = gather_windows(planes, 0, lv, dims, start + tol, wh, ww)[1]
        org = orgs[:, lv]
        off = (org != plain_orgs[:, lv]).any(-1) & ~((lo <= org) & (org <= hi)).all(-1)
        n += int(off.sum())
    return n


def track_levels(solver, pts, lvls, active, packed, wmask, dims, planes=None, offset=0,
                 win_cache=None, threshold: float = 0.001, max_iters: int = 6,
                 iters_coarse: int = 0, return_windows: bool = False):
    """The coarse-to-fine cascade (hessian.h:243-264) level by level, each
    level through ``solver`` (the signature of :func:`newton_level`):
    with :func:`newton_window_steps` the plain version of
    :func:`newton_track`, with :func:`newton_level` its one-launch-per-level
    route. Arguments as :func:`newton_track`.

    Returns (pos [F,2], ok [F] bool) and, with ``return_windows``, the
    per-level (win [F,wh,ww], org [F,2]) list as a third element.
    """
    S = int(wmask.shape[0])
    L = len(dims)
    F = pts.shape[0]
    dev = pts.device
    table = level_table(dims, max_iters, iters_coarse)
    lvls = torch.as_tensor(lvls, dtype=torch.int32, device=dev).expand(F)
    if active is None:
        active = torch.ones((F,), dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)

    scale0 = torch.pow(2.0, (lvls - 1).to(torch.float32))
    pos = pts.to(torch.float32) / scale0[:, None]
    status = torch.zeros((F,), dtype=torch.float32, device=dev)
    windows = [None] * L

    for k in range(L):
        i = L - 1 - k
        wh, ww = table["wh"][i], table["ww"][i]
        lvl_on = i <= lvls - 1
        take = lvl_on & (status == 0.0) & active

        if win_cache is not None:
            win = win_cache[0][:, i, :wh, :ww].contiguous()
            org = win_cache[1][:, i].contiguous()
        else:
            win, org = gather_windows(planes, offset, i, dims, pos, wh, ww)
        if return_windows:
            windows[i] = (win, org)
        pk = packed[:, i]
        bounds = torch.empty((F, 2), dtype=torch.float32, device=dev)
        bounds[:, 0] = float(table["w"][i])
        bounds[:, 1] = float(table["h"][i])
        new_pos, st = solver(
            win, pos.contiguous(), org, pk[:, : S * S].reshape(F, S, S).contiguous(),
            pk[:, S * S: 2 * S * S].reshape(F, S, S).contiguous(),
            pk[:, 2 * S * S].contiguous(), pk[:, 2 * S * S + 1].contiguous(),
            take.to(torch.float32), wmask, bounds, threshold=float(threshold),
            max_iters=int(table["iters"][i]), size=S,
        )
        pos = torch.where(take[:, None], new_pos, pos)
        status = torch.where(take, st, status)
        if i > 0:
            pos = torch.where(lvl_on[:, None], pos * 2.0, pos)

    ok = (status == 0.0) & active
    if return_windows:
        return pos, ok, windows
    return pos, ok


# csrc/newton.cu's TrackParams, field for field
TRACK_PARAMS = build.Params(
    (("planes", "P", 1), ("plane_off", "P", 1), ("win", "P", 1), ("win_org", "P", 1),
     ("ref", "P", 4), ("pts", "P", 1), ("lvls", "P", 1), ("active", "P", 1), ("wmask", "P", 1),
     ("bounds", "P", 1), ("pos_out", "P", 1), ("status_out", "P", 1), ("ok_out", "P", 1),
     ("stack_out", "P", 1), ("org_out", "P", 1),
     ("plane_base", "q", 1), ("win_lane", "q", 1), ("win_level", "q", 1), ("org_lane", "q", 1),
     ("ref_lane", "q", 4), ("ref_level", "i", 4),
     ("Hp", "i", 1), ("Wp", "i", 1), ("win_row", "i", 1), ("org_level", "i", 1),
     ("lvls_const", "i", 1), ("active_kind", "i", 1), ("ref_vec16", "i", 1),
     ("win_vec16", "i", 1), ("F", "i", 1), ("L", "i", 1),
     ("h", "i", MAX_LEVELS), ("w", "i", MAX_LEVELS), ("wh", "i", MAX_LEVELS),
     ("ww", "i", MAX_LEVELS), ("iters", "i", MAX_LEVELS), ("threshold", "f", 1)),
    "newton_track_params_size")

ACTIVE_ALL, ACTIVE_BOOL, ACTIVE_FLOAT = 0, 1, 2


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _aligned16(ptr: int, *strides: int) -> bool:
    """16-byte copies are possible: the address and every float stride."""
    return ptr % 16 == 0 and all(s % 4 == 0 for s in strides)


def track_params(*, F: int, table: dict, pts, lvls, active, wmask, refs, ref_vec16: bool,
                 pos_out, threshold: float, planes=None, offset=0, windows=None,
                 bounds=None, status_out=None, ok_out=None, stack_out=None,
                 org_out=None) -> dict:
    """The kernel's parameter block by field (``TRACK_PARAMS``), from
    tensors already checked.

    ``lvls`` an int or an int32 [F] tensor; ``active`` None, bool [F] or
    float [F]; ``refs`` four (pointer, lane stride, level stride) of the
    reference data, valid, mean and sumsq (floats); ``offset`` an int or an
    int64 [F] tensor (the planes source); ``windows`` (win, org) with win
    [F, L, R, C] and org [F, L, 2], inner strides 1 (the explicit source);
    ``table`` from :func:`level_table`, or its one-level counterpart.
    """
    p = dict(
        pts=pts.data_ptr(), wmask=wmask.data_ptr(), bounds=_ptr(bounds),
        pos_out=pos_out.data_ptr(), status_out=_ptr(status_out), ok_out=_ptr(ok_out),
        stack_out=_ptr(stack_out), org_out=_ptr(org_out), F=F, L=len(table["wh"]),
        threshold=float(threshold), ref_vec16=int(ref_vec16),
        ref=tuple(r[0] for r in refs), ref_lane=tuple(r[1] for r in refs),
        ref_level=tuple(r[2] for r in refs),
        **{k: tuple(table[k]) for k in ("h", "w", "wh", "ww", "iters")})
    if isinstance(lvls, int):
        p["lvls_const"] = lvls
    else:
        p["lvls"] = lvls.data_ptr()
    if active is not None:
        p["active"] = active.data_ptr()
        p["active_kind"] = ACTIVE_BOOL if active.dtype == torch.bool else ACTIVE_FLOAT
    if windows is not None:
        win, org = windows
        fits = all((c + 3) // 4 * 4 <= win.stride(2) for c in table["ww"])
        p.update(win=win.data_ptr(), win_org=org.data_ptr(), win_lane=win.stride(0),
                 win_level=win.stride(1), win_row=win.stride(2), org_lane=org.stride(0),
                 org_level=org.stride(1),
                 win_vec16=int(fits and _aligned16(win.data_ptr(), *win.stride()[:3])))
    else:
        p.update(planes=planes.data_ptr(), Hp=planes.shape[1], Wp=planes.shape[2])
        if isinstance(offset, int):
            p["plane_base"] = offset
        else:
            p["plane_off"] = offset.data_ptr()
    return p


def packed_refs(packed, size: int = SIZE):
    """``refs`` of :func:`track_params` for a packed stack [F, L, 2*S*S+2]
    (read in place) and whether 16-byte copies can read it."""
    n = size * size
    ptr, lane, level = packed.data_ptr(), packed.stride(0), packed.stride(1)
    refs = [(ptr + 4 * off, lane, level) for off in (0, n, 2 * n, 2 * n + 1)]
    return refs, _aligned16(ptr, lane, level)


def _check(t, name: str, shape, dtype=torch.float32, inner: int = 1):
    """A CUDA tensor of ``dtype`` and ``shape`` whose last ``inner`` axes
    are contiguous (the kernel reads the outer ones through strides)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    want = 1
    for ax in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        if t.shape[ax] > 1 and t.stride(ax) != want:
            raise ValueError(f"{name}: its inner axes must be contiguous")
        want *= t.shape[ax]


def newton_track_plain(pts, lvls, active, packed, wmask, dims, planes=None, offset=0,
                       win_cache=None, threshold: float = 0.001, max_iters: int = 6,
                       iters_coarse: int = 0, stack: bool = False):
    """Plain version of :func:`newton_track`: the level loop with
    :func:`newton_window_steps`, then the stack from the cut windows."""
    res = track_levels(newton_window_steps, pts, lvls, active, packed, wmask, dims,
                       planes, offset, win_cache, threshold, max_iters, iters_coarse,
                       return_windows=stack)
    if not stack:
        return res
    pos, ok, windows = res
    return pos, ok, stack_from_windows(windows, pos, dims, int(wmask.shape[0]))


def newton_track(pts, lvls, active, packed, wmask, dims, planes=None, offset=0,
                 win_cache=None, threshold: float = 0.001, max_iters: int = 6,
                 iters_coarse: int = 0, stack: bool = False, origins: bool = False):
    """Coarse-to-fine Newton tracking of F lanes over every level of their
    pyramids, in one launch on the card.

    pts [F,2] level-0 start (x, y); lvls (int or [F] int) levels each lane
    runs (the cascade starts at level lvls-1); active None or [F] bool;
    packed [F, L, 2*S*S+2] reference stacks; wmask [S,S]; dims the L level
    sizes [(h, w), ...]. Search windows come from ``planes`` [P, Hp, Wp]
    (edge-padded levels, each lane's pyramid at plane ``offset`` (int or
    [F]) + level) or from ``win_cache`` (wins [F, L, WIN, WIN], orgs
    [F, L, 2]). The Newton budget per level is :func:`level_table`'s.

    Returns (pos [F,2], ok [F] bool); with ``stack`` also the packed
    backward reference stack [F, L, 2*S*S+2] sampled at pos / 2^lv from the
    lane's level windows (:func:`stack_from_windows`); with ``origins``
    (card only) also the window origins [F, L, 2] it used.
    """
    S = int(wmask.shape[0])
    L = len(dims)
    F = pts.shape[0]
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"need 1 to {MAX_LEVELS} levels, got {L}")
    if (planes is None) == (win_cache is None):
        raise ValueError("need exactly one window source: planes or win_cache")
    if not pts.is_cuda:
        if origins:
            raise ValueError("origins: the kernel's output, on CUDA tensors only")
        return newton_track_plain(pts, lvls, active, packed, wmask, dims, planes, offset,
                                  win_cache, threshold, max_iters, iters_coarse, stack)
    if S != SIZE:
        raise ValueError(f"the CUDA kernel is compiled for {SIZE}x{SIZE} patches")
    dev = pts.device
    D = 2 * S * S + 2
    _check(pts, "pts", (F, 2), inner=2)
    _check(packed, "packed", (F, L, D))
    _check(wmask, "wmask", (S, S), inner=2)
    if not isinstance(lvls, int):
        lvls = lvls.to(device=dev, dtype=torch.int32).expand(F).contiguous()
    if active is not None:
        active = active.expand(F).contiguous()
        if not active.is_cuda or active.dtype not in (torch.bool, torch.float32):
            raise ValueError("active: expected a CUDA bool or float32 tensor")
    windows = None
    if win_cache is not None:
        windows = win_cache
        _check(windows[0], "win_cache[0]", (F, L, WIN, WIN))
        _check(windows[1], "win_cache[1]", (F, L, 2))
    else:
        build.check_cuda(planes, "planes")
        if not isinstance(offset, int):
            offset = offset.to(device=dev, dtype=torch.long).expand(F).contiguous()
    table = level_table(dims, max_iters, iters_coarse)
    refs, vec16 = packed_refs(packed, S)
    pos = torch.empty((F, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((F,), dtype=torch.bool, device=dev)
    out_stack = torch.empty((F, L, D), dtype=torch.float32, device=dev) if stack else None
    out_org = torch.empty((F, L, 2), dtype=torch.float32, device=dev) if origins else None
    params = track_params(
        F=F, table=table, pts=pts, lvls=lvls, active=active, wmask=wmask, refs=refs,
        ref_vec16=vec16, pos_out=pos, threshold=threshold, planes=planes, offset=offset,
        windows=windows, ok_out=ok, stack_out=out_stack, org_out=out_org)
    KERNEL.launch(TRACK_PARAMS.block(**params), build.stream_handle(dev))
    return (pos, ok) + ((out_stack,) if stack else ()) + ((out_org,) if origins else ())


def newton_level(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
                 wmask, bounds, threshold: float = 0.001, max_iters: int = 6,
                 size: int = SIZE, group: int = 1):
    """Batched per-level Newton refinement. Returns (pos [F,2], status [F]).

    win [F,WH,WW] (14 <= WH, WW <= 32) level pixels whose [0,0] sits at the
    absolute level coords ``org`` [F,2]; pos0 [F,2] start (x, y); ref and
    ref_valid [F,S,S]; ref_mean, ref_sumsq, active [F] (active 1/0);
    wmask [S,S]; bounds [F,2] the level's true (width, height). All float32.
    On the card it is one level of :func:`newton_track`'s kernel with these
    windows as its source.

    ``group`` G: the JAX kernel stacks G lanes into one MXU contraction
    (``_sample_grouped``, newton.py:79-150), bit-identical to G = 1 under
    sequential accumulation. This kernel has no cross-lane contraction (one
    lane per block, direct bilinear taps), so every G runs the same kernel,
    and the same plain version, as G = 1. The JAX function's preconditions
    hold: G >= 1 and F % G == 0 (there a reshape's TypeError).
    """
    F = win.shape[0]
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if F % group:
        raise TypeError(f"cannot group {F} lanes into groups of {group} "
                        f"({F} % {group} != 0)")
    if not win.is_cuda:
        return newton_window_steps(win, pos0, org, ref, ref_valid, ref_mean,
                                   ref_sumsq, active, wmask, bounds, threshold,
                                   max_iters, size)
    if int(size) != SIZE:
        raise ValueError(f"the CUDA kernel is compiled for {SIZE}x{SIZE} patches")
    F, WH, WW = win.shape
    if not (SIZE + 1 <= WH <= WIN and SIZE + 1 <= WW <= WIN):
        raise ValueError(f"window {WH}x{WW} outside [14, {WIN}]")
    S = SIZE
    for name, t, shape in (
        ("win", win, (F, WH, WW)), ("pos0", pos0, (F, 2)), ("org", org, (F, 2)),
        ("ref", ref, (F, S, S)), ("ref_valid", ref_valid, (F, S, S)),
        ("ref_mean", ref_mean, (F,)), ("ref_sumsq", ref_sumsq, (F,)),
        ("active", active, (F,)), ("wmask", wmask, (S, S)),
        ("bounds", bounds, (F, 2)),
    ):
        build.check_cuda(t, name, shape)
    pos = torch.empty((F, 2), dtype=torch.float32, device=win.device)
    status = torch.empty((F,), dtype=torch.float32, device=win.device)
    table = dict(h=[0], w=[0], wh=[WH], ww=[WW], iters=[int(max_iters)])
    refs = [(ref.data_ptr(), S * S, 0), (ref_valid.data_ptr(), S * S, 0),
            (ref_mean.data_ptr(), 1, 0), (ref_sumsq.data_ptr(), 1, 0)]
    params = track_params(
        F=F, table=table, pts=pos0, lvls=1, active=active, wmask=wmask, refs=refs,
        ref_vec16=False, pos_out=pos, threshold=threshold,
        windows=(win[:, None], org[:, None]), bounds=bounds, status_out=status)
    KERNEL.launch(TRACK_PARAMS.block(**params), build.stream_handle(win.device))
    return pos, status
