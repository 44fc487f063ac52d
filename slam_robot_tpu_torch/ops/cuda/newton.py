"""Fused per-level Newton tracker: the CUDA kernel ``csrc/newton.cu`` and its
plain PyTorch version.

Counterpart of ``slam_robot_tpu/ops/pallas/newton.py`` (``_kernel`` via
``newton_level``; math in ``_newton_iter``). The plain version below,
:func:`newton_window_steps`, runs the same iteration vectorized over lanes
with gathered bilinear taps. A CUDA tensor always goes to the kernel; a CPU
tensor always goes to the plain version. There is no fallback.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops.cuda import build

KERNEL = build.Kernel("newton_level", "slam_robot_tpu_torch/csrc/newton.cu")

OK = 0.0
OUT_OF_BOUNDS = 2.0

_MARGIN = 0.01   # hessian.h:196
MARGIN_PX = 12   # window margin: 6 Newton px + 6 patch half + bilinear fits 32
SIZE = 13        # the kernel's compiled patch size (kWindowSize, matcher.cpp:27)


def _oob(x, y, width, height):
    return ((x < _MARGIN) | (y < _MARGIN)
            | (x + _MARGIN > width) | (y + _MARGIN > height))


def _newton_iter(pos, status, done, win_flat, WW, org, ref, w_rv, r_mean,
                 r_sumsq, width, height, threshold: float, S: int, WH: int):
    """One Newton step for all lanes; done lanes pass through unchanged."""
    F = pos.shape[0]
    half = (S - 1) // 2
    eps = 1e-12
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

    a, b, c, d = tap(0), tap(1), tap(WW), tap(WW + 1)
    t0 = (1.0 - fy) * a + fy * c
    t1 = (1.0 - fy) * b + fy * d
    s0 = c - a
    s1 = d - b
    p2 = (1.0 - fx) * t0 + fx * t1
    u = t1 - t0
    v = (1.0 - fx) * s0 + fx * s1
    puv = s1 - s0

    gx = (x0 + org[:, 0].to(torch.int32))[:, None] + ar[None, :]
    gy = (y0 + org[:, 1].to(torch.int32))[:, None] + ar[None, :]
    vx = (gx >= 0) & (gx.to(torch.float32) + 1.0 <= width[:, None])
    vy = (gy >= 0) & (gy.to(torch.float32) + 1.0 <= height[:, None])
    valid2 = vy[:, :, None] & vx[:, None, :]
    w2 = torch.where(valid2, w_rv, torch.zeros_like(w_rv))

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

    gx_ = 2.0 * sum2(w2 * e * ex)
    gy_ = 2.0 * sum2(w2 * e * ey)
    hxx = 2.0 * sum2(w2 * (ex * ex + e * exx))
    hyy = 2.0 * sum2(w2 * (ey * ey + e * eyy))
    hxy = 2.0 * sum2(w2 * (ex * ey + e * exy))

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


def newton_level(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
                 wmask, bounds, threshold: float = 0.001, max_iters: int = 6,
                 size: int = SIZE, group: int = 1):
    """Batched per-level Newton refinement. Returns (pos [F,2], status [F]).

    win [F,WH,WW] (14 <= WH, WW <= 32) level pixels whose [0,0] sits at the
    absolute level coords ``org`` [F,2]; pos0 [F,2] start (x, y); ref and
    ref_valid [F,S,S]; ref_mean, ref_sumsq, active [F] (active 1/0);
    wmask [S,S]; bounds [F,2] the level's true (width, height). All float32.
    ``group`` > 1 (the JAX kernel's lanes-per-MXU-op layout) is not ported.
    """
    if group != 1:
        raise NotImplementedError(
            f"newton_level(group={group}) is not ported yet; see ROADMAP.md item "
            "A19 (off-by-default knobs)")
    if not win.is_cuda:
        return newton_window_steps(win, pos0, org, ref, ref_valid, ref_mean,
                                   ref_sumsq, active, wmask, bounds, threshold,
                                   max_iters, size)
    if int(size) != SIZE:
        raise ValueError(f"the CUDA kernel is compiled for {SIZE}x{SIZE} patches")
    F, WH, WW = win.shape
    if not (SIZE + 1 <= WH <= 32 and SIZE + 1 <= WW <= 32):
        raise ValueError(f"window {WH}x{WW} outside [14, 32]")
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
    err = KERNEL.fn()(
        win.data_ptr(), pos0.data_ptr(), org.data_ptr(), ref.data_ptr(),
        ref_valid.data_ptr(), ref_mean.data_ptr(), ref_sumsq.data_ptr(),
        active.data_ptr(), wmask.data_ptr(), bounds.data_ptr(),
        pos.data_ptr(), status.data_ptr(), F, WH, WW, float(threshold),
        int(max_iters), build.stream_handle(win.device),
    )
    build.check_launch(KERNEL.name, err)
    KERNEL.launches += 1
    return pos, status
