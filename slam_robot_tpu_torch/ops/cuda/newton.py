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


def newton_level(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
                 wmask, bounds, threshold: float = 0.001, max_iters: int = 6,
                 size: int = SIZE, group: int = 1):
    """Batched per-level Newton refinement. Returns (pos [F,2], status [F]).

    win [F,WH,WW] (14 <= WH, WW <= 32) level pixels whose [0,0] sits at the
    absolute level coords ``org`` [F,2]; pos0 [F,2] start (x, y); ref and
    ref_valid [F,S,S]; ref_mean, ref_sumsq, active [F] (active 1/0);
    wmask [S,S]; bounds [F,2] the level's true (width, height). All float32.

    ``group`` G: the JAX kernel stacks G lanes into one MXU contraction
    (``_sample_grouped``, newton.py:79-150), bit-identical to G = 1 under
    sequential accumulation. This kernel has no cross-lane contraction (one
    warp per lane, direct bilinear taps), so every G runs the same kernel,
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
    KERNEL.launch(
        win.data_ptr(), pos0.data_ptr(), org.data_ptr(), ref.data_ptr(),
        ref_valid.data_ptr(), ref_mean.data_ptr(), ref_sumsq.data_ptr(),
        active.data_ptr(), wmask.data_ptr(), bounds.data_ptr(),
        pos.data_ptr(), status.data_ptr(), F, WH, WW, float(threshold),
        int(max_iters), build.stream_handle(win.device),
    )
    return pos, status
