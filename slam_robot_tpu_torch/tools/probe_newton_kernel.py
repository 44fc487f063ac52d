"""A fused Newton level in its first form (the port of
``tools/probe_newton_kernel.py``): F = 256 lanes, 32x32 windows, 13x13
patches, 6 exact-Newton iterations of the gain/bias-normalized SSD, with
no early exit, bounds or status. The kernel has the score's gradient and
Hessian in closed form; the expected values take them by autodiff of the
probe's banded-matrix score, as the probe did.

    python -m slam_robot_tpu_torch.tools.probe_newton_kernel [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops import patch
from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
from slam_robot_tpu_torch.tools import Case, main_for, tap_bytes

F, WS, S, IT = 256, 32, 13, 6
START = 9.3  # every lane's window-local start (x, y)
# float32 operations per patch pixel and evaluation of the score with its
# gradient and Hessian, counted from csrc/probe_newton.cu (as for kernel B1)
FLOPS_PER_PIXEL_EVAL = 90


def inputs(device, seed: int = 0):
    """The probe's inputs from a numpy seed: uniform windows and reference
    patches, every lane at (9.3, 9.3), unit weights."""
    rng = np.random.default_rng(seed)
    win = rng.uniform(size=(F, WS, WS)).astype(np.float32)
    ref = rng.uniform(size=(F, S, S)).astype(np.float32)
    pos = np.full((F, 2), START, np.float32)
    wmask = np.ones((S, S), np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (win, pos, ref, wmask))


def edge_inputs(device, seed: int = 0, f: int = F, wh: int = WS, ww: int = WS):
    """Seeded inputs whose lanes spread over the window and past its edges:
    uniform windows [f, wh, ww] and references, each lane at a floor from -6
    to the window's edge less 7 on each axis plus a uniform fraction (an edge
    lane's taps outside the window read 0; at least 7 of its patch's rows
    and columns stay inside, so its gain stays defined), and the tracker's
    radial weights (not all 1)."""
    rng = np.random.default_rng(seed)
    win = rng.uniform(size=(f, wh, ww)).astype(np.float32)
    ref = rng.uniform(size=(f, S, S)).astype(np.float32)
    x = rng.integers(-6, ww - 6, f) + rng.uniform(size=f)
    y = rng.integers(-6, wh - 6, f) + rng.uniform(size=f)
    pos = np.stack([x, y], -1).astype(np.float32)
    wmask = patch.radial_mask(S).numpy()
    return tuple(torch.as_tensor(a, device=device) for a in (win, pos, ref, wmask))


def interp_mats(local, ws: int = WS, size: int = S):
    """The probe's banded bilinear matrices: row [F, S, WS] at floor(y) and
    col [F, WS, S] at floor(x); the derivative flows through the fractions."""
    dev = local.device
    x0 = torch.floor(local[:, 0])
    y0 = torch.floor(local[:, 1])
    fx = (local[:, 0] - x0)[:, None, None]
    fy = (local[:, 1] - y0)[:, None, None]
    x0i = x0.long()[:, None, None]
    y0i = y0.long()[:, None, None]
    zero = torch.zeros((), device=dev)
    i = torch.arange(size, device=dev)[None, :, None]
    k = torch.arange(ws, device=dev)[None, None, :]
    row = torch.where(k == i + y0i, 1.0 - fy, zero) + torch.where(k == i + y0i + 1, fy, zero)
    kc = torch.arange(ws, device=dev)[None, :, None]
    jc = torch.arange(size, device=dev)[None, None, :]
    col = torch.where(kc == jc + x0i, 1.0 - fx, zero) + torch.where(kc == jc + x0i + 1, fx, zero)
    return row, col


def score_of(win, refp, wmask):
    """The probe's per-lane score as a function of the positions [F, 2]."""
    n = refp.shape[1] * refp.shape[2]
    r_mean = refp.sum((1, 2)) / n
    r_sumsq = (refp * refp).sum((1, 2)) / n

    def score_sum(local):
        row, col = interp_mats(local, win.shape[2], refp.shape[1])
        p2 = row @ win @ col
        m2 = p2.sum((1, 2)) / n
        ss2 = (p2 * p2).sum((1, 2)) / n
        alpha = torch.sqrt(r_sumsq / torch.clamp(ss2, min=pn.EPS))
        beta = r_mean - alpha * m2
        d = refp - p2 * alpha[:, None, None] - beta[:, None, None]
        return (d * d * wmask[None]).sum((1, 2))

    return score_sum


def autodiff(win, pos, refp, wmask, stage: int, iters: int = IT):
    """A stage by the probes' own method: torch.func.grad of the summed
    score and jvp of the gradient for the Hessian's columns."""
    score_sum = score_of(win, refp, wmask)
    grad_fn = torch.func.grad(lambda p: torch.sum(score_sum(p)))
    ex = torch.zeros_like(pos)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(pos)
    ey[:, 1] = 1.0
    if stage == pn.EXTRACT:
        s = score_sum(pos)
        return torch.stack([s, s], -1)
    if stage == pn.GRAD:
        return grad_fn(pos)
    if stage == pn.JVP:
        return torch.func.jvp(grad_fn, (pos,), (ex,))[1]
    for _ in range(iters):
        g = grad_fn(pos)
        if stage == pn.FORI_GRAD:
            pos = pos - pn.RATE * g
            continue
        hx = torch.func.jvp(grad_fn, (pos,), (ex,))[1]
        hy = torch.func.jvp(grad_fn, (pos,), (ey,))[1]
        dx, dy = pn.newton_step(g[:, 0], g[:, 1], hx[:, 0], hx[:, 1], hy[:, 1])
        pos = pos + torch.stack([dx, dy], -1)
    return pos


def evaluations(stage: int) -> int:
    """Score evaluations of a stage (one per iteration of the loops)."""
    return IT if stage in (pn.FORI_GRAD, pn.NEWTON) else 1


def stage_bytes(win, pos, ref, wmask, stage: int) -> int:
    """Bytes a stage must move: the window pixels its taps reach at every
    evaluation's position (the plain version's path), the reference patches,
    the weights, the positions in and the results out."""
    at = [pos]
    for _ in range(evaluations(stage) - 1):
        at.append(pn.probe_newton_plain(win, at[-1], ref, wmask, stage, 1))
    at = [torch.floor(p) for p in at]
    return (tap_bytes(win.shape, [p[:, 1] for p in at], [p[:, 0] for p in at], S + 1, S + 1)
            + 4 * (ref.numel() + wmask.numel() + 2 * pos.numel()))


def stage_case(name: str, stage: int, replaces: str, atol: float, atol_card: float):
    return Case(name, pn.KERNEL, replaces, inputs,
                lambda *a: pn.probe_newton(*a, stage, IT),
                lambda *a: pn.probe_newton_plain(*a, stage, IT),
                lambda *a: autodiff(*a, stage, IT),
                atol=atol, atol_card=atol_card,
                flops=lambda win, *_: F * evaluations(stage) * S * S * FLOPS_PER_PIXEL_EVAL,
                n_bytes=lambda *a: stage_bytes(*a, stage))


# tolerance 2e-3 px: kernel B1's (a step's sums over 169 pixels in another
# order; the plain version and the autodiff reference agree to ~1e-6 px on
# the CPU)
CASES = [stage_case("newton-skeleton", pn.NEWTON, "tools/probe_newton_kernel.py:107",
                    2e-3, 2e-3)]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
