"""The fused Newton level in its first form and its bisection stages: the
CUDA kernel ``csrc/probe_newton.cu`` and its plain PyTorch version.

Counterpart of ``tools/probe_newton_kernel.py`` (``run``, six exact-Newton
iterations) and ``tools/probe_newton_bisect.py`` (``run(stage)``: the
score, its gradient, its Hessian's first column, six gradient steps). The
score and its derivatives are written out by hand, as in kernel B1
(``ops/cuda/newton.py``); the probes traced them by autodiff. A CUDA tensor
always goes to the kernel; a CPU tensor always goes to the plain version.
There is no fallback.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops.cuda import build, newton
from slam_robot_tpu_torch.ops.cuda.probe_banded import bilinear_taps

KERNEL = build.Kernel("probe_newton", "slam_robot_tpu_torch/csrc/probe_newton.cu")

EXTRACT, GRAD, JVP, FORI_GRAD, NEWTON = range(5)
STAGES = {"extract": EXTRACT, "grad": GRAD, "jvp": JVP, "fori_grad": FORI_GRAD,
          "newton": NEWTON}
SIZE = 13   # the probes' patch
ITERS = 6   # the probes' IT
RATE = 0.01  # fori_grad's step
EPS = 1e-12
MAX_WINDOW = 32


def score_terms(win, pos, ref, wmask):
    """Per lane: the score s and its exact derivatives (gx, gy, hxx, hxy,
    hyy), each [F], at window-local ``pos`` [F, 2] (kernel B1's algebra,
    ``newton.score_terms``). Taps outside the window read 0 (the banded
    matrices' zeros); r_mean and r_sumsq are plain means over all S*S
    reference pixels, not weighted by ``wmask``."""
    f, s = ref.shape[0], ref.shape[1]
    x0f = torch.floor(pos[:, 0])
    y0f = torch.floor(pos[:, 1])
    fx = (pos[:, 0] - x0f)[:, None, None]
    fy = (pos[:, 1] - y0f)[:, None, None]
    p2, u, v, puv = newton.bilinear(*bilinear_taps(win, x0f, y0f, s), fx, fy)
    flat = ref.reshape(f, s * s)
    r_mean = flat.sum(1) / (s * s)
    r_sumsq = (flat * flat).sum(1) / (s * s)
    return newton.score_terms(p2, u, v, puv, ref, wmask[None], r_mean, r_sumsq, EPS)


def newton_step(gx, gy, hxx, hxy, hyy):
    """The skeleton's step: -H^-1 g (det replaced by 1e-20 where |det| <=
    1e-20), rescaled to norm 1 if longer, clipped to +-1."""
    det = hxx * hyy - hxy * hxy
    safe = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    dx = -(hyy * gx - hxy * gy) / safe
    dy = -(-hxy * gx + hxx * gy) / safe
    nrm = torch.sqrt(dx * dx + dy * dy)
    big = nrm > 1.0
    dx = torch.where(big, dx / torch.clamp(nrm, min=1e-20), dx)
    dy = torch.where(big, dy / torch.clamp(nrm, min=1e-20), dy)
    return torch.clamp(dx, -1.0, 1.0), torch.clamp(dy, -1.0, 1.0)


def probe_newton_plain(win, pos, ref, wmask, stage: int, iters: int = ITERS):
    """Plain version of :func:`probe_newton`."""
    if stage in (EXTRACT, GRAD, JVP):
        s, gx, gy, hxx, hxy, _ = score_terms(win, pos, ref, wmask)
        return {EXTRACT: torch.stack([s, s], -1), GRAD: torch.stack([gx, gy], -1),
                JVP: torch.stack([hxx, hxy], -1)}[stage]
    for _ in range(iters):
        _, gx, gy, hxx, hxy, hyy = score_terms(win, pos, ref, wmask)
        if stage == FORI_GRAD:
            pos = pos - RATE * torch.stack([gx, gy], -1)
        else:
            dx, dy = newton_step(gx, gy, hxx, hxy, hyy)
            pos = pos + torch.stack([dx, dy], -1)
    return pos


def probe_newton(win, pos, ref, wmask, stage: int, iters: int = ITERS):
    """One probe stage for F lanes -> [F, 2] float32: EXTRACT the score in
    both columns, GRAD its gradient, JVP the Hessian's first column (H e_x),
    FORI_GRAD ``iters`` steps of pos - 0.01 g, NEWTON ``iters`` exact-Newton
    steps (:func:`newton_step`; no early exit, bounds or status).

    win [F, WH, WW] (WH, WW <= 32), pos [F, 2] window-local (x, y), ref
    [F, 13, 13], wmask [13, 13]."""
    if stage not in STAGES.values():
        raise ValueError(f"unknown stage {stage}")
    if win.dim() != 3:
        raise ValueError(f"win: expected [F, WH, WW], got {tuple(win.shape)}")
    if not win.is_cuda:
        return probe_newton_plain(win, pos, ref, wmask, stage, iters)
    f, wh, ww = win.shape
    if wh > MAX_WINDOW or ww > MAX_WINDOW:
        raise ValueError(f"window {wh}x{ww} larger than {MAX_WINDOW}x{MAX_WINDOW}")
    for name, t, shape in (("win", win, (f, wh, ww)), ("pos", pos, (f, 2)),
                           ("ref", ref, (f, SIZE, SIZE)), ("wmask", wmask, (SIZE, SIZE))):
        build.check_cuda(t, name, shape)
    out = torch.empty((f, 2), dtype=torch.float32, device=win.device)
    KERNEL.launch(win.data_ptr(), pos.data_ptr(), ref.data_ptr(), wmask.data_ptr(),
                  out.data_ptr(), f, wh, ww, stage, int(iters), build.stream_handle(win.device))
    return out
