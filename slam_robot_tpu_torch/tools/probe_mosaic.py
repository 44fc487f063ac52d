"""The fused tracker's key primitives, each in its own kernel (the port of
``tools/probe_mosaic.py``):

  P1+P2: per-lane window copy at int positions read from memory
  P2b:   the same at float positions floored in the kernel
  P3:    batched product [F, 13, 32] @ [F, 32, 32]
  P4:    gradient and Hessian of y * sum((R(x) W)^2) (the probe traced them
         by autodiff; the kernel has them in closed form)
  P5:    while loop with a vector carry and an all(done) condition
  P6:    per-lane copy guarded by a mask

    python -m slam_robot_tpu_torch.tools.probe_mosaic [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops.cuda import probe_banded as pb
from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from slam_robot_tpu_torch.tools import Case, main_for, seeded, tap_bytes, uniform

F, WS, S = 8, 32, 13
XY = (3.3, 1.7)  # P4's point
SRC = "tools/probe_mosaic.py"


def arange_image(device, h: int = 128, w: int = 256):
    return torch.arange(h * w, dtype=torch.float32, device=device).reshape(h, w)


def int_positions(device):
    """(x, y) = (7f + 3, 5f + 2), int32."""
    f = torch.arange(F, device=device)
    return torch.stack([f * 7 + 3, f * 5 + 2], -1).to(torch.int32)


def float_positions(device):
    """(x, y) = (7.3f + 3.2, 5.1f + 2.9), float32."""
    f = torch.arange(F, device=device)
    return torch.stack([f * 7.3 + 3.2, f * 5.1 + 2.9], -1).to(torch.float32)


def image_and_positions(device):
    return arange_image(device), int_positions(device)


def window_bytes(img, pos, size: int = WS) -> int:
    """A window case reads and writes its windows and reads the positions."""
    return 2 * 4 * pos.shape[0] * size * size + pos.numel() * 4


def want_windows(img, pos, size: int = WS):
    """The probes' expected windows: img[y:y+size, x:x+size] per lane."""
    im = img.cpu().numpy()
    return np.stack([im[int(y):int(y) + size, int(x):int(x) + size]
                     for x, y in np.floor(pos.cpu().numpy())])


def index_windows(img, pos, size: int = WS):
    """One advanced-indexing call over precomputed indices (timing only;
    the positions are positive, so ``long()`` floors them)."""
    ar = torch.arange(size, device=img.device)
    iy = (pos[:, 1].long()[:, None] + ar)[:, :, None]
    ix = (pos[:, 0].long()[:, None] + ar)[:, None, :]
    return lambda: img[iy, ix]


def band_score_autodiff(win, xy, size: int = S):
    """P4's expected values, by the probe's own method: the score built from
    the banded matrix, differentiated by autodiff -> [3, 2] (g, H[0], H[1])."""
    ws = win.shape[0]
    i = torch.arange(size, device=win.device)[:, None]
    j = torch.arange(ws, device=win.device)[None, :]
    zero = torch.zeros((), device=win.device)

    def score(p):
        x0 = torch.floor(p[0])
        fx = p[0] - x0
        x0 = x0.long()
        rows = torch.where(j == i + x0, 1.0 - fx, zero) + torch.where(j == i + x0 + 1, fx, zero)
        q = rows @ win
        return torch.sum(q * q) * p[1]

    g = torch.func.grad(score)(xy)
    h = torch.func.jacfwd(torch.func.grad(score))(xy)
    return torch.stack([g, h[0], h[1]])


def _while_rows(x):
    """P5's loop for each row alone: at most 5 steps of +0.5 until x[0] > 2.4."""
    out = x.cpu().numpy().copy()
    for row in out:
        for _ in range(pc.ITERS):
            row += pc.STEP
            if row[0] > pc.LIMIT:
                break
    return out


def _masked_want(mask, img):
    keep = mask.cpu().numpy() > 0
    return np.where(keep[:, None, None], 2.0 * img.cpu().numpy()[None, :WS, :WS], 0.0)


def band_bytes(win, xy, size: int = S) -> int:
    """P4 reads the rows floor(x)..floor(x)+size of W its band reaches, the
    point, and writes [3, 2]."""
    x0 = torch.floor(xy[:1])
    return (tap_bytes((1, *win.shape), [x0], [torch.zeros_like(x0)], size + 1, win.shape[1])
            + xy.numel() * 4 + 3 * 2 * 4)


def seeded_mask(device):
    """P6's seeded inputs: a uniform image and a random 0/1 mask."""
    mask = np.random.default_rng(6).integers(0, 2, F).astype(np.int32)
    return uniform(device, 16, (128, 256)), torch.as_tensor(mask, device=device)


CASES = [
    Case("P1+P2 scalar-VMEM-read window copy", pw.WINDOWS, f"{SRC}:52",
         image_and_positions,
         lambda img, pos: pw.windows(img, pos, WS, pw.INT),
         lambda img, pos: pw.windows_plain(img, pos, WS, pw.INT),
         want_windows, library=index_windows,
         n_bytes=window_bytes),
    Case("P2b computed-int-scratch scalar reads", pw.WINDOWS, f"{SRC}:87",
         lambda d: (arange_image(d), float_positions(d)),
         lambda img, pos: pw.windows(img, pos, WS, pw.FLOORED),
         lambda img, pos: pw.windows_plain(img, pos, WS, pw.FLOORED),
         want_windows, library=index_windows,
         n_bytes=window_bytes),
    Case("P3 batched dot_general", pb.BMM, f"{SRC}:112",
         lambda d: (torch.ones((F, S, WS), device=d), torch.ones((F, WS, WS), device=d)),
         pb.bmm, pb.bmm_plain,
         lambda a, b: np.full((F, S, WS), float(WS)), rtol=1e-5,
         library=lambda a, b: (lambda: torch.bmm(a, b)),
         flops=lambda a, b: 2 * F * S * WS * WS),
    Case("P4 in-kernel autodiff", pb.BAND_GRAD, f"{SRC}:147",
         lambda d: (arange_image(d, WS, WS) / 100.0, torch.tensor(XY, device=d)),
         lambda win, xy: pb.band_grad(win, xy, S),
         lambda win, xy: pb.band_grad_plain(win, xy, S),
         band_score_autodiff, rtol=1e-5,
         flops=lambda win, xy: 10 * S * WS, n_bytes=band_bytes),
    Case("P5 while_loop vector carry", pc.KERNEL, f"{SRC}:175",
         lambda d: (torch.ones((F, 2), device=d),),
         lambda x: pc.control(x, pc.ROW_DONE),
         lambda x: pc.control_plain(x, pc.ROW_DONE),
         _while_rows),
    Case("P6 pl.when guarded lane copy", pw.WINDOWS, f"{SRC}:201",
         lambda d: (torch.ones((128, 256), device=d),
                    (torch.arange(F, device=d) % 2).to(torch.int32)),
         lambda img, mask: pw.windows(img, None, WS, pw.MASKED, mask),
         lambda img, mask: pw.windows_plain(img, None, WS, pw.MASKED, mask),
         lambda img, mask: _masked_want(mask, img),
         n_bytes=lambda img, mask: 4 * WS * WS + 4 * F * WS * WS + mask.numel() * 4),
]

_P3, _P5, _P6 = CASES[2], CASES[4], CASES[5]
SEEDED = [
    seeded(_P3, lambda d: (uniform(d, 3, (F, S, WS)), uniform(d, 13, (F, WS, WS))),
           lambda a, b: a.cpu().numpy() @ b.cpu().numpy()),
    # column 0 from -0.6 to 2.6: rows leave the loop after 1 to 5 steps or
    # run all 5 without finishing
    seeded(_P5, lambda d: (uniform(d, 5, (F, 2), -0.6, 2.6),)),
    seeded(_P6, seeded_mask),
]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
