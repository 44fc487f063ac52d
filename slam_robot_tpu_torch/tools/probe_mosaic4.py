"""The ops of kernel B1's grouped sampling (``_sample_grouped``) one at a time
(the port of ``tools/probe_mosaic4.py``), F = 64 lanes in G = 4 groups, 13x13
patches, 32x32 windows:

  G1: [16, 4] repeated 26 times along axis 1 (``jnp.repeat``)
  G2: [16, 104, 32] broadcast to [16, 104, 4, 32], reshaped to [16, 104, 128]
  G3: the grouped banded selection matrix ``_banded_pair_grouped`` alone
  G4: G1 by an iota-masked sum (``_expand_rows``)
  G5: [16, 104, 32] -> [16, 4, 26, 32] -> swapaxes -> [16, 128, 26]
  G6: the whole ``_sample_grouped`` -> [64, 26, 26]: per lane the blocks
      [[V, V_x], [V_y, V_xy]] of the bilinear patch

    python -m slam_robot_tpu_torch.tools.probe_mosaic4 [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops.cuda import probe_banded as pb
from slam_robot_tpu_torch.tools import Case, main_for, tap_bytes

F, G, S, W = 64, 4, 13, 32
B = F // G
ROWS = 2 * S
SRC = "tools/probe_mosaic4.py:44"


def lane_values(device):
    """G1/G4's input: arange(F) as [B, G] float32."""
    return (torch.arange(F, dtype=torch.float32, device=device).reshape(B, G),)


def stacked_rows(device):
    """G2/G5's input: arange as [B, G*2S, W] float32."""
    return (torch.arange(B * G * ROWS * W, dtype=torch.float32, device=device)
            .reshape(B, G * ROWS, W),)


def band_inputs(device):
    """G3's fractions linspace(0, 1, F) and starts (f % 18) int32."""
    return (torch.linspace(0, 1, F, device=device),
            (torch.arange(F, device=device) % 18).to(torch.int32))


def sample_inputs(device):
    """G6's windows (arange % 255), fractions and starts."""
    win = torch.arange(F * W * W, dtype=torch.float32, device=device).reshape(F, W, W) % 255.0
    f = torch.arange(F, device=device)
    return (win, torch.linspace(0.1, 0.9, F, device=device),
            torch.linspace(0.2, 0.8, F, device=device),
            (f % 18).to(torch.int32), ((f * 3) % 18).to(torch.int32))


def want_banded_pair(frac, start, length: int = W, size: int = S, groups: int = G):
    """The band matrix written entry by entry: lane f's rows i and S+i hold
    (1 - frac, frac) and (-1, +1) at columns start+i, start+i+1 of its block."""
    fr = frac.cpu().numpy()
    st = start.cpu().numpy()
    n = fr.shape[0]
    out = np.zeros((n // groups, groups * 2 * size, groups * length), np.float32)
    for f in range(n):
        b, g = divmod(f, groups)
        for i in range(size):
            for row, (w0, w1) in ((g * 2 * size + i, (np.float32(1) - fr[f], fr[f])),
                                  (g * 2 * size + size + i, (-1.0, 1.0))):
                for k, wk in ((st[f] + i, w0), (st[f] + i + 1, w1)):
                    if 0 <= k < length:
                        out[b, row, g * length + k] = wk
    return out


def want_sample(win, fx, fy, x0, y0):
    """G6 by the probe's own formulation: per lane the banded products
    R(fy, y0) @ win @ C(fx, x0)^T, from G3's matrices (G = 1) and P3's
    product (the port's plain versions)."""
    rowp = pb.banded_pair_grouped_plain(fy, y0, W, S, 1)   # [F, 2S, W]
    colp = pb.banded_pair_grouped_plain(fx, x0, W, S, 1)   # [F, 2S, W]
    return pb.bmm_plain(pb.bmm_plain(rowp, win), colp.transpose(1, 2))


def sample_bytes(win, fx, fy, x0, y0) -> int:
    """G6 reads the (S+1) x (S+1) pixels of each window its taps reach and
    the lane's four scalars, and writes its [2S, 2S] blocks."""
    f = win.shape[0]
    return tap_bytes(win.shape, [y0], [x0], S + 1, S + 1) + 4 * 4 * f + 4 * f * (2 * S) ** 2


def _layout_case(name, inputs, case, want, library):
    return Case(name, pb.LAYOUT, SRC, inputs, lambda t: pb.layout(t, case, G, ROWS),
                lambda t: pb.layout_plain(t, case, G, ROWS), want, library=library)


def _repeat_want(a):
    return np.repeat(a.cpu().numpy(), ROWS, axis=1)


CASES = [
    _layout_case("G1 repeat", lane_values, pb.REPEAT, _repeat_want,
                 lambda a: (lambda: a.repeat_interleave(ROWS, dim=1))),
    _layout_case("G2 bcast4d+reshape", stacked_rows, pb.BROADCAST,
                 lambda t: np.broadcast_to(t.cpu().numpy()[:, :, None, :],
                                           (B, G * ROWS, G, W)).reshape(B, G * ROWS, G * W),
                 lambda t: (lambda: t[:, :, None, :].expand(B, G * ROWS, G, W)
                            .reshape(B, G * ROWS, G * W))),
    Case("G3 banded_pair_grouped", pb.BANDED_PAIR, SRC, band_inputs,
         lambda fr, st: pb.banded_pair_grouped(fr, st, W, S, G),
         lambda fr, st: pb.banded_pair_grouped_plain(fr, st, W, S, G),
         want_banded_pair),
    _layout_case("G4 iota-masked expansion", lane_values, pb.MASKED_SUM, _repeat_want,
                 lambda a: (lambda: a.repeat_interleave(ROWS, dim=1))),
    _layout_case("G5 4d reshape+swapaxes", stacked_rows, pb.BLOCK_TRANSPOSE,
                 lambda t: np.swapaxes(t.cpu().numpy().reshape(B, G, ROWS, W), -1, -2)
                 .reshape(B, G * W, ROWS),
                 lambda t: (lambda: t.reshape(B, G, ROWS, W).permute(0, 1, 3, 2).contiguous()
                            .reshape(B, G * W, ROWS))),
    Case("G6 full _sample_grouped", pb.SAMPLE_GROUPED, SRC, sample_inputs,
         lambda *a: pb.sample_grouped(*a, S, G),
         lambda *a: pb.sample_grouped_plain(*a, S),
         want_sample, rtol=1e-5, n_bytes=sample_bytes,
         flops=lambda win, *_: F * (2 * S) * (2 * S) * 9),
]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
