"""The whole first pyramid step as one kernel (the port of
``tools/probe_pyramid_fused.py``), on a 480x640 frame:

  probe1: 2x decimation, img[::2, ::2]
  probe2: blur (sigma 1.1) -> pyrDown -> blur (sigma 0.8) in one launch,
          writing level 0 and level 1, against ops.pyramid's blur and
          pyr_down (kernel B2)

    python -m slam_robot_tpu_torch.tools.probe_pyramid_fused [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.ops.cuda import probe_pyramid as pp
from slam_robot_tpu_torch.tools import Case, main_for

H, W = 480, 640
SRC = "tools/probe_pyramid_fused.py"
# one 5-tap pass: 5 multiplies and 4 adds per output value
FLOPS_PER_TAP_PASS = 9


def frame(device):
    """The probe's frame: numpy default_rng(0), uniform [0, 1) float32."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.random((H, W), np.float32), device=device)


def two_level_flops(h: int = H, w: int = W) -> int:
    """Passes the two levels need: level 0 in full, pyrDown's two passes only
    at the rows (then columns) it keeps, level 1 in full."""
    hh, wh = h // 2, w // 2
    return FLOPS_PER_TAP_PASS * (2 * h * w + hh * w + hh * wh + 2 * hh * wh)


def decimate_bytes(img) -> int:
    """img[::2, ::2] reads the even rows (every sector of a row holds kept
    pixels) and writes the quarter-size result."""
    h, w = img.shape
    return 4 * ((h + 1) // 2) * (w + (w + 1) // 2)


def want_two_level(img, k):
    """The probe's reference: pyr.blur(img, 1.1) and
    pyr.blur(pyr.pyr_down(l0), 0.8)."""
    g0 = pyr.blur(img, pp.SIGMA0)
    return g0, pyr.blur(pyr.pyr_down(g0), pp.SIGMA_DOWN)


CASES = [
    Case("probe1", pp.DECIMATE, f"{SRC}:43", lambda d: (frame(d),), pp.decimate,
         pp.decimate_plain, lambda img: img.cpu().numpy()[::2, ::2],
         library=lambda img: (lambda: img[::2, ::2].contiguous()), n_bytes=decimate_bytes),
    Case("probe2", pp.TWO_LEVEL, f"{SRC}:112",
         lambda d: (frame(d), pp.taps().to(d)), pp.two_level, pp.two_level_plain,
         want_two_level, atol=1e-5, flops=lambda img, k: two_level_flops(*img.shape)),
]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
