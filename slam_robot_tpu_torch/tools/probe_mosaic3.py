"""Window extraction by asynchronous copy, and the vector-to-scalar hand-off
(the port of ``tools/probe_mosaic3.py``):

  I: each lane's window copied asynchronously (the TMA) and waited for in turn
  J: every lane's copy started, then all waited for
  K: positions staged in shared memory first, then copied as I
  L: while loop with an all(done) condition, done per element, on (8, 128)
  M: windows at a dynamic row and column 0

    python -m slam_robot_tpu_torch.tools.probe_mosaic3 [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from slam_robot_tpu_torch.tools import Case, main_for, seeded, uniform
from slam_robot_tpu_torch.tools.probe_mosaic import (
    WS, image_and_positions, index_windows, want_windows, window_bytes)
from slam_robot_tpu_torch.tools.probe_mosaic2 import while_elements

F = 8
SRC = "tools/probe_mosaic3.py"


def _async_case(name, line, case):
    return Case(name, pw.WINDOWS_ASYNC, f"{SRC}:{line}", image_and_positions,
                lambda img, pos: pw.windows_async(img, pos, WS, case),
                lambda img, pos: pw.windows_plain(img, pos, WS, pw.INT),
                want_windows, library=index_windows, n_bytes=window_bytes)


def _want_rows(img, pos):
    im = img.cpu().numpy()
    return np.stack([im[int(y):int(y) + WS, 0:WS] for y in pos[:, 1].tolist()])


def index_rows(img, pos, size: int = WS):
    """M as one advanced-indexing call: each lane's rows, columns 0..size-1."""
    ar = torch.arange(size, device=img.device)
    iy = (pos[:, 1].long()[:, None] + ar)[:, :, None]
    return lambda: img[iy, ar[None, None, :]]


CASES = [
    _async_case("I vmem->vmem async window copy", 53, pw.ONE_BY_ONE),
    _async_case("J hbm->vmem pipelined window copy", 88, pw.ALL_THEN_WAIT),
    _async_case("K vmem-scalar->smem handoff + copy", 120, pw.STAGED),
    Case("L while vector-cond 128-wide", pc.KERNEL, f"{SRC}:149",
         lambda d: (torch.ones((F, 128), device=d),),
         lambda x: pc.control(x, pc.ELEMENT_DONE),
         lambda x: pc.control_plain(x, pc.ELEMENT_DONE), while_elements),
    Case("M sublane-only dynamic slice", pw.WINDOWS, f"{SRC}:167", image_and_positions,
         lambda img, pos: pw.windows(img, pos, WS, pw.ROWS),
         lambda img, pos: pw.windows_plain(img, pos, WS, pw.ROWS),
         _want_rows, library=index_rows, n_bytes=window_bytes),
]

# elements leave L's loop after 1 to 5 steps
SEEDED = [seeded(CASES[3], lambda d: (uniform(d, 31, (F, 128), -0.6, 2.6),))]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
