"""The primitives of probe_mosaic's P1, P2b and P5 one at a time (the port of
``tools/probe_mosaic2.py``):

  A: per-lane window copy, positions read in a loop over lanes
  B: the same, the loop unrolled
  C: one window at pos[0, 0] on both axes
  D: positions staged in shared memory, one read back to fill (8, 128)
  E: while loop with a count-only condition on an (8, 128) carry
  F: a branch on the array's sum
  G: while loop with an all(done) condition, done per element, on (8, 2)
  H: 2 * pos[f, 0] staged per lane, entry 3 read back to fill (8, 128)

    python -m slam_robot_tpu_torch.tools.probe_mosaic2 [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from slam_robot_tpu_torch.tools import Case, main_for, seeded, uniform
from slam_robot_tpu_torch.tools.probe_mosaic import (
    WS, image_and_positions, index_windows, int_positions, want_windows, window_bytes)

F = 8
SRC = "tools/probe_mosaic2.py:26"
FILL_SHAPE = (8, 128)


def _ones(shape):
    return lambda device: (torch.ones(shape, device=device),)


def fixed_steps(x):
    """E's loop: five steps of +0.5, each rounded to float32."""
    out = x.cpu().numpy().copy()
    for _ in range(pc.ITERS):
        out += np.float32(pc.STEP)
    return out


def signed_with_sum(device, seed: int, shape, total: float):
    """F's seeded inputs: uniform in [-1, 1), shifted to sum to ``total``,
    so a row's partial sum may lie on either side of 2."""
    a = np.random.default_rng(seed).uniform(-1.0, 1.0, shape)
    a += (total - a.sum()) / a.size
    return (torch.as_tensor(a.astype(np.float32), device=device),)


def while_elements(x):
    """G's loop for each element alone: at most 5 steps of +0.5 until > 2.4."""
    out = x.cpu().numpy().copy()
    done = np.zeros(out.shape, bool)
    for _ in range(pc.ITERS):
        out = np.where(done, out, out + pc.STEP)
        done |= out > pc.LIMIT
    return out


# loop inputs at the edges: values that pass 2.4 after each of 1..5 steps
# (2.4 itself and the values k/2 under it among them), that never pass
# (-0.1 and under, -inf, NaN), that start past it (+inf), and both zeros
LOOP_EDGES = (2.4, 2.0, 1.9, 1.5, 1.4, 1.0, 0.9, 0.5, 0.4, 0.0, -0.0, -0.1, -0.5, -3.0,
              2.5, 7.0, 3e38, float("inf"), float("-inf"), float("nan"))
SUM_KINDS = ("above", "below", "two")


def loop_edges(device, seed: int, shape) -> torch.Tensor:
    """float32 ``shape``: uniform in [-0.6, 2.9) (every step count, 1 to 6,
    and rows whose column 0 passes at different steps), with LOOP_EDGES laid
    over seeded places (as many as fit)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.6, 2.9, shape).astype(np.float32).ravel()
    k = min(a.size, len(LOOP_EDGES))
    edges = rng.permutation(np.array(LOOP_EDGES, np.float32))
    a[rng.choice(a.size, k, replace=False)] = edges[:k]
    return torch.as_tensor(a.reshape(shape), device=device)


def sum_edges(device, seed: int, shape, kind: str) -> torch.Tensor:
    """F's inputs at the edges: a sum far above 2 ("above"), far below it
    ("below"), or exactly 2.0, one element 2.0 and the rest 0 ("two")."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "two":
        a = np.zeros(n, np.float32)
        a[rng.integers(n)] = 2.0
    else:
        sign = 1.0 if kind == "above" else -1.0
        a = (sign * (rng.uniform(0.0, 1.0, n) + 12.0 / n)).astype(np.float32)
    return torch.as_tensor(a.reshape(shape), device=device)


def index_diagonal(img, pos, size: int = WS):
    """C as one advanced-indexing call: rows and columns from pos[0, 0]."""
    ar = pos[0, 0].long() + torch.arange(size, device=img.device)
    return lambda: img[ar[:, None], ar[None, :]]


def _window_case(name, case):
    return Case(name, pw.WINDOWS, SRC, image_and_positions,
                lambda img, pos: pw.windows(img, pos, WS, case),
                lambda img, pos: pw.windows_plain(img, pos, WS, case),
                want_windows, library=index_windows, n_bytes=window_bytes)


def _fill_case(name, idx, scale):
    return Case(name, pw.FILL, SRC, lambda d: (int_positions(d),),
                lambda pos: pw.fill(pos, FILL_SHAPE, idx, scale),
                lambda pos: pw.fill_plain(pos, FILL_SHAPE, idx, scale),
                lambda pos: np.full(FILL_SHAPE, float(pos[idx, 0].item() * scale)))


def _control_case(name, shape, case, want):
    return Case(name, pc.KERNEL, SRC, _ones(shape), lambda x: pc.control(x, case),
                lambda x: pc.control_plain(x, case), want)


CASES = [
    _window_case("A smem-pos dyn-lane-store", pw.INT),
    _window_case("B smem-pos static-lane-store", pw.INT),
    Case("C scalar-read-VMEM static idx", pw.WINDOWS, SRC, image_and_positions,
         lambda img, pos: pw.windows(img, pos, WS, pw.DIAGONAL),
         lambda img, pos: pw.windows_plain(img, pos, WS, pw.DIAGONAL),
         lambda img, pos: want_windows(img, pos[:1, :1].expand(1, 2))[0],
         library=index_diagonal, n_bytes=lambda img, pos: 2 * 4 * WS * WS + 4),
    _fill_case("D vector->SMEM scratch store", 0, 1),
    _control_case("E while scalar-cond vector-carry", (F, 128), pc.FIXED, fixed_steps),
    _control_case("F vector-reduce scalar control", (F, 128), pc.REDUCE,
                  lambda x: 2.0 * x.cpu().numpy() if float(x.sum()) > 2.0 else x.cpu().numpy()),
    _control_case("G while vector-cond (P5)", (F, 2), pc.ELEMENT_DONE, while_elements),
    _fill_case("H smem scalar loop", 3, 2),
]

_E, _F, _G = CASES[4], CASES[5], CASES[6]
# F's totals lie on each side of 2; G's elements leave after 1 to 5 steps
SEEDED = [
    seeded(_E, lambda d: (uniform(d, 24, (F, 128), -1.0, 1.0),)),
    seeded(_F, lambda d: signed_with_sum(d, 25, (F, 128), 5.0), tag="seeded, sum above 2"),
    seeded(_F, lambda d: signed_with_sum(d, 26, (F, 128), -1.0), tag="seeded, sum below 2"),
    seeded(_G, lambda d: (uniform(d, 27, (F, 2), -0.6, 2.6),)),
]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
