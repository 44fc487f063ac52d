"""In-kernel control flow of the Mosaic probes: the CUDA kernel
``csrc/probe_control.cu`` and its plain PyTorch version.

Counterpart of ``tools/probe_mosaic.py`` p5, ``tools/probe_mosaic2.py`` e, f,
g and ``tools/probe_mosaic3.py`` l. A CUDA tensor always goes to the kernel;
a CPU tensor always goes to the plain version. There is no fallback.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops.cuda import build

KERNEL = build.Kernel("probe_control", "slam_robot_tpu_torch/csrc/probe_control.cu")

# ROW_DONE: p5, a done flag per row from column 0; FIXED: e, five steps;
# REDUCE: f, a branch on the array's sum; ELEMENT_DONE: g and l, a done flag
# per element
ROW_DONE, FIXED, REDUCE, ELEMENT_DONE = range(4)

ITERS = 5
STEP = 0.5
LIMIT = 2.4
MAX_ELEMENTS = 1024


def control_plain(x, case: int):
    """Plain version. ROW_DONE / ELEMENT_DONE: ``while it < 5 and not
    all(done)``: x += 0.5 where not done, then done |= x > 2.4 (ROW_DONE:
    x[:, 0] > 2.4 per row). FIXED: five times x += 0.5. REDUCE: 2x if
    sum(x) > 2, else x."""
    if case == FIXED:
        for _ in range(ITERS):
            x = x + STEP
        return x
    if case == REDUCE:
        return torch.where(x.sum() > 2.0, x * 2.0, x)
    done = torch.zeros(x.shape[:1] if case == ROW_DONE else x.shape, dtype=torch.bool,
                       device=x.device)
    it = 0
    while it < ITERS and not bool(done.all()):
        keep = done[:, None] if case == ROW_DONE else done
        x = torch.where(keep, x, x + STEP)
        done = done | ((x[:, 0] if case == ROW_DONE else x) > LIMIT)
        it += 1
    return x


def control(x, case: int):
    """One of the probes' loops or branches on ``x`` [R, C] float32 (R * C
    <= 1024, one block); see :func:`control_plain`."""
    if case not in (ROW_DONE, FIXED, REDUCE, ELEMENT_DONE):
        raise ValueError(f"unknown case {case}")
    if x.dim() != 2 or x.numel() > MAX_ELEMENTS or x.numel() == 0:
        raise ValueError(f"need x [R, C] with 0 < R*C <= {MAX_ELEMENTS}, got {tuple(x.shape)}")
    if not x.is_cuda:
        return control_plain(x, case)
    build.check_cuda(x, "x")
    out = torch.empty_like(x)
    r, c = x.shape
    KERNEL.launch(x.data_ptr(), out.data_ptr(), r, c, case, build.stream_handle(x.device))
    return out
