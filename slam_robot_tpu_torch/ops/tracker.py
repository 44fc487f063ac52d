"""Reference patch stacks for the coarse-to-fine tracker.

Port of ``slam_robot_tpu/ops/tracker.py``'s ``get_patch_stack`` (GetPatches,
hessian.h:175-183), batched over lanes. The per-feature autodiff tracker of
that module (``tracker_impl="lanes"``) is not ported; the port runs the
fused tracker (``ops/tracker_fused``).
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops.patch import Patch
from slam_robot_tpu_torch.ops.pyramid import FlatPyramid, level_dims, PAD

def pyramid_dims(pyr: FlatPyramid):
    h, w = pyr.data.shape[-2] - 2 * PAD, pyr.data.shape[-1] - 2 * PAD
    return level_dims(h, w, pyr.depth)


def get_patch_stack(pyr: FlatPyramid, pts: torch.Tensor, size: int = 13) -> Patch:
    """Patches at pts / 2^i for every level i: Patch with axes [K, L, ...].

    ``pyr.offset`` (int or [K]) selects each lane's pyramid in a stack."""
    dims = pyramid_dims(pyr)
    K = pts.shape[0]
    offs = torch.as_tensor(pyr.offset, dtype=torch.long, device=pts.device).expand(K)
    out = []
    for i in range(pyr.depth):
        h, w = dims[i]
        out.append(patch_ops.extract(pyr.data, offs + i, w, h, pts / (2.0 ** i), size))
    return Patch(*(torch.stack([getattr(p, f) for p in out], 1) for f in Patch._fields))
