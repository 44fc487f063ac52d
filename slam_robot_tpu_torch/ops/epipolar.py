"""Essential matrix and epipolar residuals (localmap.cpp:215-262).

Port of ``slam_robot_tpu/ops/epipolar.py``. The products feed outlier
thresholds at the 1e-3 scale, so they stay in full float32
(``device.py`` turns TF32 off).
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import quaternion as quat


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def essential_matrix(q1, t1, q2, t2, eps: float = 1e-12):
    """E = R2 R1^-1 skew(t_hat), t_hat = normalize(t2 - t1)."""
    r_rel = quat.to_matrix(quat.multiply(q2, quat.conjugate(q1)))
    t = t2 - t1
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=eps)
    return torch.matmul(r_rel, skew(t))


def epipolar_residual(e, plane1, plane2):
    """r = h2^T E h1 with h = [x, y, 1]."""
    h1 = torch.cat([plane1, torch.ones_like(plane1[..., :1])], dim=-1)
    h2 = torch.cat([plane2, torch.ones_like(plane2[..., :1])], dim=-1)
    return torch.einsum("...i,...ij,...j->...", h2, e, h1)


def epipolar_residual_frames(q1, t1, q2, t2, plane1, plane2):
    return epipolar_residual(essential_matrix(q1, t1, q2, t2), plane1, plane2)
