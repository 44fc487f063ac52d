"""Quaternion algebra, Eigen storage convention ``[x, y, z, w]``.

Port of ``slam_robot_tpu/ops/quaternion.py``: the reference's sin/cos
exponential-map retraction (slam.cpp:30-50), ``q_plus_delta = exp(delta) * q``.
Every function broadcasts over leading batch axes (the JAX package's
``vmap`` becomes a batch dimension).
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def normalize(q, eps: float = 1e-12):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def conjugate(q):
    """Inverse for unit quaternions: negate the vector part."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


inverse = conjugate


def multiply(a, b):
    """Hamilton product a*b with xyzw storage (matches Eigen's operator*)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def rotate(q, v):
    """Rotate v by unit quaternion q: v + 2 w (u x v) + 2 u x (u x v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def rotate_inverse(q, v):
    return rotate(conjugate(q), v)


def to_matrix(q):
    """3x3 rotation matrix of a unit quaternion (xyzw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def exp_map(delta, eps: float = 1e-12):
    """Tangent 3-vector -> unit quaternion (slam.cpp:37-44), identity-safe."""
    n2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=eps * eps))
    sinc = torch.where(n2 > eps, torch.sin(n) / n, 1.0 - n2 / 6.0)
    vec = sinc * delta
    w = torch.where(n2 > eps, torch.cos(n), 1.0 - n2 / 2.0)
    return torch.cat([vec, w], dim=-1)


def retract(q, delta):
    """Manifold plus: exp(delta) * q, then renormalize for f32 drift."""
    return normalize(multiply(exp_map(delta), q))


def from_axis_angle(axis, angle):
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-12)
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def angle_between(a, b):
    """Rotation angle of a * b^-1 — a distance on SO(3)."""
    d = torch.abs(torch.sum(a * b, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, 0.0, 1.0))
