"""Camera geometry of the plain reference, written from its description.

Quaternions are stored ``[x, y, z, w]`` (Eigen's order). A frame's pose is
(q, t) with ``p_cam = R(q) (X - t w)`` for a homogeneous world point
``X = [x, y, z, w]``: t is the camera's position in the world. Intrinsics
``k = [k1, k2, k3, fx, fy, cx, cy]``: radial distortion
``1 + r2 (k1 + r2 (k2 + r2 k3))`` on the plane point, then focal lengths and
principal point; fy is negative (the image's y axis points down). The
retraction is the reference SLAM code's: ``q <- normalize(exp(d) * q)`` with
``exp(d) = [sin|d| d/|d|, cos|d|]``, a rotation by ``2|d|``.

Every product that a GPU code would write as a matrix product goes through
a :class:`Precision`'s ``mm``/``mv``, so that the reference can also be run
with TF32 inputs to those products (the control of ``compare``).
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away from
    zero), as the tensor cores round a product's inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """The dtype the reference computes in, and whether the inputs of its
    matrix products are rounded to TF32 first."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 inputs")
        self.dtype, self.tf32 = dtype, tf32

    def _in(self, x):
        return round_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        """Batched matrix product ``a @ b`` over leading axes."""
        return self._in(a) @ self._in(b)

    def mv(self, a, x):
        """Batched matrix-vector product ``a @ x`` over leading axes."""
        return (self._in(a) @ self._in(x)[..., None])[..., 0]


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation of unit quaternions q [..., 4] (xyzw)."""
    x, y, z, w = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(q.shape[:-1] + (3, 3))


def quat_multiply(a, b):
    """Hamilton product a * b, xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def retract(q, d):
    """``normalize(exp(d) * q)``; exp(d) = [sin|d| d/|d|, cos|d|]."""
    n = torch.linalg.norm(d, dim=-1, keepdim=True)
    small = n < 1e-12
    sinc = torch.where(small, torch.ones_like(n), torch.sin(n) / torch.where(small, 1.0, n))
    e = torch.cat([sinc * d, torch.cos(n)], -1)
    out = quat_multiply(e, q)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def axis_angle(axis, angle):
    """Unit quaternions rotating by ``angle`` about unit ``axis``."""
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], -1)


def skew(v):
    """[..., 3, 3] cross-product matrices [v]x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(v.shape[:-1] + (3, 3))


def to_camera(R, t, X, prec: Precision):
    """Camera-space points ``R (X[:3] - t X[3])``, [..., 3]."""
    return prec.mv(R, X[..., :3] - t * X[..., 3:4])


def _denominator(z):
    return torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))


def pixel(pc, k):
    """Pixel of camera-space points pc [..., 3] under intrinsics k [..., 7]."""
    xy = pc[..., :2] / _denominator(pc[..., 2:3])
    r2 = torch.sum(xy * xy, -1, keepdim=True)
    d = 1 + r2 * (k[..., 0:1] + r2 * (k[..., 1:2] + r2 * k[..., 2:3]))
    return xy * d * k[..., 3:5] + k[..., 5:7]


def pixel_jacobian(pc, k, prec: Precision):
    """d pixel / d pc, [..., 2, 3]."""
    z = _denominator(pc[..., 2])
    xy = pc[..., :2] / z[..., None]
    r2 = torch.sum(xy * xy, -1)
    d = 1 + r2 * (k[..., 0] + r2 * (k[..., 1] + r2 * k[..., 2]))
    dd = k[..., 0] + r2 * (2 * k[..., 1] + 3 * r2 * k[..., 2])
    # d pixel / d xy = diag(f) (d I + 2 dd xy xy^T)
    dxy = (d[..., None, None] * torch.eye(2, dtype=pc.dtype, device=pc.device)
           + 2 * dd[..., None, None] * xy[..., :, None] * xy[..., None, :])
    dxy = k[..., 3:5, None] * dxy
    # d xy / d pc = [I / z, -xy / z]
    dproj = torch.cat([torch.eye(2, dtype=pc.dtype, device=pc.device).expand(xy.shape + (2,))
                       / z[..., None, None], -(xy / z[..., None])[..., None]], -1)
    return prec.mm(dxy, dproj)
