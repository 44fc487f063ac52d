"""Camera model: radial distortion, plane<->pixel maps, project/unproject.

Port of ``slam_robot_tpu/ops/projection.py`` (localmap.h:29-80, project.h:11-54,
localmap.cpp:28-37). Intrinsics ``k = [k1, k2, k3, fx, fy, cx, cy]`` with the
reference's fy = -fx; the cheirality gate returns a validity mask and a
clamped-denominator pixel so nothing downstream turns NaN. Every function
broadcasts over leading batch axes.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import quaternion as quat


def distort_factor(xy, k):
    """1 + r2*(k1 + r2*(k2 + r2*k3)) for plane point xy (localmap.h:44-45)."""
    r2 = torch.sum(xy * xy, dim=-1, keepdim=True)
    return 1.0 + r2 * (k[..., 0:1] + r2 * (k[..., 1:2] + r2 * k[..., 2:3]))


def plane_to_pixel(xy, k):
    """[-1,1]^2 projective plane -> pixel space (localmap.h:40-56)."""
    p = xy * distort_factor(xy, k)
    f = torch.stack([k[..., 3], k[..., 4]], dim=-1)
    c = torch.stack([k[..., 5], k[..., 6]], dim=-1)
    return p * f + c


def pixel_to_plane(px, k):
    """Pixel -> plane via 3 fixed-point undistort iterations (localmap.h:58-80)."""
    f = torch.stack([k[..., 3], k[..., 4]], dim=-1)
    c = torch.stack([k[..., 5], k[..., 6]], dim=-1)
    p0 = (px - c) / f
    p = p0
    for _ in range(3):
        p = p0 / distort_factor(p, k)
    return p


def transform_to_camera(q, t, point4):
    """World homogeneous point -> camera-space [x*w, y*w, z*w] (project.h:24)."""
    return quat.rotate(q, point4[..., :3] - t * point4[..., 3:4])


def project_point(q, t, k, point4, cheirality_eps: float = 0.001):
    """World point -> (pixel[..., 2], valid[...]); valid is the cheirality
    test p_cam_z >= eps * w (project.h:27-30)."""
    p = transform_to_camera(q, t, point4)
    w = point4[..., 3]
    valid = p[..., 2] >= cheirality_eps * w
    z = p[..., 2:3]
    denom = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    xy = p[..., :2] / denom
    return plane_to_pixel(xy, k), valid


def reprojection_error(q, t, k, point4, observed_px, cheirality_eps: float = 0.001):
    """projected - observed, plus validity (slam.cpp:60-84)."""
    px, valid = project_point(q, t, k, point4, cheirality_eps)
    return px - observed_px, valid


def unproject(q, t, plane_xy, distance):
    """Plane point + depth guess -> unit-norm homogeneous world point
    (localmap.cpp:28-37)."""
    d = torch.as_tensor(distance, dtype=plane_xy.dtype, device=plane_xy.device)
    d = d.expand(plane_xy.shape[:-1])[..., None]
    cam = torch.cat([plane_xy * d, d], dim=-1)
    world = quat.rotate_inverse(q, cam) + t
    h = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    return h / torch.linalg.norm(h, dim=-1, keepdim=True)


def point_position(point4, w_min: float = 1e-12):
    """Homogeneous -> world 3-vector: xyz / w (localmap.h:221-223)."""
    w = point4[..., 3:4]
    sgn = torch.where(w >= 0, torch.full_like(w, w_min), torch.full_like(w, -w_min))
    w = torch.where(torch.abs(w) > w_min, w, sgn)
    return point4[..., :3] / w
