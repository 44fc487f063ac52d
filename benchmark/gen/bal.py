"""BAL-shaped bundle-adjustment problems, drawn from a seed.

Agarwal et al., "Bundle Adjustment in the Large" (ECCV 2010) publish their
problems as files that cannot be fetched here, so this module draws a
problem of one of their shapes: the exact counts of cameras, points and
observations that a configuration states, a heavy-tailed track-length
distribution with the problem's mean and a least length of 2, and one of
two observation graphs:

- ``sequential`` (Ladybug): one vehicle path; point i is seen by the run of
  consecutive cameras ``start_i .. start_i + L_i - 1``; points are numbered
  by the camera that first sees them.
- ``collection`` (Venice): cameras around one site, numbered in no order;
  point i is seen by ``L_i`` distinct cameras drawn without replacement with
  a heavy-tailed popularity per camera.

Rows are ordered as BAL's files order them: by point, cameras ascending
within a point. Every observation lies in front of its camera and inside
the image, with a margin, at the true values. The observation graph (which
cameras see which point) is the configuration's own, drawn from its
``graph_seed``, and the multiset of track lengths depends on the counts
alone: every seed poses the same work, with the same segment sizes on both
sides of the solve. The run's seed draws the geometry (cameras, points) and
the noise. Everything is drawn on ``device``, each by its own
``torch.Generator``.

Units are millimetres and pixels; the camera is the configuration's
pinhole (no distortion), which is fixed and not solved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import geometry as geo

F32 = torch.float32
# redraws of the points that some camera of their track does not see; the
# later ones draw nearer the image centre
PLACE_ROUNDS = 64


def track_lengths(n_points: int, n_obs: int, cap: int, alpha: float) -> np.ndarray:
    """Track lengths, ascending, that sum to ``n_obs`` exactly: ``2 + X``
    with X the Lomax (Pareto II) quantiles of shape ``alpha`` at
    ``(i + 1/2) / n_points``, scaled to the mean, capped at ``cap`` and
    rounded by largest remainder. A function of its arguments alone."""
    extra = n_obs - 2 * n_points
    if extra < 0 or n_obs > cap * n_points:
        raise ValueError(f"{n_obs} observations of {n_points} points: mean outside [2, {cap}]")
    u = (np.arange(n_points) + 0.5) / n_points
    g = (1.0 - u) ** (-1.0 / alpha) - 1.0
    lo, hi = 0.0, 1.0
    while np.minimum(hi * g, cap - 2).sum() < extra:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if np.minimum(mid * g, cap - 2).sum() < extra:
            lo = mid
        else:
            hi = mid
    y = np.minimum(hi * g, cap - 2)
    base = np.floor(y).astype(np.int64)
    short = extra - int(base.sum())
    if short < 0:
        raise ValueError("track lengths overshoot the observation count")
    # the largest remainders get one more, ties to the longer tracks
    order = np.lexsort((-np.arange(n_points), -(y - base)))
    base[order[:short]] += 1
    return np.sort(2 + base)


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _normal(g, shape, scale, device):
    return scale * torch.randn(shape, generator=g, device=device)


def _turn(axis: int, angle: torch.Tensor) -> torch.Tensor:
    a = torch.zeros(angle.shape + (3,), dtype=angle.dtype, device=angle.device)
    a[..., axis] = 1.0
    return geo.axis_angle(a, angle)


def camera_quat(azimuth, elevation, roll):
    """World-to-camera rotations of cameras whose optical axis has the given
    azimuth (about the world's y, from +z towards +x) and elevation, turned
    by ``roll`` about it: R = R_z(roll) R_x(elevation) R_y(-azimuth)."""
    return geo.quat_multiply(_turn(2, roll), geo.quat_multiply(_turn(0, elevation),
                                                               _turn(1, -azimuth)))


def _in_view(q, t, X, obs_frame, obs_point, k, image, margin, z_min):
    """Whether each observation's point lies in front of its camera by
    ``z_min`` and inside the image by ``margin`` pixels."""
    R = geo.rotation_matrix(q)
    pc = geo.to_camera(R[obs_frame], t[obs_frame], X[obs_point], geo.Precision(F32))
    px = geo.pixel(pc, k.expand(pc.shape[0], 7))
    return ((pc[:, 2] > z_min) & (px[:, 0] > margin) & (px[:, 0] < image[0] - margin)
            & (px[:, 1] > margin) & (px[:, 1] < image[1] - margin))


def _sequential(cfg, L, g, graph, dev):
    """Vehicle path (from ``g``), tracks as runs of consecutive cameras (from
    ``graph``), and a draw of a point in view of its track's last camera
    (``place``)."""
    C, P = cfg["cameras"], L.shape[0]
    sc = cfg["assumed"]["scene"]
    # heading: a random walk of turn rates, so the path bends and runs straight
    walk = torch.cumsum(_normal(g, (C,), sc["turn_rate_jitter"], dev), 0)
    heading = torch.cumsum(sc["turn_rate"] * torch.tanh(walk / sc["turn_rate"]), 0)
    step = sc["step_mm"] * torch.stack([torch.sin(heading), torch.zeros_like(heading),
                                        torch.cos(heading)], -1)
    pos = torch.cumsum(step, 0)
    pos[:, 1] = _normal(g, (C,), sc["height_jitter_mm"], dev)
    pos = pos - pos.mean(0)
    q = camera_quat(heading, _normal(g, (C,), sc["tilt_rad"], dev),
                    _normal(g, (C,), sc["tilt_rad"], dev))

    start = torch.floor(torch.rand(P, generator=graph, device=dev) * (C - L + 1)).long()
    order = torch.argsort(start, stable=True)   # points numbered by first camera
    L, start = L[order], start[order]
    first = torch.cumsum(L, 0) - L
    obs_point = torch.repeat_interleave(torch.arange(P, device=dev), L)
    obs_frame = start[obs_point] + torch.arange(obs_point.shape[0], device=dev) - first[obs_point]
    last = start + L - 1
    R = geo.rotation_matrix(q)

    def place(sel, shrink):
        """World points of ``sel`` at a pixel and depth of their last camera."""
        n = sel.shape[0]
        k = cfg["assumed"]["intrinsics"]
        w, h = cfg["assumed"]["image"]
        half = shrink * 0.5 * torch.tensor([w, h], dtype=F32, device=dev) - sc["margin_px"]
        uv = torch.tensor([k[5], k[6]], dtype=F32, device=dev) + half * (
            2 * torch.rand((n, 2), generator=g, device=dev) - 1)
        z = _uniform(g, n, sc["depth_mm"][0], sc["depth_mm"][1], dev)
        xy = (uv - torch.tensor([k[5], k[6]], dtype=F32, device=dev)) / torch.tensor(
            [k[3], k[4]], dtype=F32, device=dev)
        pc = torch.cat([xy * z[:, None], z[:, None]], -1)
        cam = last[sel]
        return (R[cam].transpose(1, 2) @ pc[:, :, None])[..., 0] + pos[cam]

    return q, pos, obs_frame, obs_point, place


def _collection(cfg, L, g, graph, dev):
    """Cameras around a site (from ``g``), tracks as popularity-weighted
    draws without replacement (from ``graph``), and a draw of a point in the
    site's volume (``place``)."""
    C, P = cfg["cameras"], L.shape[0]
    sc = cfg["assumed"]["scene"]
    az = _uniform(g, C, 0.0, 2 * math.pi, dev)
    dist = _uniform(g, C, sc["camera_distance_mm"][0], sc["camera_distance_mm"][1], dev)
    height = _uniform(g, C, sc["camera_height_mm"][0], sc["camera_height_mm"][1], dev)
    pos = torch.stack([dist * torch.sin(az), height, dist * torch.cos(az)], -1)
    aim = torch.stack([_normal(g, (C,), sc["aim_jitter_mm"], dev),
                       _uniform(g, C, sc["aim_height_mm"][0], sc["aim_height_mm"][1], dev),
                       _normal(g, (C,), sc["aim_jitter_mm"], dev)], -1)
    look = aim - pos
    azimuth = torch.atan2(look[:, 0], look[:, 2])
    elevation = torch.atan2(look[:, 1], torch.linalg.norm(look[:, [0, 2]], dim=-1))
    q = camera_quat(azimuth, elevation, _normal(g, (C,), sc["roll_rad"], dev))

    # Gumbel top-k: L_i distinct cameras, drawn with weights exp(sigma N)
    logw = _normal(graph, (C,), sc["popularity_sigma"], dev)
    L = L[torch.randperm(P, generator=graph, device=dev)]
    block = max(1, (1 << 25) // C)
    tracks = []
    for b in range(0, P, block):
        lb = L[b:b + block]
        keys = logw - torch.log(-torch.log(
            torch.rand((lb.shape[0], C), generator=graph, device=dev).clamp_(min=1e-30)))
        top = torch.topk(keys, int(lb.max()), dim=1).indices
        keep = torch.arange(top.shape[1], device=dev) < lb[:, None]
        top = torch.sort(torch.where(keep, top, C), dim=1).values
        tracks.append(top[keep])
    obs_frame = torch.cat(tracks)
    obs_point = torch.repeat_interleave(torch.arange(P, device=dev), L)
    lo = torch.tensor(sc["site_min_mm"], dtype=F32, device=dev)
    hi = torch.tensor(sc["site_max_mm"], dtype=F32, device=dev)

    def place(sel, shrink):
        """Points of ``sel`` drawn in the site's box, shrunk to its centre."""
        mid, half = 0.5 * (lo + hi), 0.5 * shrink * (hi - lo)
        return mid + half * (2 * torch.rand((sel.shape[0], 3), generator=g, device=dev) - 1)

    return q, pos, obs_frame, obs_point, place


GRAPHS = {"sequential": _sequential, "collection": _collection}


def generate(cfg: dict, anchors: int, seed: int, device) -> dict:
    """The problem of configuration ``cfg`` (a ``configs/*.json`` object)
    for ``seed``, as the solver's tables, on ``device``: ``frame_quat``,
    ``frame_trans``, ``frame_cam``, ``cam_k``, ``point_loc``,
    ``point_uncertainty``, ``obs_frame``, ``obs_point``, ``obs_px``,
    ``obs_ok``, ``present``, ``free_frame`` (float32, int32 and bool), and
    the truth ``true_quat``, ``true_trans``, ``true_points``. The first
    ``anchors`` cameras are held fixed (the gauge); every other one is free."""
    dev = torch.device(device)
    C, P, O = cfg["cameras"], cfg["points"], cfg["observations"]
    a = cfg["assumed"]
    k = torch.tensor(a["intrinsics"], dtype=F32, device=dev)
    if any(a["intrinsics"][:3]):
        raise ValueError("the generator places points through a pinhole without distortion")
    tl = a["track_length"]
    L = torch.as_tensor(track_lengths(P, O, tl["cap"], tl["tail_alpha"]), device=dev)
    if int(L.max()) > C:
        raise ValueError(f"a track of {int(L.max())} cameras in a problem of {C}")
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    graph = torch.Generator(device=dev)
    graph.manual_seed(int(a["graph_seed"]))

    q, pos, obs_frame, obs_point, place = GRAPHS[cfg["graph"]](cfg, L, g, graph, dev)
    sc = a["scene"]
    X = torch.ones((P, 4), dtype=F32, device=dev)
    todo = torch.arange(P, device=dev)
    for r in range(PLACE_ROUNDS):
        X[todo, :3] = place(todo, min(1.0, 1.5 * (1.0 - r / PLACE_ROUNDS)))
        seen = _in_view(q, pos, X, obs_frame, obs_point, k, a["image"], sc["margin_px"],
                        sc["z_min_mm"])
        bad = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
            0, obs_point, (~seen).to(torch.int32)) > 0
        todo = torch.nonzero(bad)[:, 0]
        if todo.shape[0] == 0:
            break
    else:
        raise RuntimeError(f"{todo.shape[0]} points not placed in view of their tracks")

    noise = a["noise"]
    R = geo.rotation_matrix(q)
    pc = geo.to_camera(R[obs_frame], pos[obs_frame], X[obs_point], geo.Precision(F32))
    px = geo.pixel(pc, k.expand(O, 7)) + _normal(g, (O, 2), noise["pixel"], dev)
    t0 = pos + _normal(g, (C, 3), noise["pose_mm"], dev)
    t0[:anchors] = pos[:anchors]
    X0 = X.clone()
    X0[:, :3] += _normal(g, (P, 3), noise["point_mm"], dev)
    free_frame = torch.arange(C, device=dev) >= anchors
    return dict(
        frame_quat=q, frame_trans=t0, frame_cam=torch.zeros(C, dtype=torch.int32, device=dev),
        cam_k=k[None], point_loc=X0,
        point_uncertainty=torch.full((P,), a["point_uncertainty"], dtype=F32, device=dev),
        obs_frame=obs_frame.to(torch.int32), obs_point=obs_point.to(torch.int32), obs_px=px,
        obs_ok=torch.ones(O, dtype=torch.bool, device=dev),
        present=torch.ones(C, dtype=torch.bool, device=dev), free_frame=free_frame,
        true_quat=q, true_trans=pos, true_points=X)
