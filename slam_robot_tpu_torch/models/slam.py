"""Bundle-adjustment windows over the map (slam.{h,cpp}).

Port of ``slam_robot_tpu/models/slam.py``'s ``window_masks``,
``solve_frames`` (slam.cpp:417-443: the newest S frames free, the next P-S
presented but const, cameras const) and ``solve_all_frames`` (every frame
free, optionally the cameras too), the reference's no-op
``solve_frame_pose`` and the intended epipolar pose re-solve
``solve_frame_pose_epipolar`` (behind ``mid_frame_resolve``).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.ops import ba
from slam_robot_tpu_torch.ops import epipolar as epi
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import quaternion as quat


def _ba_cfg(cfg: SlamConfig, range_: float, solve_cameras: bool = False,
            fine: bool = False) -> ba.BAConfig:
    return ba.BAConfig(
        range=range_,
        max_iters=cfg.ba_max_iters,
        ftol=cfg.ba_ftol_fine if fine else cfg.ba_ftol,
        baseline=cfg.baseline_mm,
        frame_dist_weight=cfg.frame_dist_weight,
        frame_dist_loss=cfg.frame_dist_loss,
        uncertainty_free=cfg.uncertainty_confident,
        lm_lambda_init=cfg.lm_lambda_init,
        lm_lambda_up=cfg.lm_lambda_up,
        lm_lambda_down=cfg.lm_lambda_down,
        lm_lambda_min=cfg.lm_lambda_min,
        lm_policy=cfg.lm_policy,
        max_free_frames=16,
        cheirality_eps=cfg.cheirality_eps,
        solve_cameras=solve_cameras,
        camera_loss=cfg.camera_loss,
        stab_focal=cfg.focal,
        stab_cx=cfg.cx,
        stab_cy=cfg.cy,
    )


def window_masks(state: lm.MapState, num_to_solve: int, num_to_present: int):
    """Newest ``num_to_solve`` frames free, next presented const
    (slam.cpp:425-434)."""
    idx = torch.arange(state.frame_quat.shape[0], device=state.device)
    age = state.n_frames - 1 - idx
    free = (age >= 0) & (age < num_to_solve)
    present = (age >= 0) & (age < num_to_present)
    return free, present


def _obs_ok(state: lm.MapState, present_lo):
    """Participating observations: enabled, of slam-usable points, in a
    presented frame [present_lo, n_frames) (slam.cpp:279-299)."""
    usable = lm.slam_usable(state.point_flags)
    return (state.obs_mask & ~state.obs_disabled
            & usable[state.obs_point.clamp(min=0).long()]
            & (state.obs_frame >= present_lo)
            & (state.obs_frame < state.n_frames)
            & (state.obs_point >= 0))


def _run(state: lm.MapState, free, present, present_lo, bcfg: ba.BAConfig,
         window_obs: int | None = None, compact_obs: int | None = None):
    obs_frame, obs_point, obs_px = state.obs_frame, state.obs_point, state.obs_px
    obs_ok = _obs_ok(state, present_lo)
    obs_dropped = torch.zeros((), dtype=torch.int32, device=state.device)
    O = state.obs_frame.shape[0]
    if window_obs is not None and window_obs < O:
        # every observation of the presented (= newest) frames lives in the
        # append-ordered table's tail; count the participating rows the
        # fixed-size tail slice excludes (the reference includes them all)
        start = torch.clamp(state.n_obs - window_obs, min=0)
        head = torch.arange(O, device=state.device) < start
        obs_dropped = torch.sum((obs_ok & head), dtype=torch.int32)
        rows = start.long() + torch.arange(window_obs, device=state.device)
        obs_frame, obs_point, obs_px, obs_ok = (
            obs_frame[rows], obs_point[rows], obs_px[rows], obs_ok[rows])
    if compact_obs is not None and 0 < compact_obs < obs_ok.shape[0]:
        # participating rows first (stable), then truncate; overflow counted
        order = torch.argsort((~obs_ok).to(torch.int8), stable=True)
        keep = order[:compact_obs]
        n_ok = torch.sum(obs_ok, dtype=torch.int32)
        obs_dropped = obs_dropped + torch.clamp(n_ok - compact_obs, min=0)
        obs_frame, obs_point, obs_px, obs_ok = (
            obs_frame[keep], obs_point[keep], obs_px[keep], obs_ok[keep])
    res = ba.solve(state.frame_quat, state.frame_trans, state.frame_cam,
                   state.cam_k, state.point_loc, state.point_uncertainty,
                   obs_frame, obs_point, obs_px, obs_ok, present, free, bcfg)
    new_state = state._replace(frame_quat=res.frame_quat, frame_trans=res.frame_trans,
                               point_loc=res.point_loc, cam_k=res.cam_k)
    return new_state, res._replace(obs_dropped=obs_dropped)


def solve_frames(state: lm.MapState, num_to_solve: int, num_to_present: int,
                 range_: float = 2.0, cfg: SlamConfig | None = None,
                 max_iters: int | None = None, window_obs: int | None = None,
                 max_free_points: int | None = None,
                 compact_obs: int | None = None):
    """Slam::SolveFrames. Returns (state, BAResult)."""
    cfg = cfg or SlamConfig()
    free, present = window_masks(state, num_to_solve, num_to_present)
    bcfg = _ba_cfg(cfg, range_)._replace(max_free_frames=max(1, int(num_to_solve)))
    if max_free_points is not None:
        bcfg = bcfg._replace(max_free_points=int(max_free_points))
    if max_iters is not None:
        bcfg = bcfg._replace(max_iters=max_iters)
    return _run(state, free, present, state.n_frames - num_to_present, bcfg,
                window_obs=cfg.window_obs if window_obs is None else window_obs,
                compact_obs=compact_obs)


def solve_all_frames(state: lm.MapState, range_: float = 2.0,
                     solve_cameras: bool = False, cfg: SlamConfig | None = None):
    """Slam::SolveAllFrames: every frame free; optionally also the camera
    intrinsics (with stabilization residuals). Returns (state, BAResult)."""
    cfg = cfg or SlamConfig()
    present = state.frame_mask
    bcfg = _ba_cfg(cfg, range_, solve_cameras=solve_cameras, fine=solve_cameras)
    bcfg = bcfg._replace(max_free_frames=int(state.frame_quat.shape[0]))
    return _run(state, present, present, 0, bcfg)


def solve_frame_pose(state: lm.MapState, *_args, **_kw):
    """Slam::SolveFramePose as the reference runs it: an unconditional
    ``return false`` (slam.cpp:177-182). The intended behavior is
    :func:`solve_frame_pose_epipolar`."""
    return state, False


def solve_frame_pose_epipolar(state: lm.MapState, iters: int = 20, min_count: int = 8):
    """The intended Slam::SolveFramePose (slam.cpp:177-248): re-solve the
    newest frame's pose against its predecessor from epipolar constraints.

    Five parameters: the relative rotation q_rel = q2 q1^-1 on its tangent
    and the unit translation direction r = normalize([x+d0, y-d0-d1, z+d1])
    (UnitVectorParameterization, slam.cpp:162-174); per shared point the
    residual h2^T skew(t) R h1 under CauchyLoss(0.01) (slam.cpp:128-158),
    ``iters`` Gauss-Newton steps. Fewer than ``min_count`` shared points
    leave the state as it is (slam.cpp:222-225); otherwise q2 = q_rel q1,
    t2 = t1 - t_dir |t1 - t2| (slam.cpp:244-245). Returns (state, ok), ok a
    tensor: no host read."""
    dev = state.device
    P = state.point_loc.shape[0]
    f2 = torch.clamp(state.n_frames - 1, min=0).reshape(1).long()
    f1 = torch.clamp(state.n_frames - 2, min=0).reshape(1).long()
    pxs, ok_ring, _rows = lm._ring_gather(state, state.obs_px)

    def pick(fid):
        m = ok_ring & (state.ring_frame == fid.to(torch.int32))
        j = torch.argmax(m.to(torch.uint8), dim=1)
        px = torch.gather(pxs, 1, j[:, None, None].expand(-1, 1, 2))[:, 0]
        return px, torch.any(m, dim=1)

    px1, has1 = pick(f1)
    px2, has2 = pick(f2)
    pair_ok = has1 & has2 & state.point_mask
    count = torch.sum(pair_ok, dtype=torch.int32)

    def row(a, f):
        return a.index_select(0, f)[0]

    k1 = state.cam_k.index_select(0, row(state.frame_cam, f1).reshape(1).long())[0]
    k2 = state.cam_k.index_select(0, row(state.frame_cam, f2).reshape(1).long())[0]
    ones = torch.ones((P, 1), dtype=torch.float32, device=dev)
    h1h = torch.cat([proj.pixel_to_plane(px1, k1), ones], dim=1)
    h2h = torch.cat([proj.pixel_to_plane(px2, k2), ones], dim=1)
    w_pair = pair_ok.to(torch.float32)

    q1, t1 = row(state.frame_quat, f1), row(state.frame_trans, f1)
    q2, t2 = row(state.frame_quat, f2), row(state.frame_trans, f2)
    q_rel = quat.normalize(quat.multiply(q2, quat.conjugate(q1)))
    tvec = t1 - t2
    length = torch.linalg.norm(tvec)
    t_dir = tvec / torch.clamp(length, min=1e-9)
    c = 0.01  # CauchyLoss(0.01), slam.cpp:188

    def unit_dir(t_dir, dd):
        t = t_dir + torch.stack([dd[0], -dd[0] - dd[1], dd[1]])
        return t / torch.clamp(torch.linalg.norm(t), min=1e-9)

    def residuals(xi, dd, q_rel, t_dir):
        e = epi.skew(unit_dir(t_dir, dd)) @ quat.to_matrix(quat.retract(q_rel, xi))
        return torch.einsum("pi,ij,pj->p", h2h, e, h1h)

    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    z2 = torch.zeros(2, dtype=torch.float32, device=dev)
    eye = 1e-8 * torch.eye(5, dtype=torch.float32, device=dev)
    jac = jacfwd(residuals, argnums=(0, 1))
    for _ in range(iters):
        r = residuals(z3, z2, q_rel, t_dir)
        jxi, jdd = jac(z3, z2, q_rel, t_dir)
        j = torch.cat([jxi, jdd], dim=1)  # [P, 5]
        wr = w_pair / (1.0 + (r * r) / (c * c))
        H = torch.einsum("pa,pb,p->ab", j, j, wr) + eye
        g = torch.einsum("pa,p,p->a", j, wr, r)
        d, _info = torch.linalg.solve_ex(H, -g)
        q_rel = quat.retract(q_rel, d[:3])
        t_dir = unit_dir(t_dir, d[3:])

    ok = (count >= min_count) & (state.n_frames >= 2)
    new_q2 = quat.normalize(quat.multiply(q_rel, q1))
    new_t2 = t1 - t_dir * length
    return state._replace(
        frame_quat=torch.where(ok, state.frame_quat.index_put((f2,), new_q2[None]),
                               state.frame_quat),
        frame_trans=torch.where(ok, state.frame_trans.index_put((f2,), new_t2[None]),
                                state.frame_trans),
    ), ok
