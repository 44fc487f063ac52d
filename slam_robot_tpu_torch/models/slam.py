"""Bundle-adjustment windows over the map (slam.{h,cpp}).

Port of ``slam_robot_tpu/models/slam.py``'s ``window_masks``,
``solve_frames`` (slam.cpp:417-443: the newest S frames free, the next P-S
presented but const, cameras const) and ``solve_all_frames`` (every frame
free, optionally the cameras too). The epipolar pose re-solve
(``solve_frame_pose_epipolar``, behind ``mid_frame_resolve``) is not ported.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.ops import ba


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
