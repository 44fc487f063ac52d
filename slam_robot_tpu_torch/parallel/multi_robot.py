"""Multi-robot shared mapping (BASELINE config 5).

Port of ``slam_robot_tpu/parallel/multi_robot.py``. R robots each own a
trajectory (frames and observations) into ONE shared landmark table. Joint
BA over all robots couples their frames only through shared points, so a
block-coordinate scheme scales cleanly:

  (a) point solve: the landmark normal equations of every robot, computed
      in one batch over robots and summed, update the shared points in
      closed form
  (b) frame solve: per-robot windowed BA (``ops/ba.solve``) with the
      points held const, robot by robot (the solve's LM loop reads its exit
      flag on the host, so it does not batch over robots)

Alternating (a)/(b) is Gauss-Seidel on the joint problem; for the
workloads here a few sweeps reach the same fixed point as joint LM.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from slam_robot_tpu_torch.ops import ba
from slam_robot_tpu_torch.ops import projection as proj


def _point_normal_eqs(frame_quat, frame_trans, frame_cam, cam_k, point_loc,
                      obs_frame, obs_point, obs_px, obs_ok, c: float,
                      cheirality_eps: float = 0.001):
    """Per-robot landmark blocks, batched over robots: C [R,P,3,3], b [R,P,3]
    from frame tables [R,F,*] and observation tables [R,O,*]."""
    R, O = obs_frame.shape
    P = point_loc.shape[0]
    rr = torch.arange(R, device=obs_frame.device)[:, None]
    f = obs_frame.clamp(min=0).long()
    p = obs_point.clamp(min=0).long()
    q, t = frame_quat[rr, f], frame_trans[rr, f]
    k = cam_k[frame_cam[rr, f].long()]
    loc = point_loc[p]

    r, valid = proj.reprojection_error(q, t, k, loc, obs_px, cheirality_eps)
    use = obs_ok & valid & torch.all(torch.isfinite(r), dim=-1)
    w = torch.where(use, 1.0 / (1.0 + torch.sum(r * r, -1) / (c * c)), 0.0)

    def res(loc, q, t, k, px):
        return proj.reprojection_error(q, t, k, loc, px, cheirality_eps)[0]

    flat = lambda x: x.reshape(R * O, *x.shape[2:])  # noqa: E731
    jp = vmap(jacfwd(res))(flat(loc), flat(q), flat(t), flat(k), flat(obs_px))
    # xyz columns only: the homogeneous scale direction is gauge (the
    # closed-form step has no LM accept/reject to contain it)
    jp = jp[..., :3].reshape(R, O, 2, 3) * use[..., None, None]
    row = (rr * P + p).reshape(-1)
    C = jp.new_zeros((R * P, 3, 3)).index_add_(
        0, row, flat(torch.einsum("roia,roib,ro->roab", jp, jp, w)))
    b = jp.new_zeros((R * P, 3)).index_add_(
        0, row, flat(-torch.einsum("roia,roi->roa", jp,
                                   w[..., None] * torch.where(use[..., None], r, 0.0))))
    return C.reshape(R, P, 3, 3), b.reshape(R, P, 3)


def solve_shared_map(
    frame_quat,         # [R,F,4] per-robot
    frame_trans,        # [R,F,3]
    frame_cam,          # [R,F]
    cam_k,              # [C,7] shared cameras
    point_loc,          # [P,4] SHARED landmarks
    point_uncertainty,  # [P]
    obs_frame,          # [R,O]
    obs_point,          # [R,O] indices into the shared table
    obs_px,             # [R,O,2]
    obs_ok,             # [R,O]
    present,            # [R,F]
    free_frame,         # [R,F]
    cfg: ba.BAConfig = ba.BAConfig(),
    sweeps: int = 3,
):
    """Alternating multi-robot BA on the tensors' device. Returns
    (frame_quat, frame_trans, point_loc) updated."""
    fq, ft, locs = frame_quat, frame_trans, point_loc
    eye3 = torch.eye(3, dtype=locs.dtype, device=locs.device)
    # points const in the frame solve: uncertainty 0 keeps them out of the
    # free set
    tiny_unc = torch.zeros_like(point_uncertainty)
    for _ in range(sweeps):
        # (a) shared point solve: accumulate across robots
        C, b = _point_normal_eqs(fq, ft, frame_cam, cam_k, locs, obs_frame, obs_point,
                                 obs_px, obs_ok, cfg.range, cfg.cheirality_eps)
        C = torch.sum(C, dim=0)
        b = torch.sum(b, dim=0)
        tr = torch.einsum("pii->p", C)
        damp = 1e-3 * eye3 * torch.clamp(tr[:, None, None] / 3.0, min=1e-6) + 1e-8 * eye3
        dp = torch.einsum("pab,pb->pa", torch.linalg.inv_ex(C + damp).inverse, b)
        locs = torch.cat([locs[:, :3] + torch.where((tr > 0)[:, None], dp, 0.0), locs[:, 3:]],
                         dim=1)

        # (b) per-robot frame solve with the points const
        res = [ba.solve(fq[i], ft[i], frame_cam[i], cam_k, locs, tiny_unc, obs_frame[i],
                        obs_point[i], obs_px[i], obs_ok[i], present[i], free_frame[i], cfg)
               for i in range(fq.shape[0])]
        fq = torch.stack([r.frame_quat for r in res])
        ft = torch.stack([r.frame_trans for r in res])
    return fq, ft, locs
