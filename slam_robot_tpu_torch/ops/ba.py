"""Schur-complement Levenberg-Marquardt bundle adjustment.

Port of ``slam_robot_tpu/ops/ba.py`` (the reference's Ceres solve,
slam.cpp:257-521): Cauchy IRLS, per-observation Jacobians in the 3-dof
tangent of the exp-map retraction (frames) and raw homogeneous 4-space
(points), batched Schur elimination of the 4x4 landmark blocks, the
FrameDistance prior, the classic and marquardt damping policies, and
free-point / free-frame slot compaction, and (``solve_cameras``) the
camera intrinsics with their CameraStabilization residuals.

Block sums over observations are one-hot matrix products, as in the JAX
package: they are exact (each output sums one real term and exact zeros)
and, unlike atomic scatter-adds on the card, they give the same bits on
every run. The LM ``while_loop`` is a host loop that reads one pair of
flags per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from slam_robot_tpu_torch.device import host, span
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import quaternion as quat

F32 = torch.float32
I32 = torch.int32


class BAConfig(NamedTuple):
    range: float = 2.0
    max_iters: int = 50
    ftol: float = 1e-7
    xtol: float = 1e-6
    baseline: float = 150.0
    frame_dist_weight: float = 0.1
    frame_dist_loss: float = 15.0
    uncertainty_free: float = 100.0
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10
    lm_policy: str = "classic"
    max_free_frames: int = 16
    max_free_points: int = 0
    cheirality_eps: float = 0.001
    solve_cameras: bool = False
    camera_loss: float = 5.0
    stab_focal: float = 416.0
    stab_cx: float = 320.0
    stab_cy: float = 240.0


TERM_NOT_RUN = 0
TERM_FTOL = 1
TERM_XTOL = 2
TERM_STALL = 3
TERM_MAX_ITERS = 4


class BAResult(NamedTuple):
    frame_quat: torch.Tensor
    frame_trans: torch.Tensor
    point_loc: torch.Tensor
    cam_k: torch.Tensor
    ok: torch.Tensor
    cost: torch.Tensor
    iters: torch.Tensor
    term: torch.Tensor
    cost0: torch.Tensor
    obs_dropped: torch.Tensor | int = 0


def _cauchy_weight(s, c):
    return 1.0 / (1.0 + s / (c * c))


def _cauchy_rho(s, c):
    return c * c * torch.log1p(s / (c * c))


def inv4x4(m):
    """Batched closed-form 4x4 inverse via the adjugate. m: [..., 4, 4]."""
    a = m
    s0 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    s1 = a[..., 0, 0] * a[..., 1, 2] - a[..., 1, 0] * a[..., 0, 2]
    s2 = a[..., 0, 0] * a[..., 1, 3] - a[..., 1, 0] * a[..., 0, 3]
    s3 = a[..., 0, 1] * a[..., 1, 2] - a[..., 1, 1] * a[..., 0, 2]
    s4 = a[..., 0, 1] * a[..., 1, 3] - a[..., 1, 1] * a[..., 0, 3]
    s5 = a[..., 0, 2] * a[..., 1, 3] - a[..., 1, 2] * a[..., 0, 3]
    c5 = a[..., 2, 2] * a[..., 3, 3] - a[..., 3, 2] * a[..., 2, 3]
    c4 = a[..., 2, 1] * a[..., 3, 3] - a[..., 3, 1] * a[..., 2, 3]
    c3 = a[..., 2, 1] * a[..., 3, 2] - a[..., 3, 1] * a[..., 2, 2]
    c2 = a[..., 2, 0] * a[..., 3, 3] - a[..., 3, 0] * a[..., 2, 3]
    c1 = a[..., 2, 0] * a[..., 3, 2] - a[..., 3, 0] * a[..., 2, 2]
    c0 = a[..., 2, 0] * a[..., 3, 1] - a[..., 3, 0] * a[..., 2, 1]

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    tiny = torch.where(det >= 0, torch.full_like(det, 1e-30), torch.full_like(det, -1e-30))
    det = torch.where(torch.abs(det) > 1e-30, det, tiny)
    inv_det = 1.0 / det
    b = torch.stack([
        a[..., 1, 1] * c5 - a[..., 1, 2] * c4 + a[..., 1, 3] * c3,
        -a[..., 0, 1] * c5 + a[..., 0, 2] * c4 - a[..., 0, 3] * c3,
        a[..., 3, 1] * s5 - a[..., 3, 2] * s4 + a[..., 3, 3] * s3,
        -a[..., 2, 1] * s5 + a[..., 2, 2] * s4 - a[..., 2, 3] * s3,
        -a[..., 1, 0] * c5 + a[..., 1, 2] * c2 - a[..., 1, 3] * c1,
        a[..., 0, 0] * c5 - a[..., 0, 2] * c2 + a[..., 0, 3] * c1,
        -a[..., 3, 0] * s5 + a[..., 3, 2] * s2 - a[..., 3, 3] * s1,
        a[..., 2, 0] * s5 - a[..., 2, 2] * s2 + a[..., 2, 3] * s1,
        a[..., 1, 0] * c4 - a[..., 1, 1] * c2 + a[..., 1, 3] * c0,
        -a[..., 0, 0] * c4 + a[..., 0, 1] * c2 - a[..., 0, 3] * c0,
        a[..., 3, 0] * s4 - a[..., 3, 1] * s2 + a[..., 3, 3] * s0,
        -a[..., 2, 0] * s4 + a[..., 2, 1] * s2 - a[..., 2, 3] * s0,
        -a[..., 1, 0] * c3 + a[..., 1, 1] * c1 - a[..., 1, 2] * c0,
        a[..., 0, 0] * c3 - a[..., 0, 1] * c1 + a[..., 0, 2] * c0,
        -a[..., 3, 0] * s3 + a[..., 3, 1] * s1 - a[..., 3, 2] * s0,
        a[..., 2, 0] * s3 - a[..., 2, 1] * s1 + a[..., 2, 2] * s0,
    ], dim=-1).reshape(m.shape)
    return b * inv_det[..., None, None]


def _count_into(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram of ``idx`` over [0, n) (index ``n`` is the drop bin)."""
    ones = torch.ones_like(idx, dtype=I32)
    return torch.zeros(n + 1, dtype=I32, device=idx.device).index_add(0, idx.long(), ones)[:n]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over [0, n); index n (the drop sentinel) is all-zero."""
    return F.one_hot(idx.long(), n + 1)[:, :n].to(F32)


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def _stab_residual(k, cfg: BAConfig):
    """CameraStabilization (slam.cpp:107-124) of one camera's k [7]:
    weights * (k1, k2, k3, fx - f, fy + fx, cx - cx0, cy - cy0)^2.

    Written with whole-vector tensor ops only: under ``jacfwd`` an op
    between a 0-d tensor and a Python float yields a float64 tangent."""
    opts = dict(dtype=k.dtype, device=k.device)
    mix = torch.eye(7, **opts)
    mix[4, 3] = 1.0                       # row 4: k[4] + k[3] (exact)
    off = torch.tensor([0.0, 0.0, 0.0, -cfg.stab_focal, 0.0, -cfg.stab_cx,
                        -cfg.stab_cy], **opts)
    w = torch.tensor([1000.0, 1000.0, 1000.0, 0.1, 0.1, 0.01, 0.01], **opts)
    d = mix @ k + off
    return w * d * d


def _block_diag(blocks):
    """[C, n, n] -> the [C*n, C*n] block-diagonal matrix."""
    C, n = blocks.shape[0], blocks.shape[1]
    eye = torch.eye(C, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("cd,cab->cadb", eye, blocks).reshape(C * n, C * n)


@span("ba_solve")
def solve(frame_quat, frame_trans, frame_cam, cam_k, point_loc, point_uncertainty,
          obs_frame, obs_point, obs_px, obs_ok, present, free_frame,
          cfg: BAConfig = BAConfig()) -> BAResult:
    """Windowed BA over the given tables (shapes as the JAX package's
    ``ops/ba.solve``). Returns a :class:`BAResult`."""
    dev = frame_quat.device
    Fn = frame_quat.shape[0]
    P = point_loc.shape[0]
    C = cam_k.shape[0]
    W = cfg.max_free_frames
    DF = 6 * W
    cams = cfg.solve_cameras
    DK = 7 * C if cams else 0
    ar_f = torch.arange(Fn, device=dev)

    f_idx = obs_frame.clamp(min=0).long()
    p_idx = obs_point.clamp(min=0).long()
    c_idx = frame_cam[f_idx].long()

    # ---- structure masks (slam.cpp:267-308, 344-354) ----
    fsent = torch.full_like(f_idx, Fn)
    psent = torch.full_like(p_idx, P)
    frame_has_obs = _count_into(torch.where(obs_ok, f_idx, fsent), Fn) > 0
    n_used = torch.sum((present & frame_has_obs), dtype=I32)
    solvable = n_used >= 2
    free_f = free_frame & frame_has_obs & solvable
    point_in = _count_into(torch.where(obs_ok, p_idx, psent), P) > 0
    fluid = _count_into(torch.where(obs_ok & free_f[f_idx], p_idx, psent), P) > 0
    free_p = point_in & (fluid | (point_uncertainty > cfg.uncertainty_free)) & solvable

    if cfg.max_free_points and cfg.max_free_points < P:
        PW = cfg.max_free_points
        # newest-first priority: the oldest free points are demoted to const
        rank = torch.flip(torch.cumsum(torch.flip(free_p.to(I32), [0]), 0), [0]) - 1
        free_p = free_p & (rank < PW)
        pslot_of = torch.where(free_p, rank, torch.full_like(rank, PW)).to(I32)
        obs_pc = pslot_of[p_idx]
        merge_p = _one_hot(pslot_of, PW)                       # [P, PW]
        free_pc = torch.arange(PW, device=dev) < torch.sum(free_p, dtype=I32)
    else:
        PW = P
        obs_pc = p_idx
        merge_p = None
        free_pc = free_p

    fi = free_f.to(I32)
    slot_of = torch.where(free_f, torch.cumsum(fi, 0).to(I32) - 1,
                          torch.full_like(fi, W)).clamp(max=W)
    obs_slot = slot_of[f_idx]

    prev_present = torch.roll(present, 1)
    prev_present = torch.cat([torch.zeros_like(prev_present[:1]), prev_present[1:]])
    prior_f = free_f & prev_present & (ar_f >= 1)

    eps_c = cfg.cheirality_eps

    def obs_residuals(fq, ft, ks, locs):
        r, valid = proj.reprojection_error(fq[f_idx], ft[f_idx], ks[c_idx],
                                           locs[p_idx], obs_px, eps_c)
        use = obs_ok & valid & torch.all(torch.isfinite(r), dim=-1)
        return torch.where(use[:, None], r, torch.zeros_like(r)), use

    stab = vmap(lambda k: _stab_residual(k, cfg))
    stab_jac = vmap(jacfwd(lambda k: _stab_residual(k, cfg)))

    def total_cost(fq, ft, ks, locs):
        r, use = obs_residuals(fq, ft, ks, locs)
        s = torch.sum(r * r, dim=-1)
        rho = _cauchy_rho(s, cfg.range)
        cost = torch.sum(torch.where(use, rho, torch.zeros_like(rho)))
        d = torch.linalg.norm(ft - torch.roll(ft, 1, dims=0), dim=-1)
        rp = cfg.frame_dist_weight * (d - cfg.baseline)
        rho_p = _cauchy_rho(rp * rp, cfg.frame_dist_loss)
        cost = cost + torch.sum(torch.where(prior_f, rho_p, torch.zeros_like(rho_p)))
        if cams:
            rs = stab(ks)
            cost = cost + torch.sum(_cauchy_rho(torch.sum(rs * rs, dim=-1), cfg.camera_loss))
        return 0.5 * cost

    def res_params(xi, t, p, k, q0, px):
        r, _ = proj.reprojection_error(quat.retract(q0, xi), t, k, p, px, eps_c)
        return r

    jac_fn = vmap(jacfwd(res_params, argnums=(0, 1, 2, 3) if cams else (0, 1, 2)))
    ohs = _one_hot(obs_slot, W)                                  # [O, W]
    ohp = _one_hot(obs_pc, PW)                                   # [O, PW]
    eyeW = torch.eye(W, dtype=F32, device=dev)

    slot_prev = torch.roll(slot_of, 1)
    slot_prev = torch.cat([torch.full_like(slot_prev[:1], W), slot_prev[1:]])
    oh_f = _one_hot(torch.where(prior_f, slot_of, torch.full_like(slot_of, W)), W)
    oh_prev = _one_hot(torch.where(prior_f, slot_prev, torch.full_like(slot_prev, W)), W)

    def build_normal(fq, ft, ks, locs):
        """Every lambda-independent block at the current state."""
        r, use = obs_residuals(fq, ft, ks, locs)
        s = torch.sum(r * r, dim=-1)
        w = torch.where(use, _cauchy_weight(s, cfg.range), torch.zeros_like(s))
        O = f_idx.shape[0]
        jac = jac_fn(torch.zeros((O, 3), dtype=F32, device=dev), ft[f_idx],
                     locs[p_idx], ks[c_idx], fq[f_idx], obs_px)
        jxi, jt, jp = jac[:3]
        jf = torch.cat([jxi, jt], dim=-1)
        jf = jf * (use & (obs_slot < W))[:, None, None].to(F32)
        jp = jp * (use & free_p[p_idx])[:, None, None].to(F32)
        jaug = torch.cat([jf, r[:, :, None], jp], dim=-1)         # [O,2,11]
        blk = torch.einsum("oia,oib,o->oab", jaug, jaug, w)

        mp = torch.einsum("op,oab->pab", ohp, blk[:, 6:, 6:])
        Cp = mp[:, 1:, 1:]
        bp = -mp[:, 1:, 0]
        mf = torch.einsum("ow,oab->wab", ohs, blk[:, :7, :7])
        Hff = mf[:, :6, :6].clone()
        bf = -mf[:, :6, 6]
        A = torch.einsum("op,owab->pwab", ohp,
                         torch.einsum("ow,oab->owab", ohs, blk[:, :6, 7:]))

        tprev = torch.roll(ft, 1, dims=0)
        dvec = ft - tprev
        dnorm = torch.linalg.norm(dvec, dim=-1)
        dhat = dvec / torch.clamp(dnorm, min=1e-9)[:, None]
        rp = cfg.frame_dist_weight * (dnorm - cfg.baseline)
        wp = torch.where(prior_f, _cauchy_weight(rp * rp, cfg.frame_dist_loss),
                         torch.zeros_like(rp))
        jp_t = cfg.frame_dist_weight * dhat
        pblk = torch.einsum("fa,fb,f->fab", jp_t, jp_t, wp)
        prior_diag = (torch.einsum("fw,fab->wab", oh_f, pblk)
                      + torch.einsum("fw,fab->wab", oh_prev, pblk))
        Hff[:, 3:, 3:] += prior_diag
        gvec = (wp * rp)[:, None] * jp_t
        prior_b = (-torch.einsum("fw,fa->wa", oh_f, gvec)
                   + torch.einsum("fw,fa->wa", oh_prev, gvec))
        bf = torch.cat([bf[:, :3], bf[:, 3:] + prior_b], dim=1)
        off = torch.einsum("fa,fb,f->fab", jp_t, -jp_t, wp)
        T = torch.einsum("fw,fv,fab->wavb", oh_f, oh_prev, off)
        if not cams:
            return Cp, bp, Hff, bf, A, T, None

        # camera columns: coupling with frames and points, plus the
        # stabilization residuals
        jk = jac[3] * use[:, None, None].to(F32)                  # [O,2,7]
        rm = torch.where(use[:, None], r, torch.zeros_like(r))
        ohc = _one_hot(c_idx, C)                                   # [O,C]
        Hkk = torch.einsum("oc,oab->cab", ohc, torch.einsum("oia,oib,o->oab", jk, jk, w))
        bk = -torch.einsum("oc,oia,oi->ca", ohc, jk, w[:, None] * rm)
        Hfk = torch.einsum("oc,owab->wcab", ohc, torch.einsum(
            "ow,oab->owab", ohs, torch.einsum("oia,oib,o->oab", jf, jk, w)))
        Ak = torch.einsum("op,ocab->pcab", ohp, torch.einsum(
            "oc,oab->ocab", ohc, torch.einsum("oia,oib,o->oab", jk, jp, w)))
        js = stab_jac(ks)                                          # [C,7,7]
        rs = stab(ks)
        ws = _cauchy_weight(torch.sum(rs * rs, dim=-1), cfg.camera_loss)
        Hkk = Hkk + torch.einsum("cia,cib,c->cab", js, js, ws)
        bk = bk - torch.einsum("cia,ci,c->ca", js, rs, ws)
        return Cp, bp, Hff, bf, A, T, (Hkk, bk, Hfk, Ak)

    def solve_damped(normal, lam):
        """Damping, Schur complement, reduced solve, back-substitution."""
        Cp, bp, Hff, bf, A, T, cam = normal
        eye4 = torch.eye(4, dtype=F32, device=dev)
        eye6 = torch.eye(6, dtype=F32, device=dev)
        lamI4 = lam * eye4 * torch.clamp(_trace(Cp)[:, None, None] / 4.0, min=1e-6) \
            + 1e-8 * eye4
        Cinv = torch.where(free_pc[:, None, None], inv4x4(Cp + lamI4),
                           torch.zeros((1, 4, 4), dtype=F32, device=dev))
        # A free point's damped block that is singular in float32 (the
        # damping lost to rounding beside large entries) gets an inverse
        # that overflows to inf; the JAX package's whole step is then NaN
        # (inf * 0 in the Schur products) and its LM loop rejects it. Here
        # that step is zeroed and marked invalid, and the loop rejects it
        # the same way without making a NaN (checked_step guards every
        # operation).
        valid = torch.all(torch.isfinite(Cinv))
        Cinv = torch.where(valid, Cinv, torch.zeros_like(Cinv))
        Hff_d = Hff + lam * eye6 * torch.clamp(_trace(Hff)[:, None, None] / 6.0, min=1e-6) \
            + 1e-8 * eye6
        S66 = torch.einsum("wv,wab->wavb", eyeW, Hff_d).clone()
        S66[:, 3:, :, 3:] += T + T.permute(2, 3, 0, 1)
        ACi = torch.einsum("pwia,pab->pwib", A, Cinv)
        S66 = S66 - torch.einsum("pwib,pvjb->wivj", ACi, A)
        S = S66.reshape(DF, DF)
        rhs = (bf - torch.einsum("pwib,pb->wi", ACi, bp)).reshape(DF)

        slot_active = torch.repeat_interleave(
            torch.arange(W, device=dev) < torch.sum(free_f, dtype=I32), 6)
        if cam is not None:
            Hkk, bk, Hfk, Ak = cam
            eye7 = torch.eye(7, dtype=F32, device=dev)
            Hkk_d = Hkk + lam * eye7 * torch.clamp(_trace(Hkk)[:, None, None] / 7.0, min=1e-6) \
                + 1e-8 * eye7
            AkCi = torch.einsum("pcia,pab->pcib", Ak, Cinv)
            S_kk = torch.einsum("pcib,pdjb->cidj", AkCi, Ak).reshape(DK, DK)
            fk = Hfk.reshape(DF, DK) - torch.einsum("pwib,pcjb->wicj", ACi, Ak).reshape(DF, DK)
            S = torch.cat([torch.cat([S, fk], dim=1),
                           torch.cat([fk.T, _block_diag(Hkk_d) - S_kk], dim=1)], dim=0)
            rhs = torch.cat([rhs, bk.reshape(DK)
                             - torch.einsum("pcib,pb->ci", AkCi, bp).reshape(DK)])
            slot_active = torch.cat([slot_active,
                                     torch.ones(DK, dtype=torch.bool, device=dev)])
        m2 = slot_active[:, None] & slot_active[None, :]
        S = torch.where(m2, S, torch.eye(DF + DK, dtype=F32, device=dev))
        rhs = torch.where(slot_active, rhs, torch.zeros_like(rhs))
        delta, _info = torch.linalg.solve_ex(S, rhs)
        df = delta[:DF].reshape(W, 6)
        dk = delta[DF:].reshape(C, 7) if cam is not None else None

        Atd = torch.einsum("pwia,wi->pa", A, df)
        if cam is not None:
            Atd = Atd + torch.einsum("pcia,ci->pa", Ak, dk)
        dp = torch.einsum("pab,pb->pa", Cinv, bp - Atd)

        d_dot_b = torch.sum(df * bf) + torch.sum(dp * bp)
        scale_f = torch.clamp(_trace(Hff) / 6.0, min=1e-6)
        scale_p = torch.clamp(_trace(Cp) / 4.0, min=1e-6)
        d_dot_Dd = (torch.sum(scale_f * torch.sum(df * df, dim=-1))
                    + torch.sum(scale_p * torch.sum(dp * dp, dim=-1)))
        if cam is not None:
            d_dot_b = d_dot_b + torch.sum(dk * bk)
            scale_k = torch.clamp(_trace(Hkk) / 7.0, min=1e-6)
            d_dot_Dd = d_dot_Dd + torch.sum(scale_k * torch.sum(dk * dk, dim=-1))
        pred_red = 0.5 * (d_dot_b + lam * d_dot_Dd)

        if merge_p is not None:
            dp = torch.matmul(merge_p, dp)
        dp = torch.where(free_p[:, None], dp, torch.zeros_like(dp))
        upd = (free_f & (slot_of < W))[:, None]
        dsel = df[slot_of.clamp(0, W - 1).long()]
        upd = upd & valid
        dxi = torch.where(upd, dsel[:, :3], torch.zeros_like(dsel[:, :3]))
        dt = torch.where(upd, dsel[:, 3:], torch.zeros_like(dsel[:, 3:]))
        dp = torch.where(valid, dp, torch.zeros_like(dp))
        if dk is not None:
            dk = torch.where(valid, dk, torch.zeros_like(dk))
        pred_red = torch.where(valid, pred_red, torch.zeros_like(pred_red))
        return dxi, dt, dk, dp, pred_red, valid

    def apply(fq, ft, ks, locs, dxi, dt, dk, dp):
        nq = quat.retract(fq, dxi)
        nq = torch.where(free_f[:, None], nq, fq)
        return nq, ft + dt, ks if dk is None else ks + dk, locs + dp

    # ---- LM loop (host-driven; one flag read per iteration) ----
    fq, ft, ks, locs = frame_quat, frame_trans, cam_k, point_loc
    cost0 = total_cost(fq, ft, ks, locs)
    cost = cost0
    lam = torch.tensor(cfg.lm_lambda_init, dtype=F32, device=dev)
    nu = torch.tensor(2.0, dtype=F32, device=dev)
    rejects = torch.zeros((), dtype=I32, device=dev)
    term = torch.tensor(TERM_MAX_ITERS, dtype=I32, device=dev)
    normal = None
    stale = True
    it = 0
    done = not host(solvable)
    while it < cfg.max_iters and not done:
        if stale:
            normal = build_normal(fq, ft, ks, locs)
        dxi, dt, dk, dp, pred_red, valid = solve_damped(normal, lam)
        step_inf = torch.maximum(torch.max(torch.abs(dxi)),
                                 torch.maximum(torch.max(torch.abs(dt)),
                                               torch.max(torch.abs(dp))))
        if dk is not None:
            step_inf = torch.maximum(step_inf, torch.max(torch.abs(dk)))
        # an invalid step is the JAX package's NaN step: neither tiny nor
        # accepted
        tiny = (step_inf < cfg.xtol) & valid
        cq, ct, ck, cl = apply(fq, ft, ks, locs, dxi, dt, dk, dp)
        new_cost = total_cost(cq, ct, ck, cl)
        accept = (new_cost < cost) & valid
        fq = torch.where(accept, cq, fq)
        ft = torch.where(accept, ct, ft)
        ks = torch.where(accept, ck, ks)
        locs = torch.where(accept, cl, locs)
        if cfg.lm_policy == "marquardt":
            rho = (cost - new_cost) / torch.clamp(pred_red, min=1e-20)
            shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            new_lam = torch.where(accept, lam * shrink, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        else:
            new_lam = torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
        new_lam = torch.clamp(new_lam, cfg.lm_lambda_min, 1e8)
        converged = accept & ((cost - new_cost) <= cfg.ftol * torch.clamp(cost, min=1e-20))
        rejects = torch.where(accept, torch.zeros_like(rejects), rejects + 1)
        stalled = (rejects >= 5) | (new_lam >= 1e7)
        cost = torch.where(accept, new_cost, cost)
        term = torch.where(converged, TERM_FTOL, torch.where(
            tiny, TERM_XTOL, torch.where(stalled, TERM_STALL, TERM_MAX_ITERS))).to(I32)
        lam = new_lam
        it += 1
        done, stale = host(torch.stack([converged | stalled | tiny, accept]))

    return BAResult(
        frame_quat=torch.where(solvable, fq, frame_quat),
        frame_trans=torch.where(solvable, ft, frame_trans),
        point_loc=torch.where(solvable, locs, point_loc),
        cam_k=torch.where(solvable, ks, cam_k),
        ok=solvable,
        cost=cost,
        iters=torch.tensor(it, dtype=I32, device=dev),
        term=torch.where(solvable, term, torch.full_like(term, TERM_NOT_RUN)),
        cost0=cost0,
    )
