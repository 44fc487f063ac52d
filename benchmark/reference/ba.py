"""The plain reference of the large-map bundle adjuster: Gauss-Newton over
the reduced camera system, solved by preconditioned conjugate gradients.

Written from the solver's description (the reference SLAM code's
ITERATIVE_SCHUR with SCHUR_JACOBI, slam.cpp:488-490, as the solver under
test states its mathematics), in plain PyTorch, with Jacobians in closed
form and every sum over observations an ``index_add_``. It takes the
problem's tables and the configuration's ``solver`` settings and works out
all else again; it reads nothing that the solver under test made.

One Gauss-Newton step at the current frames (q, t) and points X:

- residual ``r = pixel(R(q) (X[:3] - t X[3])) - observed`` of each row that
  is ``ok``, in front of its camera (``z >= cheirality_eps * X[3]``) and
  finite; Cauchy weight ``w = 1 / (1 + |r|^2 / range^2)``; cost
  ``0.5 sum range^2 log(1 + |r|^2 / range^2)``.
- Jacobians at the current values: a frame's 6 columns (rotation
  ``q <- normalize(exp(d) q)``, translation), a point's 4 (homogeneous).
  The gauge's frames and frames past ``max_free_frames`` slots get no
  columns; points that no free frame sees (and whose uncertainty is at most
  ``uncertainty_free``) neither.
- blocks ``C_p = sum w Jp^T Jp``, ``H_f = sum w Jf^T Jf``, gradients
  ``b = -sum J^T w r``; on each free frame's translation block the
  frame-distance prior ``fdw (|t_f - t_(f-1)| - baseline)`` with a Cauchy
  weight of scale ``frame_dist_loss`` (the diagonal block alone).
- damping ``+ damping * max(trace / n, 1e-6) I + 1e-8 I`` on every block.
- ``cg_iters`` iterations of CG from zero, preconditioned by the damped
  diagonal of ``H_f`` (``precond`` ``diag``, the only one taken), on
  ``S x = b_f - E C^-1 b_p`` with ``S = H_f - E C^-1 E^T``, applied as
  products over the rows; rows of S past the free frames are the identity.
- the points back-substituted: ``dX = C^-1 (b_p - E^T x)``.
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry as geo


def _cauchy_weight(s, c):
    return 1.0 / (1.0 + s / (c * c))


def _cauchy_rho(s, c):
    return c * c * torch.log1p(s / (c * c))


def _damped(H, lam):
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    return H + lam * eye * torch.clamp(tr / n, min=1e-6)[..., None, None] + 1e-8 * eye


def _seg(n, idx, vals):
    """Sum of ``vals`` rows by ``idx`` into ``n`` rows."""
    return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, idx, vals)


def jacobians(R, t, X, pc, k, prec: geo.Precision):
    """A row's pixel Jacobians at frame (R, t), point X, camera-space point
    pc, intrinsics k: by the frame's 6 parameters (rotation d of
    ``normalize(exp(d) q)``, then translation), [..., 2, 6], and by the
    point's 4, [..., 2, 4]."""
    A = geo.pixel_jacobian(pc, k, prec)                     # d pixel / d pc
    AR = prec.mm(A, R)
    j_rot = -2.0 * prec.mm(A, geo.skew(pc))                 # d pc / d d = -2 [pc]x
    j_t = -X[..., 3, None, None] * AR                        # d pc / d t = -X[3] R
    j_X = torch.cat([AR, -prec.mv(AR, t)[..., None]], -1)   # d pc / d X = [R, -R t]
    return torch.cat([j_rot, j_t], -1), j_X


def solve(tables: dict, solver: dict, prec: geo.Precision = geo.Precision()) -> dict:
    """The solve of ``tables`` (the generator's, as handed to the solver
    under test) with ``solver`` (a configuration's ``solver`` settings plus
    ``max_free_frames``), computed in ``prec``. Returns ``frame_quat``,
    ``frame_trans``, ``point_loc``, ``cost0``, ``cost`` (float64 scalars)
    and ``ok``."""
    if solver["precond"] != "diag":
        raise ValueError(f"precond {solver['precond']!r}: the reference has 'diag' alone")
    dt = prec.dtype
    fq = tables["frame_quat"].to(dt)
    ft = tables["frame_trans"].to(dt)
    X = tables["point_loc"].to(dt)
    cam_k = tables["cam_k"].to(dt)
    px_obs = tables["obs_px"].to(dt)
    f = tables["obs_frame"].long().clamp(min=0)
    p = tables["obs_point"].long().clamp(min=0)
    k = cam_k[tables["frame_cam"].long()[f]]
    ok = tables["obs_ok"]
    present, free_frame = tables["present"], tables["free_frame"]
    dev = fq.device
    C, P, W = fq.shape[0], X.shape[0], solver["max_free_frames"]
    c_range, eps = solver["range"], solver["cheirality_eps"]

    frame_has_obs = torch.bincount(f[ok], minlength=C) > 0
    solvable = int(torch.sum(present & frame_has_obs)) >= 2
    free_f = free_frame & frame_has_obs & solvable
    point_in = torch.bincount(p[ok], minlength=P) > 0
    fluid = torch.bincount(p[ok & free_f[f]], minlength=P) > 0
    free_p = point_in & (fluid | (tables["point_uncertainty"] > solver["uncertainty_free"]))
    free_p &= solvable
    slot_of = torch.where(free_f, torch.cumsum(free_f, 0) - 1, W).clamp(max=W)
    slot = slot_of[f]
    n_active = int(torch.sum(free_f))
    active = torch.arange(W, device=dev) < n_active
    prior_f = free_f & torch.roll(present, 1) & (torch.arange(C, device=dev) >= 1)

    def residuals(fq, ft, X):
        R = geo.rotation_matrix(fq)[f]
        Xo = X[p]
        pc = geo.to_camera(R, ft[f], Xo, prec)
        r = geo.pixel(pc, k) - px_obs
        use = ok & (pc[:, 2] >= eps * Xo[:, 3]) & torch.all(torch.isfinite(r), -1)
        return torch.where(use[:, None], r, 0.0), use, R, pc, Xo

    def cost_of(fq, ft, X):
        r, use = residuals(fq, ft, X)[:2]
        rho = _cauchy_rho(torch.sum(r * r, -1), c_range)
        return 0.5 * torch.sum(torch.where(use, rho, 0.0), dtype=torch.float64)

    def gn_step(fq, ft, X):
        r, use, R, pc, Xo = residuals(fq, ft, X)
        w = torch.where(use, _cauchy_weight(torch.sum(r * r, -1), c_range), 0.0)
        jf, jp = jacobians(R, ft[f], Xo, pc, k, prec)
        jf = jf * (use & (slot < W))[:, None, None]
        jp = jp * (use & free_p[p])[:, None, None]
        jfT, jpT = jf.transpose(1, 2), jp.transpose(1, 2)
        wr = w[:, None] * r
        Cp = _seg(P, p, w[:, None, None] * prec.mm(jpT, jp))
        bp = -_seg(P, p, prec.mv(jpT, wr))
        Hf = _seg(W + 1, slot, w[:, None, None] * prec.mm(jfT, jf))
        bf = -_seg(W + 1, slot, prec.mv(jfT, wr))

        # frame-distance prior on the translation's diagonal block
        dvec = ft - torch.roll(ft, 1, 0)
        dnorm = torch.linalg.norm(dvec, dim=-1)
        dhat = dvec / torch.clamp(dnorm, min=1e-9)[:, None]
        rp = solver["frame_dist_weight"] * (dnorm - solver["baseline"])
        wp = torch.where(prior_f, _cauchy_weight(rp * rp, solver["frame_dist_loss"]), 0.0)
        jt = solver["frame_dist_weight"] * dhat
        Hf[:, 3:, 3:] += _seg(W + 1, slot_of, torch.where(
            prior_f[:, None, None], wp[:, None, None] * jt[:, :, None] * jt[:, None, :], 0.0))
        bf[:, 3:] += _seg(W + 1, slot_of, torch.where(prior_f[:, None],
                                                      -(wp * rp)[:, None] * jt, 0.0))
        Hd = _damped(Hf[:W], solver["damping"])
        bf = bf[:W]
        Cinv = torch.where(free_p[:, None, None],
                           torch.linalg.inv(_damped(Cp, solver["damping"])), 0.0)
        zero6 = Hd.new_zeros((1, 6))

        def to_points(x):   # E^T x: [W,6] -> [P,4]
            t1 = prec.mv(jf, torch.cat([x, zero6])[slot])
            return _seg(P, p, prec.mv(jpT, w[:, None] * t1))

        def to_frames(v):   # E v: [P,4] -> [W,6]
            t2 = prec.mv(jp, v[p])
            return _seg(W + 1, slot, prec.mv(jfT, w[:, None] * t2))[:W]

        def schur(x):
            y = to_frames(prec.mv(Cinv, to_points(x)))
            return torch.where(active[:, None], prec.mv(Hd, x) - y, x)

        rhs = torch.where(active[:, None], bf - to_frames(prec.mv(Cinv, bp)), 0.0)
        dinv = 1.0 / torch.clamp(torch.diagonal(Hd, dim1=1, dim2=2), min=1e-12)

        def precond(z):
            return z * dinv

        x = torch.zeros_like(rhs)
        res = rhs
        z = precond(res)
        d = z
        rz = torch.sum(res * z)
        for _ in range(solver["cg_iters"]):
            Sd = schur(d)
            alpha = rz / torch.clamp(torch.sum(d * Sd), min=1e-20)
            x = x + alpha * d
            res = res - alpha * Sd
            z = precond(res)
            rz_new = torch.sum(res * z)
            d = z + rz_new / torch.clamp(rz, min=1e-20) * d
            rz = rz_new

        dX = torch.where(free_p[:, None], prec.mv(Cinv, bp - to_points(x)), 0.0)
        upd = (free_f & (slot_of < W))[:, None]
        step = torch.cat([x, zero6])[slot_of]
        fq = torch.where(upd, geo.retract(fq, step[:, :3]), fq)
        return fq, ft + torch.where(upd, step[:, 3:], 0.0), X + dX

    cost0 = cost_of(fq, ft, X)
    q1, t1, X1 = fq, ft, X
    if solvable:
        for _ in range(solver["gn_iters"]):
            q1, t1, X1 = gn_step(q1, t1, X1)
    return dict(frame_quat=q1, frame_trans=t1, point_loc=X1, cost0=cost0,
                cost=cost_of(q1, t1, X1), ok=solvable)
