"""Large-scale bundle adjustment: implicit Schur complement + CG.

Port of ``slam_robot_tpu/ops/ba_cg.py``, the analog of the reference's
ITERATIVE_SCHUR + SCHUR_JACOBI configuration (slam.cpp:488-490) for maps
far past the dense window solver (``ops/ba``): the reduced camera system
S = B - E C^-1 E^T is never formed. CG needs only S @ x, and every term of
that product is a gather or a segment sum over the observation table:

    t1 = Jf x                      (per observation, gathered by frame slot)
    u  = seg_p Jp^T w t1           (segment sum into [P,4])
    v  = C^-1 u                    (batched closed-form 4x4)
    y  = seg_slot Jf^T w Jp v      (segment sum into [W,6])

Peak memory is O(P*16 + O*...), independent of W*P. Gauss-Newton outer
loop with fixed Levenberg damping; a block-Jacobi (``precond="block"``) or
diagonal (``"diag"``) preconditioner; the frame-distance prior on the block
diagonal only (the JAX package's documented deviation).

Both loops have fixed trip counts (``gn_iters``, ``cg_iters``), so a solve
reads nothing back to the host: CG's zero-denominator guards are
``clamp``s on the device, and the caller reads the result when it wants it.

Segment sums (``layout``):

- ``"padded"`` (default): the observation table is sorted once per solve
  by point and by frame slot (two stable argsorts and a searchsorted) into
  [N, K] tables of row indices, with row O as the zero sentinel; every
  segment sum is then a row gather and a sum over K. Rows ranked past K in
  their segment go to a compacted spill, added with an accumulating
  ``index_put_`` (sorted on CUDA), so the sum stays exact and comes out the
  same every run; only spill overflow past ``pad_spill`` loses rows, which
  ``ok`` reports.
- ``"scatter"``: ``index_add_`` over the table. On CUDA it adds with
  atomics, in no fixed order, so its last bits move from run to run.

The observation table may be split in row blocks (:func:`solve_sharded`,
or any :class:`~slam_robot_tpu_torch.ops.obs_shards.ObsShards`): every
observation-derived sum (the [P,*] landmark sums and the reduced [W,6]
camera system) then passes through the shards' ``allsum`` seam, the JAX
package's ``psum``, and frame and point state stays on the home device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from slam_robot_tpu_torch.device import Tally, span, tracing
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import quaternion as quat
from slam_robot_tpu_torch.ops.ba import (
    TERM_MAX_ITERS,
    TERM_NOT_RUN,
    BAResult,
    _cauchy_rho,
    _cauchy_weight,
    _count_into,
    inv4x4,
)
from slam_robot_tpu_torch.ops.obs_shards import ObsShards, split_and_solve

F32 = torch.float32
I32 = torch.int32

# the padded plans' spill, by side (p: points, f: frame slots), fed only while
# the spans stamp the device (device.tracing): plans.<side> the plans made,
# walked.<side> the rows their spill sums walk, spill_rows.<side> the rows
# that spill (each a device count, summed at the read), run.<side> the longest
# run of one segment index a spill sum walks (taken at the read)
SPILL = Tally()


def _longest_run(sorted_ids) -> int:
    """The longest run of one value in a sorted index tensor (a host read)."""
    if sorted_ids.numel() == 0:
        return 0
    return int(torch.unique_consecutive(sorted_ids, return_counts=True)[1].max())


def _padded_plan(seg_id, n_segments: int, K: int, spill_cap: int, side: str):
    """Gather plan for segment sums into ``[n_segments, D]``.

    seg_id [O] integer segment of each row; ids >= n_segments are left out
    of the plan (their values are never read). Returns (pad_idx
    [n_segments, K] row indices with O as the zero-pad sentinel, spill_rows
    [S], spill_seg [S], spill_exceeded bool), S = min(O, spill_cap); the
    index tensors are int64. Rows ranked past K within their segment go to
    the compacted spill (sentinels: row O, segment n_segments); only spill
    overflow beyond spill_cap loses rows, which the flag reports. ``side``
    names the plan's counters in :data:`SPILL`."""
    dev = seg_id.device
    O = seg_id.shape[0]
    order = torch.argsort(seg_id, stable=True)
    sidx = seg_id[order].contiguous()
    first = torch.searchsorted(sidx, sidx, side="left")
    rank = torch.arange(O, device=dev) - first
    valid = sidx < n_segments
    in_pad = valid & (rank < K)

    # writes of rows outside the pad go to one scratch slot, sliced off
    slot = torch.where(in_pad, sidx.long() * K + rank, n_segments * K)
    pad_idx = torch.full(((n_segments + 1) * K,), O, dtype=torch.long, device=dev)
    pad_idx = pad_idx.index_put((slot,), torch.where(in_pad, order, O))
    pad_idx = pad_idx[:n_segments * K].reshape(n_segments, K)

    spill = valid & (rank >= K)
    sp_sel = torch.argsort((~spill).to(torch.uint8), stable=True)[:spill_cap]
    sp_is = spill[sp_sel]
    spill_rows = torch.where(sp_is, order[sp_sel], O)
    spill_seg = torch.where(sp_is, sidx[sp_sel].long(), n_segments)
    n_spill = torch.sum(spill, dtype=I32)
    exceeded = n_spill > spill_cap
    if tracing():
        # spill_seg is sorted, the sentinel segment last: its runs are the
        # runs of equal indices that the accumulating index_put_ walks
        SPILL.add(f"plans.{side}", 1)
        SPILL.add(f"walked.{side}", spill_seg.shape[0])
        SPILL.keep(f"spill_rows.{side}", n_spill)
        SPILL.peak(f"run.{side}", functools.partial(_longest_run, spill_seg))
    return pad_idx, spill_rows, spill_seg, exceeded


def _padded_seg_sum(vals, pad_idx, spill_rows, spill_seg, side: str):
    """Sum ``vals`` rows per segment through the :func:`_padded_plan`
    tables. vals [O, D] -> [n_segments, D]; a zero row appended to ``vals``
    makes the O sentinel add nothing, and a scratch row takes the spill's
    sentinel segment. The pad and the spill are spanned apart, by ``side``."""
    D = vals.shape[-1]
    with span(f"ba_cg_seg_{side}_pad"):
        vz = torch.cat([vals, vals.new_zeros((1, D))])
        out = vz[pad_idx].sum(1)
    with span(f"ba_cg_seg_{side}_spill"):
        n = out.shape[0]
        out = torch.cat([out, out.new_zeros((1, D))])
        out.index_put_((spill_seg,), vz[spill_rows], accumulate=True)
    return out[:n]


class CGConfig(NamedTuple):
    range: float = 2.0
    gn_iters: int = 8             # outer Gauss-Newton steps
    cg_iters: int = 30            # inner CG iterations
    damping: float = 1e-4         # Levenberg diagonal scaling
    baseline: float = 150.0
    frame_dist_weight: float = 0.1
    frame_dist_loss: float = 15.0
    uncertainty_free: float = 100.0
    max_free_frames: int = 64     # frame slots in the reduced system
    cheirality_eps: float = 0.001
    precond: str = "block"        # "block" (6x6 inverses) | "diag"
    layout: str = "padded"        # "padded" | "scatter" (module doc)
    pad_obs_per_point: int = 8    # K for the point-side padded table
    pad_obs_per_frame: int = 128  # K for the frame-slot-side padded table
    pad_spill: int = 4096         # compacted spill capacity


@span("ba_cg_solve")
def solve_shards(frame_quat, frame_trans, frame_cam, cam_k, point_loc, point_uncertainty,
                 shards: ObsShards, present, free_frame,
                 cfg: CGConfig = CGConfig()) -> BAResult:
    """The solver over an observation table held in ``shards``. Frame,
    point and camera tensors live on ``shards.home``; each shard's rows on
    its own device. Every observation-derived reduction goes through
    ``shards.sum``, so with a process group each rank runs the same solve
    on identical replicated state."""
    dev = shards.home
    Fn = frame_quat.shape[0]
    P = point_loc.shape[0]
    W = cfg.max_free_frames
    eps_c = cfg.cheirality_eps

    def on(x, s):
        return x.to(s["f"].device)

    with span("ba_cg_plan"):
        sh = []
        for t in shards.tables:
            f = t["obs_frame"].clamp(min=0).long()
            sh.append(dict(f=f, p=t["obs_point"].clamp(min=0).long(),
                           c=frame_cam.to(f.device)[f].long(), px=t["obs_px"], ok=t["obs_ok"]))

        frame_has_obs = shards.sum(lambda s: _count_into(
            torch.where(s["ok"], s["f"], Fn), Fn), sh) > 0
        n_used = torch.sum(present & frame_has_obs, dtype=I32)
        solvable = n_used >= 2
        free_f = free_frame & frame_has_obs & solvable

        point_in = shards.sum(lambda s: _count_into(torch.where(s["ok"], s["p"], P), P), sh) > 0
        fluid = shards.sum(lambda s: _count_into(
            torch.where(s["ok"] & on(free_f, s)[s["f"]], s["p"], P), P), sh) > 0
        free_p = point_in & (fluid | (point_uncertainty > cfg.uncertainty_free)) & solvable

        slot_of = torch.where(free_f, torch.cumsum(free_f, 0) - 1, W).clamp(max=W)
        for s in sh:
            s["slot"] = on(slot_of, s)[s["f"]]

        # frame 0 has no predecessor; the roll's wrapped row is masked off
        prior_f = free_f & torch.roll(present, 1) & (torch.arange(Fn, device=dev) >= 1)

        # segment sums O -> [P,*] and O -> [W,*]: once per assembly and twice in
        # every CG product
        if cfg.layout == "padded":
            for s in sh:
                s["plan_p"] = _padded_plan(torch.where(s["ok"], s["p"], P), P,
                                           cfg.pad_obs_per_point, cfg.pad_spill, "p")
                s["plan_f"] = _padded_plan(
                    torch.where(s["ok"] & (s["slot"] < W), s["slot"], W), W,
                    cfg.pad_obs_per_frame, cfg.pad_spill, "f")
            spill_ok = shards.sum(
                lambda s: (s["plan_p"][3] | s["plan_f"][3]).to(I32), sh) == 0

            def seg_p(s, vals):
                return _padded_seg_sum(vals, *s["plan_p"][:3], "p")

            def seg_f(s, vals):
                return _padded_seg_sum(vals, *s["plan_f"][:3], "f")
        elif cfg.layout == "scatter":
            spill_ok = torch.ones((), dtype=torch.bool, device=dev)

            def seg_p(s, vals):
                return vals.new_zeros((P, vals.shape[-1])).index_add_(0, s["p"], vals)

            def seg_f(s, vals):
                return vals.new_zeros((W + 1, vals.shape[-1])).index_add_(0, s["slot"], vals)[:W]
        else:
            raise ValueError(f"layout {cfg.layout!r}: 'padded' or 'scatter'")

    def residuals(s, fq, ft, locs):
        f = s["f"]
        r, valid = proj.reprojection_error(on(fq, s)[f], on(ft, s)[f], on(cam_k, s)[s["c"]],
                                           on(locs, s)[s["p"]], s["px"], eps_c)
        use = s["ok"] & valid & torch.all(torch.isfinite(r), dim=-1)
        return torch.where(use[:, None], r, 0.0), use

    @span("ba_cg_cost")
    def cost_of(fq, ft, locs):
        def part(s):
            r, use = residuals(s, fq, ft, locs)
            rho = _cauchy_rho(torch.sum(r * r, dim=-1), cfg.range)
            return 0.5 * torch.sum(torch.where(use, rho, 0.0))
        return shards.sum(part, sh)

    def res_params(xi, t, p, q0, px, k):
        r, _ = proj.reprojection_error(quat.retract(q0, xi), t, k, p, px, eps_c)
        return r

    jac_fn = vmap(jacfwd(res_params, argnums=(0, 1, 2)))
    zrow6 = torch.zeros((1, 6), dtype=F32, device=dev)

    def gn_step(fq, ft, locs):
        def assemble(s):
            f, p = s["f"], s["p"]
            r, use = residuals(s, fq, ft, locs)
            w = torch.where(use, _cauchy_weight(torch.sum(r * r, dim=-1), cfg.range), 0.0)
            O = f.shape[0]
            jxi, jt, jp = jac_fn(torch.zeros((O, 3), dtype=F32, device=f.device),
                                 on(ft, s)[f], on(locs, s)[p], on(fq, s)[f], s["px"],
                                 on(cam_k, s)[s["c"]])
            jf = torch.cat([jxi, jt], dim=-1) * (use & (s["slot"] < W))[:, None, None]
            jp = jp * (use & on(free_p, s)[p])[:, None, None]
            s.update(jf=jf, jp=jp, w=w)
            wr = w[:, None] * r
            return (seg_p(s, torch.einsum("oia,oib,o->oab", jp, jp, w).reshape(O, 16)),
                    seg_p(s, -torch.einsum("oia,oi->oa", jp, wr)),
                    seg_f(s, torch.einsum("oia,oib,o->oab", jf, jf, w).reshape(O, 36)),
                    seg_f(s, -torch.einsum("oia,oi->oa", jf, wr)))

        with span("ba_cg_linearize"):
            # landmark blocks and gradient, summed over the shards before the
            # replicated prior and damping terms are added once
            Cp, bp, Hff, bf = shards.sum(assemble, sh)
            Cp = Cp.reshape(P, 4, 4)
            Hff = Hff.reshape(W, 6, 6)

            # frame-distance prior on the block diagonal; frames without a slot
            # write to a scratch row
            dvec = ft - torch.roll(ft, 1, dims=0)
            dnorm = torch.linalg.norm(dvec, dim=-1)
            dhat = dvec / torch.clamp(dnorm, min=1e-9)[:, None]
            rp = cfg.frame_dist_weight * (dnorm - cfg.baseline)
            wp = torch.where(prior_f, _cauchy_weight(rp * rp, cfg.frame_dist_loss), 0.0)
            jp_t = cfg.frame_dist_weight * dhat
            blk = torch.einsum("fa,fb,f->fab", jp_t, jp_t, wp)
            Hx = torch.cat([Hff, Hff.new_zeros((1, 6, 6))])
            Hx[:, 3:, 3:] += Hx.new_zeros((W + 1, 3, 3)).index_add_(
                0, slot_of, torch.where(prior_f[:, None, None], blk, 0.0))
            bx = torch.cat([bf, bf.new_zeros((1, 6))])
            bx[:, 3:] += bx.new_zeros((W + 1, 3)).index_add_(
                0, slot_of, torch.where(prior_f[:, None], -(wp * rp)[:, None] * jp_t, 0.0))
            Hff, bf = Hx[:W], bx[:W]

            lam = cfg.damping
            eye6 = torch.eye(6, dtype=F32, device=dev)
            eye4 = torch.eye(4, dtype=F32, device=dev)
            Hff_d = (Hff + lam * eye6 * torch.clamp(
                torch.einsum("fii->f", Hff)[:, None, None] / 6.0, min=1e-6) + 1e-8 * eye6)
            Cd = (Cp + lam * eye4 * torch.clamp(
                torch.einsum("pii->p", Cp)[:, None, None] / 4.0, min=1e-6) + 1e-8 * eye4)
            Cinv = torch.where(free_p[:, None, None], inv4x4(Cd), 0.0)
            slot_active = torch.arange(W, device=dev) < torch.sum(free_f)

        def landmark_sum(x):  # [W,6] -> sum over shards of Jp^T w Jf x, [P,4]
            xz = torch.cat([x, zrow6])

            def part(s):
                t1 = torch.einsum("oia,oa->oi", s["jf"], on(xz, s)[s["slot"]])
                return seg_p(s, torch.einsum("oia,oi,o->oa", s["jp"], t1, s["w"]))
            return shards.sum(part, sh)

        def frame_sum(v):  # [P,4] -> sum over shards of Jf^T w Jp v, [W,6]
            def part(s):
                t2 = torch.einsum("oia,oa->oi", s["jp"], on(v, s)[s["p"]])
                return seg_f(s, torch.einsum("oia,oi,o->oa", s["jf"], t2, s["w"]))
            return shards.sum(part, sh)

        def schur_matvec(x):  # x: [W, 6]
            v = torch.einsum("pab,pb->pa", Cinv, landmark_sum(x))
            y = frame_sum(v)
            return torch.where(slot_active[:, None],
                               torch.einsum("wab,wb->wa", Hff_d, x) - y, x)

        with span("ba_cg_pcg"):
            # rhs = bf - E C^-1 bp
            e_cb = frame_sum(torch.einsum("pab,pb->pa", Cinv, bp))
            rhs = torch.where(slot_active[:, None], bf - e_cb, 0.0)

            # Jacobi preconditioner (SCHUR_JACOBI); inv_ex checks nothing on
            # the host
            if cfg.precond == "block":
                Minv = torch.where(slot_active[:, None, None],
                                   torch.linalg.inv_ex(Hff_d).inverse, eye6)

                def precond(z):
                    return torch.einsum("wab,wb->wa", Minv, z)
            else:
                dinv = 1.0 / torch.clamp(torch.diagonal(Hff_d, dim1=1, dim2=2), min=1e-12)

                def precond(z):
                    return z * dinv

            x = torch.zeros((W, 6), dtype=F32, device=dev)
            rr = rhs
            z = precond(rhs)
            pdir = z
            rz = torch.sum(rhs * z)
            for _ in range(cfg.cg_iters):
                Ap = schur_matvec(pdir)
                alpha = rz / torch.clamp(torch.sum(pdir * Ap), min=1e-20)
                x = x + alpha * pdir
                rr = rr - alpha * Ap
                z = precond(rr)
                rz_new = torch.sum(rr * z)
                beta = rz_new / torch.clamp(rz, min=1e-20)
                pdir = z + beta * pdir
                rz = rz_new

        with span("ba_cg_update"):
            # back-substitute the points
            dp = torch.einsum("pab,pb->pa", Cinv, bp - landmark_sum(x))
            dp = torch.where(free_p[:, None], dp, 0.0)

            upd = (free_f & (slot_of < W))[:, None]
            dsel = torch.cat([x, zrow6])[slot_of]
            dxi = torch.where(upd, dsel[:, :3], 0.0)
            dt = torch.where(upd, dsel[:, 3:], 0.0)
            for s in sh:  # the step's Jacobians are spent
                del s["jf"], s["jp"], s["w"]
            fq, ft, locs = torch.where(upd, quat.retract(fq, dxi), fq), ft + dt, locs + dp
        return fq, ft, locs

    cost0 = cost_of(frame_quat, frame_trans, point_loc)
    fq, ft, locs = frame_quat, frame_trans, point_loc
    for _ in range(cfg.gn_iters):
        fq, ft, locs = gn_step(fq, ft, locs)
    cost = cost_of(fq, ft, locs)

    def full(v):
        return torch.full((), v, dtype=I32, device=dev)

    return BAResult(
        frame_quat=torch.where(solvable, fq, frame_quat),
        frame_trans=torch.where(solvable, ft, frame_trans),
        point_loc=torch.where(solvable, locs, point_loc),
        cam_k=cam_k,
        # padded layout: ok also reports spill overflow
        ok=solvable & spill_ok,
        cost=cost,
        iters=full(cfg.gn_iters),
        # fixed-iteration GN: the cap is always the exit reason
        term=torch.where(solvable, full(TERM_MAX_ITERS), full(TERM_NOT_RUN)),
        cost0=cost0,
    )


def solve(frame_quat, frame_trans, frame_cam, cam_k, point_loc, point_uncertainty,
          obs_frame, obs_point, obs_px, obs_ok, present, free_frame,
          cfg: CGConfig = CGConfig()) -> BAResult:
    """Large-map BA over the given tables (shapes as the JAX package's
    ``ops/ba_cg.solve``), on their device, with no host read."""
    return solve_shards(frame_quat, frame_trans, frame_cam, cam_k, point_loc,
                        point_uncertainty, ObsShards.whole(obs_frame, obs_point, obs_px, obs_ok),
                        present, free_frame, cfg)


def solve_sharded(mesh, frame_quat, frame_trans, frame_cam, cam_k, point_loc,
                  point_uncertainty, obs_frame, obs_point, obs_px, obs_ok, present,
                  free_frame, cfg: CGConfig = CGConfig(), obs_axis: str = "model") -> BAResult:
    """:func:`solve` with the observation tables split over mesh axis
    ``obs_axis`` (the SURVEY §5 large-map scale-out): padded with
    ``obs_ok=False`` rows to a multiple of the axis size, one row block per
    device of the axis, each with its own padded plan. Frame and point
    state is replicated on the mesh's first device, where the result
    lands. Per CG product the seam sums one [P,4] and one [W,6] partial per
    shard. Matches :func:`solve` up to float32 summation order."""
    return split_and_solve(solve_shards, mesh.axis_devices(obs_axis), frame_quat, frame_trans,
                           frame_cam, cam_k, point_loc, point_uncertainty, obs_frame,
                           obs_point, obs_px, obs_ok, present, free_frame, cfg)
