"""Feature lifecycle: per-frame tracking orchestration (matcher.cpp).

Port of ``slam_robot_tpu/models/matcher.py``. Per frame
(matcher.cpp:301-405): drop features whose point is no longer
feature-usable; walk the stored views newest-first, forward+backward
tracking from projection-predicted starts; commit matches as
observations; below ``min_matches`` store a keyframe view, detect corners,
suppress them near matches and seed new points.

With the default tracker (``tracker_kind="hessian"``,
``tracker_impl="fused"``) each lane walks its own stored views through
``ops/tracker_fused`` (kernel B1), as the reference's full (view rank x
pass) ladder or, with ``retry_mode="cycle"``, as one sweep and
``retry_sweeps`` cycled retries. The alternative trackers
(``tracker_impl="lanes"``: the autodiff ``ops/tracker``;
``tracker_kind="klt"``: ``ops/klt``) take the JAX package's round-1 walk,
the views globally newest-first; the fused-only knobs (the adaptive first
attempt, ``retry_mode="cycle"``, ``bwd_window_cache``) do not apply there,
as in the JAX package. The off-by-default knobs ``adaptive_fwd_px``,
``clean_duplicates``, ``mid_frame_resolve`` and ``seed_depth_adaptive`` run
as in the JAX package.

The JAX package's ``lax.cond``s become Python ``if``s on a host read: an
empty sweep is skipped, the keyframe branch runs only on keyframes, and the
cycle's escalation and the mid-frame re-solve run only when they fire.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import KNOBS, default_device, host, span
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import slam as slam_mod
from slam_robot_tpu_torch.ops import corners as corner_ops
from slam_robot_tpu_torch.ops import klt
from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.ops import quaternion as quat
from slam_robot_tpu_torch.ops import tracker, tracker_fused
from slam_robot_tpu_torch.ops.pyramid import PAD, FlatPyramid


class MatcherState(NamedTuple):
    view_frame: torch.Tensor    # [V] int32 map frame index, -1 = empty slot
    view_pyr: torch.Tensor      # [V, L, H0+2*PAD, W0+2*PAD] flat pyramids
    feat_point: torch.Tensor    # [NF] int32 map point index, -1 = dead
    feat_px: torch.Tensor       # [NF, V, 2] stored match per view
    feat_valid: torch.Tensor    # [NF, V] bool
    feat_refpack: torch.Tensor  # [NF, V, L, 2*S*S+2] packed reference stacks
    feat_refwin: torch.Tensor   # [NF, V, L, WIN, WIN] cached search windows
    feat_reforg: torch.Tensor   # [NF, V, L, 2] window origins
    feat_fail: torch.Tensor     # [NF] int32 consecutive all-failed frames
    feat_sharp: torch.Tensor    # [NF] bool: matched within adaptive_fwd_px of its prediction


def init(cfg: SlamConfig, device=None) -> MatcherState:
    """An empty matcher on ``device`` (default: the CUDA card)."""
    V, NF, L = cfg.max_views, cfg.max_features, cfg.pyramid_depth
    S = cfg.patch_size
    h0, w0 = cfg.image_height, cfg.image_width
    WIN = tracker_fused.WIN
    z = dict(device=default_device(device))
    return MatcherState(
        view_frame=torch.full((V,), -1, dtype=torch.int32, **z),
        view_pyr=torch.zeros((V, L, h0 + 2 * PAD, w0 + 2 * PAD), dtype=torch.float32, **z),
        feat_point=torch.full((NF,), -1, dtype=torch.int32, **z),
        feat_px=torch.zeros((NF, V, 2), dtype=torch.float32, **z),
        feat_valid=torch.zeros((NF, V), dtype=torch.bool, **z),
        feat_refpack=torch.zeros((NF, V, L, 2 * S * S + 2), dtype=torch.float32, **z),
        feat_refwin=torch.zeros((NF, V, L, WIN, WIN), dtype=torch.float32, **z),
        feat_reforg=torch.zeros((NF, V, L, 2), dtype=torch.float32, **z),
        feat_fail=torch.zeros((NF,), dtype=torch.int32, **z),
        feat_sharp=torch.zeros((NF,), dtype=torch.bool, **z),
    )


def in_image(pts, cfg: SlamConfig):
    """Half-open image-bounds gate for tracking start points [.., 2]."""
    return ((pts[..., 0] >= 0) & (pts[..., 1] >= 0)
            & (pts[..., 0] < cfg.image_width) & (pts[..., 1] < cfg.image_height))


def _row(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a 0-d index tensor without a host sync."""
    i = torch.as_tensor(i, device=x.device).reshape(1).long()
    return x.index_select(0, i)[0]


def _view_pyramid(ms: MatcherState, vi, cfg: SlamConfig) -> FlatPyramid:
    """The stacked view ring [V*L, Hp, Wp] with per-lane offset vi*L."""
    V, L = ms.view_pyr.shape[:2]
    h, w = pyr.level_sizes(cfg.image_height, cfg.image_width, L, ms.view_pyr.device)
    return FlatPyramid(data=ms.view_pyr.reshape((V * L,) + ms.view_pyr.shape[2:]),
                       heights=h.repeat(V), widths=w.repeat(V), depth_=L,
                       offset=vi.long() * L)


@span("matcher")
def track(ms: MatcherState, map_state: lm.MapState, img, frame_idx, camera_idx,
          cfg: SlamConfig):
    """One Matcher::Track step. ``img`` is [H,W(,3)] uint8 or f32 on the
    state's device. Returns (matcher_state, map_state, metrics)."""
    NF, V, L = cfg.max_features, cfg.max_views, cfg.pyramid_depth
    dev = map_state.device
    S = cfg.patch_size
    weight = patch_ops.radial_mask(S, cfg.mask_bias, device=dev)
    new_pyr = pyr.build_pyramid(img, L, cfg.blur_sigma0, cfg.blur_sigma_down)
    frame_idx = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    lanes = torch.arange(NF, device=dev)

    # 1. drop features whose point became unusable (matcher.cpp:327-330)
    pt_idx = ms.feat_point
    pt_ok = (pt_idx >= 0) & lm.feature_usable(map_state.point_flags[pt_idx.clamp(min=0).long()])
    pt_idx = torch.where(pt_ok, pt_idx, torch.full_like(pt_idx, -1))
    ms = ms._replace(feat_point=pt_idx)
    live = pt_idx >= 0
    all_lanes = torch.ones((NF,), dtype=torch.bool, device=dev)

    def cadence(k):
        if k <= 1:
            return all_lanes
        return (ms.feat_fail == 0) | (torch.remainder(frame_idx + lanes, k) == 0)

    due = cadence(cfg.find_fail_backoff)
    due_deep = cadence(cfg.find_fail_backoff_deep)

    fq = _row(map_state.frame_quat, frame_idx)
    ft = _row(map_state.frame_trans, frame_idx)
    k = _row(map_state.cam_k, camera_idx)
    pidx = pt_idx.clamp(min=0).long()
    unc = map_state.point_uncertainty[pidx]
    loc = map_state.point_loc[pidx]
    lvls3 = torch.where(unc > cfg.uncertainty_confident,
                        torch.full_like(pt_idx, cfg.levels_unsure),
                        torch.full_like(pt_idx, cfg.levels_confident))

    def predictions(fq_, ft_):
        """Start locations from projecting each point (matcher.cpp:233-239),
        used where the point is confident."""
        pred_px, pred_ok = proj.project_point(fq_, ft_, k, loc)
        use = (unc < cfg.uncertainty_confident) & pred_ok
        return torch.where(use[:, None], pred_px, torch.zeros_like(pred_px)), use

    start_pred, use_pred = predictions(fq, ft)

    if cfg.tracker_kind == "hessian" and cfg.tracker_impl == "fused":
        run_find = _fused_find(ms, cfg, new_pyr, weight, lanes, live, due, due_deep, lvls3)
    else:
        run_find = _round1_find(ms, cfg, new_pyr, weight, live & due, lvls3)

    # 2. FindMatches
    matched, to_px = run_find(torch.zeros((NF,), dtype=torch.bool, device=dev),
                              torch.zeros((NF, 2), dtype=torch.float32, device=dev),
                              start_pred, use_pred)

    if cfg.clean_duplicates:
        # CleanDuplicates (matcher.cpp:274-288, coded but not called by the
        # reference): matches in the same half-resolution pixel as a lower
        # slot's are mismatched
        cell = (to_px / 2.0).to(torch.int32)
        same = ((cell[:, None, 0] == cell[None, :, 0]) & (cell[:, None, 1] == cell[None, :, 1])
                & matched[:, None] & matched[None, :])
        dup = torch.any(same & (lanes[None, :] < lanes[:, None]), dim=1)
        P = map_state.point_flags.shape[0]
        dup_points = torch.where(dup, pt_idx, torch.full_like(pt_idx, P))
        flags = map_state.point_flags
        flags = lm.scatter_set(flags, dup_points,
                               flags[dup_points.clamp(max=P - 1).long()] | lm.MISMATCHED)
        map_state = map_state._replace(point_flags=flags)
        matched = matched & ~dup
        KNOBS.add("duplicates", torch.sum(dup, dtype=torch.int32))

    # 3. write observations (matcher.cpp:255-257)
    map_state = lm.add_observations(map_state, frame_idx, pt_idx, to_px, matched)
    n_matches = torch.sum(matched, dtype=torch.int32)

    resolve_fired = torch.tensor(False, device=dev)
    if cfg.mid_frame_resolve and host(n_matches < cfg.min_matches):
        # the mid-frame pose re-solve (matcher.cpp:338-346; dead in the
        # reference, whose SolveFramePose returns false): re-solve the pose
        # from epipolar constraints, re-predict, re-find the unmatched lanes
        map_state, resolve_fired = slam_mod.solve_frame_pose_epipolar(map_state)
        sp2, up2 = predictions(_row(map_state.frame_quat, frame_idx),
                               _row(map_state.frame_trans, frame_idx))
        matched2, to_px = run_find(matched, to_px, sp2, up2)
        map_state = lm.add_observations(map_state, frame_idx, pt_idx, to_px,
                                        matched2 & ~matched)
        matched = matched2
        n_matches = torch.sum(matched, dtype=torch.int32)

    feat_fail = torch.where(matched, torch.zeros_like(ms.feat_fail),
                            torch.where(live & due, ms.feat_fail + 1, ms.feat_fail))
    feat_point = ms.feat_point
    if cfg.find_fail_give_up > 0:
        gone = (feat_point >= 0) & (feat_fail >= cfg.find_fail_give_up)
        feat_point = torch.where(gone, torch.full_like(feat_point, -1), feat_point)
    if cfg.adaptive_fwd_px > 0:
        inno = torch.linalg.norm(to_px - start_pred, dim=-1)
        feat_sharp = matched & use_pred & (inno < cfg.adaptive_fwd_px)
    else:
        feat_sharp = torch.zeros((NF,), dtype=torch.bool, device=dev)
    ms = ms._replace(feat_fail=feat_fail, feat_point=feat_point, feat_sharp=feat_sharp)

    # 4. keyframe branch (matcher.cpp:353-402)
    is_kf, slot = host(torch.stack([
        (n_matches < cfg.min_matches).to(torch.int64), torch.argmin(ms.view_frame)]))
    n_added = torch.zeros((), dtype=torch.int32, device=dev)
    if is_kf:
        ms, map_state, n_added = _keyframe(ms, map_state, new_pyr, matched, to_px,
                                           frame_idx, slot, fq, ft, k, cfg)

    metrics = {
        "n_matches": n_matches,
        "n_added": n_added,
        "is_keyframe": torch.tensor(bool(is_kf), device=dev),
        "resolve_fired": resolve_fired,
        "feat_point": pt_idx,
        "feat_px": to_px,
        "feat_matched": matched,
    }
    return ms, map_state, metrics


def _fused_find(ms: MatcherState, cfg: SlamConfig, new_pyr: FlatPyramid, weight, lanes,
                live, due, due_deep, lvls3):
    """FindMatches with the fused tracker: per-lane view ranks, each lane
    walking its own valid views newest-first (matcher.cpp:221-269), as the
    full (view rank x pass) ladder or the cycled retries. Returns
    run_find(matched, to_px, start_pred, use_pred) -> (matched, to_px)."""
    NF, V = cfg.max_features, cfg.max_views
    dev = lvls3.device
    unsure = lvls3 == cfg.levels_unsure
    unsure_arr = torch.full_like(lvls3, cfg.levels_unsure)
    all_lanes = torch.ones((NF,), dtype=torch.bool, device=dev)
    key = torch.where(ms.feat_valid & (ms.view_frame >= 0)[None, :],
                      ms.view_frame[None, :].expand(NF, V), torch.full_like(ms.feat_valid, -1, dtype=torch.int32))
    lane_order = torch.argsort(-key, dim=1, stable=True)
    key_sorted = torch.gather(key, 1, lane_order)

    def cap_b(x):
        return x if cfg.roundtrip_levels <= 0 else torch.clamp(x, max=cfg.roundtrip_levels)

    if cfg.adaptive_fwd_px > 0:
        # sharp lanes (matched last frame within adaptive_fwd_px of their
        # prediction) make their first attempt at one level both ways
        sharp_ok = ms.feat_sharp & ~unsure
        lvls_first = torch.where(sharp_ok, torch.ones_like(lvls3), lvls3)
    else:
        lvls_first = lvls3
    bwd_first = cap_b(lvls_first)
    first_tally = "sharp_first_lanes" if cfg.adaptive_fwd_px > 0 else None

    def make_sweep(start_pred_, use_pred_, due_):
        def sweep(matched, to_px, vi_lane, has, lvls_arr, bwd_arr=None, tally=None):
            """One fused tracker sweep with per-lane view pick ``vi_lane``.
            Returns (matched, to_px, ran)."""
            from_pt = ms.feat_px[lanes, vi_lane]
            start = torch.where(use_pred_[:, None], start_pred_, from_pt)
            cand = live & due_ & ~matched & has & in_image(start, cfg)
            if tally:
                KNOBS.add(tally, torch.sum(cand & (lvls_arr == 1), dtype=torch.int32))
            if not host(torch.any(cand)):
                return matched, to_px, False
            packed_sel = ms.feat_refpack[lanes, vi_lane]
            bwd_wins = ((ms.feat_refwin[lanes, vi_lane], ms.feat_reforg[lanes, vi_lane])
                        if cfg.bwd_window_cache else None)
            res_px, res_ok = tracker_fused.track_bidirectional_batch(
                _view_pyramid(ms, vi_lane, cfg), new_pyr, from_pt, start, lvls_arr,
                weight, cfg.track_threshold, cfg.track_max_iters,
                iters_coarse=cfg.track_iters_coarse, roundtrip_px=cfg.roundtrip_px,
                active=cand, p1_packed=packed_sel,
                bwd_lvls=cap_b(lvls_arr) if bwd_arr is None else bwd_arr,
                bwd_ref_from_window=cfg.bwd_ref_from_window, bwd_win_cache=bwd_wins,
            )
            newly = cand & res_ok
            return matched | newly, torch.where(newly[:, None], res_px, to_px), True

        return sweep

    def full_walk(sweep, matched, to_px, deep, first_rung=True):
        """The (view rank x pass) ladder (matcher.cpp:221-269, 248): pass 0
        at the lane's levels, pass 1 retries confident lanes at
        levels_unsure; ``deep`` gates the 6-level attempts. With
        ``first_rung`` the very first attempt takes the adaptive budgets."""
        for rank in range(V):
            has = key_sorted[:, rank] >= 0
            first = first_rung and rank == 0
            matched, to_px, _ = sweep(
                matched, to_px, lane_order[:, rank], has & torch.where(unsure, deep, all_lanes),
                lvls_first if first else lvls3, bwd_first if first else None,
                tally=first_tally if first else None)
            matched, to_px, _ = sweep(matched, to_px, lane_order[:, rank],
                                      has & ~unsure & deep, unsure_arr)
        return matched, to_px

    if cfg.retry_mode == "cycle":
        # the ladder's attempts after the first, in its order: (rank0, pass1),
        # (rank1, pass0), (rank1, pass1), ... A failing lane tries one a
        # sweep, picked by cycling its fail counter through its own valid
        # attempts
        att_r = torch.tensor([(j + 1) // 2 for j in range(2 * V - 1)], device=dev)
        att_p = torch.tensor([(j + 1) % 2 for j in range(2 * V - 1)], device=dev)
        has_rank = key_sorted >= 0
        att_ok = has_rank[:, att_r] & ((att_p == 0)[None, :] | ~unsure[:, None])
        n_att = torch.sum(att_ok, dim=1, dtype=torch.int32)
        cum_att = torch.cumsum(att_ok.to(torch.int32), dim=1)

        def run_find(matched, to_px, start_pred_, use_pred_):
            sweep = make_sweep(start_pred_, use_pred_, due)
            matched, to_px, _ = sweep(
                matched, to_px, lane_order[:, 0], has_rank[:, 0], lvls_first, bwd_first,
                tally=first_tally)
            for s in range(cfg.retry_sweeps):
                cyc = torch.remainder(ms.feat_fail + s, torch.clamp(n_att, min=1))
                pick = (cum_att == cyc[:, None] + 1) & att_ok
                j = torch.argmax(pick.to(torch.uint8), dim=1)  # 0 where none is valid
                vi = lane_order[lanes, att_r[j]]
                lvls_arr = torch.where(att_p[j] == 0, lvls3, unsure_arr)
                matched, to_px, ran = sweep(matched, to_px, vi, n_att > 0, lvls_arr)
                KNOBS.add("cycle_sweeps", int(ran))
            if cfg.retry_escalate_margin >= 0:
                # a decaying frame runs the reference's full walk, the
                # straggler backoff ignored
                low = torch.sum(matched) < cfg.min_matches + cfg.retry_escalate_margin
                if host(low):
                    KNOBS.add("escalations", 1)
                    matched, to_px = full_walk(make_sweep(start_pred_, use_pred_, all_lanes),
                                               matched, to_px, all_lanes, first_rung=False)
            return matched, to_px
    else:
        def run_find(matched, to_px, start_pred_, use_pred_):
            return full_walk(make_sweep(start_pred_, use_pred_, due), matched, to_px,
                             due_deep)
    return run_find


def _round1_find(ms: MatcherState, cfg: SlamConfig, new_pyr: FlatPyramid, weight,
                 eligible, lvls3):
    """FindMatches with an alternative tracker: the JAX package's round-1
    walk (its matcher.py:425-489). The stored views are walked globally,
    newest first; each gets a pass at the lanes' levels, then a pass
    retrying the confident lanes at levels_unsure (matcher.cpp:248). Every
    pass tracks the ``eligible`` lanes not matched yet that are valid in the
    view, through ``tracker.track_bidirectional`` with ``ops/klt`` or
    ``ops/tracker`` as ``track_fn``; a pass with no candidate is skipped on
    one host read. Returns run_find(matched, to_px, start_pred, use_pred)."""
    track_fn = klt.track_feature if cfg.tracker_kind == "klt" else tracker.track_feature
    order = torch.argsort(-ms.view_frame, stable=True)  # newest first, empty slots last
    confident = lvls3 != cfg.levels_unsure
    unsure_arr = torch.full_like(lvls3, cfg.levels_unsure)

    def run_find(matched, to_px, start_pred, use_pred):
        for r in range(cfg.max_views):
            vi = order[r:r + 1]
            from_pt = ms.feat_px.index_select(1, vi)[:, 0]
            start = torch.where(use_pred[:, None], start_pred, from_pt)
            in_view = (eligible & (ms.view_frame.index_select(0, vi) >= 0)
                       & ms.feat_valid.index_select(1, vi)[:, 0] & in_image(start, cfg))
            for retry in (False, True):
                cand = in_view & ~matched & (confident if retry else True)
                if not host(torch.any(cand)):
                    continue
                res_px, res_ok = tracker.track_bidirectional(
                    _view_pyramid(ms, vi[0], cfg), new_pyr, from_pt, start,
                    unsure_arr if retry else lvls3, weight, cfg.track_threshold,
                    cfg.track_max_iters, cfg.roundtrip_px, active=cand, track_fn=track_fn)
                newly = cand & res_ok
                matched = matched | newly
                to_px = torch.where(newly[:, None], res_px, to_px)
        return matched, to_px

    return run_find


@span("keyframe")
def _keyframe(ms: MatcherState, map_state: lm.MapState, new_pyr: FlatPyramid,
              matched, to_px, frame_idx, slot: int, fq, ft, k, cfg: SlamConfig):
    """Store a view in ring slot ``slot``, detect corners, seed new points
    and refresh the slot's reference caches. Returns (ms, map, n_added)."""
    NF = cfg.max_features
    dev = map_state.device
    P = map_state.point_loc.shape[0]
    kneed = min(NF, -(-(cfg.min_matches + cfg.max_corners + 32) // 64) * 64)

    view_frame = ms.view_frame.clone()
    view_frame[slot] = frame_idx
    feat_valid = ms.feat_valid.clone()
    feat_valid[:, slot] = matched
    feat_px = ms.feat_px.clone()
    feat_px[:, slot] = to_px
    map_state = map_state._replace(
        frame_keyframe=lm.set_row(map_state.frame_keyframe, frame_idx, True))

    grey = new_pyr.data[0, PAD:-PAD, PAD:-PAD]
    cpts, cval = corner_ops.detect(grey, cfg.max_corners, cfg.corner_quality,
                                   cfg.corner_min_dist)
    occ = corner_ops.occupancy_grid(to_px, matched, cfg.image_width,
                                    cfg.image_height, cfg.suppress_grid)
    cval = corner_ops.suppress_by_grid(cpts, cval, occ, cfg.image_width,
                                       cfg.image_height, cfg.suppress_grid)

    if cfg.seed_depth_adaptive:
        # seed at the median camera depth of the map's confident points
        # (a fixed guess far from the scene's depth biases every new point
        # the same way), clipped to [200, 50000] mm; seed_depth_mm below 16
        pm = map_state.point_mask & (map_state.point_uncertainty <= cfg.uncertainty_confident)
        ploc = map_state.point_loc
        w_h = torch.where(torch.abs(ploc[:, 3]) > 1e-9, ploc[:, 3],
                          torch.full_like(ploc[:, 3], 1e-9))
        zc = quat.rotate(fq, ploc[:, :3] / w_h[:, None] - ft)[:, 2]
        ok_z = pm & (zc > 1.0)
        nv = torch.sum(ok_z, dtype=torch.int32)
        zs = torch.sort(torch.where(ok_z, zc, torch.full_like(zc, float("inf")))).values
        med = _row(zs, torch.clamp(nv - 1, min=0) // 2)
        adaptive = nv >= 16
        seed_depth = torch.where(adaptive, torch.clamp(med, 200.0, 50000.0),
                                 torch.full_like(med, cfg.seed_depth_mm))
        KNOBS.add("adaptive_seeds", adaptive.to(torch.int32))
    else:
        seed_depth = cfg.seed_depth_mm
    plane = proj.pixel_to_plane(cpts, k)
    locs = proj.unproject(fq, ft, plane, seed_depth)
    trackable = torch.any(feat_valid, dim=1)
    feat_point_live = torch.where(trackable, ms.feat_point, torch.full_like(ms.feat_point, -1))
    free = feat_point_live < 0
    slot_order = torch.argsort((~free).to(torch.int8), stable=True)
    n_free = torch.sum(free, dtype=torch.int32)
    kk = cpts.shape[0]
    ar_k = torch.arange(kk, device=dev)
    dest = slot_order[ar_k.clamp(0, NF - 1)]
    assign = cval & (ar_k < n_free)

    # capacity-pressure eviction never evicts a point a live lane tracks
    referenced = lm.scatter_set(
        torch.zeros((P,), dtype=torch.bool, device=dev),
        torch.where(feat_point_live >= 0, feat_point_live, torch.full_like(feat_point_live, P)),
        True)
    map_state, pids = lm.add_points(map_state, locs, assign, referenced=referenced,
                                    evict_retain=cfg.point_evict_retain)
    assign = assign & (pids >= 0)
    map_state = lm.add_observations(map_state, frame_idx, pids, cpts, assign)

    sdest = torch.where(assign, dest, torch.full_like(dest, NF))
    slot_t = torch.full((kk,), slot, dtype=torch.long, device=dev)
    feat_point = lm.scatter_set(feat_point_live, sdest, pids)
    feat_px = lm.scatter_set(feat_px, sdest, cpts, col=slot_t)
    feat_valid = lm.scatter_set(feat_valid, sdest, False)
    feat_valid = lm.scatter_set(feat_valid, sdest, True, col=slot_t)
    feat_fail = lm.scatter_set(ms.feat_fail, sdest, 0)

    # refresh only the lanes stored in this view (<= min_matches + corners)
    if kneed < NF:
        need = feat_valid[:, slot]
        ksel = torch.argsort((~need).to(torch.int8), stable=True)[:kneed]
        kmask = need[ksel]
        kpts = feat_px[ksel, slot]
        wdest = torch.where(kmask, ksel, torch.full_like(ksel, NF))
        covered = lm.scatter_set(torch.zeros((NF,), dtype=torch.bool, device=dev), wdest, True)
        feat_valid = feat_valid.clone()
        feat_valid[:, slot] = need & covered
    else:
        kpts = feat_px[:, slot]
        wdest = torch.arange(NF, device=dev)

    if cfg.bwd_window_cache:
        wins, orgs = tracker_fused.get_window_stacks(new_pyr, kpts)
        stacks = tracker_fused.get_patch_stacks_from_windows(new_pyr, kpts, wins, orgs,
                                                             cfg.patch_size)
    else:
        wins = orgs = None
        stacks = tracker_fused.get_patch_stacks(new_pyr, kpts, cfg.patch_size)
    packed = tracker_fused.pack_stacks(stacks)

    slot_w = torch.full_like(wdest, slot)
    view_pyr = ms.view_pyr.clone()
    view_pyr[slot] = new_pyr.data
    upd = dict(
        view_frame=view_frame, feat_px=feat_px, feat_valid=feat_valid,
        feat_point=feat_point, feat_fail=feat_fail, view_pyr=view_pyr,
        feat_refpack=lm.scatter_set(ms.feat_refpack, wdest, packed, col=slot_w),
    )
    if wins is not None:
        upd["feat_refwin"] = lm.scatter_set(ms.feat_refwin, wdest, wins, col=slot_w)
        upd["feat_reforg"] = lm.scatter_set(ms.feat_reforg, wdest, orgs, col=slot_w)
    return ms._replace(**upd), map_state, torch.sum(assign, dtype=torch.int32)
