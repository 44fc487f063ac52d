"""Feature lifecycle: per-frame tracking orchestration (matcher.cpp).

Port of ``slam_robot_tpu/models/matcher.py`` on its default path: the fused
tracker (``tracker_impl="fused"``, ``tracker_kind="hessian"``) with the
per-lane view-rank retry ladder (``retry_mode="ladder"``). Per frame
(matcher.cpp:301-405): drop features whose point is no longer
feature-usable; walk each lane's stored views newest-first with a 6-level
retry pass, forward+backward tracking from projection-predicted starts;
commit matches as observations; below ``min_matches`` store a keyframe
view, detect corners, suppress them near matches and seed new points.

The JAX package's ``lax.cond``s become Python ``if``s on a host read: an
empty sweep is skipped, and the keyframe branch runs only on keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import default_device, host, span
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.ops import corners as corner_ops
from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.ops import tracker_fused
from slam_robot_tpu_torch.ops.pyramid import PAD, FlatPyramid, level_dims

# Non-default knobs the port does not run yet, with the ROADMAP item that
# will port each: {field: (default, item)}.
UNPORTED = {
    "tracker_impl": ("fused", "A12 (alternative trackers)"),
    "tracker_kind": ("hessian", "A12 (alternative trackers)"),
    "mid_frame_resolve": (False, "A15 (mid_frame_resolve)"),
    "motion_model": ("copy", "A16 (constant_velocity)"),
    "retry_mode": ("ladder", "A19 (off-by-default knobs)"),
    "adaptive_fwd_px": (0.0, "A19 (off-by-default knobs)"),
    "seed_depth_adaptive": (False, "A19 (off-by-default knobs)"),
    "drop_idle_frames": (False, "A19 (off-by-default knobs)"),
    "clean_duplicates": (False, "A19 (off-by-default knobs)"),
}


def check_supported(cfg: SlamConfig) -> None:
    """Raise NotImplementedError for a knob this port has not ported."""
    for field, (default, item) in UNPORTED.items():
        val = getattr(cfg, field)
        if val != default:
            raise NotImplementedError(
                f"SlamConfig.{field}={val!r} is not ported yet (default "
                f"{default!r}); see ROADMAP.md item {item}")


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
    feat_sharp: torch.Tensor    # [NF] bool (adaptive_fwd_px; always False here)


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
    dims = level_dims(cfg.image_height, cfg.image_width, cfg.pyramid_depth)
    V, L = ms.view_pyr.shape[:2]
    dev = ms.view_pyr.device
    h = torch.tensor([d[0] for d in dims], dtype=torch.int32, device=dev).repeat(V)
    w = torch.tensor([d[1] for d in dims], dtype=torch.int32, device=dev).repeat(V)
    return FlatPyramid(data=ms.view_pyr.reshape((V * L,) + ms.view_pyr.shape[2:]),
                       heights=h, widths=w, depth_=L, offset=vi.long() * L)


@span("matcher")
def track(ms: MatcherState, map_state: lm.MapState, img, frame_idx, camera_idx,
          cfg: SlamConfig):
    """One Matcher::Track step. ``img`` is [H,W(,3)] uint8 or f32 on the
    state's device. Returns (matcher_state, map_state, metrics)."""
    check_supported(cfg)
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

    def cadence(k):
        if k <= 1:
            return torch.ones((NF,), dtype=torch.bool, device=dev)
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

    # predicted start locations from projecting each point (matcher.cpp:233-239)
    pred_px, pred_ok = proj.project_point(fq, ft, k, loc)
    use_pred = (unc < cfg.uncertainty_confident) & pred_ok
    start_pred = torch.where(use_pred[:, None], pred_px, torch.zeros_like(pred_px))

    # per-lane view ranks: each lane walks its own valid views newest-first
    key = torch.where(ms.feat_valid & (ms.view_frame >= 0)[None, :],
                      ms.view_frame[None, :].expand(NF, V), torch.full_like(ms.feat_valid, -1, dtype=torch.int32))
    lane_order = torch.argsort(-key, dim=1, stable=True)
    key_sorted = torch.gather(key, 1, lane_order)

    def cap_b(x):
        return x if cfg.roundtrip_levels <= 0 else torch.clamp(x, max=cfg.roundtrip_levels)

    def sweep(matched, to_px, vi_lane, has, lvls_arr, bwd_arr):
        from_pt = ms.feat_px[lanes, vi_lane]
        start = torch.where(use_pred[:, None], start_pred, from_pt)
        cand = live & due & ~matched & has & in_image(start, cfg)
        if not host(torch.any(cand)):
            return matched, to_px
        packed_sel = ms.feat_refpack[lanes, vi_lane]
        bwd_wins = ((ms.feat_refwin[lanes, vi_lane], ms.feat_reforg[lanes, vi_lane])
                    if cfg.bwd_window_cache else None)
        res_px, res_ok = tracker_fused.track_bidirectional_batch(
            _view_pyramid(ms, vi_lane, cfg), new_pyr, from_pt, start, lvls_arr,
            weight, cfg.track_threshold, cfg.track_max_iters,
            iters_coarse=cfg.track_iters_coarse, roundtrip_px=cfg.roundtrip_px,
            active=cand, p1_packed=packed_sel, bwd_lvls=bwd_arr, bwd_ref_from_window=cfg.bwd_ref_from_window,
            bwd_win_cache=bwd_wins,
        )
        newly = cand & res_ok
        return matched | newly, torch.where(newly[:, None], res_px, to_px)

    # 2. FindMatches: the (view rank x pass) ladder (matcher.cpp:221-269, 248)
    matched = torch.zeros((NF,), dtype=torch.bool, device=dev)
    to_px = torch.zeros((NF, 2), dtype=torch.float32, device=dev)
    unsure = lvls3 == cfg.levels_unsure
    for rank in range(V):
        has = key_sorted[:, rank] >= 0
        for retry_pass in (0, 1):
            if retry_pass == 0:
                pass_ok = torch.where(unsure, due_deep, torch.ones_like(due_deep))
                lvls_arr = lvls3
            else:
                pass_ok = ~unsure & due_deep
                lvls_arr = torch.full_like(lvls3, cfg.levels_unsure)
            matched, to_px = sweep(matched, to_px, lane_order[:, rank], has & pass_ok,
                                   lvls_arr, cap_b(lvls_arr))

    # 3. write observations (matcher.cpp:255-257)
    map_state = lm.add_observations(map_state, frame_idx, pt_idx, to_px, matched)
    n_matches = torch.sum(matched, dtype=torch.int32)

    feat_fail = torch.where(matched, torch.zeros_like(ms.feat_fail),
                            torch.where(live & due, ms.feat_fail + 1, ms.feat_fail))
    feat_point = ms.feat_point
    if cfg.find_fail_give_up > 0:
        gone = (feat_point >= 0) & (feat_fail >= cfg.find_fail_give_up)
        feat_point = torch.where(gone, torch.full_like(feat_point, -1), feat_point)
    ms = ms._replace(feat_fail=feat_fail, feat_point=feat_point,
                     feat_sharp=torch.zeros((NF,), dtype=torch.bool, device=dev))

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
        "resolve_fired": torch.tensor(False, device=dev),
        "feat_point": pt_idx,
        "feat_px": to_px,
        "feat_matched": matched,
    }
    return ms, map_state, metrics


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

    plane = proj.pixel_to_plane(cpts, k)
    locs = proj.unproject(fq, ft, plane, cfg.seed_depth_mm)
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
