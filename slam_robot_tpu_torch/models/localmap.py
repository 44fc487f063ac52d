"""The world model: a fixed-capacity, mask-based, struct-of-arrays map state.

Port of ``slam_robot_tpu/models/localmap.py`` (localmap.{h,cpp}). ``MapState``
keeps the JAX package's fields, shapes and dtypes field for field (int32
stays int32; indices are cast to int64 only to index). Every mutation is a
function ``MapState -> MapState`` that returns new tensors and leaves its
input untouched.

The JAX package's out-of-range scatters drop their writes
(``mode="drop"``); torch's ``index_put`` would raise or device-assert. The
port routes such writes to one extra scratch row that is sliced off
(:func:`scatter_set`), and never clamps them onto a real row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import default_device, host, span
from slam_robot_tpu_torch.ops import epipolar as epi
from slam_robot_tpu_torch.ops import projection as proj
from slam_robot_tpu_torch.ops import quaternion as quat

# ---- point flag bits (localmap.h:184-190) ----
BAD_LOCATION = 1 << 0
NO_BASELINE = 1 << 1
NO_OBSERVATIONS = 1 << 2
MISMATCHED = 1 << 3
BAD_FEATURE = 1 << 4

_SLAM_BAD = BAD_LOCATION | NO_BASELINE | NO_OBSERVATIONS | BAD_FEATURE
_FEATURE_BAD = MISMATCHED | BAD_LOCATION

I32 = torch.int32
F32 = torch.float32


def slam_usable(flags):
    """localmap.h:242-248."""
    return (flags & _SLAM_BAD) == 0


def feature_usable(flags):
    """localmap.h:249."""
    return (flags & _FEATURE_BAD) == 0


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX scatter index semantics: negatives wrap once, anything still out
    of [0, n) is dropped — routed to the scratch row ``n``."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals, col=None,
                accumulate: bool = False) -> torch.Tensor:
    """``arr.at[idx(, col)].set(vals, mode="drop")`` (or ``.add``) without
    touching ``arr``: out-of-range rows land in a scratch row that is sliced
    off. ``col`` (optional) indexes the second axis and must be in range."""
    n = arr.shape[0]
    buf = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
    rows = _drop_index(idx, n)
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    index = (rows,) if col is None else (rows, col.long())
    return buf.index_put(index, vals, accumulate=accumulate)[:n]


def set_row(arr: torch.Tensor, i: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[i].set(val)`` for a 0-d index tensor, without a host sync."""
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return arr.index_put((i.reshape(1).long(),), val.reshape((1,) + arr.shape[1:]))


class MapState(NamedTuple):
    cam_k: torch.Tensor        # [C, 7] k1,k2,k3,fx,fy,cx,cy
    cam_k_init: torch.Tensor   # [C, 7]
    frame_quat: torch.Tensor   # [F, 4] xyzw
    frame_trans: torch.Tensor  # [F, 3]
    frame_cam: torch.Tensor    # [F] int32
    frame_keyframe: torch.Tensor  # [F] bool
    frame_obs_start: torch.Tensor  # [F] int32
    n_frames: torch.Tensor     # int32 scalar
    point_loc: torch.Tensor    # [P, 4]
    point_uncertainty: torch.Tensor  # [P] f32
    point_flags: torch.Tensor  # [P] int32
    point_free: torch.Tensor   # [P] bool
    n_points: torch.Tensor     # int32 scalar high-water mark
    obs_frame: torch.Tensor    # [O] int32
    obs_point: torch.Tensor    # [O] int32
    obs_px: torch.Tensor       # [O, 2] f32
    obs_disabled: torch.Tensor  # [O] bool
    obs_err: torch.Tensor      # [O, 2] f32
    obs_err_valid: torch.Tensor  # [O] bool
    obs_slot: torch.Tensor     # [O] int32
    n_obs: torch.Tensor        # int32 scalar
    point_obs: torch.Tensor    # [P, R] int32
    point_obs_total: torch.Tensor  # [P] int32
    ring_frame: torch.Tensor   # [P, R] int32
    ring_disabled: torch.Tensor  # [P, R] bool

    @property
    def device(self):
        return self.point_loc.device

    @property
    def frame_mask(self):
        return torch.arange(self.frame_quat.shape[0], device=self.device) < self.n_frames

    @property
    def point_mask(self):
        return ((torch.arange(self.point_loc.shape[0], device=self.device) < self.n_points)
                & ~self.point_free)

    @property
    def obs_mask(self):
        return torch.arange(self.obs_frame.shape[0], device=self.device) < self.n_obs

    @property
    def ring_size(self):
        return self.point_obs.shape[1]

    def point_position(self):
        return proj.point_position(self.point_loc)

    def point_ring_count(self):
        return torch.clamp(self.point_obs_total, max=self.ring_size)

    def recent_obs_index(self, i: int):
        """Obs-table index of observation(-i) per point (localmap.h:205-218)."""
        total = self.point_obs_total
        slot = torch.remainder(total - i, self.ring_size)
        idx = torch.gather(self.point_obs, 1, slot.long()[:, None])[:, 0]
        ok = (total >= i) & (i >= 1) & (i <= self.point_ring_count())
        return torch.where(ok, idx, torch.full_like(idx, -1))


def empty(cfg: SlamConfig, device=None) -> MapState:
    """An empty map on ``device`` (default: the CUDA card)."""
    C, F, P, O, R = (cfg.num_cameras, cfg.max_frames, cfg.max_points,
                     cfg.max_obs, cfg.max_obs_per_point)
    z = dict(device=default_device(device))
    return MapState(
        cam_k=torch.zeros((C, 7), dtype=F32, **z),
        cam_k_init=torch.zeros((C, 7), dtype=F32, **z),
        frame_quat=torch.tensor([0, 0, 0, 1], dtype=F32, **z).repeat(F, 1),
        frame_trans=torch.zeros((F, 3), dtype=F32, **z),
        frame_cam=torch.zeros((F,), dtype=I32, **z),
        frame_keyframe=torch.zeros((F,), dtype=torch.bool, **z),
        frame_obs_start=torch.zeros((F,), dtype=I32, **z),
        n_frames=torch.zeros((), dtype=I32, **z),
        point_loc=torch.tensor([0, 0, 1, 1], dtype=F32, **z).repeat(P, 1),
        point_uncertainty=torch.full((P,), 1e8, dtype=F32, **z),
        point_flags=torch.zeros((P,), dtype=I32, **z),
        point_free=torch.zeros((P,), dtype=torch.bool, **z),
        n_points=torch.zeros((), dtype=I32, **z),
        obs_frame=torch.full((O,), -1, dtype=I32, **z),
        obs_point=torch.full((O,), -1, dtype=I32, **z),
        obs_px=torch.zeros((O, 2), dtype=F32, **z),
        obs_disabled=torch.zeros((O,), dtype=torch.bool, **z),
        obs_err=torch.zeros((O, 2), dtype=F32, **z),
        obs_err_valid=torch.zeros((O,), dtype=torch.bool, **z),
        obs_slot=torch.full((O,), -1, dtype=I32, **z),
        n_obs=torch.zeros((), dtype=I32, **z),
        point_obs=torch.full((P, R), -1, dtype=I32, **z),
        point_obs_total=torch.zeros((P,), dtype=I32, **z),
        ring_frame=torch.full((P, R), -1, dtype=I32, **z),
        ring_disabled=torch.zeros((P, R), dtype=torch.bool, **z),
    )


def set_camera(state: MapState, idx: int, k) -> MapState:
    """AddCamera + Reset (localmap.cpp:101-104, localmap.h:32-36)."""
    k = torch.as_tensor(np.asarray(k), dtype=F32, device=state.device)
    cam_k = state.cam_k.clone()
    cam_k[idx] = k
    cam_k_init = state.cam_k_init.clone()
    cam_k_init[idx] = k
    return state._replace(cam_k=cam_k, cam_k_init=cam_k_init)


def reset_cameras(state: MapState) -> MapState:
    """LocalMap::Reset of every camera: k back to its initial value
    (localmap.h:32-36), as before a SolveCameras run."""
    return state._replace(cam_k=state.cam_k_init)


def add_frame(state: MapState, cam_idx, q=None, t=None):
    """Append a frame (localmap.cpp:93-99). Returns (state, frame_idx)."""
    i = state.n_frames
    dev = state.device
    q = quat.identity(device=dev) if q is None else q
    t = torch.zeros(3, dtype=F32, device=dev) if t is None else t
    cam = torch.as_tensor(cam_idx, dtype=I32, device=dev)
    return (
        state._replace(
            frame_quat=set_row(state.frame_quat, i, q),
            frame_trans=set_row(state.frame_trans, i, t),
            frame_cam=set_row(state.frame_cam, i, cam),
            frame_keyframe=set_row(state.frame_keyframe, i, False),
            frame_obs_start=set_row(state.frame_obs_start, i, state.n_obs),
            n_frames=i + 1,
        ),
        i,
    )


def evict_points(state: MapState, deficit, referenced=None,
                 retain_frames: int = 40) -> MapState:
    """Free up to ``deficit`` point slots under capacity pressure: dead points
    (not feature- and not slam-usable) first, then LRU-stale ones; never a
    point in ``referenced``. Evicted slots set ``point_free`` and their
    obs-table rows are retired (obs_point -> -1, disabled, no valid error).
    """
    P = state.point_loc.shape[0]
    flags = state.point_flags
    dead = ~feature_usable(flags) & ~slam_usable(flags)
    last_obs = torch.max(state.ring_frame, dim=1).values
    stale = last_obs < (state.n_frames - retain_frames)
    cand = state.point_mask & (dead | stale)
    if referenced is not None:
        cand = cand & ~referenced
    score = torch.where(
        cand,
        dead.to(F32) * 1e9 + (state.n_frames - last_obs).to(F32),
        torch.full((P,), -float("inf"), dtype=F32, device=state.device),
    )
    order = torch.argsort(-score, stable=True)
    take = (torch.arange(P, device=state.device) < deficit) & (score[order] > -float("inf"))
    evict = torch.zeros(P, dtype=torch.bool, device=state.device).index_put((order,), take)

    retired = evict[state.obs_point.clamp(min=0).long()] & (state.obs_point >= 0) & state.obs_mask
    return state._replace(
        point_free=state.point_free | evict,
        obs_point=torch.where(retired, torch.full_like(state.obs_point, -1), state.obs_point),
        obs_disabled=state.obs_disabled | retired,
        obs_err_valid=state.obs_err_valid & ~retired,
        ring_disabled=state.ring_disabled | evict[:, None],
    )


def add_points(state: MapState, locs, valid, referenced=None,
               evict_retain: int = 0):
    """Batched AddPoint (localmap.cpp:106-112). Returns (state, point_idx[K]).

    New points get NO_OBSERVATIONS|NO_BASELINE and uncertainty 1e8; invalid
    rows get -1 and use no capacity. Free (evicted) slots are taken first in
    index order, then the append region. ``evict_retain`` > 0 reclaims
    dead/stale slots first when the call would overflow the table.
    """
    valid = torch.as_tensor(valid, dtype=torch.bool, device=state.device)
    P = state.point_loc.shape[0]
    dev = state.device

    if evict_retain:
        n_avail = torch.sum(state.point_free, dtype=I32) + P - state.n_points
        deficit = torch.sum(valid, dtype=I32) - n_avail
        state = evict_points(state, deficit, referenced, evict_retain)

    avail = state.point_free | (torch.arange(P, device=dev) >= state.n_points)
    n_avail = torch.sum(avail, dtype=I32)
    slot_order = torch.argsort((~avail).to(torch.int8), stable=True)
    vi = valid.to(I32)
    rank = torch.cumsum(vi, 0).to(I32) - vi
    in_cap = valid & (rank < n_avail)
    picked = slot_order[rank.clamp(0, P - 1).long()]
    dest = torch.where(in_cap, picked, torch.full_like(picked, P))

    n_appended = torch.sum((in_cap & (dest >= state.n_points)), dtype=I32)
    idx = torch.where(in_cap, dest, torch.full_like(dest, -1)).to(I32)
    R = state.point_obs.shape[1]
    return (
        state._replace(
            point_loc=scatter_set(state.point_loc, dest, locs),
            point_flags=scatter_set(state.point_flags, dest, NO_OBSERVATIONS | NO_BASELINE),
            point_uncertainty=scatter_set(state.point_uncertainty, dest, 1e8),
            point_obs=scatter_set(state.point_obs, dest, torch.full((R,), -1, dtype=I32)),
            point_obs_total=scatter_set(state.point_obs_total, dest, 0),
            ring_frame=scatter_set(state.ring_frame, dest, torch.full((R,), -1, dtype=I32)),
            ring_disabled=scatter_set(state.ring_disabled, dest, False),
            point_free=scatter_set(state.point_free, dest, False),
            n_points=state.n_points + n_appended,
        ),
        idx,
    )


def add_observations(state: MapState, frame_idx, point_idx, px, valid) -> MapState:
    """Batched Frame::AddObservation + Commit (localmap.h:139-144,
    localmap.cpp:86-90): append rows to the obs table, publish them into the
    per-point rings, then re-derive evidence flags. Each point appears at
    most once per call."""
    dev = state.device
    point_idx = torch.as_tensor(point_idx, dtype=I32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev) & (point_idx >= 0)
    O = state.obs_frame.shape[0]
    P = state.point_loc.shape[0]
    vi = valid.to(I32)
    offs = state.n_obs + torch.cumsum(vi, 0).to(I32) - vi
    in_cap = valid & (offs < O)
    dest = torch.where(in_cap, offs, torch.full_like(offs, O))
    fidx = torch.as_tensor(frame_idx, dtype=I32, device=dev)

    totals = state.point_obs_total[point_idx.clamp(min=0).long()]
    slot = torch.remainder(totals, state.ring_size)
    pr = torch.where(in_cap, point_idx, torch.full_like(point_idx, P))

    new = state._replace(
        obs_frame=scatter_set(state.obs_frame, dest, fidx),
        obs_point=scatter_set(state.obs_point, dest, point_idx),
        obs_px=scatter_set(state.obs_px, dest, px),
        obs_disabled=scatter_set(state.obs_disabled, dest, False),
        obs_err=scatter_set(state.obs_err, dest, 0.0),
        obs_err_valid=scatter_set(state.obs_err_valid, dest, False),
        obs_slot=scatter_set(state.obs_slot, dest, slot.to(I32)),
        n_obs=state.n_obs + torch.sum(in_cap, dtype=I32),
        point_obs=scatter_set(state.point_obs, pr, offs, col=slot),
        point_obs_total=scatter_set(state.point_obs_total, pr, 1, accumulate=True),
        ring_frame=scatter_set(state.ring_frame, pr, fidx, col=slot),
        ring_disabled=scatter_set(state.ring_disabled, pr, False, col=slot),
    )
    return refresh_flags(new)


# ---------------------------------------------------------------------------
# flag evidence (CheckFlags, localmap.cpp:44-84) — clear-only
# ---------------------------------------------------------------------------

def _ring_slots(state: MapState):
    """Per-point ring slots in storage order: (idx [P,R], ok [P,R], age [P,R]);
    ``age`` is each slot's position in arrival order (0 = oldest kept)."""
    P, R = state.point_obs.shape
    total = state.point_obs_total
    cnt = state.point_ring_count()
    start = torch.remainder(total - cnt, R)[:, None]
    k = torch.arange(R, device=state.device)[None, :]
    age = torch.remainder(k - start, R)
    idx = state.point_obs
    ok = (age < cnt[:, None]) & (idx >= 0)
    return idx, ok, age


def _ring_gather(state: MapState, field):
    """A per-obs field over the ring slots [P, R] in storage order, with the
    slots' validity and obs rows: (vals, ok, idx)."""
    idx, ok, _age = _ring_slots(state)
    return field[idx.clamp(min=0).long()], ok, idx


def _refresh_flags_from(flags, good, pos, age, min_baseline: float = 50.0):
    """Flag-evidence core on pre-gathered ring data (see refresh_flags)."""
    n_good = torch.sum(good, dim=1)
    clear_no_obs = n_good >= 2
    R = good.shape[1]
    aged = torch.where(good, age, torch.full_like(age, R))
    first_age, first_slot = torch.min(aged, dim=1)
    has_base = torch.any(good, dim=1)
    base = torch.gather(pos, 1, first_slot[:, None, None].expand(-1, 1, 3))[:, 0]
    dist = torch.linalg.norm(pos - base[:, None, :], dim=-1)
    later = good & (age > first_age[:, None])
    clear_no_base = has_base & torch.any(later & (dist >= min_baseline), dim=1)
    flags = torch.where(clear_no_obs, flags & ~NO_OBSERVATIONS, flags)
    flags = torch.where(clear_no_base, flags & ~NO_BASELINE, flags)
    return flags


def refresh_flags(state: MapState, min_baseline: float = 50.0) -> MapState:
    """Clear NO_OBSERVATIONS (>= 2 enabled observations) and NO_BASELINE (an
    enabled observation >= 50 mm from the first enabled one's frame)."""
    _idx, ok, age = _ring_slots(state)
    good = ok & ~state.ring_disabled
    pos = state.frame_trans[state.ring_frame.clamp(min=0).long()]
    flags = _refresh_flags_from(state.point_flags, good, pos, age, min_baseline)
    return state._replace(point_flags=flags)


# ---------------------------------------------------------------------------
# normalize (localmap.cpp:114-155)
# ---------------------------------------------------------------------------

@span("normalize")
def normalize(state: MapState, rescale: bool = False, baseline: float = 150.0) -> MapState:
    """Re-anchor frame 0 at origin/identity; optionally re-fix scale.

    When the anchor is already the identity (frame 0 is const in every
    window solve) the full transform reproduces its inputs, so only the
    points' unit-norm and the frames' renormalization remain (the fast
    branch); both branches are computed and selected without a host sync.
    """
    do = state.n_frames >= 2
    t0 = state.frame_trans[0]
    q0 = state.frame_quat[0]
    pm = state.point_mask[:, None]
    fm = state.frame_mask[:, None]

    is_id = ((torch.abs(q0[3]) > 1.0 - 1e-7)
             & (torch.sum(torch.abs(q0[:3])) + torch.sum(torch.abs(t0)) < 1e-7)
             & (not rescale))

    loc = state.point_loc
    # fast branch
    unit = loc / torch.clamp(torch.linalg.norm(loc, dim=-1, keepdim=True), min=1e-12)
    fast_q = quat.normalize(state.frame_quat)

    # full branch
    if rescale:
        scale = baseline / torch.clamp(torch.linalg.norm(t0 - state.frame_trans[1]), min=1e-9)
    else:
        scale = torch.ones((), dtype=F32, device=state.device)
    new_t = quat.rotate(q0, (state.frame_trans - t0) * scale)
    new_q = quat.normalize(quat.multiply(state.frame_quat, quat.conjugate(q0)))
    xyz = loc[..., :3] - t0 * loc[..., 3:4]
    w = loc[..., 3:4] / scale
    moved = torch.cat([quat.rotate(q0, xyz), w], dim=-1)
    moved = moved / torch.clamp(torch.linalg.norm(moved, dim=-1, keepdim=True), min=1e-12)

    full_t = torch.where(do & fm, new_t, state.frame_trans)
    full_q = torch.where(do & fm, new_q, state.frame_quat)
    full_loc = torch.where(do & pm, moved, loc)
    fast_qq = torch.where(do & fm, fast_q, state.frame_quat)
    fast_loc = torch.where(do & pm, unit, loc)
    return state._replace(
        frame_trans=torch.where(is_id, state.frame_trans, full_t),
        frame_quat=torch.where(is_id, fast_qq, full_q),
        point_loc=torch.where(is_id, fast_loc, full_loc),
    )


def estimate_motion(state: MapState, frame_idx):
    """Constant-velocity pose prediction for the frame at ``frame_idx`` (the
    intended LocalMap::EstimateMotion, declared at localmap.h:300 and never
    implemented): the same physical camera's pose two frames ago advanced
    by its displacement over its last stride (frames i-4 -> i-2). Before
    frame 4 it is the plain copy of frame i-2. Returns (quat, trans)."""
    i = torch.as_tensor(frame_idx, dtype=I32, device=state.device).reshape(1).long()
    i2 = torch.clamp(i - 2, min=0)
    i4 = torch.clamp(i - 4, min=0)
    q2, t2 = state.frame_quat.index_select(0, i2)[0], state.frame_trans.index_select(0, i2)[0]
    q4, t4 = state.frame_quat.index_select(0, i4)[0], state.frame_trans.index_select(0, i4)[0]
    dq = quat.normalize(quat.multiply(q2, quat.conjugate(q4)))
    pred_t = t2 + (t2 - t4)
    pred_q = quat.normalize(quat.multiply(dq, q2))
    ok = i[0] >= 4
    return torch.where(ok, pred_q, q2), torch.where(ok, pred_t, t2)


# ---------------------------------------------------------------------------
# pop_frame / check_not_moving (localmap.cpp:158-187)
# ---------------------------------------------------------------------------

def pop_frame(state: MapState) -> MapState:
    """Remove the newest frame and its observations (localmap.cpp:158-171).

    Its observations are the obs table's tail and the newest entry of each
    of their points' rings: the ring totals decrement and the slot that
    held each row, (total - 1) % R, is cleared, so that a wrapped ring never
    reads the removed row as its oldest. Rows whose point was evicted
    (obs_point -1) touch no ring. Flags stay (evidence is clear-only)."""
    has = state.n_frames > 0
    last = torch.clamp(state.n_frames - 1, min=0)
    start = state.frame_obs_start.index_select(0, last.reshape(1).long())[0]
    O = state.obs_frame.shape[0]
    P, R = state.point_obs.shape
    rows = torch.arange(O, device=state.device)
    removed = (rows >= start) & (rows < state.n_obs) & has
    pts = torch.where(removed & (state.obs_point >= 0), state.obs_point,
                      torch.full_like(state.obs_point, P))
    slot = torch.remainder(state.point_obs_total[pts.clamp(max=P - 1).long()] - 1, R)
    return state._replace(
        n_frames=torch.where(has, last, state.n_frames),
        n_obs=torch.where(has, start, state.n_obs),
        obs_frame=torch.where(removed, torch.full_like(state.obs_frame, -1), state.obs_frame),
        obs_point=torch.where(removed, torch.full_like(state.obs_point, -1), state.obs_point),
        obs_err_valid=state.obs_err_valid & ~removed,
        point_obs=scatter_set(state.point_obs, pts, -1, col=slot),
        point_obs_total=scatter_set(state.point_obs_total, pts, -1, accumulate=True),
    )


def check_not_moving(state: MapState, d2_threshold: float = 5.0) -> MapState:
    """Drop the newest two frames when the motion is negligible
    (localmap.cpp:173-187): at least 4 frames, d1^2 + d2^2 <= threshold
    and neither of the two a keyframe. One host read decides."""
    n = state.n_frames
    i = torch.clamp(n, min=4).reshape(1).long()
    pos = state.frame_trans

    def at(a, back):
        return a.index_select(0, i - back)[0]

    d1 = torch.linalg.norm(at(pos, 1) - at(pos, 3))
    d2 = torch.linalg.norm(at(pos, 2) - at(pos, 4))
    idle = (d1 * d1 + d2 * d2) <= d2_threshold
    kf = at(state.frame_keyframe, 1) | at(state.frame_keyframe, 2)
    if host((n >= 4) & idle & ~kf):
        state = pop_frame(pop_frame(state))
    return state


# ---------------------------------------------------------------------------
# reproject (slam.cpp:523-548)
# ---------------------------------------------------------------------------

def _tail_rows(state: MapState, window: int | None):
    """Row indices of the newest ``window`` obs rows (or None = all)."""
    O = state.obs_frame.shape[0]
    if window is None or window >= O:
        return None
    start = torch.clamp(state.n_obs - window, min=0)
    return start.long() + torch.arange(window, device=state.device)


def _project_rows(state: MapState, obs_frame, obs_point, cheirality_eps):
    f = obs_frame.clamp(min=0).long()
    p = obs_point.clamp(min=0).long()
    q = state.frame_quat[f]
    t = state.frame_trans[f]
    k = state.cam_k[state.frame_cam[f].long()]
    loc = state.point_loc[p]
    return proj.project_point(q, t, k, loc, cheirality_eps)


@span("reproject")
def reproject(state: MapState, cheirality_eps: float = 0.001,
              window: int | None = None):
    """Recompute observation reprojection errors; return (state, mean).

    Rows failing the cheirality test keep error = observed pixel, lose
    ``obs_err_valid`` and are excluded from the mean (slam.cpp:529-545);
    retired rows (obs_point -1) keep their stored error. ``window`` limits
    the recompute to the newest rows of the table.
    """
    rows = _tail_rows(state, window)
    sl = (lambda a: a) if rows is None else (lambda a: a[rows])
    obs_frame, obs_point = sl(state.obs_frame), sl(state.obs_point)
    obs_px, obs_mask_w = sl(state.obs_px), sl(state.obs_mask)

    px, valid = _project_rows(state, obs_frame, obs_point, cheirality_eps)
    active = obs_mask_w & (obs_point >= 0)
    err = torch.where((valid & active)[:, None], px - obs_px, obs_px)
    counted = valid & active
    norms = torch.linalg.norm(err, dim=-1)
    mean = torch.sum(torch.where(counted, norms, torch.zeros_like(norms))) / torch.clamp(
        torch.sum(counted.to(F32)), min=1.0)
    new_err = torch.where(active[:, None], err, sl(state.obs_err))
    new_valid = torch.where(active, counted, sl(state.obs_err_valid))
    if rows is None:
        obs_err, obs_err_valid = new_err, new_valid
    else:
        obs_err = state.obs_err.index_put((rows,), new_err)
        obs_err_valid = state.obs_err_valid.index_put((rows,), new_valid)
    return state._replace(obs_err=obs_err, obs_err_valid=obs_err_valid), mean


def mean_obs_error(state: MapState, window: int | None = None) -> torch.Tensor:
    """The mean reproject would return when nothing moved since the last
    reproject, from the stored error table (rows with ``obs_err_valid``)."""
    rows = _tail_rows(state, window)
    sl = (lambda a: a) if rows is None else (lambda a: a[rows])
    counted = sl(state.obs_mask) & sl(state.obs_err_valid)
    norms = torch.linalg.norm(sl(state.obs_err), dim=-1)
    return torch.sum(torch.where(counted, norms, torch.zeros_like(norms))) / torch.clamp(
        torch.sum(counted.to(F32)), min=1.0)


def normalize_canary(state: MapState, rows: int = 64,
                     cheirality_eps: float = 0.001) -> torch.Tensor:
    """Max per-row |fresh error norm - stored error norm| over the newest
    ``rows`` obs rows, against the current (post-normalize) geometry
    (main.cpp:602-605 CHECKs this invariance every frame)."""
    O = state.obs_frame.shape[0]
    rows = min(rows, O)
    start = torch.clamp(state.n_obs - rows, min=0)
    r = start.long() + torch.arange(rows, device=state.device)
    px, valid = _project_rows(state, state.obs_frame[r], state.obs_point[r], cheirality_eps)
    counted = valid & state.obs_mask[r] & state.obs_err_valid[r]
    fresh = torch.linalg.norm(px - state.obs_px[r], dim=-1)
    stored = torch.linalg.norm(state.obs_err[r], dim=-1)
    d = torch.where(counted, torch.abs(fresh - stored), torch.zeros_like(fresh))
    return torch.max(d)


def clamp_pending(state: MapState, w_min: float = 1e-6) -> torch.Tensor:
    """True iff clean's homogeneous-w clamp will move a usable point."""
    usable = slam_usable(state.point_flags) & state.point_mask
    return torch.any(usable & (state.point_loc[:, 3] < w_min))


# ---------------------------------------------------------------------------
# clean (localmap.cpp:283-398)
# ---------------------------------------------------------------------------

@span("clean")
def clean(state: MapState, error_threshold: float = 5.0, cfg: SlamConfig | None = None):
    """Disable high-error observations, flag degenerate points
    (LocalMap::Clean). Returns (state, all_ok): all_ok iff nothing was
    disabled. Steps: w clamp; BAD_LOCATION for depth < close_point_z;
    worst-first disable with bar max(threshold, maxerr/4) + MISMATCHED;
    BAD_FEATURE on avg ring error; uncertainty <- avg error; re-derive
    evidence flags for changed points."""
    cfg = cfg or SlamConfig()
    pm = state.point_mask
    usable = slam_usable(state.point_flags) & pm

    w = state.point_loc[:, 3]
    wmin = cfg.homogeneous_w_min
    w_fixed = torch.where(torch.abs(w) < wmin, torch.full_like(w, wmin), torch.abs(w))
    loc = torch.where(usable[:, None],
                      torch.cat([state.point_loc[:, :3], w_fixed[:, None]], dim=1),
                      state.point_loc)
    state = state._replace(point_loc=loc)

    ring_rows, ok, age = _ring_slots(state)
    errs2 = state.obs_err[ring_rows.clamp(min=0).long()]
    frames = state.ring_frame
    enabled = ~state.ring_disabled
    errn = torch.linalg.norm(errs2, dim=-1)

    fr = frames.clamp(min=0).long()
    fq = state.frame_quat[fr]
    ft = state.frame_trans[fr]
    pos = state.point_position()[:, None, :]
    z = quat.rotate(fq, pos - ft)[..., 2]
    new_bad_loc = usable & torch.any(ok & (z < cfg.close_point_z), dim=1)

    cand = ok & enabled & (errn > error_threshold) & usable[:, None] & ~new_bad_loc[:, None]
    maxerr = torch.max(torch.where(cand, errn, torch.zeros_like(errn)))
    bar = torch.clamp(maxerr / cfg.clean_maxerr_div, min=error_threshold)
    to_disable = cand & (errn >= bar)
    any_disabled_pt = torch.any(to_disable, dim=1)
    all_ok = ~torch.any(to_disable)
    # ring -> flat disable sync: row o is disabled iff its own ring cell
    # (obs_point[o], obs_slot[o]) names it among the cells to disable
    packed = torch.where(to_disable, ring_rows, torch.full_like(ring_rows, -1))
    named = packed[state.obs_point.clamp(min=0).long(), state.obs_slot.clamp(min=0).long()]
    obs_disabled = state.obs_disabled | (
        named == torch.arange(state.obs_frame.shape[0], device=state.device))
    state = state._replace(obs_disabled=obs_disabled,
                           ring_disabled=state.ring_disabled | to_disable)

    cnt = torch.clamp(state.point_ring_count(), min=1)
    avg = torch.sum(torch.where(ok, errn, torch.zeros_like(errn)), dim=1) / cnt
    new_bad_feat = (usable & (avg > cfg.bad_feature_avg_err)
                    & (state.point_ring_count() > cfg.bad_feature_min_obs))
    unc = torch.where(usable, avg, state.point_uncertainty)

    flags = state.point_flags
    flags = torch.where(new_bad_loc, flags | BAD_LOCATION, flags)
    flags = torch.where(any_disabled_pt, flags | MISMATCHED, flags)
    flags = torch.where(new_bad_feat, flags | BAD_FEATURE, flags)
    changed = new_bad_loc | any_disabled_pt | new_bad_feat
    flags = torch.where(changed, flags | NO_OBSERVATIONS | NO_BASELINE, flags)
    good = ok & enabled & ~to_disable
    flags = _refresh_flags_from(flags, good, ft, age)
    return state._replace(point_flags=flags, point_uncertainty=unc), all_ok


# ---------------------------------------------------------------------------
# epipolar constraint (localmap.cpp:232-276)
# ---------------------------------------------------------------------------

@span("epipolar")
def apply_epipolar_constraint(state: MapState, cfg: SlamConfig | None = None) -> MapState:
    """Gate recent matches on the epipolar constraint: obs1 = newest, obs2 =
    newest enabled earlier observation; skip same-camera pairs; |r| above
    100x the threshold disables obs1 + MISMATCHED when the point has > 8
    observations, else BAD_FEATURE (localmap.cpp:242-274)."""
    cfg = cfg or SlamConfig()
    P, R = state.point_obs.shape
    cnt = state.point_ring_count()
    total = state.point_obs_total
    ring_rows, ok, age = _ring_slots(state)
    enabled = ~state.ring_disabled

    last_age = cnt - 1
    cand2 = ok & enabled & (age < last_age[:, None]) & (age >= 1)
    neg = torch.full_like(age, -1)
    j2 = torch.argmax(torch.where(cand2, age, neg), dim=1)
    has2 = torch.any(cand2, dim=1)
    j1 = torch.argmax(torch.where(ok, age, neg), dim=1)
    row1 = torch.gather(ring_rows, 1, j1[:, None])[:, 0]
    row2 = torch.gather(ring_rows, 1, j2[:, None])[:, 0]
    r1 = row1.clamp(min=0).long()
    r2 = row2.clamp(min=0).long()
    f1 = state.obs_frame[r1].clamp(min=0).long()
    f2 = state.obs_frame[r2].clamp(min=0).long()
    px1 = state.obs_px[r1]
    px2 = state.obs_px[r2]

    cam1 = state.frame_cam[f1].long()
    cam2 = state.frame_cam[f2].long()
    eligible = (state.point_mask & (total >= 2) & feature_usable(state.point_flags)
                & ((state.point_flags & BAD_FEATURE) == 0) & has2 & (cam1 != cam2))
    h1 = proj.pixel_to_plane(px1, state.cam_k[cam1])
    h2 = proj.pixel_to_plane(px2, state.cam_k[cam2])
    r = epi.epipolar_residual_frames(
        state.frame_quat[f1], state.frame_trans[f1],
        state.frame_quat[f2], state.frame_trans[f2], h1, h2,
    )
    hard = eligible & (torch.abs(r) > cfg.epipolar_threshold * cfg.epipolar_hard_mult)
    many = total > cfg.epipolar_mismatch_obs
    disable1 = hard & many
    O = state.obs_frame.shape[0]
    rows = torch.where(disable1, row1, torch.full_like(row1, O))
    obs_disabled = scatter_set(state.obs_disabled, rows, True)
    ring_disabled = state.ring_disabled | (
        disable1[:, None] & (torch.arange(R, device=state.device)[None, :] == j1[:, None]))
    flags = state.point_flags
    flags = torch.where(disable1, flags | MISMATCHED, flags)
    flags = torch.where(hard & ~many, flags | BAD_FEATURE, flags)
    return state._replace(obs_disabled=obs_disabled, ring_disabled=ring_disabled,
                          point_flags=flags)


# ---------------------------------------------------------------------------
# host-side summary (LocalMap::Stats, localmap.cpp:400-483)
# ---------------------------------------------------------------------------

def stats(state: MapState) -> dict:
    """Counts of what the reference prints in Stats() (no histograms)."""
    pm = state.point_mask.cpu().numpy()
    flags = state.point_flags.cpu().numpy()
    n = int(state.n_obs)
    d = {
        "n_frames": int(state.n_frames),
        "n_points": int(pm.sum()),
        "n_obs": n,
        "slam_usable": int((slam_usable(state.point_flags).cpu().numpy() & pm).sum()),
        "no_baseline": int((((flags & NO_BASELINE) != 0) & pm).sum()),
        "no_observations": int((((flags & NO_OBSERVATIONS) != 0) & pm).sum()),
        "bad_location": int((((flags & BAD_LOCATION) != 0) & pm).sum()),
        "bad_feature": int((((flags & BAD_FEATURE) != 0) & pm).sum()),
        "mismatched": int((((flags & MISMATCHED) != 0) & pm).sum()),
        "n_disabled_obs": int((state.obs_disabled & state.obs_mask).sum()),
    }
    nf = int(state.n_frames)
    if nf > 1:
        pos = state.frame_trans[:nf].cpu().numpy()
        d["frame_dist"] = np.linalg.norm(np.diff(pos, axis=0), axis=1).round(1).tolist()
    return d
