"""The full per-frame SLAM step (main.cpp:503-645).

Port of ``slam_robot_tpu/models/pipeline.py``'s ``init``, ``step``,
``polish``, ``maybe_polish`` and ``slam_zero_result``. Per frame: camera ^= 1;
add a frame with the pose init rules (main.cpp:540-552); matcher.track; the
fast (2,5) window BA -> reproject -> clean; the slow (10,20) window on the
first 10 frames and every 5th; the xslow (16,32) tier every 24th; the
epipolar constraint; reproject -> normalize -> reproject with the
invariance canary. With ``motion_model="constant_velocity"`` frames from 2
on start from ``localmap.estimate_motion``; with ``drop_idle_frames`` the
step ends by dropping its newest two frames when they did not move
(``localmap.check_not_moving``).

The JAX package's ``lax.cond``s become Python ``if``s on host reads, whose
count per frame ``device.SYNCS`` records.

The live-loop variants (``step_donated``, ``step_live``, ``step_live_ring``)
and ``checked_step`` are ported too (``pipeline.py:352-433`` of the JAX
package). Their packed telemetry is built on the device and adds no host
read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import KNOBS, default_device, host, span
from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import matcher as matcher_mod
from slam_robot_tpu_torch.models import slam
from slam_robot_tpu_torch.ops import ba
from slam_robot_tpu_torch.utils import numerics, synthetic

I32 = torch.int32
F32 = torch.float32


class PipelineState(NamedTuple):
    map: lm.MapState
    matcher: matcher_mod.MatcherState
    camera: torch.Tensor          # int32: camera of the previous frame
    total_ba_iters: torch.Tensor  # int32 cumulative (slam.h:48)
    last_error: torch.Tensor      # f32 final BA cost (slam.h:49)


def init(cfg: SlamConfig, intrinsics=None, device=None) -> PipelineState:
    """Two cameras with the reference's intrinsics by default, on
    ``device`` (default: the CUDA card, see ``device.default_device``)."""
    device = default_device(device)
    m = lm.empty(cfg, device)
    if intrinsics is None:
        intrinsics = [synthetic.reference_intrinsics(cfg)] * cfg.num_cameras
    for i in range(cfg.num_cameras):
        m = lm.set_camera(m, i, intrinsics[i])
    z = dict(device=device)
    return PipelineState(
        map=m,
        matcher=matcher_mod.init(cfg, device),
        camera=torch.zeros((), dtype=I32, **z),
        total_ba_iters=torch.zeros((), dtype=I32, **z),
        last_error=torch.zeros((), dtype=F32, **z),
    )


def slam_zero_result(m: lm.MapState) -> ba.BAResult:
    dev = m.device
    return ba.BAResult(
        frame_quat=m.frame_quat, frame_trans=m.frame_trans, point_loc=m.point_loc,
        cam_k=m.cam_k, ok=torch.tensor(True, device=dev),
        cost=torch.zeros((), dtype=F32, device=dev),
        iters=torch.zeros((), dtype=I32, device=dev),
        term=torch.tensor(ba.TERM_NOT_RUN, dtype=I32, device=dev),
        cost0=torch.zeros((), dtype=F32, device=dev),
        obs_dropped=torch.zeros((), dtype=I32, device=dev),
    )


def _maintain(m: lm.MapState, cfg: SlamConfig, rw):
    """reproject -> (clamp_pending) -> clean after a window solve."""
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    touched = lm.clamp_pending(m, cfg.homogeneous_w_min)
    m, _ok = lm.clean(m, cfg.error_threshold, cfg)
    return m, touched


@span("slam")
def _slam(m: lm.MapState, frame_idx: int, cfg: SlamConfig):
    """The BA + maintenance half of the step for frames >= 1."""
    rw = cfg.reproject_window or None
    dev = m.device
    m, res_fast = slam.solve_frames(
        m, cfg.solve_fast[0], cfg.solve_fast[1], cfg.ba_range, cfg,
        max_iters=cfg.ba_iters_fast, window_obs=cfg.window_obs_fast,
        max_free_points=cfg.ba_free_points_fast,
        compact_obs=cfg.ba_compact_obs_fast or None,
    )
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    touched = torch.tensor(False, device=dev)
    if host(res_fast.ok):
        touched = lm.clamp_pending(m, cfg.homogeneous_w_min)
        m, _ok = lm.clean(m, cfg.error_threshold, cfg)

    slow_due = frame_idx < cfg.slow_first_n or frame_idx % cfg.slow_every == 0
    if slow_due:
        m, res_slow = slam.solve_frames(
            m, cfg.solve_slow[0], cfg.solve_slow[1], cfg.ba_range, cfg,
            max_iters=cfg.ba_iters_slow, max_free_points=cfg.ba_free_points_slow,
            compact_obs=cfg.ba_compact_obs_slow or None,
        )
        m, touched = _maintain(m, cfg, rw)
    else:
        z = {f: torch.zeros_like(v) if torch.is_tensor(v) else 0
             for f, v in res_fast._asdict().items()}
        res_slow = ba.BAResult(**z)._replace(ok=torch.tensor(True, device=dev))

    polish_due = False
    if cfg.solve_xslow[0]:
        xs, xp = cfg.solve_xslow
        if frame_idx % cfg.xslow_every == 0 and frame_idx > xp:
            m, _res = slam.solve_frames(
                m, xs, xp, cfg.ba_range, cfg, max_iters=cfg.ba_iters_xslow,
                max_free_points=cfg.ba_free_points_slow,
            )
            m, touched = _maintain(m, cfg, rw)
            polish_due = True

    m = lm.apply_epipolar_constraint(m, cfg)

    touched_h = host(touched)
    if touched_h or polish_due:
        m, err1 = lm.reproject(m, cfg.cheirality_eps, window=rw)
    else:
        err1 = lm.mean_obs_error(m, window=rw)
    m = lm.normalize(m)
    if touched_h or slow_due or polish_due:
        m, err2 = lm.reproject(m, cfg.cheirality_eps, window=rw)
    else:
        err2 = lm.mean_obs_error(m, window=rw)
    if cfg.normalize_canary_rows:
        canary = lm.normalize_canary(m, cfg.normalize_canary_rows, cfg.cheirality_eps)
    else:
        canary = torch.zeros((), dtype=F32, device=dev)
    if cfg.drop_idle_frames:
        # the reference declares CheckNotMoving but never calls it
        n0 = m.n_frames
        m = lm.check_not_moving(m, cfg.not_moving_d2)
        KNOBS.add("popped_frames", n0 - m.n_frames)

    # rows of presented frames older than the reproject tail keep stale
    # errors: count them
    O = m.obs_frame.shape[0]
    if rw is not None and rw < O:
        lo = m.n_frames - cfg.solve_slow[1]
        in_presented = m.obs_mask & (m.obs_frame >= lo) & (m.obs_frame < m.n_frames)
        head = torch.arange(O, device=dev) < (m.n_obs - rw)
        repro_dropped = torch.sum((in_presented & head), dtype=I32)
    else:
        repro_dropped = torch.zeros((), dtype=I32, device=dev)
    return m, res_fast, res_slow, err1, err2, repro_dropped, canary


def step(ps: PipelineState, img: torch.Tensor, cfg: SlamConfig, run_slam: bool = True):
    """One full SLAM step. Returns (PipelineState, metrics dict)."""
    camera = ps.camera ^ 1
    m = ps.map
    dev = m.device
    frame_idx = int(host(m.n_frames))

    # pose init (main.cpp:540-552)
    if frame_idx == 0:
        init_q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32, device=dev)
        init_t = torch.zeros(3, dtype=F32, device=dev)
    elif frame_idx == 1:
        init_q = m.frame_quat[0]
        init_t = torch.tensor([cfg.baseline_mm, 0.0, 0.0], dtype=F32, device=dev)
    elif cfg.motion_model == "constant_velocity":
        init_q, init_t = lm.estimate_motion(m, frame_idx)
        if frame_idx >= 4:
            KNOBS.add("constant_velocity", 1)
    else:
        init_q = m.frame_quat[frame_idx - 2]
        init_t = m.frame_trans[frame_idx - 2]
    m, fidx = lm.add_frame(m, camera, init_q, init_t)

    ms, m, track_metrics = matcher_mod.track(ps.matcher, m, img, fidx, camera, cfg)
    metrics = dict(track_metrics)
    metrics["frame_id"] = fidx

    if run_slam and frame_idx >= 1:
        m, res_fast, res_slow, err1, err2, repro_dropped, canary = _slam(m, frame_idx, cfg)
    else:
        res_fast = res_slow = slam_zero_result(m)
        zero = torch.zeros((), dtype=F32, device=dev)
        err1 = err2 = canary = zero
        repro_dropped = torch.zeros((), dtype=I32, device=dev)
    if run_slam:
        total_iters = ps.total_ba_iters + res_fast.iters + res_slow.iters
        last_error = res_fast.cost
    else:
        total_iters = ps.total_ba_iters
        last_error = ps.last_error
    metrics.update(
        fast_obs_dropped=torch.as_tensor(res_fast.obs_dropped, dtype=I32, device=dev),
        slow_obs_dropped=torch.as_tensor(res_slow.obs_dropped, dtype=I32, device=dev),
        reproject_obs_dropped=repro_dropped,
        fast_ok=res_fast.ok, fast_iters=res_fast.iters,
        slow_ok=res_slow.ok, slow_iters=res_slow.iters,
        mean_reproj_err=err2,
        normalize_err_drift=torch.abs(err1 - err2),
        normalize_canary_px=canary,
        ba_cost=res_fast.cost,
        fast_term=res_fast.term, slow_term=res_slow.term,
        fast_cost0=res_fast.cost0, slow_cost0=res_slow.cost0,
        slow_cost=res_slow.cost,
        n_points=m.n_points, n_obs=m.n_obs,
    )
    return (PipelineState(map=m, matcher=ms, camera=camera,
                          total_ba_iters=total_iters, last_error=last_error),
            metrics)


@span("polish")
def polish(ps: PipelineState, cfg: SlamConfig, ns: int = 0):
    """One-time early-trajectory polish (slam.cpp:447-480): free every frame
    except the 0/1 gauge anchor with all evidence so far presented."""
    ns = ns or cfg.polish_solve or (cfg.polish_at - 1)
    rw = cfg.reproject_window or None
    m, res = slam.solve_frames(ps.map, ns, ns + 2, cfg.ba_range, cfg,
                               max_iters=cfg.ba_iters_polish,
                               max_free_points=cfg.ba_free_points_slow)
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    m, _ok = lm.clean(m, cfg.error_threshold, cfg)
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    return ps._replace(map=m, total_ba_iters=ps.total_ba_iters + res.iters), res


def maybe_polish(ps: PipelineState, frame_idx: int, cfg: SlamConfig,
                 run_slam: bool = True) -> PipelineState:
    """Host-loop helper: the polish at ``cfg.polish_at`` and the second one
    at ``cfg.polish2_at`` (0 = disabled)."""
    if run_slam and cfg.polish_at and frame_idx == cfg.polish_at:
        ps, _ = polish(ps, cfg)
    if run_slam and cfg.polish2_at and frame_idx == cfg.polish2_at:
        ps, _ = polish(ps, cfg, ns=cfg.polish2_at - 1)
    return ps


def step_donated(ps: PipelineState, img: torch.Tensor, cfg: SlamConfig,
                 run_slam: bool = True):
    """:func:`step` under the name of the JAX package's donating variant.

    JAX donates the state's buffers to the jitted step so that XLA updates
    them in place; PyTorch has no buffer donation, and ``step`` already
    leaves its input state untouched. Kept for callers written against the
    JAX package's live loop."""
    return step(ps, img, cfg, run_slam)


# packed live-telemetry layout (one f32 row per frame): loop scalars, then
# the safety counters (obs-window truncation guards and the normalize
# canary the reference CHECKs every frame, main.cpp:602-605). Consumers
# index rows by name via LIVE_IDX.
LIVE_SCALARS = (
    "n_matches", "is_keyframe", "mean_reproj_err", "slow_ok",
    "n_points", "n_added", "fast_iters", "slow_iters",
    "fast_obs_dropped", "slow_obs_dropped", "reproject_obs_dropped",
    "normalize_canary_px",
)
LIVE_IDX = {k: i for i, k in enumerate(LIVE_SCALARS)}
LIVE_WIDTH = len(LIVE_SCALARS)


def step_live(ps: PipelineState, img: torch.Tensor, cfg: SlamConfig,
              run_slam: bool = True):
    """:func:`step` returning the state and one packed f32[LIVE_WIDTH] of
    :data:`LIVE_SCALARS`, stacked on the device (no host read)."""
    ps, met = step(ps, img, cfg, run_slam)
    packed = torch.stack([met[k].to(F32) for k in LIVE_SCALARS])
    return ps, packed


def step_live_ring(ps: PipelineState, ring: torch.Tensor, img: torch.Tensor,
                   cfg: SlamConfig, run_slam: bool = True):
    """:func:`step_live` with device-side telemetry batching: ``ring`` is a
    caller-carried f32[k, LIVE_WIDTH] of the last k frames' packed scalars;
    the returned ring drops its oldest row and ends with this frame's. A
    loop reads it on the host once every k frames."""
    ps, packed = step_live(ps, img, cfg, run_slam)
    return ps, torch.cat([ring[1:], packed[None]], dim=0)


def checked_step(ps: PipelineState, img: torch.Tensor, cfg: SlamConfig,
                 run_slam: bool = True):
    """:func:`step` under float guards, the counterpart of checkify's
    ``float_checks``: a NaN produced by any operation inside the step (not
    only in its outputs) and an integer division by zero.

    Returns ``(err, (state, metrics))``; ``err.get()`` is None or a message
    naming the first failing operation, ``err.throw()`` raises it. The
    guard only observes, so state and metrics equal :func:`step`'s."""
    guard = numerics.NanGuard()
    with guard:
        out = step(ps, img, cfg, run_slam)
    return numerics.CheckError(guard), out
