"""The port's matcher knobs (``models/matcher.track`` with
``adaptive_fwd_px``, ``retry_mode="cycle"``, ``clean_duplicates``,
``mid_frame_resolve`` and ``seed_depth_adaptive``) against the JAX package:
one ``track`` per knob, from a JAX state in which the knob fires, carried
across by ``bridge``.

The states come from a JAX run at tests/test_pipeline.CFG (the sequence of
tests/test_torch_pipeline.py); the frame is added with the JAX package's
pose init. Tolerances as the tracking step of tests/test_torch_pipeline.py:
integers and booleans equal, floats atol 1e-4 (the trackers' positions
agree to ~1e-5 px). The mid-frame re-solve moves the newest pose by 20
Gauss-Newton steps, held at 1e-2 mm (tests/test_torch_knobs_slam.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.io import sources
from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import matcher as j_matcher
from slam_robot_tpu.models import pipeline as j_pipe
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.device import KNOBS
from slam_robot_tpu_torch.models import matcher as t_matcher
from tests.test_pipeline import CFG, scaled_intrinsics
from tests.test_torch_config import port_cfg
from tests.test_torch_localmap import assert_state_close

torch.set_num_threads(1)

N_FRAMES = 10  # the state before frame 10 (a slow-window frame, no keyframe)


@pytest.fixture(scope="module")
def before():
    """(JAX PipelineState before frame N_FRAMES, that frame's image)."""
    src = sources.SyntheticSource(CFG, n_frames=N_FRAMES + 1, n_points=400, step_mm=18.0,
                                  yaw_rate=0.06)
    ps = j_pipe.init(CFG, scaled_intrinsics(CFG))
    for i in range(N_FRAMES):
        ps, _ = j_pipe.step(ps, jnp.asarray(src.get(i % 2, i)), CFG)
    return ps, np.asarray(src.get(N_FRAMES % 2, N_FRAMES))


def track_both(ps, img, **knobs):
    """One matcher.track in each package on the frame added to ``ps`` with
    the copy pose rule. Returns ((ms, map, metrics) port, the same JAX)."""
    cfg = dataclasses.replace(CFG, **knobs)
    n = int(ps.map.n_frames)
    cam = ps.camera ^ 1
    m, fidx = j_lm.add_frame(ps.map, cam, ps.map.frame_quat[n - 2], ps.map.frame_trans[n - 2])
    want = j_matcher.track(ps.matcher, m, jnp.asarray(img), fidx, cam, cfg)
    KNOBS.reset()
    got = t_matcher.track(bridge.from_numpy(ps.matcher, "cpu"), bridge.from_numpy(m, "cpu"),
                          torch.as_tensor(np.array(img)), int(fidx), int(cam), port_cfg(cfg))
    return got, want


def check_track(got, want, atol_px=1e-4):
    """matched, to_px and every metric; feat_fail, feat_sharp and the rest
    of the matcher state; the map's obs, ring and flag fields."""
    (gms, gm, gmet), (wms, wm, wmet) = got, want
    assert set(gmet) == set(wmet)
    for k, w in wmet.items():
        g, w = gmet[k].numpy(), np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5, err_msg=k)
    assert_state_close(gms, wms, atol=1e-4, atol_px=1e-4)
    assert_state_close(gm, wm, atol=1e-4, atol_px=atol_px)


def test_adaptive_first_attempt_matches(before):
    """Every live lane sharp: the confident ones make their first attempt
    at one level both ways (budgets 1 mixed with 3 and 6 in one sweep)."""
    ps, img = before
    ps = ps._replace(matcher=ps.matcher._replace(feat_sharp=ps.matcher.feat_point >= 0))
    got, want = track_both(ps, img, adaptive_fwd_px=1.0)
    assert KNOBS.read()["sharp_first_lanes"] > 10
    check_track(got, want)
    assert int(np.asarray(want[0].feat_sharp).sum()) > 0


def test_cycle_retries_match(before):
    ps, img = before
    assert int((np.asarray(ps.matcher.feat_fail) > 0).sum()) > 0
    got, want = track_both(ps, img, retry_mode="cycle")
    fired = KNOBS.read()
    assert fired["cycle_sweeps"] == CFG.retry_sweeps and fired.get("escalations", 0) == 1
    check_track(got, want)


def test_clean_duplicates_matches(before):
    """Lane j a copy of lane i (stored matches, caches, point location): the
    pair lands in one cell, j is cleaned and its point mismatched, i keeps
    its match."""
    ps, img = before
    ms, m = ps.matcher, ps.map
    fp = np.asarray(ms.feat_point)
    live = np.nonzero((fp >= 0) & (np.asarray(ms.feat_fail) == 0))[0]
    i, j = int(live[0]), int(live[-1])
    copy = {f: getattr(ms, f).at[j].set(getattr(ms, f)[i])
            for f in ("feat_px", "feat_valid", "feat_refpack", "feat_refwin", "feat_reforg",
                      "feat_fail", "feat_sharp")}
    pi, pj = int(fp[i]), int(fp[j])
    m = m._replace(**{f: getattr(m, f).at[pj].set(getattr(m, f)[pi])
                      for f in ("point_loc", "point_uncertainty")})
    ps = ps._replace(matcher=ms._replace(**copy), map=m)
    got, want = track_both(ps, img, clean_duplicates=True)
    assert KNOBS.read()["duplicates"] >= 1
    check_track(got, want)
    matched = got[2]["feat_matched"].numpy()
    flags = got[1].point_flags.numpy()
    assert matched[i] and not matched[j]
    assert flags[pj] & j_lm.MISMATCHED and not flags[pi] & j_lm.MISMATCHED


def test_mid_frame_resolve_matches(before):
    """min_matches 40 (above this sequence's ~20 matches): the re-solve
    fires, moves the pose and re-finds the unmatched lanes."""
    ps, img = before
    got, want = track_both(ps, img, mid_frame_resolve=True, min_matches=40)
    assert bool(got[2]["resolve_fired"]) and bool(want[2]["resolve_fired"])
    check_track(got, want, atol_px=1e-2)


def test_adaptive_seed_depth_matches(before):
    """A keyframe (min_matches 40) seeded at the median depth of the map's
    confident points."""
    ps, img = before
    got, want = track_both(ps, img, seed_depth_adaptive=True, min_matches=40)
    assert KNOBS.read()["adaptive_seeds"] == 1 and int(got[2]["n_added"]) > 0
    check_track(got, want)
