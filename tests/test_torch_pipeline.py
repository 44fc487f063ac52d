"""The port's full SLAM step (``models/pipeline``) against the JAX package,
one step at a time on the same bridged state, plus a closed loop through
the port alone.

Keyframe cadence and BA exits are chaotic in float32 order (PERF_TPU.md
findings 15, 26, 32), so the packages are never compared by one closed-loop
draw. A JAX run at tests/test_pipeline.CFG supplies the state before each
frame; the port then takes one step from that state.

Tolerances:
- tracking (``run_slam=False``): every field of both states and every
  metric; integers and booleans equal, floats atol 1e-4 (the trackers'
  positions agree to ~1e-5 px; pyramids to 1e-6).
- full step: everything tracking decides as above. What BA decides is
  held looser: each LM solve stops at an ftol/stall exit that compares a
  float32 relative cost change of ~1e-6, so the two packages leave the
  loop a few iterations apart along near-flat directions (measured on this
  sequence: costs agree to ~1e-5 relative, poses to < 1 mm of a ~200 mm
  path). Poses atol 1 mm / 1e-4, the first BA cost rtol 1e-4, and at most
  1 % of point flags / disabled rows may differ (a clean threshold
  decision on an error within float32 of 5 px).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.config import REFERENCE_EXACT_KW
from slam_robot_tpu.io import sources
from slam_robot_tpu.models import pipeline as j_pipe
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.device import SYNCS
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.ops.cuda import blur as t_blur
from tests.test_pipeline import CFG, scaled_intrinsics
from tests.test_torch_localmap import assert_state_close

torch.set_num_threads(1)

N_FRAMES = 12
KEYFRAME = 9   # the sequence's first keyframe after frame 0
SLOW = 10      # a slow-window (10,20) frame (10 % slow_every == 0)

BA_DECIDED = {"frame_quat", "frame_trans", "point_loc", "point_uncertainty",
              "point_flags", "obs_err", "obs_err_valid", "obs_disabled",
              "ring_disabled", "total_ba_iters", "last_error"}
BA_METRICS = {"fast_iters", "slow_iters", "fast_term", "slow_term", "ba_cost",
              "slow_cost", "slow_cost0", "mean_reproj_err", "normalize_err_drift",
              "normalize_canary_px"}


@pytest.fixture(scope="module")
def jax_run():
    src = sources.SyntheticSource(CFG, n_frames=N_FRAMES, n_points=400, step_mm=18.0,
                                  yaw_rate=0.06)
    frames = [np.asarray(src.get(i % 2, i)) for i in range(N_FRAMES)]
    ps = j_pipe.init(CFG, scaled_intrinsics(CFG))
    states, mets = [ps], []
    for img in frames:
        ps, m = j_pipe.step(ps, jnp.asarray(img), CFG)
        states.append(ps)
        mets.append(m)
    assert bool(mets[KEYFRAME]["is_keyframe"]) and not bool(mets[SLOW]["is_keyframe"])
    return frames, states, mets


def compare_metrics(got, want, skip=()):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in skip:
            continue
        g, w = got[k].numpy(), np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("frame", [KEYFRAME, SLOW])
def test_tracking_step_matches(jax_run, frame):
    frames, states, _ = jax_run
    img = frames[frame]
    want_ps, want_m = j_pipe.step(states[frame], jnp.asarray(img), CFG, run_slam=False)
    got_ps, got_m = t_pipe.step(bridge.from_numpy(states[frame], "cpu"),
                                torch.as_tensor(np.array(img)), CFG, run_slam=False)
    assert bool(got_m["is_keyframe"]) == (frame == KEYFRAME)
    compare_metrics(got_m, want_m)
    assert_state_close(got_ps, want_ps, atol=1e-4, atol_px=1e-4)


def test_first_keyframe_with_compacted_refresh_matches(jax_run):
    """Frame 0 (a keyframe) with more lane slots than the keyframe refresh
    needs (max_features 192 > 128 = min_matches + max_corners + 32 rounded
    up to 64), so only the stored lanes' caches are rebuilt, as at the
    default config's 256 slots."""
    cfg = dataclasses.replace(CFG, max_features=192)
    img = jax_run[0][0]
    want_ps, want_m = j_pipe.step(j_pipe.init(cfg, scaled_intrinsics(cfg)),
                                  jnp.asarray(img), cfg, run_slam=False)
    got_ps, got_m = t_pipe.step(t_pipe.init(cfg, scaled_intrinsics(cfg)),
                                torch.as_tensor(np.array(img)), cfg, run_slam=False)
    assert bool(got_m["is_keyframe"]) and int(got_m["n_added"]) > 5
    compare_metrics(got_m, want_m)
    assert_state_close(got_ps, want_ps, atol=1e-4, atol_px=1e-4)


def check_full_step(got_ps, got_m, want_ps, want_m):
    """A full step's results against the JAX package's: tracking-decided
    fields as tight as the tracking-only step, BA-decided ones looser."""
    compare_metrics(got_m, want_m, skip=BA_METRICS)
    assert int(got_m["fast_obs_dropped"]) == int(want_m["fast_obs_dropped"]) == 0
    np.testing.assert_allclose(float(got_m["fast_cost0"]), float(want_m["fast_cost0"]),
                               rtol=1e-4)
    assert float(got_m["normalize_canary_px"]) < 0.1
    # tracking-decided fields: as tight as the tracking-only step
    assert_state_close(got_ps, want_ps, atol=1e-4, atol_px=1e-4, skip=BA_DECIDED)
    gm, wm = got_ps.map, want_ps.map
    np.testing.assert_allclose(gm.frame_trans.numpy(), np.asarray(wm.frame_trans), atol=1.0)
    np.testing.assert_allclose(gm.frame_quat.numpy(), np.asarray(wm.frame_quat), atol=1e-4)
    for f in ("point_flags", "obs_disabled", "ring_disabled", "obs_err_valid"):
        g, w = getattr(gm, f).numpy(), np.asarray(getattr(wm, f))
        assert (g != w).mean() <= 0.01, f


@pytest.mark.parametrize("frame", [KEYFRAME, SLOW])
def test_full_step_matches(jax_run, frame):
    frames, states, mets = jax_run
    got_ps, got_m = t_pipe.step(bridge.from_numpy(states[frame], "cpu"),
                                torch.as_tensor(np.array(frames[frame])), CFG)
    check_full_step(got_ps, got_m, states[frame + 1], mets[frame])


def test_reference_exact_config_matches(jax_run):
    """REFERENCE_EXACT_KW (no backoff or give-up, backward refs and windows
    re-extracted, classic LM, no polish or xslow tier): full steps at a
    fast-window frame and a slow-window frame."""
    cfg = dataclasses.replace(CFG, **REFERENCE_EXACT_KW)
    frames = jax_run[0]
    ps = j_pipe.init(cfg, scaled_intrinsics(cfg))
    for i in range(SLOW + 1):
        ps_next, m = j_pipe.step(ps, jnp.asarray(frames[i]), cfg)
        if i in (SLOW - 3, SLOW):
            got_ps, got_m = t_pipe.step(bridge.from_numpy(ps, "cpu"),
                                        torch.as_tensor(np.array(frames[i])), cfg)
            check_full_step(got_ps, got_m, ps_next, m)
        ps = ps_next


def test_polish_matches(jax_run):
    """The one-time polish as it runs at ``polish_at``: every frame but the
    0/1 gauge anchor free (here 10 of 12), on the state after the last
    frame; BA-decided tolerances as the full step's. The state is already
    near its optimum (cost ~1), so which LM exit fires first (ftol or
    stall) is not compared, as the full step does not compare it."""
    _, states, _ = jax_run
    ns = N_FRAMES - 2
    want_ps, want_res = j_pipe.polish(states[N_FRAMES], CFG, ns=ns)
    got_ps, got_res = t_pipe.polish(bridge.from_numpy(states[N_FRAMES], "cpu"), CFG, ns=ns)
    assert bool(got_res.ok) and bool(want_res.ok)
    np.testing.assert_allclose(float(got_res.cost0), float(want_res.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(got_res.cost), float(want_res.cost), rtol=1e-3)
    assert_state_close(got_ps, want_ps, atol=1e-4, atol_px=1e-4, skip=BA_DECIDED)
    gm, wm = got_ps.map, want_ps.map
    np.testing.assert_allclose(gm.frame_trans.numpy(), np.asarray(wm.frame_trans), atol=1.0)
    np.testing.assert_allclose(gm.frame_quat.numpy(), np.asarray(wm.frame_quat), atol=1e-4)
    for f in ("point_flags", "obs_disabled", "ring_disabled", "obs_err_valid"):
        g, w = getattr(gm, f).numpy(), np.asarray(getattr(wm, f))
        assert (g != w).mean() <= 0.01, f


def test_closed_loop_runs_and_converges():
    """The bars of tests/test_pipeline.test_full_loop_runs_and_converges,
    through the port alone."""
    src = sources.SyntheticSource(CFG, n_frames=10, n_points=400, step_mm=10.0)
    ps = t_pipe.init(CFG, scaled_intrinsics(CFG))
    hist = []
    launches = t_blur.KERNEL.launches
    syncs = SYNCS.n
    for i in range(10):
        ps, m = t_pipe.step(ps, torch.as_tensor(np.array(src.get(i % 2, i))), CFG)
        ps = t_pipe.maybe_polish(ps, i, CFG)
        hist.append({k: v.item() for k, v in m.items() if v.dim() == 0})
    assert hist[0]["is_keyframe"] and hist[0]["n_added"] > 5
    assert all(h["n_matches"] > 5 for h in hist[1:])
    assert np.median([h["mean_reproj_err"] for h in hist[2:]]) < 1.0
    assert all(h["normalize_err_drift"] < 0.1 for h in hist[1:])
    assert all(h["normalize_canary_px"] < 0.1 for h in hist)
    assert max(h["fast_iters"] for h in hist[2:]) <= CFG.ba_max_iters
    t = ps.map.frame_trans[:10].numpy()
    np.testing.assert_allclose(t[0], np.zeros(3), atol=1.0)
    assert 75.0 < np.linalg.norm(t[1] - t[0]) < 300.0
    assert t[-1][2] > t[0][2]
    # the CPU path never touches the CUDA kernels' counters
    assert t_blur.KERNEL.launches == launches
    assert SYNCS.n > syncs


def test_pipeline_state_bridge_round_trip(jax_run):
    _, states, _ = jax_run
    js = states[4]
    back = bridge.to_numpy(bridge.from_numpy(js, "cpu"))
    for sub in ("map", "matcher"):
        for f in getattr(js, sub)._fields:
            a = np.asarray(getattr(getattr(js, sub), f))
            b = getattr(getattr(back, sub), f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, f)
    for f in ("camera", "total_ba_iters", "last_error"):
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(back, f)), f


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "import slam_robot_tpu_torch, slam_robot_tpu_torch.bridge\n"
        "import slam_robot_tpu_torch.models.pipeline, slam_robot_tpu_torch.utils.benchscene\n"
        "import slam_robot_tpu_torch.utils.dump, slam_robot_tpu_torch.ops.cuda.build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
