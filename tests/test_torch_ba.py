"""The port's windowed bundle adjustment (``ops/ba.solve`` via
``models/slam.solve_frames``) against the JAX package on a
``utils/synthetic.build_scene`` problem with noisy initial values.

The LM steps solve the same normal equations with block sums and a dense
solve taken in another order, so the two packages drift apart by float32
rounding as iterations accumulate:

- over the first 5 iterations, iteration count and termination code are
  equal, poses agree to 1e-3 mm / 1e-6 and points to rtol 1e-5;
- a full solve ends with the same termination code and ok flag, the cost
  at rtol 1e-3, poses at 0.05 mm / 1e-5, 95 % of point coordinates at
  rtol 1e-3 and all at rtol 5e-3 (a point seen over a short baseline
  drifts along its weakly observed ray, at no cost either side). Its
  iteration count may differ by a few: the ftol exit compares a relative
  cost change of ~1e-6, at float32 resolution, and the stall exit counts
  rejected steps whose accept test sits on the same edge.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu.ops import ba as j_ba
from slam_robot_tpu.utils import synthetic
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import slam as t_slam
from slam_robot_tpu_torch.ops import ba as t_ba
from slam_robot_tpu_torch.utils import dump as t_dump

torch.set_num_threads(1)

CFG = SlamConfig(max_frames=16, max_points=96, max_obs=2048, max_obs_per_point=16)


def problem(seed):
    sc = synthetic.build_scene(CFG, n_frames=8, n_points=60, seed=seed, pixel_noise=0.3,
                               pose_noise=0.002, point_noise=10.0)
    return sc.state, bridge.from_numpy(sc.state, "cpu")


CASES = {
    "fast_marquardt_compact": dict(policy="marquardt", window=(2, 5), iters=20,
                                   free_points=48, compact=256, window_obs=512),
    "slow_classic": dict(policy="classic", window=(6, 8), iters=30,
                         free_points=None, compact=None, window_obs=None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("full", [False, True])
def test_solve_frames_matches(case, full):
    c = CASES[case]
    cfg = dataclasses.replace(CFG, lm_policy=c["policy"])
    js, ts = problem(seed=len(case))
    kw = dict(max_iters=c["iters"] if full else 5, max_free_points=c["free_points"],
              compact_obs=c["compact"], window_obs=c["window_obs"])
    jn, jr = j_slam.solve_frames(js, *c["window"], 2.0, cfg, **kw)
    tn, tr = t_slam.solve_frames(ts, *c["window"], 2.0, cfg, **kw)
    assert bool(jr.ok) and bool(tr.ok)
    assert int(tr.term) == int(jr.term)
    assert int(tr.obs_dropped) == int(jr.obs_dropped)
    np.testing.assert_allclose(float(tr.cost0), float(jr.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3 if full else 1e-5)
    assert float(jr.cost) < 0.5 * float(jr.cost0)  # the solve did real work
    if full:
        assert abs(int(tr.iters) - int(jr.iters)) <= 5
        tol_t, tol_q, rtol_p, rtol_max = 5e-2, 1e-5, 1e-3, 5e-3
    else:
        assert int(tr.iters) == int(jr.iters) == 5
        tol_t, tol_q, rtol_p, rtol_max = 1e-3, 1e-6, 1e-5, 1e-5
    np.testing.assert_allclose(tn.frame_trans.numpy(), np.asarray(jn.frame_trans), atol=tol_t)
    np.testing.assert_allclose(tn.frame_quat.numpy(), np.asarray(jn.frame_quat), atol=tol_q)
    want_p = np.asarray(jn.point_loc)
    rel = np.abs(tn.point_loc.numpy() - want_p) / np.maximum(np.abs(want_p), 1.0)
    assert np.quantile(rel, 0.95) <= rtol_p and rel.max() <= rtol_max, (rel.max(),)


def test_inv4x4_matches():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 4, 4)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(4, dtype=np.float32)
    got = t_ba.inv4x4(torch.as_tensor(m)).numpy()
    want = np.asarray(j_ba.inv4x4(m))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got @ m, np.broadcast_to(np.eye(4), m.shape), atol=1e-3)


def test_unsolvable_window_is_not_run():
    js, ts = problem(seed=9)
    # present only one frame: fewer than two usable frames aborts the solve
    jn, jr = j_slam.solve_frames(js, 1, 1, 2.0, CFG)
    tn, tr = t_slam.solve_frames(ts, 1, 1, 2.0, CFG)
    assert not bool(jr.ok) and not bool(tr.ok)
    assert int(tr.term) == int(jr.term) == t_ba.TERM_NOT_RUN
    assert int(tr.iters) == int(jr.iters) == 0
    np.testing.assert_array_equal(tn.frame_trans.numpy(), np.asarray(jn.frame_trans))


@pytest.mark.parametrize("iters", [3, 50])
@pytest.mark.parametrize("solve_cameras", [False, True])
def test_solve_all_frames_matches(solve_cameras, iters):
    """Every frame free; with ``solve_cameras`` the intrinsics too, from a
    k1 that is 0.08 off (as tests/test_ba.py's camera test).

    After 3 iterations: cost rtol 1e-3, k1..k3 atol 1e-4, fx, fy, cx, cy
    atol 0.01 px (measured 2e-4 relative, 3e-5, 1e-4 px). To the
    50-iteration cap, the camera solve crawls along the weakly determined
    k1..k3-vs-points direction in both packages, float32 rounding apart:
    cost rtol 5e-3 (0.25 % measured), k1..k3 atol 2e-3 (1.3e-3 measured),
    fx, fy, cx, cy atol 0.05 px. Positions 0.05 mm after a Sim(3) fit, as
    every frame is free and so is the 7-dof gauge."""
    cfg = dataclasses.replace(CFG, ba_max_iters=iters)
    sc = synthetic.build_scene(CFG, n_frames=8, n_points=40, seed=5)
    js = sc.state._replace(cam_k=sc.state.cam_k.at[:, 0].add(0.08))
    ts = bridge.from_numpy(js, "cpu")
    jn, jr = j_slam.solve_all_frames(js, 2.0, solve_cameras=solve_cameras, cfg=cfg)
    tn, tr = t_slam.solve_all_frames(ts, 2.0, solve_cameras=solve_cameras, cfg=cfg)
    assert bool(jr.ok) and bool(tr.ok)
    assert int(tr.term) == int(jr.term)
    assert abs(int(tr.iters) - int(jr.iters)) <= (0 if iters == 3 else 5)
    np.testing.assert_allclose(float(tr.cost0), float(jr.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost),
                               rtol=1e-3 if iters == 3 else 5e-3)
    assert float(jr.cost) < 0.5 * float(jr.cost0)
    got_k, want_k = tn.cam_k.numpy(), np.asarray(jn.cam_k)
    if not solve_cameras:
        np.testing.assert_array_equal(got_k, np.asarray(js.cam_k))
    elif iters == 50:
        assert abs(float(want_k[0, 0])) < 0.75 * 0.08  # the solve moved k1
    np.testing.assert_allclose(got_k[:, :3], want_k[:, :3], atol=1e-4 if iters == 3 else 2e-3)
    np.testing.assert_allclose(got_k[:, 3:], want_k[:, 3:], atol=1e-2 if iters == 3 else 5e-2)
    got_t, want_t = tn.frame_trans.numpy()[:8], np.asarray(jn.frame_trans)[:8]
    s, R, t = t_dump.align_umeyama(got_t, want_t)
    np.testing.assert_allclose(s * got_t @ R.T + t, want_t, atol=5e-2)
