"""``profile_step``'s stages and ``profile_scan``'s accuracy figures against
the JAX package, on one JAX map carried across by ``bridge`` (a
``utils/synthetic.build_scene`` problem at tests/test_pipeline.CFG, 20
frames, noisy initial values).

- Each BA and maintenance stage of ``profile_step.stages`` returns what the
  JAX call of the original's closure returns (``tools/profile_step.py:
  96-125``), with the tolerances of the stage tests: BA fast and slow
  costs rtol 1e-3 (tests/test_torch_ba.py, a full solve), reproject's mean
  error rtol 1e-4, clean's and epipolar's ``n_obs`` equal, normalize's
  ``frame_trans`` 1e-3 mm (tests/test_torch_localmap.py).
- ``profile_scan.scan_stats`` equals the original's formulas
  (``tools/profile_scan.py:77-104``, with the JAX package's
  ``utils/dump.ate_aligned``) on the same map and per-frame metrics, within
  1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu.utils import benchscene as j_scene
from slam_robot_tpu.utils import dump as j_dump
from slam_robot_tpu.utils import synthetic
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.tools import profile_scan, profile_step
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def maps():
    sc = synthetic.build_scene(CFG, n_frames=20, n_points=200, seed=3, pixel_noise=0.3,
                               pose_noise=0.002, point_noise=10.0)
    js, _ = j_lm.reproject(sc.state)
    return js, bridge.from_numpy(js, "cpu")


@pytest.fixture(scope="module")
def stages(maps):
    _, ts = maps
    ps = t_pipe.init(TCFG, device="cpu")._replace(map=ts)
    img = torch.zeros((CFG.image_height, CFG.image_width))
    return {label: fn for label, fn, _ in profile_step.stages(ps, img, TCFG)}


def test_stages_are_the_originals_in_order(stages):
    assert tuple(stages) == profile_step.STAGES


@pytest.mark.parametrize("label, window", [("BA fast (2,5)", "fast"), ("BA slow (10,20)", "slow")])
def test_ba_stage_cost_matches_jax(maps, stages, label, window):
    js, _ = maps
    c = CFG
    if window == "fast":
        want = j_slam.solve_frames(js, c.solve_fast[0], c.solve_fast[1], c.ba_range, c,
                                   max_iters=c.ba_iters_fast, window_obs=c.window_obs_fast)[1]
    else:
        want = j_slam.solve_frames(js, c.solve_slow[0], c.solve_slow[1], c.ba_range, c,
                                   max_iters=c.ba_iters_slow)[1]
    got = stages[label]()
    np.testing.assert_allclose(float(got), float(want.cost), rtol=1e-3)
    assert float(want.cost) < float(want.cost0)


def test_maintenance_stages_match_jax(maps, stages):
    js, _ = maps
    rw = CFG.reproject_window or None
    np.testing.assert_allclose(float(stages["reproject"]()),
                               float(j_lm.reproject(js, CFG.cheirality_eps, window=rw)[1]),
                               rtol=1e-4)
    assert int(stages["clean"]()) == int(j_lm.clean(js, CFG.error_threshold, CFG)[0].n_obs)
    assert int(stages["epipolar"]()) == int(j_lm.apply_epipolar_constraint(js, CFG).n_obs)
    np.testing.assert_allclose(stages["normalize"]().numpy(),
                               np.asarray(j_lm.normalize(js).frame_trans), atol=1e-3, rtol=1e-5)


def _jax_stats(m, nm, kf, fit, sit) -> dict:
    """tools/profile_scan.py:77-104 on the JAX map."""
    no = int(m.n_obs)
    errn = np.linalg.norm(np.asarray(m.obs_err[:no]), axis=1)
    dis = np.asarray(m.obs_disabled[:no])
    median_err = float(np.median(errn[~dis])) if (~dis).any() else 0.0
    nf = int(m.n_frames)
    true_t = np.stack([j_scene.sweep_pose(i)[1] for i in range(nf)])
    est_t = np.asarray(m.frame_trans[:nf])
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    return {
        "median_enabled_err_px": round(median_err, 3),
        "ate_mm": round(ate, 1),
        "ate_pct_of_path": round(100.0 * ate / max(path, 1e-9), 2),
        "ate_pct_aligned": round(100.0 * j_dump.ate_aligned(est_t, true_t) / max(path, 1e-9), 2),
        "n_points": int(m.n_points),
        "mean_matches": round(float(np.asarray(nm).mean()), 1),
        "keyframes_in_scan": int(np.asarray(kf).sum()),
        "mean_fast_iters": round(float(np.asarray(fit).mean()), 1),
        "mean_slow_iters": round(float(np.asarray(sit).mean()), 1),
    }


def test_scan_stats_match_the_original_formulas(maps):
    js, ts = maps
    rng = np.random.default_rng(7)
    per_frame = [rng.integers(0, 96, 16).astype(np.int32), rng.random(16) < 0.2,
                 rng.integers(1, 21, 16).astype(np.int32), rng.integers(0, 31, 16).astype(np.int32)]
    want = _jax_stats(js, *(jnp.asarray(a) for a in per_frame))
    got = profile_scan.scan_stats(ts, *(torch.as_tensor(a) for a in per_frame))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    assert want["keyframes_in_scan"] > 0 and want["ate_mm"] > 0
