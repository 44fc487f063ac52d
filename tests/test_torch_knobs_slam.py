"""The port's mid-frame pose re-solve (``models/slam``:
``solve_frame_pose_epipolar`` and the reference's no-op
``solve_frame_pose``) against the JAX package on a JAX-made state carried
across by ``bridge``.

The re-solve runs 20 Gauss-Newton steps in float32 from the same start;
the packages sum the 5x5 normal equations in another order, so the newest
pose is held at atol 1e-4 on the quaternion and 1e-2 mm on the translation
(a ~150 mm stride); every other field equal or as tests/test_torch_localmap.py.

Last, one full ``pipeline.step`` with all seven of the step's off-by-default
knobs on, held as tests/test_torch_pipeline.py holds a full step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.io import sources
from slam_robot_tpu.models import pipeline as j_pipe
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu.ops import quaternion as j_quat
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.device import KNOBS
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.models import slam as t_slam
from tests import test_pipeline
from tests.test_torch_config import port_cfg
from tests.test_torch_localmap import CFG, assert_state_close, scene
from tests.test_torch_pipeline import check_full_step

torch.set_num_threads(1)


def _perturbed(seed, n_frames=8):
    """A scene whose newest pose is off its truth by a small rotation and
    ~5 mm."""
    js = scene(seed=seed, n_frames=n_frames)
    rng = np.random.default_rng(seed)
    n = int(js.n_frames) - 1
    dq = j_quat.exp_map(jnp.asarray(rng.normal(scale=0.01, size=3).astype(np.float32)))
    q = j_quat.normalize(j_quat.multiply(dq, js.frame_quat[n]))
    t = js.frame_trans[n] + jnp.asarray(rng.normal(scale=3.0, size=3).astype(np.float32))
    return js._replace(frame_quat=js.frame_quat.at[n].set(q),
                       frame_trans=js.frame_trans.at[n].set(t))


@pytest.mark.parametrize("seed", [0, 5])
def test_epipolar_resolve_matches(seed):
    js = _perturbed(seed)
    want, wok = j_slam.solve_frame_pose_epipolar(js, CFG)
    got, gok = t_slam.solve_frame_pose_epipolar(bridge.from_numpy(js, "cpu"))
    assert bool(gok) and bool(wok) and gok.dim() == 0
    n = int(js.n_frames) - 1
    # the newest pose moved, and to where the JAX package moved it
    assert float(np.abs(np.asarray(want.frame_trans[n] - js.frame_trans[n])).max()) > 0.1
    np.testing.assert_allclose(got.frame_quat.numpy(), np.asarray(want.frame_quat), atol=1e-4)
    np.testing.assert_allclose(got.frame_trans.numpy(), np.asarray(want.frame_trans), atol=1e-2)
    assert_state_close(got, want, skip={"frame_quat", "frame_trans"})


def test_epipolar_resolve_needs_eight_shared_points():
    """Seven points seen by both newest frames: ok is false and the state is
    returned as it came."""
    js = scene(seed=6, n_frames=8, n_points=7)
    ts = bridge.from_numpy(js, "cpu")
    want, wok = j_slam.solve_frame_pose_epipolar(js, CFG)
    got, gok = t_slam.solve_frame_pose_epipolar(ts)
    assert not bool(gok) and not bool(wok)
    assert_state_close(got, want, atol=0.0, atol_px=0.0)
    assert_state_close(got, js, atol=0.0, atol_px=0.0)


def test_solve_frame_pose_is_the_reference_no_op():
    js = scene(seed=0)
    ts = bridge.from_numpy(js, "cpu")
    got, ok = t_slam.solve_frame_pose(ts)
    assert got is ts and ok is False
    assert j_slam.solve_frame_pose(js)[1] is False


ALL_KNOBS = dict(mid_frame_resolve=True, motion_model="constant_velocity", retry_mode="cycle",
                 adaptive_fwd_px=1.0, seed_depth_adaptive=True, drop_idle_frames=True,
                 clean_duplicates=True)


def test_full_step_with_all_seven_knobs_matches():
    """min_matches 24 at tests/test_pipeline.CFG: frame 1 is a keyframe on
    which the mid-frame re-solve fires; from frame 4 the pose starts from
    the constant-velocity prediction and sharp lanes make their first
    attempt at one level. (The cycle's retries and the adaptive seed depth
    fire in tests/test_torch_knobs_matcher.py.)"""
    cfg = dataclasses.replace(test_pipeline.CFG, min_matches=24, **ALL_KNOBS)
    src = sources.SyntheticSource(cfg, n_frames=6, n_points=400, step_mm=18.0, yaw_rate=0.06)
    ps = j_pipe.init(cfg, test_pipeline.scaled_intrinsics(cfg))
    for i in range(6):
        img = np.asarray(src.get(i % 2, i))
        nxt, met = j_pipe.step(ps, jnp.asarray(img), cfg)
        if i in (1, 5):
            KNOBS.reset()
            got_ps, got_m = t_pipe.step(bridge.from_numpy(ps, "cpu"),
                                        torch.as_tensor(np.array(img)), port_cfg(cfg))
            check_full_step(got_ps, got_m, nxt, met)
            fired = KNOBS.read()
            if i == 1:
                assert bool(got_m["resolve_fired"]) and bool(got_m["is_keyframe"])
            else:
                assert fired["constant_velocity"] == 1 and fired["sharp_first_lanes"] > 10
        ps = nxt
