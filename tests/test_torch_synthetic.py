"""The port's ``utils/synthetic`` against the JAX package's: the same seed
gives the same scene.

Both packages make the same numpy draws in the same order, so every integer
array is equal and every float array agrees to float32 rounding: rtol 1e-5
per element, with an absolute floor of 1e-5 of the array's largest
magnitude for entries that are zero in one package and a rounding residue
in the other (a rotated baseline's y component, a quaternion's x).
"""

import numpy as np
import pytest

from slam_robot_tpu.config import SlamConfig as JCfg
from slam_robot_tpu.utils import synthetic as j_syn
from slam_robot_tpu_torch.config import SlamConfig as TCfg
from slam_robot_tpu_torch.utils import synthetic as t_syn

SIZES = dict(max_frames=16, max_points=64, max_obs=2048, max_obs_per_point=16)


def assert_same(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind == "f":
        floor = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor, err_msg=name)
    else:
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


NOISE = {
    "exact": dict(),
    "noisy": dict(pixel_noise=0.3, pose_noise=0.002, point_noise=10.0),
}


@pytest.mark.parametrize("noise", sorted(NOISE))
def test_build_scene_matches(noise):
    kw = dict(n_frames=8, n_points=40, seed=3, **NOISE[noise])
    js = j_syn.build_scene(JCfg(**SIZES), **kw)
    ts = t_syn.build_scene(TCfg(**SIZES), device="cpu", **kw)
    for field in js.state._fields:
        assert_same(field, getattr(ts.state, field).numpy(), getattr(js.state, field))
    for field in ("true_quat", "true_trans", "true_points"):
        assert_same(field, getattr(ts, field).numpy(), getattr(js, field))
    assert int(ts.state.n_obs) > 200  # the scene is observed


def test_build_large_problem_matches():
    jp = j_syn.build_large_problem(200, 5000, 60)
    tp = t_syn.build_large_problem(200, 5000, 60, device="cpu")
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert_same(key, tp[key].numpy(), jp[key])
    assert 0.3 < float(np.mean(np.asarray(jp["obs_ok"]))) < 0.9


def test_trajectory_and_points_match():
    jq, jt = j_syn.make_trajectory(7, JCfg())
    tq, tt = t_syn.make_trajectory(7, TCfg(), device="cpu")
    assert_same("quat", tq.numpy(), jq)
    assert_same("trans", tt.numpy(), jt)
    assert_same("points", t_syn.make_points(30, np.random.default_rng(1), device="cpu").numpy(),
                j_syn.make_points(30, np.random.default_rng(1)))
