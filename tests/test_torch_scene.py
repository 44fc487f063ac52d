"""Scene generation and evaluation helpers of the port against the JAX
package: intrinsics, the bench sweep's poses, the renderer, patch
extraction and scoring, and the Sim(3)-aligned trajectory error.

Tolerances: rendered frames atol 1e-5 (sprites summed by scatter-add in
another order, ~10 float32 terms per pixel); patches atol 1e-6 and
scores rtol 1e-5 (169-term float32 sums); trajectory alignment 1e-9 (both in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import renderer as j_render
from slam_robot_tpu.ops import patch as j_patch
from slam_robot_tpu.ops import quaternion as j_quat
from slam_robot_tpu.utils import benchscene as j_scene
from slam_robot_tpu.utils import dump as j_dump
from slam_robot_tpu.utils import synthetic as j_syn
from slam_robot_tpu_torch.models import renderer as t_render
from slam_robot_tpu_torch.ops import patch as t_patch
from slam_robot_tpu_torch.ops import quaternion as t_quat
from slam_robot_tpu_torch.utils import benchscene as t_scene
from slam_robot_tpu_torch.utils import dump as t_dump
from slam_robot_tpu_torch.utils import synthetic as t_syn
from tests.test_pipeline import CFG

torch.set_num_threads(1)


def test_intrinsics_and_sweep_poses_match():
    for cfg in (CFG, CFG.__class__()):
        np.testing.assert_array_equal(t_syn.reference_intrinsics(cfg),
                                      j_syn.reference_intrinsics(cfg))
    for i in range(0, 200, 7):
        ty, tt = t_scene.sweep_pose(i)
        jy, jt = j_scene.sweep_pose(i)
        assert ty == jy
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("frame", [0, 41, 120])
def test_render_matches_jax(frame):
    world, bright = t_scene.make_world(seed=0)
    k = t_syn.reference_intrinsics(CFG)
    yaw, tr = t_scene.sweep_pose(frame)
    jq = j_quat.from_axis_angle(jnp.array([0.0, 1.0, 0.0]), yaw)
    tq = t_quat.from_axis_angle(torch.tensor([0.0, 1.0, 0.0]), torch.tensor(yaw))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-7)
    kw = dict(height=CFG.image_height, width=CFG.image_width)
    want = j_render.render(jq, jnp.asarray(tr), jnp.asarray(k), jnp.asarray(world),
                           jnp.asarray(bright), **kw)
    got = t_render.render(tq, torch.as_tensor(tr), torch.as_tensor(k),
                          torch.as_tensor(world), torch.as_tensor(bright), **kw)
    assert got.shape == (CFG.image_height, CFG.image_width)
    assert float(got.std()) > 0.01  # sprites landed, not just the background
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_patch_extract_and_score_match():
    rng = np.random.default_rng(3)
    planes = rng.uniform(size=(2, 60, 80)).astype(np.float32)  # padded 44x64 levels
    pts = rng.uniform([-3, -3], [67, 47], size=(32, 2)).astype(np.float32)
    w = t_patch.radial_mask(13)
    tp = [t_patch.extract(torch.as_tensor(planes), i, 64, 44, torch.as_tensor(pts))
          for i in (0, 1)]
    jp = [jax.vmap(lambda p, i=i: j_patch.extract(jnp.asarray(planes[i]), 64, 44, p, 13))(
        jnp.asarray(pts)) for i in (0, 1)]
    for t_, j_ in zip(tp, jp):
        np.testing.assert_array_equal(t_.valid.numpy(), np.asarray(j_.valid))
        for f in ("data", "mean", "sumsq"):
            np.testing.assert_allclose(getattr(t_, f).numpy(), np.asarray(getattr(j_, f)),
                                       atol=1e-6)
    got = t_patch.score(tp[0], tp[1], w).numpy()
    want = jax.vmap(lambda a, b: j_patch.score(a, b, jnp.asarray(w.numpy())))(jp[0], jp[1])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_aligned_ate_matches_jax_and_fixes_reflection():
    rng = np.random.default_rng(4)
    true = np.cumsum(rng.normal(scale=50.0, size=(40, 3)), axis=0)
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    est = 0.8 * true @ R.T + [10.0, -5.0, 3.0] + rng.normal(scale=2.0, size=true.shape)
    for with_scale in (True, False):
        got = t_dump.align_umeyama(est, true, with_scale)
        want = j_dump.align_umeyama(est, true, with_scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-9)
        np.testing.assert_allclose(t_dump.ate_aligned(est, true, with_scale),
                                   j_dump.ate_aligned(est, true, with_scale), atol=1e-9)
    # a straight-line trajectory: rank-deficient covariance, where the sign
    # of det is 0 and must not turn the rotation into a projection
    line = np.outer(np.arange(10.0), [1.0, 2.0, 0.5])
    s, R, _ = t_dump.align_umeyama(line * 1.5, line)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
    assert np.linalg.det(R) == pytest.approx(1.0)
    assert t_dump.ate_aligned(line * 1.5, line) < 1e-9
