"""The port's constant-velocity prediction and idle-frame removal
(``models/localmap``: ``estimate_motion``, ``pop_frame``,
``check_not_moving``, ``_ring_gather``) against the JAX package on a
JAX-made state carried across by ``bridge``.

Tolerances as tests/test_torch_localmap.py: integer and boolean fields
equal, floats atol 1e-3 at pixel scale and 1e-5 at unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import localmap as t_lm
from tests.test_torch_localmap import assert_state_close, scene

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_estimate_motion_matches(n):
    js = scene(seed=3, n_frames=10)
    ts = bridge.from_numpy(js, "cpu")
    wq, wt = j_lm.estimate_motion(js, n)
    gq, gt = t_lm.estimate_motion(ts, n)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-3)
    if n < 4:  # the copy rule of frame n-2
        np.testing.assert_array_equal(gt.numpy(), np.asarray(js.frame_trans[n - 2]))


def _evicted(js):
    """``js`` with three points dead (neither feature- nor slam-usable) and
    evicted: their rows, the newest frame's included, read obs_point -1."""
    dead = jnp.zeros_like(js.point_flags).at[jnp.array([1, 5, 9])].set(
        j_lm.BAD_LOCATION | j_lm.MISMATCHED)
    js = j_lm.evict_points(js._replace(point_flags=js.point_flags | dead), 3)
    last = int(js.n_frames) - 1
    rows = np.arange(int(js.frame_obs_start[last]), int(js.n_obs))
    assert (np.asarray(js.obs_point)[rows] == -1).sum() == 3
    return js


# ring size 8: six frames leave every ring unwrapped, ten wrap it
@pytest.mark.parametrize("case", ["plain", "wrapped", "evicted"])
def test_pop_frame_matches(case):
    js = scene(seed=1, n_frames=6 if case == "plain" else 10)
    if case == "evicted":
        js = _evicted(js)
    wrapped = int(np.asarray(js.point_obs_total).max()) > js.point_obs.shape[1]
    assert wrapped == (case != "plain")
    want = j_lm.pop_frame(js)
    got = t_lm.pop_frame(bridge.from_numpy(js, "cpu"))
    assert int(got.n_frames) == int(js.n_frames) - 1
    assert_state_close(got, want)
    # a second pop from there too
    assert_state_close(t_lm.pop_frame(got), j_lm.pop_frame(want))


def _idle_tail(js, moving=False, keyframe=False):
    """The newest two frames at the translations of the two before them
    (or 10 mm off them), optionally with a keyframe among them."""
    n = int(js.n_frames)
    t = np.asarray(js.frame_trans).copy()
    t[n - 2:n] = t[n - 4:n - 2] + (10.0 if moving else 0.0)
    js = js._replace(frame_trans=jnp.asarray(t))
    if keyframe:
        js = js._replace(frame_keyframe=js.frame_keyframe.at[n - 1].set(True))
    return js


@pytest.mark.parametrize("case", ["idle", "moving", "keyframe"])
def test_check_not_moving_matches(case):
    js = _idle_tail(scene(seed=2, n_frames=10), moving=case == "moving",
                    keyframe=case == "keyframe")
    want = j_lm.check_not_moving(js)
    got = t_lm.check_not_moving(bridge.from_numpy(js, "cpu"))
    assert int(got.n_frames) == (8 if case == "idle" else 10)
    assert_state_close(got, want)


def test_check_not_moving_needs_four_frames():
    js = _idle_tail(scene(seed=2, n_frames=4))._replace(n_frames=jnp.int32(3))
    got = t_lm.check_not_moving(bridge.from_numpy(js, "cpu"))
    assert int(got.n_frames) == 3
    assert_state_close(got, j_lm.check_not_moving(js))


def test_ring_gather_matches():
    js = scene(seed=4, n_frames=10)
    want = j_lm._ring_gather(js, js.obs_px)
    got = t_lm._ring_gather(bridge.from_numpy(js, "cpu"), bridge.from_numpy(js, "cpu").obs_px)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
