"""The port's map maintenance (``models/localmap``) against the JAX package
on a JAX-made state carried across by ``bridge``.

Integer and boolean fields must be equal. Float fields: atol 1e-3 for
pixel-scale values (reprojection errors, positions in mm) and 1e-5 for
unit-scale ones — the same float32 formulas, summed in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.utils import synthetic
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import localmap as t_lm

torch.set_num_threads(1)

CFG = SlamConfig(max_frames=16, max_points=64, max_obs=1024, max_obs_per_point=8)
PIXEL_SCALE = {"obs_err", "obs_px", "frame_trans", "point_uncertainty"}


def assert_state_close(got, want, atol=1e-5, atol_px=1e-3, skip=()):
    """Every field of a port state against the JAX state, field by field."""
    for f in got._fields:
        if f in skip:
            continue
        g = getattr(got, f)
        w = getattr(want, f)
        if isinstance(g, tuple):
            assert_state_close(g, w, atol, atol_px, skip)
            continue
        g = g.detach().cpu().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (f, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            tol = atol_px if f in PIXEL_SCALE else atol
            np.testing.assert_allclose(g, w, atol=tol, rtol=1e-5, err_msg=f)


def scene(seed=0, n_frames=10, n_points=40):
    sc = synthetic.build_scene(CFG, n_frames=n_frames, n_points=n_points, seed=seed,
                               pixel_noise=0.3, pose_noise=0.001, point_noise=5.0)
    return sc.state


def both(state):
    return state, bridge.from_numpy(state, "cpu")


def test_bridge_round_trip_is_identity():
    js = scene()
    back = bridge.to_numpy(bridge.from_numpy(js, "cpu"))
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(back, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_empty_and_add_frame_match():
    je = j_lm.empty(CFG)
    te = t_lm.empty(CFG)
    assert_state_close(te, je)
    k = synthetic.reference_intrinsics(CFG)
    je = j_lm.set_camera(je, 1, k)
    te = t_lm.set_camera(te, 1, k)
    q = np.array([0.1, 0.2, 0.3, 0.9], np.float32)
    q /= np.linalg.norm(q)
    tr = np.array([1.0, 2.0, 3.0], np.float32)
    je, ji = j_lm.add_frame(je, 1, jnp.asarray(q), jnp.asarray(tr))
    te, ti = t_lm.add_frame(te, 1, torch.as_tensor(q), torch.as_tensor(tr))
    assert int(ji) == int(ti)
    assert_state_close(te, je)


def test_add_points_and_observations_with_eviction_match():
    js, ts = both(scene())
    rng = np.random.default_rng(1)
    # flag some points dead so eviction has candidates; fill past capacity
    flags = np.asarray(js.point_flags).copy()
    flags[:6] |= j_lm.MISMATCHED | j_lm.BAD_FEATURE
    js = js._replace(point_flags=jnp.asarray(flags))
    ts = ts._replace(point_flags=torch.as_tensor(flags))
    K = 32
    locs = np.concatenate([rng.normal(scale=1000.0, size=(K, 3)), np.ones((K, 1))], 1)
    locs = (locs / np.linalg.norm(locs, axis=1, keepdims=True)).astype(np.float32)
    valid = rng.uniform(size=K) > 0.2
    referenced = np.zeros(CFG.max_points, bool)
    referenced[[2, 3]] = True
    js2, jidx = j_lm.add_points(js, jnp.asarray(locs), jnp.asarray(valid),
                                referenced=jnp.asarray(referenced), evict_retain=4)
    ts2, tidx = t_lm.add_points(ts, torch.as_tensor(locs), torch.as_tensor(valid),
                                referenced=torch.as_tensor(referenced), evict_retain=4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # evicted dead slots (0..5 minus the referenced 2, 3) were reused
    assert set(np.asarray(jidx)[:4].tolist()) == {0, 1, 4, 5}
    assert_state_close(ts2, js2)

    px = rng.uniform([0, 0], [640, 480], size=(K, 2)).astype(np.float32)
    js3 = j_lm.add_observations(js2, 9, jidx, jnp.asarray(px), jnp.asarray(valid))
    ts3 = t_lm.add_observations(ts2, 9, tidx, torch.as_tensor(px), torch.as_tensor(valid))
    assert_state_close(ts3, js3)


def test_reproject_clean_epipolar_match():
    js, ts = both(scene(seed=2))
    # corrupt a few observations, some in the newest frame, so clean and
    # the epipolar gate both fire
    n = int(js.n_obs)
    rng = np.random.default_rng(3)
    px = np.asarray(js.obs_px).copy()
    rows = np.concatenate([rng.choice(n - 40, size=8, replace=False), n - 40 + np.arange(0, 40, 5)])
    px[rows] += rng.normal(scale=150.0, size=(len(rows), 2)).astype(np.float32)
    js = js._replace(obs_px=jnp.asarray(px))
    ts = ts._replace(obs_px=torch.as_tensor(px))

    for window in (None, 128):
        jr, jm = j_lm.reproject(js, 0.001, window=window)
        tr, tm = t_lm.reproject(ts, 0.001, window=window)
        np.testing.assert_allclose(float(tm), float(jm), rtol=1e-4)
        assert_state_close(tr, jr)
        np.testing.assert_allclose(float(t_lm.mean_obs_error(tr, window)),
                                   float(j_lm.mean_obs_error(jr, window)), rtol=1e-4)

    assert bool(t_lm.clamp_pending(tr)) == bool(j_lm.clamp_pending(jr))
    jc, jok = j_lm.clean(jr, 5.0, CFG)
    tc, tok = t_lm.clean(tr, 5.0, CFG)
    assert bool(tok) == bool(jok) is False
    assert_state_close(tc, jc)

    assert (np.asarray(jc.point_flags) & j_lm.MISMATCHED).any()

    je = j_lm.apply_epipolar_constraint(jr, CFG)
    te = t_lm.apply_epipolar_constraint(tr, CFG)
    assert_state_close(te, je)
    assert np.asarray(je.obs_disabled).sum() > np.asarray(jr.obs_disabled).sum()
    assert t_lm.stats(te)["n_points"] == j_lm.stats(je)["n_points"]


def test_normalize_and_canary_match():
    js, ts = both(scene(seed=4))
    # move the anchor off the identity so normalize takes its full branch
    q0 = np.array([0.05, -0.1, 0.02, 1.0], np.float32)
    q0 /= np.linalg.norm(q0)
    fq = np.asarray(js.frame_quat).copy()
    ft = np.asarray(js.frame_trans).copy()
    fq[0] = q0
    ft[0] = [30.0, -5.0, 12.0]
    for fq_, ft_ in ((np.asarray(js.frame_quat), np.asarray(js.frame_trans)), (fq, ft)):
        j1 = js._replace(frame_quat=jnp.asarray(fq_), frame_trans=jnp.asarray(ft_))
        t1 = ts._replace(frame_quat=torch.as_tensor(fq_), frame_trans=torch.as_tensor(ft_))
        j1, _ = j_lm.reproject(j1)
        t1, _ = t_lm.reproject(t1)
        for rescale in (False, True):  # True: also re-fix the 0-1 baseline
            jn = j_lm.normalize(j1, rescale=rescale)
            tn = t_lm.normalize(t1, rescale=rescale)
            assert_state_close(tn, jn)
            np.testing.assert_allclose(float(t_lm.normalize_canary(tn, 64)),
                                       float(j_lm.normalize_canary(jn, 64)), atol=1e-3)


def test_refresh_flags_and_recent_obs_match():
    js, ts = both(scene(seed=5, n_frames=12))
    dis = np.asarray(js.ring_disabled).copy()
    dis[::3, 1] = True
    js = js._replace(ring_disabled=jnp.asarray(dis), point_flags=js.point_flags | j_lm.NO_BASELINE)
    ts = ts._replace(ring_disabled=torch.as_tensor(dis),
                     point_flags=ts.point_flags | t_lm.NO_BASELINE)
    assert_state_close(t_lm.refresh_flags(ts), j_lm.refresh_flags(js))
    for i in (1, 2, 5, 9):
        np.testing.assert_array_equal(ts.recent_obs_index(i).numpy(),
                                      np.asarray(js.recent_obs_index(i)))


def test_unported_knobs_raise():
    import pytest

    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.ops.cuda import newton

    for kw in ({"tracker_impl": "lanes"}, {"tracker_kind": "klt"}, {"retry_mode": "cycle"},
               {"mid_frame_resolve": True}, {"motion_model": "constant_velocity"},
               {"drop_idle_frames": True}, {"clean_duplicates": True},
               {"adaptive_fwd_px": 2.0}, {"seed_depth_adaptive": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pipeline.init(dataclasses.replace(CFG, **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        newton.newton_level(*[None] * 10, group=4)
