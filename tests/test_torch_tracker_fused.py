"""The port's fused tracker (``ops/tracker_fused``) and patch extraction
against the JAX package, lane by lane, on the same seeded images.

Window cuts, patch stacks and packing are copies and bilinear mixes of the
same pixels (atol 1e-6: the mixes may round differently). Tracked
positions use the bars of tests/test_tracker_fused.py: atol 2e-3 px for
one direction, 5e-3 px for the forward/backward pair, ok flags equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from slam_robot_tpu.ops import patch as j_patch
from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.ops import tracker_fused as j_tf
from slam_robot_tpu_torch.ops import pyramid as t_pyr
from slam_robot_tpu_torch.ops import tracker_fused as t_tf
from tests.test_tracker import make_texture, shift_image

torch.set_num_threads(1)

WEIGHT = np.asarray(j_patch.radial_mask(13))
ITERS = 6


def pyramids(rng, dx=2.5, dy=-1.5, depth=4):
    img = make_texture(rng)
    img2 = shift_image(img, dx, dy)
    j = [j_pyr.build_pyramid(jnp.asarray(a), depth=depth) for a in (img, img2)]
    t = [t_pyr.build_pyramid(torch.as_tensor(a), depth=depth) for a in (img, img2)]
    return j, t


def test_window_and_patch_stacks_match():
    rng = np.random.default_rng(3)
    (ja, _), (ta, _) = pyramids(rng)
    K = 40
    pts = np.stack([rng.uniform(-30, 190, K), rng.uniform(-30, 150, K)], -1).astype(np.float32)
    pts[0] = np.nan
    pts[1] = [1e9, -1e9]
    jw, jo = j_tf.get_window_stacks(ja, jnp.asarray(pts))
    tw, to = t_tf.get_window_stacks(ta, torch.as_tensor(pts))
    # windows are copies of pyramid pixels (the pyramids agree to 1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    ok = np.isfinite(pts).all(1) & (np.abs(pts) < 1e6).all(1)
    js = j_tf.get_patch_stacks(ja, jnp.asarray(pts[ok]), 13)
    ts = t_tf.get_patch_stacks(ta, torch.as_tensor(pts[ok]), 13)
    tsw = t_tf.get_patch_stacks_from_windows(ta, torch.as_tensor(pts[ok]), tw[ok], to[ok], 13)
    for f in ("data", "valid", "mean", "sumsq"):
        want = np.asarray(getattr(js, f))
        np.testing.assert_allclose(getattr(ts, f).numpy(), want, atol=1e-5)
        # the window re-read is exact against plane extraction in the port
        np.testing.assert_array_equal(getattr(tsw, f).numpy(), getattr(ts, f).numpy())

    jp = j_tf.pack_stacks(js)
    tp = t_tf.pack_stacks(ts)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_sample_from_windows_matches():
    rng = np.random.default_rng(4)
    F = 24
    win = rng.uniform(size=(F, 32, 31)).astype(np.float32)
    org = rng.integers(-8, 20, size=(F, 2)).astype(np.float32)
    pt = (org + rng.uniform(-4, 36, size=(F, 2))).astype(np.float32)
    want = j_tf._sample_from_windows(jnp.asarray(win), jnp.asarray(org), jnp.asarray(pt),
                                     40.0, 30.0, 13)
    got = t_tf._sample_from_windows(torch.as_tensor(win), torch.as_tensor(org),
                                    torch.as_tensor(pt), 40.0, 30.0, 13)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_track_feature_batch_matches():
    rng = np.random.default_rng(0)
    (ja, jb), (ta, tb) = pyramids(rng)
    F = 16
    pts = rng.uniform(30, 90, size=(F, 2)).astype(np.float32)
    lvls = np.asarray([3, 4] * 8, np.int32)
    active = np.ones(F, bool)
    active[5] = False
    jpk = j_tf.pack_stacks(j_tf.get_patch_stacks(ja, jnp.asarray(pts)))
    want_pos, want_ok = j_tf.track_feature_batch(
        jb, None, jnp.asarray(pts), jnp.asarray(lvls), jnp.asarray(WEIGHT),
        max_iters=ITERS, active=jnp.asarray(active), backend="xla", packed=jpk)
    tpk = t_tf.pack_stacks(t_tf.get_patch_stacks(ta, torch.as_tensor(pts)))
    got_pos, got_ok = t_tf.track_feature_batch(
        tb, torch.as_tensor(pts), torch.as_tensor(lvls), torch.as_tensor(WEIGHT),
        max_iters=ITERS, active=torch.as_tensor(active), packed=tpk)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert ok.sum() > 10
    np.testing.assert_allclose(got_pos.numpy()[ok], np.asarray(want_pos)[ok], atol=2e-3)


def _bidirectional(rng, ref_from_window: bool, win_cache: bool):
    (ja, jb), (ta, tb) = pyramids(rng, dx=3.2, dy=2.1)
    F = 12
    pts = rng.uniform(35, 85, size=(F, 2)).astype(np.float32)
    start = pts + np.float32([3.0, 2.0])
    lvls = np.full((F,), 4, np.int32)
    active = np.asarray([True] * 10 + [False] * 2)
    jpk = j_tf.pack_stacks(j_tf.get_patch_stacks(ja, jnp.asarray(pts)))
    tpk = t_tf.pack_stacks(t_tf.get_patch_stacks(ta, torch.as_tensor(pts)))
    jc = j_tf.get_window_stacks(ja, jnp.asarray(pts)) if win_cache else None
    tc = t_tf.get_window_stacks(ta, torch.as_tensor(pts)) if win_cache else None
    want_px, want_ok = j_tf.track_bidirectional_batch(
        ja, jb, jnp.asarray(pts), jnp.asarray(start), jnp.asarray(lvls), jnp.asarray(WEIGHT),
        max_iters=ITERS, active=jnp.asarray(active), backend="xla", p1_packed=jpk,
        bwd_ref_from_window=ref_from_window, bwd_win_cache=jc)
    got_px, got_ok = t_tf.track_bidirectional_batch(
        ta, tb, torch.as_tensor(pts), torch.as_tensor(start), torch.as_tensor(lvls),
        torch.as_tensor(WEIGHT), max_iters=ITERS, active=torch.as_tensor(active),
        p1_packed=tpk, bwd_ref_from_window=ref_from_window, bwd_win_cache=tc)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert ok.sum() > 6  # the scene is trackable
    np.testing.assert_allclose(got_px.numpy()[ok], np.asarray(want_px)[ok], atol=5e-3)


def test_bidirectional_matches_production_path():
    """bwd_ref_from_window + bwd_window_cache: the defaults the matcher runs."""
    _bidirectional(np.random.default_rng(1), True, True)


def test_bidirectional_matches_reference_exact_path():
    """Both off: REFERENCE_EXACT_KW's backward pass."""
    _bidirectional(np.random.default_rng(2), False, False)


def test_bidirectional_extracted_refs_match():
    rng = np.random.default_rng(5)
    (ja, jb), (ta, tb) = pyramids(rng, dx=-2.0, dy=1.0)
    F = 12
    pts = rng.uniform(35, 85, size=(F, 2)).astype(np.float32)
    lvls = np.full((F,), 3, np.int32)
    want_px, want_ok = j_tf.track_bidirectional_batch(
        ja, jb, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(lvls), jnp.asarray(WEIGHT),
        max_iters=ITERS, backend="xla")
    got_px, got_ok = t_tf.track_bidirectional_batch(
        ta, tb, torch.as_tensor(pts), torch.as_tensor(pts), torch.as_tensor(lvls),
        torch.as_tensor(WEIGHT), max_iters=ITERS)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert ok.sum() > 6
    np.testing.assert_allclose(got_px.numpy()[ok], np.asarray(want_px)[ok], atol=5e-3)
