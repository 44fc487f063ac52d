"""The port's fused tracker (``ops/tracker_fused``) and patch extraction
against the JAX package, lane by lane, on the same seeded images.

Window cuts, patch stacks and packing are copies and bilinear mixes of the
same pixels (atol 1e-6: the mixes may round differently). Tracked
positions use the bars of tests/test_tracker_fused.py: atol 2e-3 px for
one direction, 5e-3 px for the forward/backward pair, ok flags equal.

The plain level loop (``newton.track_levels`` with ``newton_window_steps``,
the plain version of the one-launch ``newton_track`` kernel) is held to the
JAX cascade on the production path, the packed backward stack that the
kernel's epilogue writes included (atol 1e-5: bilinear samples of the same
pixels, on every lane and level the backward pass reads).
"""

import jax.numpy as jnp
import numpy as np
import torch

from slam_robot_tpu.ops import patch as j_patch
from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.ops import tracker_fused as j_tf
from slam_robot_tpu_torch.ops import pyramid as t_pyr
from slam_robot_tpu_torch.ops import tracker_fused as t_tf
from slam_robot_tpu_torch.ops.cuda import newton as t_newton
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


def _jax_stack(windows, to_pt, dims, S=13):
    """The JAX package's backward stack (tracker_fused.py:587-599)."""
    F = to_pt.shape[0]
    cols = []
    for lv, (winl, orgl) in enumerate(windows):
        h, w = dims[lv]
        d, v, m, sq = j_tf._sample_from_windows(winl, orgl, to_pt / (2.0 ** lv),
                                                float(w), float(h), S)
        cols.append(jnp.concatenate([d.reshape(F, S * S), v.reshape(F, S * S),
                                     m[:, None], sq[:, None]], axis=-1))
    return jnp.stack(cols, axis=1)


def test_plain_level_loop_matches_jax_on_production_path():
    """Forward on the planes with the backward stack, then backward on the
    window cache: the port's plain loop against the JAX cascade."""
    rng = np.random.default_rng(11)
    (ja, jb), (ta, tb) = pyramids(rng, dx=2.7, dy=-1.8)
    F = 24
    pts = rng.uniform(30, 90, size=(F, 2)).astype(np.float32)
    start = pts + np.float32([2.5, -2.0])
    lvls = np.asarray([3, 4] * (F // 2), np.int32)
    active = np.ones(F, bool)
    active[[4, 9]] = False
    jpk = j_tf.pack_stacks(j_tf.get_patch_stacks(ja, jnp.asarray(pts)))
    tpk = t_tf.pack_stacks(t_tf.get_patch_stacks(ta, torch.as_tensor(pts)))
    dims = t_tf._static_dims(tb)
    j_pos, j_ok, j_win = j_tf.track_feature_batch(
        jb, None, jnp.asarray(start), jnp.asarray(lvls), jnp.asarray(WEIGHT),
        max_iters=ITERS, active=jnp.asarray(active), backend="xla", packed=jpk,
        return_windows=True)
    j_stack = _jax_stack(j_win, j_pos, dims)
    t_pos, t_ok, t_stack = t_newton.newton_track(
        torch.as_tensor(start), torch.as_tensor(lvls), torch.as_tensor(active), tpk,
        torch.as_tensor(WEIGHT), dims, planes=tb.data, offset=tb.offset,
        max_iters=ITERS, stack=True)
    # the public entry point runs the same plain loop on CPU tensors
    l_pos, l_ok, l_win = t_newton.track_levels(
        t_newton.newton_window_steps, torch.as_tensor(start), torch.as_tensor(lvls),
        torch.as_tensor(active), tpk, torch.as_tensor(WEIGHT), dims, planes=tb.data,
        max_iters=ITERS, return_windows=True)
    assert torch.equal(l_pos, t_pos) and torch.equal(l_ok, t_ok)
    assert torch.equal(t_newton.stack_from_windows(l_win, l_pos, dims), t_stack)
    ok = np.asarray(j_ok)
    np.testing.assert_array_equal(t_ok.numpy(), ok)
    assert ok.sum() > 15
    np.testing.assert_allclose(t_pos.numpy()[ok], np.asarray(j_pos)[ok], atol=2e-3)
    # the backward pass reads level i of lane f where f is ok and i < lvls
    # (JAX leaves other lanes' windows zero where its lane buckets skip them)
    read = ok[:, None] & (np.arange(len(dims))[None, :] < lvls[:, None])
    np.testing.assert_allclose(t_stack.numpy()[read], np.asarray(j_stack)[read], atol=1e-5)

    jc = j_tf.get_window_stacks(ja, jnp.asarray(pts))
    tc = t_tf.get_window_stacks(ta, torch.as_tensor(pts))
    jb_pos, jb_ok = j_tf.track_feature_batch(
        ja, None, jnp.asarray(pts), jnp.asarray(lvls), jnp.asarray(WEIGHT),
        max_iters=ITERS, active=j_ok, backend="xla", packed=j_stack, win_cache=jc)
    tb_pos, tb_ok = t_newton.newton_track(
        torch.as_tensor(pts), torch.as_tensor(lvls), t_ok, t_stack, torch.as_tensor(WEIGHT),
        dims, win_cache=tc, max_iters=ITERS)
    np.testing.assert_array_equal(tb_ok.numpy(), np.asarray(jb_ok))
    okb = np.asarray(jb_ok)
    assert okb.sum() > 15
    np.testing.assert_allclose(tb_pos.numpy()[okb], np.asarray(jb_pos)[okb], atol=2e-3)


def test_level_loop_with_one_level_solver_is_the_same_loop():
    """track_levels is parameterised by its level solver: newton_level (on
    CPU tensors its plain version) gives the plain loop's result exactly."""
    rng = np.random.default_rng(12)
    _, (ta, tb) = pyramids(rng)
    F = 10
    pts = torch.as_tensor(rng.uniform(30, 90, size=(F, 2)).astype(np.float32))
    tpk = t_tf.pack_stacks(t_tf.get_patch_stacks(ta, pts))
    dims = t_tf._static_dims(tb)
    args = (pts + 1.5, 4, None, tpk, torch.as_tensor(WEIGHT), dims, tb.data, 0)
    a = t_newton.track_levels(t_newton.newton_window_steps, *args, iters_coarse=3)
    b = t_newton.track_levels(t_newton.newton_level, *args, iters_coarse=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
