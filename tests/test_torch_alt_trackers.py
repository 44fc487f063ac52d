"""The port's alternative trackers against the JAX package on the CPU: the
autodiff "lanes" tracker (``ops/tracker``), KLT (``ops/klt``), brute SAD
(``ops/brute``), the matcher's round-1 view walk that runs the first two,
and a few steps of the SLAM step with each.

The JAX package's functions are single-feature and vmapped over lanes; the
port's are batched. Inputs are tests/test_tracker.py's textures (160x120,
depth 4), 32 lanes with some starts outside the image, made from a seed
with numpy.

Tolerances:
- lanes and KLT: positions within 1e-3 px, ok (status) equal. The two
  packages' derivatives and sums run in another float order, which moves
  a converged position by ~2e-5 px.
- brute: positions within 1e-5 px, ok equal: a grid scan lands on the same
  grid point unless two SADs tie within float32, and a tie picks the
  first grid point in both packages.
- the lanes tracker against the port's fused tracker (its plain loop on
  the CPU): ok equal, positions of ok lanes within 2e-3 px, as
  tests/test_tracker_fused.py holds the JAX package's pair.
- matcher.track from a bridged JAX state: the matched mask and n_matches
  equal, positions and observation pixels within 1e-3 px, every other
  float field within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import matcher as j_matcher
from slam_robot_tpu.ops import brute as j_brute
from slam_robot_tpu.ops import klt as j_klt
from slam_robot_tpu.ops import patch as j_patch
from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.ops import tracker as j_tracker
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import matcher as t_matcher
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.ops import brute as t_brute
from slam_robot_tpu_torch.ops import klt as t_klt
from slam_robot_tpu_torch.ops import patch as t_patch
from slam_robot_tpu_torch.ops import pyramid as t_pyr
from slam_robot_tpu_torch.ops import tracker as t_tracker
from slam_robot_tpu_torch.ops import tracker_fused as t_fused
from tests.test_torch_config import port_cfg
from tests.test_torch_localmap import assert_state_close
from tests.test_tracker import make_texture, shift_image

torch.set_num_threads(1)

J_W = j_patch.radial_mask(13)
T_W = t_patch.radial_mask(13)
DEPTH = 4
ITERS = 6
K = 32
# name: (dx, dy, gain, seed of an unrelated second image or None)
CASES = {
    "subpixel": (0.4, -0.3, 1.0, None),           # tests/test_tracker.py:50
    "multi_pixel": (6.5, -4.25, 1.0, None),       # :58
    "gain_bias": (2.0, 1.0, 1.5, None),           # :78
    "decorrelated": (0.0, 0.0, 1.0, 99),          # :111
    "cascade": (6.3, -4.7, 1.0, None),            # tests/test_alt_trackers.py:82
}
# starts outside or on the edge of the 160x120 image (tests/test_tracker.py:87)
OUTSIDE = [[-50.0, -50.0], [175.0, 60.0], [80.0, -3.0], [0.004, 60.0]]


@functools.cache
def scene(name):
    """(JAX pyramids a, b; port pyramids a, b; pts [K,2]; lvls [K]; active [K])."""
    dx, dy, gain, other = CASES[name]
    rng = np.random.default_rng(0)
    img = make_texture(rng)
    img2 = (make_texture(np.random.default_rng(other)) if other is not None
            else shift_image(img, dx, dy) * gain)
    pts = np.concatenate([rng.uniform([18, 18], [140, 100], size=(K - 4, 2)),
                          OUTSIDE]).astype(np.float32)
    lvls = np.array([3, 4] * (K // 2), np.int32)
    active = np.arange(K) % 7 != 3
    jp = [j_pyr.build_pyramid(jnp.asarray(im), depth=DEPTH) for im in (img, img2)]
    tp = [t_pyr.build_pyramid(torch.as_tensor(im), depth=DEPTH) for im in (img, img2)]
    return jp, tp, pts, lvls, active


def t_in(pts, lvls, active):
    return torch.as_tensor(pts), torch.as_tensor(lvls), torch.as_tensor(active)


@functools.partial(jax.jit, static_argnums=0)
def j_feature(kind, pa, pb, pts, lvls, active):
    """Each lane's reference stack at its start in ``pa``, tracked in ``pb``."""
    fn = {"lanes": j_tracker.track_feature, "klt": j_klt.track_feature}[kind]

    def one(p, lv, act):
        return fn(pb, j_tracker.get_patch_stack(pa, p), p, lv, J_W, max_iters=ITERS,
                  active=act)

    return jax.vmap(one)(pts, lvls, active)


@functools.partial(jax.jit, static_argnums=0)
def j_bidirectional(kind, pa, pb, pts, lvls, active):
    fn = {"lanes": None, "klt": j_klt.track_feature}[kind]

    def one(p, lv, act):
        return j_tracker.track_bidirectional(pa, pb, p, p, lv, J_W, max_iters=ITERS,
                                             active=act, track_fn=fn)

    return jax.vmap(one)(pts, lvls, active)


@jax.jit
def j_level(pa, pb, pts, active):
    """Level 0 of each tracker from 0.7 px off each lane's start."""
    img, j, w, h = pb.level_ref(0)

    def one(p, act):
        ref = j_tracker._level_patch(j_tracker.get_patch_stack(pa, p), 0)
        start = p + jnp.array([0.7, -0.4])
        return (j_tracker.track_level(img, w, h, ref, start, J_W, max_iters=ITERS,
                                      active=act, index=j),
                j_klt.track_level(img, w, h, ref, start, J_W, max_iters=ITERS,
                                  active=act, index=j))

    return jax.vmap(one)(pts, active)


@jax.jit
def j_brute_track(pa, pb, pts, lvls):
    def one(p, lv):
        return j_brute.track_feature(pb, j_tracker.get_patch_stack(pa, p), p, lv)

    return jax.vmap(one)(pts, lvls)


def check(got, want, atol, what):
    (gp, gok), (wp, wok) = got, want
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok), err_msg=what)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("case", ["subpixel", "multi_pixel", "gain_bias", "decorrelated"])
@pytest.mark.parametrize("kind", ["lanes", "klt"])
def test_track_feature_and_bidirectional_match_jax(kind, case):
    (ja, jb), (ta, tb), pts, lvls, active = scene(case)
    fn = {"lanes": t_tracker.track_feature, "klt": t_klt.track_feature}[kind]
    tpts, tlv, tact = t_in(pts, lvls, active)
    got = fn(tb, t_tracker.get_patch_stack(ta, tpts), tpts, tlv, T_W, max_iters=ITERS,
             active=tact)
    want = j_feature(kind, ja, jb, pts, lvls, active)
    check(got, want, 1e-3, f"{kind} track_feature")
    if case != "decorrelated":
        assert got[1][:K - 4].float().mean() > 0.7  # the scene is trackable
    assert not got[1][K - 4:].any()  # every start outside fails

    got = t_tracker.track_bidirectional(ta, tb, tpts, tpts, tlv, T_W, max_iters=ITERS,
                                        active=tact, track_fn=None if kind == "lanes" else fn)
    want = j_bidirectional(kind, ja, jb, pts, lvls, active)
    check(got, want, 1e-3, f"{kind} track_bidirectional")
    if case == "decorrelated":  # a stray lane may pass, in both packages
        assert got[1].sum() <= 2


@pytest.mark.parametrize("case", ["multi_pixel", "gain_bias"])
def test_track_level_matches_jax(case):
    (ja, jb), (ta, tb), pts, _, active = scene(case)
    tpts, _, tact = t_in(pts, np.zeros(K, np.int32), active)
    ref = t_tracker.level_patch(t_tracker.get_patch_stack(ta, tpts), 0)
    start = tpts + torch.tensor([0.7, -0.4])
    h, w = t_tracker.pyramid_dims(tb)[0]
    lanes = t_tracker.track_level(tb.data, 0, w, h, ref, start, T_W, max_iters=ITERS,
                                  active=tact)
    klt = t_klt.track_level(tb.data, 0, w, h, ref, start, T_W, max_iters=ITERS, active=tact)
    want_lanes, want_klt = j_level(ja, jb, pts, active)
    check(lanes, want_lanes, 1e-3, "tracker.track_level")
    check(klt, want_klt, 1e-3, "klt.track_level")
    assert (lanes[1] == t_tracker.OUT_OF_BOUNDS).sum() >= 2
    # inactive lanes come back where they started, OK
    idle = ~tact
    assert torch.equal(lanes[0][idle], start[idle]) and (lanes[1][idle] == t_tracker.OK).all()


@pytest.mark.parametrize("case", ["subpixel", "gain_bias", "decorrelated", "cascade"])
def test_brute_matches_jax(case):
    (ja, jb), (ta, tb), pts, lvls, _ = scene(case)
    if case == "cascade":
        lvls = np.full(K, 4, np.int32)
    tpts = torch.as_tensor(pts)
    got = t_brute.track_feature(tb, t_tracker.get_patch_stack(ta, tpts), tpts,
                                torch.as_tensor(lvls))
    want = j_brute_track(ja, jb, pts, lvls)
    check(got, want, 1e-5, "brute.track_feature")
    if case == "cascade":
        err = np.linalg.norm(got[0].numpy()[:K - 4] - (pts[:K - 4] + [6.3, -4.7]), axis=1)
        assert np.median(err) < 0.2


@jax.jit
def j_search(pa, pb, pts, step):
    img, j, w, h = pb.level_ref(0)

    def one(p):
        ref = j_tracker._level_patch(j_tracker.get_patch_stack(pa, p), 0)
        return j_brute.search_best(img, w, h, ref, p, step, index=j)

    return jax.vmap(one)(pts)


def test_brute_search_best_matches_jax_and_ties_pick_the_first_grid_point():
    """Positions within 1e-5 px; SADs within 1e-4 (sums of 169 terms whose
    gain and bias come from sums in another order)."""
    (ja, jb), (ta, tb), pts, _, _ = scene("subpixel")
    tpts = torch.as_tensor(pts)
    ref = t_tracker.level_patch(t_tracker.get_patch_stack(ta, tpts), 0)
    h, w = t_tracker.pyramid_dims(tb)[0]
    for step in (1.0, 1 / 3, 1 / 81):
        got = t_brute.search_best(tb.data, 0, w, h, ref, tpts, step)
        want = j_search(ja, jb, pts, np.float32(step))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)
    # a flat image: every candidate's SAD is the same, and both take the first
    flat = np.full((120, 160), 0.5, np.float32)
    tf_ = t_pyr.build_pyramid(torch.as_tensor(flat), depth=DEPTH)
    got = t_brute.search_best(tf_.data, 0, w, h, ref, tpts, 1.0)
    want = j_search(ja, j_pyr.build_pyramid(jnp.asarray(flat), depth=DEPTH), pts, np.float32(1))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    inner = slice(0, K - 4)  # every candidate's support inside the image
    np.testing.assert_array_equal(got[0].numpy()[inner], pts[inner] - 3.0)
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [float("nan"), 0.0, float("nan"), 0.0],
                      [2.0, 2.0, 2.0, 2.0]])
    assert t_brute.first_argmin(x).tolist() == [1, 0, 0] == np.argmin(x.numpy(), 1).tolist()


def test_lanes_tracker_matches_the_fused_plain_loop():
    """As tests/test_tracker_fused.py:82 holds the JAX package's fused
    tracker against its lanes tracker."""
    rng = np.random.default_rng(0)
    img = make_texture(rng)
    pa, pb = (t_pyr.build_pyramid(torch.as_tensor(im), depth=DEPTH)
              for im in (img, shift_image(img, 2.5, -1.5)))
    pts = torch.as_tensor(rng.uniform(30, 90, size=(16, 2)).astype(np.float32))
    lvls = torch.tensor([3, 4] * 8, dtype=torch.int32)
    fused = t_fused.track_feature_batch(pb, pts, lvls, T_W, max_iters=ITERS,
                                        ref_pyr=pa, ref_pts=pts)
    lanes = t_tracker.track_feature(pb, t_tracker.get_patch_stack(pa, pts), pts, lvls, T_W,
                                    max_iters=ITERS)
    assert torch.equal(fused[1], lanes[1]) and lanes[1].sum() > 12
    np.testing.assert_allclose(fused[0][lanes[1]].numpy(), lanes[0][lanes[1]].numpy(),
                               atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def matcher_state():
    """The JAX state before frame 2 of a three-frame shift sequence at
    tests/test_matcher.py's CFG with min_matches 40, run with KLT: frames 0
    and 1 are keyframes, so frame 2 walks two stored views."""
    from tests.test_matcher import CFG, fresh, shift, texture

    img0 = texture(0)
    frames = [img0, shift(img0, 2, 1), shift(img0, 4, 1.5)]
    cfg = dataclasses.replace(CFG, min_matches=40, tracker_kind="klt")
    ms, s = fresh()
    for i in range(2):
        s, f = j_lm.add_frame(s, i % 2)
        ms, s, _ = j_matcher.track(ms, s, jnp.asarray(frames[i]), f, i % 2, cfg)
    s, _ = j_lm.add_frame(s, 0)
    return ms, s, frames[2]


@pytest.mark.parametrize("kw", [{"tracker_impl": "lanes"}, {"tracker_kind": "klt"}])
def test_matcher_round1_walk_matches_jax(matcher_state, kw):
    from tests.test_matcher import CFG

    ms, s, img = matcher_state
    cfg = dataclasses.replace(CFG, min_matches=40, **kw)
    assert int((np.asarray(ms.view_frame) >= 0).sum()) == 2
    wms, wm, wmet = j_matcher.track(ms, s, jnp.asarray(img), 2, 0, cfg)
    gms, gm, gmet = t_matcher.track(bridge.from_numpy(ms, "cpu"), bridge.from_numpy(s, "cpu"),
                                    torch.as_tensor(img), 2, 0, port_cfg(cfg))
    matched = np.asarray(wmet["feat_matched"])
    np.testing.assert_array_equal(gmet["feat_matched"].numpy(), matched)
    assert int(gmet["n_matches"]) == int(wmet["n_matches"]) > 20
    np.testing.assert_allclose(gmet["feat_px"].numpy()[matched],
                               np.asarray(wmet["feat_px"])[matched], atol=1e-3, rtol=0)
    assert_state_close(gm, wm, atol=1e-4, atol_px=1e-3)
    assert_state_close(gms, wms, atol=1e-4, skip=("feat_px",))
    np.testing.assert_allclose(gms.feat_px.numpy(), np.asarray(wms.feat_px), atol=1e-3, rtol=0)


@pytest.mark.parametrize("kw", [{"tracker_impl": "lanes"}, {"tracker_kind": "klt"}])
def test_pipeline_steps_with_alternative_trackers_stay_finite(kw):
    from tests.test_matcher import CFG, shift, texture

    cfg = port_cfg(dataclasses.replace(CFG, max_frames=8, **kw))
    ps = t_pipe.init(cfg, device="cpu")
    img0 = texture(1)
    n_matches = []
    for i in range(4):
        ps, met = t_pipe.step(ps, torch.as_tensor(shift(img0, 1.5 * i, 0.5 * i)), cfg)
        n_matches.append(int(met["n_matches"]))
    for name, t in list(ps.map._asdict().items()) + list(ps.matcher._asdict().items()):
        if t.is_floating_point():
            assert torch.isfinite(t).all(), name
    assert min(n_matches[1:]) > 10 and int(ps.map.n_obs) > 40
