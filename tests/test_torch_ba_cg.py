"""The port's large-map solver (``ops/ba_cg``) against the JAX package's.

- ``_padded_plan`` equals JAX's exactly (index tables, spill rows and
  segments, the overflow flag), on a table that fits, one that spills and
  one that overflows the spill; ``_padded_seg_sum`` agrees with JAX's and
  with a numpy ``np.add.at`` reference to rtol 1e-5 (float32 sums in
  another order).
- ``solve`` on the inputs of tests/test_ba.py's CG test (8 frames, 40
  points with 40 mm of point noise, no pixel noise), for both layouts and
  both preconditioners: after 2 GN iterations the cost at rtol 1e-3 (past
  them both packages reach the float32 residue of a noise-free problem,
  ~4e-5, where a relative comparison means nothing; both converged costs
  are checked under 1e-3 instead), and after 15 iterations frame
  translations within 0.1 mm and point positions within 1 mm.
- tests/test_ba.py's larger-map gate on the port alone.
- No host read in a solve: ``device.SYNCS`` does not move.
"""

import numpy as np
import pytest
import torch

from slam_robot_tpu.config import SlamConfig as JCfg
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu.ops import ba_cg as j_cg
from slam_robot_tpu.utils import synthetic as j_syn
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.config import SlamConfig as TCfg
from slam_robot_tpu_torch.device import SYNCS
from slam_robot_tpu_torch.models import localmap as t_lm
from slam_robot_tpu_torch.models import slam as t_slam
from slam_robot_tpu_torch.ops import ba_cg as t_cg
from slam_robot_tpu_torch.utils import synthetic as t_syn

torch.set_num_threads(1)

SIZES = dict(max_frames=16, max_points=64, max_obs=2048, max_obs_per_point=16)

PLANS = {  # (segments, rows, K, spill cap): fits / spills / overflows the spill
    "fits": (40, 200, 16, 64),
    "spills": (40, 400, 8, 256),
    "overflows": (20, 400, 4, 32),
}


def _seg_ids(n_seg, O, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_seg + 3, O).astype(np.int32)  # ids >= n_seg are left out
    return ids, rng.normal(size=(O, 5)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(PLANS))
def test_padded_plan_and_seg_sum_match(case):
    n_seg, O, K, cap = PLANS[case]
    ids, vals = _seg_ids(n_seg, O, seed=len(case))
    jplan = j_cg._padded_plan(ids, n_seg, K, cap)
    tplan = t_cg._padded_plan(torch.as_tensor(ids), n_seg, K, cap, "p")
    for name, got, want in zip(("pad_idx", "spill_rows", "spill_seg", "exceeded"),
                               tplan, jplan):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    exceeded = bool(jplan[3])
    n_spill = int(np.sum(np.asarray(jplan[1]) < O))
    assert (case == "overflows") == exceeded
    assert (n_spill > 0) == (case != "fits")

    got = t_cg._padded_seg_sum(torch.as_tensor(vals), *tplan[:3], "p").numpy()
    want = np.asarray(j_cg._padded_seg_sum(vals, *jplan[:3]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not exceeded:
        ref = np.zeros((n_seg + 3, 5), np.float64)
        np.add.at(ref, ids, vals)
        np.testing.assert_allclose(got, ref[:n_seg], rtol=1e-5, atol=1e-5)


def _cg_problem(pixel_noise=0.0):
    scene = j_syn.build_scene(JCfg(**SIZES), n_frames=8, n_points=40, point_noise=40.0,
                              pixel_noise=pixel_noise)
    s = scene.state
    free, present = j_slam.window_masks(s, 6, 8)
    obs_ok = j_slam._obs_ok(s, s.n_frames - 8)
    jargs = (s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k, s.point_loc,
             s.point_uncertainty, s.obs_frame, s.obs_point, s.obs_px, obs_ok, present, free)
    targs = tuple(torch.as_tensor(np.array(a)) for a in jargs)
    return scene, jargs, targs


def _positions(loc):
    loc = np.asarray(loc)[:40]
    return loc[:, :3] / loc[:, 3:]


@pytest.mark.parametrize("precond", ["block", "diag"])
@pytest.mark.parametrize("layout", ["padded", "scatter"])
def test_solve_matches(layout, precond):
    scene, jargs, targs = _cg_problem()
    for gn_iters in (2, 15):
        cfg = j_cg.CGConfig(max_free_frames=8, gn_iters=gn_iters, cg_iters=50, layout=layout,
                            precond=precond)
        jr = j_cg.solve(*jargs, cfg)
        tr = t_cg.solve(*targs, t_cg.CGConfig(**cfg._asdict()))
        assert bool(jr.ok) and bool(tr.ok)
        assert int(tr.iters) == gn_iters and int(tr.term) == int(jr.term)
        np.testing.assert_allclose(float(tr.cost0), float(jr.cost0), rtol=1e-5)
        if gn_iters == 2:
            assert float(jr.cost) < 0.1 * float(jr.cost0)
            np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
        else:
            assert float(tr.cost) < 1e-3 and float(jr.cost) < 1e-3
            np.testing.assert_allclose(tr.frame_trans.numpy(), np.asarray(jr.frame_trans),
                                       atol=0.1)
            np.testing.assert_allclose(_positions(tr.point_loc), _positions(jr.point_loc),
                                       atol=1.0)
            np.testing.assert_allclose(_positions(tr.point_loc),
                                       np.asarray(scene.true_points[:, :3]), atol=10.0)


def test_cg_solver_larger_map():
    """tests/test_ba.py's larger-map gate (30 frames, 2000 points), port
    alone: the reprojection error falls below a tenth and under 1 px. (Its
    ~2000 rows a frame overflow the frame side's padded table and spill, so
    ``ok`` is false here, as in the JAX package: the rows past the spill are
    left out of the frame sums.)"""
    cfg = TCfg(max_frames=64, max_points=4096, max_obs=32768, max_obs_per_point=16)
    s = t_syn.build_scene(cfg, n_frames=30, n_points=2000, point_noise=30.0,
                          pixel_noise=0.2, device="cpu").state
    free, present = t_slam.window_masks(s, 30, 30)
    obs_ok = t_slam._obs_ok(s, s.n_frames - 30)
    res = t_cg.solve(s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k, s.point_loc,
                     s.point_uncertainty, s.obs_frame, s.obs_point, s.obs_px, obs_ok,
                     present, free, t_cg.CGConfig(max_free_frames=32, gn_iters=10))
    s2 = s._replace(frame_quat=res.frame_quat, frame_trans=res.frame_trans,
                    point_loc=res.point_loc)
    before = float(t_lm.reproject(s)[1])
    after = float(t_lm.reproject(s2)[1])
    assert after < 0.1 * before and after < 1.0, (before, after)


@pytest.mark.parametrize("layout", ["padded", "scatter"])
def test_solve_reads_nothing_on_the_host(layout):
    _, _, targs = _cg_problem(pixel_noise=0.3)
    before = SYNCS.n
    res = t_cg.solve(*targs, t_cg.CGConfig(max_free_frames=8, gn_iters=3, cg_iters=10,
                                           layout=layout))
    assert SYNCS.n == before
    assert bool(res.ok) and float(res.cost) < float(res.cost0)


def test_unsolvable_problem_is_not_run():
    _, _, targs = _cg_problem()
    present = torch.zeros_like(targs[10])
    present[0] = True
    res = t_cg.solve(*targs[:10], present, targs[11], t_cg.CGConfig(max_free_frames=8))
    assert not bool(res.ok) and int(res.term) == t_cg.TERM_NOT_RUN
    assert torch.equal(res.frame_trans, targs[1]) and torch.equal(res.point_loc, targs[4])


def test_large_problem_matches():
    """bench_suite config 5's solve (5 GN x 20 CG, diag) at its --small size
    (200 frames, 5000 points, 60 observations a frame) against the JAX
    package's: cost at rtol 1e-3, pose error within 0.01 mm. In both the
    cost falls while the pose error stays where it started (within 0.1 %):
    most landmarks are seen once, so they absorb the pose noise."""
    jp = j_syn.build_large_problem(200, 5000, 60)
    tp = t_syn.build_large_problem(200, 5000, 60, device="cpu")
    keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
            "point_uncertainty", "obs_frame", "obs_point", "obs_px", "obs_ok", "present",
            "free_frame")
    cfg = j_cg.CGConfig(max_free_frames=200, gn_iters=5, cg_iters=20, precond="diag")
    jr = j_cg.solve(*(jp[k] for k in keys), cfg)
    tr = t_cg.solve(*(tp[k] for k in keys), t_cg.CGConfig(**cfg._asdict()))
    assert bool(jr.ok) and bool(tr.ok)
    np.testing.assert_allclose(float(tr.cost0), float(jr.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
    assert float(tr.cost) < 0.7 * float(tr.cost0)

    def ate(trans):
        return float(np.sqrt(np.mean(np.sum((np.asarray(trans) - np.asarray(jp["true_trans"]))
                                            ** 2, axis=1))))

    ate0, j_ate, t_ate = ate(jp["frame_trans"]), ate(jr.frame_trans), ate(tr.frame_trans.numpy())
    assert abs(t_ate - j_ate) < 0.01
    assert abs(t_ate - ate0) < 1e-3 * ate0 and abs(j_ate - ate0) < 1e-3 * ate0
