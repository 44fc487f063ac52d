"""The port's observation-sharded solvers and multi-robot map against the
port's unsharded solvers and the JAX package's (JAX on its 8-device virtual
CPU mesh, the port on a CPU mesh of four shards).

A sharded solve adds each shard's partial sums of the observation blocks,
so it agrees with the unsharded one to float32 summation order:

- ``ba_cg.solve_sharded`` (4 shards) against the port's ``solve``: cost
  rtol 1e-4, frame translations 0.1 mm, point positions 1 mm; against JAX's
  ``solve_sharded`` on ``mesh8`` the same. The problem has pixel noise, so
  its optimum cost stands above float32 residue.
- ``sharded_ba.solve_sharded`` against the port's ``ba.solve`` and against
  JAX's ``solve_sharded``, with tests/test_parallel.py's criteria (frames
  within 1 mm, mean reprojection error within 0.1 px).
- ``assemble_partials`` against JAX's at rtol 1e-5.
- A one-shard mesh gives ``ba.solve``'s and ``ba_cg.solve``'s results bit
  for bit (the seam adds nothing).
- ``multi_robot.solve_shared_map`` against JAX's at R = 2, 8 sweeps
  (tests/test_parallel.py's problem): points within 0.05 mm, frame
  translations within 0.01 mm, and the shared points within 10 mm of the
  truth, the original's gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.config import SlamConfig as JCfg
from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu.ops import ba as j_ba
from slam_robot_tpu.ops import ba_cg as j_cg
from slam_robot_tpu.parallel import mesh as j_mesh
from slam_robot_tpu.parallel import multi_robot as j_mr
from slam_robot_tpu.parallel import sharded_ba as j_sba
from slam_robot_tpu.utils import synthetic as j_syn
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import localmap as t_lm
from slam_robot_tpu_torch.ops import ba as t_ba
from slam_robot_tpu_torch.ops import ba_cg as t_cg
from slam_robot_tpu_torch.parallel import mesh as t_mesh
from slam_robot_tpu_torch.parallel import multi_robot as t_mr
from slam_robot_tpu_torch.parallel import sharded_ba as t_sba

torch.set_num_threads(1)

CFG = JCfg(max_frames=16, max_points=64, max_obs=2048, max_obs_per_point=16)
MESH4 = t_mesh.make_mesh({"model": 4}, devices=["cpu"] * 4)
MESH1 = t_mesh.make_mesh({"model": 1}, devices=["cpu"])


@pytest.fixture(scope="module")
def mesh8():
    return j_mesh.make_mesh({"model": 8})


def _problem(pixel_noise=0.0, drop=0):
    """tests/test_parallel.py's window (8 frames, 30 points, 40 mm of point
    noise), the observation table cut to its filled rows (less ``drop``) so
    every shard holds some."""
    scene = j_syn.build_scene(CFG, n_frames=8, n_points=30, point_noise=40.0,
                              pixel_noise=pixel_noise)
    s = scene.state
    free, present = j_slam.window_masks(s, 4, 8)
    obs_ok = j_slam._obs_ok(s, s.n_frames - 8)
    O = int(s.n_obs) - drop
    jargs = (s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k, s.point_loc,
             s.point_uncertainty, s.obs_frame[:O], s.obs_point[:O], s.obs_px[:O], obs_ok[:O],
             present, free)
    return s, jargs, tuple(torch.as_tensor(np.array(a)) for a in jargs)


def _pos(loc):
    loc = np.asarray(loc)[:30]
    return loc[:, :3] / loc[:, 3:]


def _close(got, want, cost_rtol=1e-4, trans_mm=0.1, point_mm=1.0):
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=cost_rtol)
    np.testing.assert_allclose(np.asarray(got.frame_trans)[:8], np.asarray(want.frame_trans)[:8],
                               atol=trans_mm)
    np.testing.assert_allclose(_pos(got.point_loc), _pos(want.point_loc), atol=point_mm)


@pytest.mark.parametrize("drop", [0, 3])  # 3: a row count that needs padding
def test_cg_solve_sharded_matches(mesh8, drop):
    _, jargs, targs = _problem(pixel_noise=0.3, drop=drop)
    cfg = t_cg.CGConfig(max_free_frames=8)
    ref = t_cg.solve(*targs, cfg)
    shd = t_cg.solve_sharded(MESH4, *targs, cfg=cfg)
    assert len(t_mesh.ObsShards.split(MESH4.axis_devices("model"), *targs[6:10]).tables) == 4
    assert float(shd.cost) < 0.5 * float(shd.cost0)
    _close(shd, ref)
    jshd = j_cg.solve_sharded(mesh8, *jargs, cfg=j_cg.CGConfig(**cfg._asdict()))
    _close(shd, jshd)


def test_sharded_ba_matches(mesh8):
    s, jargs, targs = _problem()
    ref = t_ba.solve(*targs, t_ba.BAConfig())
    shd = t_sba.solve_sharded(MESH4, *targs, cfg=t_ba.BAConfig())
    jshd = j_sba.solve_sharded(mesh8, *jargs, cfg=j_ba.BAConfig())
    ts = bridge.from_numpy(s, "cpu")

    def reproj(res):
        st = ts._replace(frame_quat=torch.as_tensor(np.array(res.frame_quat)),
                         frame_trans=torch.as_tensor(np.array(res.frame_trans)),
                         point_loc=torch.as_tensor(np.array(res.point_loc)))
        return float(t_lm.reproject(st)[1])

    for other in (ref, jshd):
        assert bool(shd.ok) and bool(other.ok)
        np.testing.assert_allclose(shd.frame_trans[:8].numpy(),
                                   np.asarray(other.frame_trans)[:8], atol=1.0)
        assert abs(reproj(shd) - reproj(other)) < 0.1
    js = s._replace(frame_quat=jshd.frame_quat, frame_trans=jshd.frame_trans,
                    point_loc=jshd.point_loc)
    assert abs(float(j_lm.reproject(js)[1]) - reproj(jshd)) < 1e-4


@pytest.mark.parametrize("solver", ["ba", "ba_cg"])
def test_one_shard_is_the_unsharded_solve_bit_for_bit(solver):
    _, _, targs = _problem(pixel_noise=0.3)
    if solver == "ba":
        ref = t_ba.solve(*targs, t_ba.BAConfig())
        one = t_sba.solve_sharded(MESH1, *targs, cfg=t_ba.BAConfig())
    else:
        ref = t_cg.solve(*targs, t_cg.CGConfig(max_free_frames=8))
        one = t_cg.solve_sharded(MESH1, *targs, cfg=t_cg.CGConfig(max_free_frames=8))
    for name, a, b in zip(ref._fields, ref, one):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), name


def test_assemble_partials_match(mesh8):
    rng = np.random.default_rng(0)
    O, P_, W = 64, 10, 4
    r = rng.normal(size=(O, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=O).astype(np.float32)
    jf = rng.normal(size=(O, 2, 6)).astype(np.float32)
    jp = rng.normal(size=(O, 2, 4)).astype(np.float32)
    pidx = rng.integers(0, P_, size=O).astype(np.int32)
    slot = rng.integers(0, W + 2, size=O).astype(np.int32)  # W, W+1: dropped
    want = j_sba.assemble_partials(mesh8, *(jnp.asarray(a) for a in (r, w, jf, jp, pidx, slot)),
                                   P_, W)
    got = t_sba.assemble_partials(MESH4, *(torch.as_tensor(a) for a in (r, w, jf, jp, pidx, slot)),
                                  P_, W)
    for name, g, wt in zip(("hff", "bf", "c", "bp"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5, atol=1e-5, err_msg=name)


def test_multi_robot_shared_map_matches():
    sc0 = j_syn.build_scene(CFG, n_frames=6, n_points=25, seed=0)
    rng = np.random.default_rng(3)
    locs = sc0.state.point_loc.at[:25, :3].add(
        jnp.asarray(rng.normal(scale=60.0, size=(25, 3)).astype(np.float32)))
    s0 = sc0.state
    free0, present0 = j_slam.window_masks(s0, 4, 6)
    ok0 = j_slam._obs_ok(s0, s0.n_frames - 6)

    def st(a):
        return jnp.stack([a, a])

    jargs = (st(s0.frame_quat), st(s0.frame_trans), st(s0.frame_cam), s0.cam_k, locs,
             s0.point_uncertainty, st(s0.obs_frame), st(s0.obs_point), st(s0.obs_px), st(ok0),
             st(present0), st(free0))
    jfq, jft, jlocs = j_mr.solve_shared_map(*jargs, sweeps=8)
    tfq, tft, tlocs = t_mr.solve_shared_map(*(torch.as_tensor(np.array(a)) for a in jargs),
                                            sweeps=8)
    np.testing.assert_allclose(_pos(tlocs)[:25], _pos(jlocs)[:25], atol=0.05)
    np.testing.assert_allclose(tft.numpy(), np.asarray(jft), atol=0.01)
    np.testing.assert_allclose(tfq.numpy(), np.asarray(jfq), atol=1e-5)
    np.testing.assert_allclose(_pos(tlocs)[:25], np.asarray(sc0.true_points[:, :3]), atol=10.0)
