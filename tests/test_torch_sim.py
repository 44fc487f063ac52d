"""The port's closed loop (``models/sim``, ``parallel/mesh``,
``parallel/rollouts``) against the JAX package's, on the CPU.

Tolerances:
- ``camera_pose``: q atol 1e-6, t atol 1e-4 mm (one float32 product each);
- ``pure_pursuit`` on seeded states: speed, turn and distance atol 1e-5;
- ``rollout`` step by step: from each of the JAX package's own states of
  the 64 seed-0 goals over 300 steps, the port's next state atol 1e-5.
  In both comparisons a state may differ only where a float32 near-tie
  decides the JAX package's commands (its near-equal choices steer apart:
  Dubins types within 1e-4 m of the shortest, pursuit samples within 1e-4
  of the best score, turns more than 1e-4 apart; or the goal within 1e-4 m
  of the stop radius), and such states may be at most 2 % of all;
- the 64-goal fleet (300 steps): reached count within 1 goal and median
  final distance within 0.01 m of the JAX package's (which reads 42 and
  0.1736 m on the CPU);
- ``rollout_slam`` at ``run_sim``'s config for 4 steps: trajectory atol
  1e-4 m, estimates atol 1 mm, final distance atol 1e-3 m (JAX: 3.4817 m,
  last estimate [150, 0, 0] mm). Longer loops are not compared: from the
  fifth frame the BA windows run to their iteration cap in both packages
  and one step from the same state already differs by millimetres.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam_robot_tpu.config import SlamConfig as JSlamConfig
from slam_robot_tpu.models import planner as jp
from slam_robot_tpu.models import sim as jsim
from slam_robot_tpu.models import vehicle as jv
from slam_robot_tpu.parallel import mesh as j_mesh
from slam_robot_tpu.parallel import rollouts as j_rollouts
from slam_robot_tpu.utils import synthetic as j_synthetic
from slam_robot_tpu_torch import SlamConfig
from slam_robot_tpu_torch.models import sim as tsim
from slam_robot_tpu_torch.models import vehicle as tv
from slam_robot_tpu_torch.parallel import mesh as t_mesh
from slam_robot_tpu_torch.parallel import rollouts as t_rollouts
from slam_robot_tpu_torch.run_sim import SLAM_LOOP, goal_batch

torch.set_num_threads(2)

N_GOALS, N_STEPS = 64, 300
TIE = 1e-4
# run_sim --slam's config, as the JAX CLI writes it (slam_robot_tpu/run_sim.py:44-50)
SLAM_KW = dict(image_width=160, image_height=120, pyramid_depth=4, levels_unsure=4,
               max_features=96, max_corners=48, min_matches=12, max_frames=64,
               max_points=384, max_obs=8192, max_obs_per_point=16, ba_max_iters=10,
               window_obs=2048)


def _jax_goals(n, seed=0):
    # the JAX CLI's draw, inline (slam_robot_tpu/run_sim.py:65-70)
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(2, 7, (n, 2)), rng.uniform(-3.14, 3.14, (n, 1))],
                          axis=1).astype(np.float32)


def test_goal_batch_is_the_jax_cli_draw():
    np.testing.assert_array_equal(goal_batch(N_GOALS, 0), _jax_goals(N_GOALS, 0))
    np.testing.assert_array_equal(goal_batch(8, 3), _jax_goals(8, 3))


@jax.jit
def _jax_decision_ties(pos, heading, goal):
    """Per state, with the JAX package's own functions: whether a float32
    near-tie decides its commands. Among the Dubins types within TIE m of
    the shortest and, on each, the samples within TIE of its best pursuit
    score, the turn commands span more than TIE; or the distance to the goal
    lies within TIE of the 0.3 m stop radius. (Many states tie between types
    that trace one curve; those steer alike and do not count.) The scoring
    is the JAX package's pure_pursuit (slam_robot_tpu/models/sim.py:48-67),
    which exposes no per-sample scores, rebuilt from its planner; the port's
    counterpart is ``sim.pursuit_samples``, which the comparisons below hold
    to it."""
    def one(pos, heading, goal):
        def typ(i):
            p = jp.generate_mixed_path(pos, heading, goal[:2], goal[2], i)
            length = jnp.where(p.valid, jp.path_length(p), jnp.inf)
            pts, valid = jp.interpolate_path(pos, heading, p, 0.25, samples_per_seg=64)
            to = pts - pos[None, :]
            d = jnp.linalg.norm(to, axis=1)
            score = jnp.where(valid & (d > 0.05), -jnp.abs(d - 1.0), -1e9)
            turn = jnp.clip(jp.modpi(jnp.arctan2(to[:, 1], to[:, 0]) - heading) / 0.45, -1, 1)
            return length, score, turn
        length, score, turn = jax.vmap(typ)(jnp.arange(jp.N_TYPES))
        cand = ((length - length.min()) <= TIE)[:, None] & (
            score >= score.max(axis=1, keepdims=True) - TIE)
        span = jnp.max(jnp.where(cand, turn, -jnp.inf)) - jnp.min(jnp.where(cand, turn, jnp.inf))
        stop = jnp.abs(jnp.linalg.norm(goal[:2] - pos) - 0.3) < TIE
        return (span > TIE) | stop
    return jax.vmap(one)(pos, heading, goal)


def _ties(pos, heading, goals, chunk=2400):
    out = []
    for i in range(0, len(pos), chunk):
        n = min(chunk, len(pos) - i)
        pad = lambda a: np.concatenate([a[i:i + n], a[:chunk - n]])  # noqa: E731 (one shape)
        out.append(np.asarray(_jax_decision_ties(pad(pos), pad(heading), pad(goals)))[:n])
    return np.concatenate(out)


def _assert_close_but_ties(got, want, ties, atol):
    """``got`` within ``atol`` of ``want`` on every state (axis 0) but
    near-ties, which may differ on at most 2 % of the states."""
    bad = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(ties), -1).max(-1) > atol
    assert not (bad & ~ties).any(), np.nonzero(bad & ~ties)
    assert bad.mean() <= 0.02, bad.mean()
    return bad


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's rollouts of the 64 seed-0 goals: every state, the
    commands taken from it and the next state, then rollout's own result."""
    goals = _jax_goals(N_GOALS)

    def states(goal):
        def step(vs, _):
            speed, turn, dist = jsim.pure_pursuit(vs, goal)
            nvs = jv.step(vs, speed, turn, 0.1)
            return nvs, (vs, (speed, turn, dist), nvs)
        return jax.lax.scan(step, jv.init_state(), None, length=N_STEPS)[1]

    vs, cmd, nvs = jax.jit(jax.vmap(states))(goals)
    traj, dist = jax.jit(jax.vmap(lambda g: jsim.rollout(g, n_steps=N_STEPS)))(goals)
    # the scan above is rollout's own loop
    np.testing.assert_array_equal(np.asarray(nvs.pos), np.asarray(traj))
    return goals, jax.tree.map(np.asarray, (vs, cmd, nvs)), np.asarray(dist)


def test_camera_pose_matches():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-5, 5, (256, 2)).astype(np.float32)
    heading = rng.uniform(-2 * np.pi, 2 * np.pi, 256).astype(np.float32)
    want_q, want_t = jax.vmap(lambda p, h: jsim.camera_pose(jv.VehicleState(p, h, 0.0)))(
        pos, heading)
    q, t = tsim.camera_pose(tv.VehicleState(torch.tensor(pos), torch.tensor(heading),
                                            torch.zeros(256)))
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), atol=1e-4)
    # heading 0 looks along world +X, heading pi/2 along +Z
    from slam_robot_tpu_torch.ops import quaternion as quat

    for h, fwd in ((0.0, [1.0, 0.0, 0.0]), (np.pi / 2, [0.0, 0.0, 1.0])):
        q, _ = tsim.camera_pose(tv.init_state(heading=h, device="cpu"))
        got = quat.rotate_inverse(q, torch.tensor([0.0, 0.0, 1.0]))
        np.testing.assert_allclose(got.numpy(), fwd, atol=1e-6)


def test_pure_pursuit_matches_on_seeded_states():
    rng = np.random.default_rng(4)
    n = 512
    pos = rng.uniform(-2, 8, (n, 2)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    speed = rng.uniform(0, 1, n).astype(np.float32)
    goals = _jax_goals(n, 7)
    goals[:16, :2] = pos[:16] + rng.uniform(-0.3, 0.3, (16, 2))   # within the stop radius
    want = jax.vmap(lambda p, h, s, g: jsim.pure_pursuit(jv.VehicleState(p, h, s), g))(
        pos, heading, speed, goals)
    got = tsim.pure_pursuit(tv.VehicleState(torch.tensor(pos), torch.tensor(heading),
                                            torch.tensor(speed)), torch.tensor(goals))
    ties = _ties(pos, heading, goals)
    for g, w in zip(got, want):
        _assert_close_but_ties(g.numpy(), w, ties, 1e-5)
    assert (got[0].numpy()[:16] == 0).any()


def test_rollout_step_by_step_on_jax_states(jax_fleet):
    goals, (vs, cmd, nvs), _ = jax_fleet
    flat = lambda a: a.reshape(N_GOALS * N_STEPS, *a.shape[2:])  # noqa: E731
    g = np.repeat(goals[:, None], N_STEPS, axis=1)
    state = tv.VehicleState(*(torch.tensor(flat(x)) for x in vs))
    speed, turn, dist = tsim.pure_pursuit(state, torch.tensor(flat(g)))
    got = tv.step(state, speed, turn, 0.1)
    ties = _ties(flat(vs.pos), flat(vs.heading), flat(g))
    bad = np.zeros(len(ties), bool)
    for a, b in zip(got, nvs):
        bad |= _assert_close_but_ties(a.numpy(), flat(b), ties, 1e-5)
    assert bad.mean() <= 0.02
    np.testing.assert_allclose(dist.numpy(), flat(cmd[2]), atol=1e-5)
    np.testing.assert_allclose(speed.numpy(), flat(cmd[0]), atol=1e-5)


def test_fleet_summary_matches_jax(jax_fleet):
    goals, _, want = jax_fleet
    traj, dist = tsim.rollout(torch.tensor(goals), n_steps=N_STEPS)
    assert traj.shape == (N_GOALS, N_STEPS, 2) and dist.shape == (N_GOALS,)
    d = dist.numpy()
    assert np.isfinite(d).all() and np.isfinite(traj.numpy()).all()
    assert abs(int((d < 0.5).sum()) - int((want < 0.5).sum())) <= 1
    assert abs(float(np.median(d)) - float(np.median(want))) <= 0.01


def test_rollout_single_goal_and_device_default():
    traj, dist = tsim.rollout(torch.tensor([4.0, 3.0, 0.0]), n_steps=400)
    assert traj.shape == (400, 2) and float(dist) < 0.5
    traj, dist = tsim.rollout([4.0, 3.0, 0.0], n_steps=5, device="cpu")
    assert traj.shape == (5, 2)


class _HostReads(TorchDispatchMode):
    """Records every op that reads a value back to the host or whose output
    shape depends on the data (a sync on a CUDA device)."""

    READS = ("_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "item",
             "_unique", "unique_dim", "_unique2", "equal")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name.split("::")[-1] in self.READS:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_rollout_reads_nothing_back():
    goals = torch.tensor(_jax_goals(8))
    with _HostReads() as mode:
        traj, dist = tsim.rollout(goals, n_steps=6)
    assert mode.seen == [] and traj.shape == (8, 6, 2)
    # the recorder sees a read
    with _HostReads() as mode:
        bool(dist.sum() > 0)
    assert mode.seen


def test_make_world_matches():
    want = jsim.make_world(400, seed=0)
    got = tsim.make_world(400, seed=0, device="cpu")
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.brightness.numpy(), np.asarray(want.brightness))


def test_rollout_slam_matches_jax_at_four_steps():
    jcfg = JSlamConfig(**SLAM_KW)
    cfg = SlamConfig(**SLAM_KW)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert SLAM_LOOP == SLAM_KW
    k = j_synthetic.reference_intrinsics(jcfg)
    goal = np.array([3.0, 2.0, 0.0], np.float32)
    jt, je, jd = jsim.rollout_slam(jnp.asarray(goal), jsim.make_world(400, seed=0), jcfg,
                                   [k, k], n_steps=4)
    world = tsim.make_world(400, seed=0, device="cpu")
    seen = []
    tt, te, td = tsim.rollout_slam(torch.tensor(goal), world, cfg, [k, k], n_steps=4,
                                   on_step=lambda i, vs, ps: seen.append(i))
    assert seen == [0, 1, 2, 3]
    assert tt.shape == (4, 2) and te.shape == (4, 3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1.0)
    np.testing.assert_allclose(float(td), float(jd), atol=1e-3)


def test_fleet_on_a_one_device_mesh_is_the_batch():
    goals = torch.tensor(_jax_goals(8))
    m = t_mesh.make_mesh(devices=["cpu"])
    assert m.shape == {"data": 1}
    traj, dist = t_rollouts.fleet(m, goals, n_steps=40)
    want_traj, want_dist = tsim.rollout(goals, n_steps=40)
    assert torch.equal(traj, want_traj) and torch.equal(dist, want_dist)


def test_fleet_splits_over_the_data_axis_like_jax():
    """64 goals over two chunks of a 2x2 mesh against the JAX fleet on the
    8-device CPU mesh: the fleet summary's tolerances (per-rollout paths
    part at near-ties, and the 8-device CPU build of XLA orders float32
    sums differently again)."""
    goals = _jax_goals(N_GOALS)
    jm = j_mesh.make_mesh({"data": 8}, jax.devices()[:8])
    _, want = j_rollouts.fleet(jm, jnp.asarray(goals), n_steps=N_STEPS)
    want = np.asarray(want)
    m = t_mesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    traj, dist = t_rollouts.fleet(m, goals, n_steps=N_STEPS)
    assert traj.shape == (N_GOALS, N_STEPS, 2)
    d = dist.numpy()
    assert abs(int((d < 0.5).sum()) - int((want < 0.5).sum())) <= 1
    assert abs(float(np.median(d)) - float(np.median(want))) <= 0.01


def test_mesh_and_fleet_checks():
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        t_mesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 3)
    m = t_mesh.make_mesh({"data": 3}, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split"):
        t_rollouts.fleet(m, torch.tensor(_jax_goals(8)), n_steps=2)
