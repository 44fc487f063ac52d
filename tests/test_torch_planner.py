"""The port's Dubins planner (``models/planner``) against the JAX package's,
on the cases of tests/test_planner.py and 256 seeded (cpos, cdir, gpos,
gdir), negative angles included.

Tolerances:
- all 18 lengths atol 1e-4 m, the invalid (inf) types equal;
- the chosen type equal, except where the JAX package's two best lengths
  lie within 1e-4 m: several types often tie (a flipped or time-reversed
  variant traces the same curve), and float32 order decides among them;
- where the type is equal: the chosen path's dist atol 1e-4, kind and
  valid exact;
- ``interpolate_path`` on the same path: points atol 1e-4 m, masks equal;
  ``path_endpoint`` atol 1e-4 m / 1e-4 rad;
- ``mod2pi`` and ``modpi`` atol 1e-6 on negative and positive angles
  (floor modulo in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import planner as jp
from slam_robot_tpu_torch.models import planner as tp
from tests.test_planner import CASES

TIE = 1e-4


def _seeded(n=256, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.uniform(-8, 8, (n, 2)).astype(f), rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(f),
            rng.uniform(-8, 8, (n, 2)).astype(f), rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(f))


def _cases():
    c = np.array([c[0] for c in CASES], np.float32)
    cd = np.array([c[1] for c in CASES], np.float32)
    g = np.array([c[2] for c in CASES], np.float32)
    gd = np.array([c[3] for c in CASES], np.float32)
    return c, cd, g, gd


INPUTS = {"reference_cases": _cases, "seeded": _seeded}


def _jax_all(c, cd, g, gd):
    """The JAX package's 18 paths and lengths, by its own generate_mixed_path."""
    def one(c, cd, g, gd):
        def typ(i):
            p = jp.generate_mixed_path(c, cd, g, gd, i, jp.TURNING_RADIUS)
            return p, jnp.where(p.valid, jp.path_length(p), jnp.inf)
        return jax.vmap(typ)(jnp.arange(jp.N_TYPES))

    p, lengths = jax.jit(jax.vmap(one))(c, cd, g, gd)
    return jax.tree.map(np.asarray, p), np.asarray(lengths)


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _ties(lengths):
    s = np.sort(lengths, axis=1)
    return (s[:, 1] - s[:, 0]) < TIE


@pytest.mark.parametrize("which", INPUTS)
def test_all_18_lengths_match(which):
    c, cd, g, gd = INPUTS[which]()
    want_p, want = _jax_all(c, cd, g, gd)
    got_p, got = tp.all_paths(*_torch(c, cd, g, gd))
    got = got.numpy()
    assert got.shape == want.shape == (len(c), 18)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4)
    np.testing.assert_array_equal(got_p.valid.numpy(), want_p.valid)
    np.testing.assert_array_equal(got_p.kind.numpy(), want_p.kind)
    # every type's segments, valid or not, stay finite (the clamps on sdist)
    assert np.isfinite(got_p.dist.numpy()).all()
    np.testing.assert_allclose(got_p.dist.numpy(), want_p.dist, atol=1e-4)


@pytest.mark.parametrize("which", INPUTS)
def test_shortest_path_matches(which):
    c, cd, g, gd = INPUTS[which]()
    want = jax.vmap(jp.shortest_path)(c, cd, g, gd)
    _, lengths = _jax_all(c, cd, g, gd)
    got_p, got_len, got_type = tp.shortest_path(*_torch(c, cd, g, gd))
    np.testing.assert_allclose(got_len.numpy(), np.asarray(want[1]), atol=1e-4)
    same = got_type.numpy() == np.asarray(want[2])
    assert (same | _ties(lengths)).all(), np.nonzero(~same)
    np.testing.assert_allclose(got_p.dist.numpy()[same], np.asarray(want[0].dist)[same],
                               atol=1e-4)
    np.testing.assert_array_equal(got_p.kind.numpy()[same], np.asarray(want[0].kind)[same])
    np.testing.assert_array_equal(got_p.valid.numpy(), np.asarray(want[0].valid))


def test_ties_go_to_the_first_type():
    # goal straight ahead with the start's heading: LSL+ (type 0) and
    # other types tie at the straight line's length
    _, length, best = tp.shortest_path(torch.tensor([0.0, 0.0]), 0.0,
                                       torch.tensor([10.0, 0.0]), 0.0)
    _, lengths = tp.all_paths(torch.tensor([0.0, 0.0]), 0.0, torch.tensor([10.0, 0.0]), 0.0)
    first = int(torch.nonzero(lengths == lengths.min())[0, 0])
    assert int(best) == first
    np.testing.assert_allclose(float(length), 10.0, atol=1e-5)


@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("step,samples", [(0.25, 64), (0.1, 256)])
def test_interpolate_path_and_endpoint_match(which, step, samples):
    c, cd, g, gd = INPUTS[which]()
    jpath = jax.vmap(jp.shortest_path)(c, cd, g, gd)[0]
    want_pts, want_valid = jax.vmap(
        lambda c, cd, p: jp.interpolate_path(c, cd, p, step, samples_per_seg=samples))(
        c, cd, jpath)
    tpath = tp.Path(*_torch(*(np.asarray(x) for x in jpath)))
    got_pts, got_valid = tp.interpolate_path(*_torch(c, cd), tpath, step, samples_per_seg=samples)
    assert got_pts.shape == (len(c), 3 * samples + 1, 2)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), atol=1e-4)
    want_end = jax.vmap(jp.path_endpoint)(c, cd, jpath)
    got_end = tp.path_endpoint(*_torch(c, cd), tpath)
    np.testing.assert_allclose(got_end[0].numpy(), np.asarray(want_end[0]), atol=1e-4)
    np.testing.assert_allclose(got_end[1].numpy(), np.asarray(want_end[1]), atol=1e-4)


@pytest.mark.parametrize("cpos,cdir,gpos,gdir", CASES)
def test_port_path_reaches_goal(cpos, cdir, gpos, gdir):
    p, length, _ = tp.shortest_path(torch.tensor(cpos), float(cdir), torch.tensor(gpos),
                                    float(gdir))
    assert bool(p.valid) and np.isfinite(float(length))
    pos, direction = tp.path_endpoint(torch.tensor(cpos), float(cdir), p)
    assert float(torch.linalg.norm(pos - torch.tensor(gpos))) < 0.05
    assert abs(float(tp.modpi(direction - float(gdir)))) < 0.05


def test_mod2pi_and_modpi_on_negative_angles():
    x = np.concatenate([np.linspace(-20, 20, 2001), [-np.pi, -2 * np.pi, -1e-7, -6.3]])
    x = x.astype(np.float32)
    got2, gotpi = tp.mod2pi(torch.as_tensor(x)).numpy(), tp.modpi(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got2, np.asarray(jp.mod2pi(x)), atol=1e-6)
    np.testing.assert_allclose(gotpi, np.asarray(jp.modpi(x)), atol=1e-6)
    assert (got2 >= 0).all()
    # truncated modulo would differ on every negative angle
    neg = x < -1e-3
    assert not np.allclose(torch.fmod(torch.as_tensor(x), 2 * np.pi).numpy()[neg], got2[neg])


@pytest.mark.parametrize("prim", ["_lsl", "_lsr", "_lrl"])
@pytest.mark.parametrize("parity", [1.0, -1.0])
def test_primitives_match_and_stay_finite(prim, parity):
    c, cd, g, gd = _seeded(seed=5)
    want = jax.vmap(lambda c, cd, g, gd: getattr(jp, prim)(
        c, cd, g, gd, jnp.float32(parity), jp.TURNING_RADIUS))(c, cd, g, gd)
    got = getattr(tp, prim)(*_torch(c, cd, g, gd), torch.tensor(parity), tp.TURNING_RADIUS)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < got.valid.sum() < len(c) or prim == "_lsl"
    assert np.isfinite(got.dist.numpy()).all()
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), atol=1e-4)
    np.testing.assert_array_equal(got.kind.expand_as(got.dist).numpy(), np.asarray(want.kind))
