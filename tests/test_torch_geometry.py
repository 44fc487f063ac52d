"""The PyTorch port's geometry (quaternion, projection, epipolar) against the
JAX package on the same seeded inputs.

Tolerance 1e-5 (relative, with a small absolute floor): both sides compute
the same float32 formulas; only the order of a few sums may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.ops import epipolar as j_epi
from slam_robot_tpu.ops import projection as j_proj
from slam_robot_tpu.ops import quaternion as j_quat
from slam_robot_tpu_torch.ops import epipolar as t_epi
from slam_robot_tpu_torch.ops import projection as t_proj
from slam_robot_tpu_torch.ops import quaternion as t_quat

torch.set_num_threads(1)

N = 64


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def t(a):
    return torch.as_tensor(np.array(a))


def unit_quats(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["multiply", "rotate", "to_matrix", "retract",
                                "exp_map", "angle_between", "conjugate"])
def test_quaternion_ops_match(fn):
    rng = np.random.default_rng(0)
    a, b = unit_quats(rng), unit_quats(rng)
    v = rng.normal(scale=100.0, size=(N, 3)).astype(np.float32)
    d = rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    d[:4] = 0.0  # the identity-safe branch of exp_map
    args = {
        "multiply": (a, b), "rotate": (a, v), "to_matrix": (a,), "retract": (a, d),
        "exp_map": (d,), "angle_between": (a, b), "conjugate": (a,),
    }[fn]
    want = getattr(j_quat, fn)(*[jnp.asarray(x) for x in args])
    got = getattr(t_quat, fn)(*[t(x) for x in args])
    close(got, want, atol=2e-5)


def intrinsics(rng, n=N):
    k = np.zeros((n, 7), np.float32)
    k[:, :3] = rng.normal(scale=0.05, size=(n, 3))
    k[:, 3] = 416.0
    k[:, 4] = -416.0  # the reference's y-flip
    k[:, 5:] = [320.0, 240.0]
    return k


def test_projection_matches():
    rng = np.random.default_rng(1)
    q = unit_quats(rng)
    tr = rng.normal(scale=200.0, size=(N, 3)).astype(np.float32)
    k = intrinsics(rng)
    pts = np.concatenate([rng.normal(scale=1500.0, size=(N, 3)),
                          rng.uniform(0.5, 1.5, size=(N, 1))], 1).astype(np.float32)
    want_px, want_ok = j_proj.project_point(*map(jnp.asarray, (q, tr, k, pts)))
    got_px, got_ok = t_proj.project_point(*map(t, (q, tr, k, pts)))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert 0 < ok.sum() < N  # both sides of the cheirality gate
    close(got_px.numpy()[ok], np.asarray(want_px)[ok], atol=1e-3, rtol=1e-5)

    px = rng.uniform([0, 0], [640, 480], size=(N, 2)).astype(np.float32)
    close(t_proj.pixel_to_plane(t(px), t(k)), j_proj.pixel_to_plane(jnp.asarray(px), jnp.asarray(k)))
    plane = np.asarray(j_proj.pixel_to_plane(jnp.asarray(px), jnp.asarray(k)))
    close(t_proj.plane_to_pixel(t(plane), t(k)),
          j_proj.plane_to_pixel(jnp.asarray(plane), jnp.asarray(k)), atol=1e-3)
    depth = rng.uniform(500.0, 5000.0, size=(N,)).astype(np.float32)
    close(t_proj.unproject(t(q), t(tr), t(plane), t(depth)),
          j_proj.unproject(jnp.asarray(q), jnp.asarray(tr), jnp.asarray(plane), jnp.asarray(depth)))
    close(t_proj.point_position(t(pts)), j_proj.point_position(jnp.asarray(pts)), atol=1e-3)


def test_epipolar_matches():
    rng = np.random.default_rng(2)
    q1, q2 = unit_quats(rng), unit_quats(rng)
    t1 = rng.normal(scale=100.0, size=(N, 3)).astype(np.float32)
    t2 = rng.normal(scale=100.0, size=(N, 3)).astype(np.float32)
    h1 = rng.normal(scale=0.5, size=(N, 2)).astype(np.float32)
    h2 = rng.normal(scale=0.5, size=(N, 2)).astype(np.float32)
    close(t_epi.essential_matrix(*map(t, (q1, t1, q2, t2))),
          j_epi.essential_matrix(*map(jnp.asarray, (q1, t1, q2, t2))))
    close(t_epi.epipolar_residual_frames(*map(t, (q1, t1, q2, t2, h1, h2))),
          j_epi.epipolar_residual_frames(*map(jnp.asarray, (q1, t1, q2, t2, h1, h2))))
    close(t_epi.skew(t(t1)), j_epi.skew(jnp.asarray(t1)))
