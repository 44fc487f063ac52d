"""The port's Shi-Tomasi detector and occupancy grid against the JAX package.

The corner SETS must be identical (same pixels, same order, same validity):
candidates are integer pixel positions, so only a response tie broken in
another order could move one, and the response maps agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import torch

from slam_robot_tpu.ops import corners as j_c
from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu_torch.ops import corners as t_c

torch.set_num_threads(1)


def texture(seed, h=120, w=160):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(h, w)).astype(np.float32)
    return np.asarray(j_pyr.blur(jnp.asarray(img), 1.5))


def test_min_eig_response_matches():
    img = texture(0)
    np.testing.assert_allclose(t_c.min_eig_response(torch.as_tensor(img)).numpy(),
                               np.asarray(j_c.min_eig_response(jnp.asarray(img))),
                               atol=1e-6)


def test_detect_identical_corner_sets():
    for seed, (mc, md) in enumerate([(48, 8.0), (120, 20.0), (30, 5.0)]):
        img = texture(seed + 1)
        jp, jv = j_c.detect(jnp.asarray(img), mc, 0.01, md)
        tp, tv = t_c.detect(torch.as_tensor(img), mc, 0.01, md)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tv.numpy().sum() > 5


def test_occupancy_and_suppression_match():
    rng = np.random.default_rng(7)
    n = 40
    px = rng.uniform([-10, -10], [170, 130], size=(n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.3
    jo = j_c.occupancy_grid(jnp.asarray(px), jnp.asarray(valid), 160, 120, 30)
    to = t_c.occupancy_grid(torch.as_tensor(px), torch.as_tensor(valid), 160, 120, 30)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    cand = rng.uniform([0, 0], [160, 120], size=(64, 2)).astype(np.float32)
    cval = rng.uniform(size=64) > 0.2
    js = j_c.suppress_by_grid(jnp.asarray(cand), jnp.asarray(cval), jo, 160, 120, 30)
    ts = t_c.suppress_by_grid(torch.as_tensor(cand), torch.as_tensor(cval), to, 160, 120, 30)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
