"""Blur/pyrDown (kernel B2's plain version) and build_pyramid of the PyTorch
port against the JAX package: the Pallas kernel in interpret mode and the
XLA convolutions of ``ops/pyramid``.

Tolerance 1e-5, as tests/test_pallas_kernels.py holds the Pallas kernel to
the XLA path: five-tap float32 sums in another order. The flat pyramid
(``blur.pyramid_flat``'s plain version, what ``build_pyramid`` runs on the
CPU) is held to the JAX ``build_pyramid`` on every element, the edge
padding and the zero region included, down to levels of one pixel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.ops.pallas import blur as j_blur
from slam_robot_tpu_torch.ops import pyramid as t_pyr
from slam_robot_tpu_torch.ops.cuda import blur as t_blur

torch.set_num_threads(1)

SHAPES = [(48, 64), (47, 63), (15, 20), (3, 5), (480, 640)]


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_matches_jax(shape):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=shape).astype(np.float32)
    got = t_pyr.blur(torch.as_tensor(img), 1.1).numpy()
    want_xla = np.asarray(j_pyr.blur(jnp.asarray(img), 1.1))
    np.testing.assert_allclose(got, want_xla, atol=1e-5)
    if shape[0] * shape[1] <= 48 * 64:  # interpret mode is slow at 480x640
        want_pallas = np.asarray(j_blur.blur(jnp.asarray(img), 1.1, interpret=True))
        np.testing.assert_allclose(got, want_pallas, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_pyr_down_matches_jax(shape):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=shape).astype(np.float32)
    got = t_pyr.pyr_down(torch.as_tensor(img)).numpy()
    want = np.asarray(j_pyr.pyr_down(jnp.asarray(img)))
    assert got.shape == want.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if shape[0] * shape[1] <= 48 * 64:
        want_pallas = np.asarray(j_blur.pyr_down(jnp.asarray(img), interpret=True))
        np.testing.assert_allclose(got, want_pallas, atol=1e-5)


def test_gaussian_weights_match():
    for sigma in (1.1, 0.8):
        np.testing.assert_allclose(t_pyr.gaussian_kernel(sigma),
                                   np.asarray(j_pyr.gaussian_kernel(sigma)), rtol=1e-6)


def test_build_pyramid_matches_jax():
    rng = np.random.default_rng(2)
    img = (rng.uniform(size=(120, 160, 3)) * 255).astype(np.uint8)
    want = j_pyr.build_pyramid(jnp.asarray(img), depth=4)
    got = t_pyr.build_pyramid(torch.as_tensor(img), depth=4)
    assert got.depth == want.depth == 4
    np.testing.assert_array_equal(got.heights.numpy(), np.asarray(want.heights))
    np.testing.assert_array_equal(got.widths.numpy(), np.asarray(want.widths))
    assert got.data.shape == want.data.shape
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), atol=1e-5)


def test_sep5_rejects_bad_input():
    with pytest.raises(ValueError):
        t_blur.sep5(torch.zeros((2, 8)), t_blur.PYRDOWN_WEIGHTS, 1)
    with pytest.raises(ValueError):
        t_blur.sep5(torch.zeros((8, 8)), t_blur.PYRDOWN_WEIGHTS, 3)


@pytest.mark.parametrize("shape", [(480, 640), (47, 63), (6, 8)])
def test_plain_flat_pyramid_matches_jax(shape):
    rng = np.random.default_rng(3)
    grey = rng.uniform(size=shape).astype(np.float32)
    want = j_pyr.build_pyramid(jnp.asarray(grey), depth=6)
    got = t_blur.pyramid_flat_plain(torch.as_tensor(grey), 6)
    assert got.shape == want.data.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), atol=1e-5)
    # the zero region is exactly zero on both sides
    zero = np.asarray(want.data) == 0.0
    assert zero.any() and (got.numpy()[zero] == 0.0).all()
    pyr = t_pyr.build_pyramid(torch.as_tensor(grey), depth=6)
    assert torch.equal(pyr.data, got)
    np.testing.assert_array_equal(pyr.heights.numpy(), np.asarray(want.heights))
    np.testing.assert_array_equal(pyr.widths.numpy(), np.asarray(want.widths))


@pytest.mark.parametrize("shape", [(2, 2), (1, 1), (1, 5), (2, 7)])
def test_sep5_plain_reflects_tiny_levels_like_jax(shape):
    """Levels of one or two pixels reflect with numpy's period 2(n-1)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(size=shape).astype(np.float32)
    got = t_blur.sep5_plain(torch.as_tensor(img), t_blur.gaussian_weights(0.8))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_pyr.blur(jnp.asarray(img), 0.8)),
                               atol=1e-6)
    got = t_blur.sep5_plain(torch.as_tensor(img), t_blur.PYRDOWN_WEIGHTS, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_pyr.pyr_down(jnp.asarray(img))),
                               atol=1e-6)


def test_flat_pyramid_route_is_parameterised_by_its_pass():
    """pyramid_flat_plain with the sep5 wrapper (its plain version on CPU
    tensors) is the plain pyramid exactly; sep5 refuses levels under 3."""
    rng = np.random.default_rng(5)
    grey = torch.as_tensor(rng.uniform(size=(60, 82)).astype(np.float32))
    a = t_blur.pyramid_flat_plain(grey, 5)
    b = t_blur.pyramid_flat_plain(grey, 5, sep=t_blur.sep5)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        t_blur.pyramid_flat_plain(grey[:8, :8], 4, sep=t_blur.sep5)
