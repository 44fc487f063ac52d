"""Kernel B1's plain version (``ops/cuda/newton.newton_window_steps``) against
the JAX package's ``newton_level`` on the same seeded windows.

F = 37 lanes with some inactive, some pushed out of bounds, and the depth-6
pyramid's coarsest 31x32 window. Tolerance: pos atol 1e-4 px (both sides
run the same six float32 Newton iterations; the sums over 169 pixels are
taken in another order, and the JAX side resamples by banded matmuls);
status must be equal. The same holds for ``group`` 2 and 4 (F = 36), where
the port's result must also equal its own ``group=1`` result exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.ops import patch as j_patch
from slam_robot_tpu.ops.pallas import newton as j_newton
from slam_robot_tpu_torch.ops import patch as t_patch
from slam_robot_tpu_torch.ops.cuda import newton as t_newton
from tests.test_torch_cuda_kernels import ORDER, make_newton_case as make_case

torch.set_num_threads(1)


@pytest.mark.parametrize("wh,ww", [(32, 32), (31, 32), (26, 31)])
def test_plain_newton_matches_jax(wh, ww):
    case = make_case(wh * 100 + ww, wh, ww)
    want_pos, want_st = j_newton.newton_level(
        *[jnp.asarray(case[k]) for k in ORDER], threshold=1e-3, max_iters=6, backend="xla")
    got_pos, got_st = t_newton.newton_level(
        *[torch.as_tensor(case[k]) for k in ORDER], threshold=1e-3, max_iters=6)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=1e-4)
    st = got_st.numpy()
    assert (st == 2.0).any() and (st == 0.0).any()
    inactive = case["active"] < 0.5
    assert inactive.any()
    np.testing.assert_array_equal(got_pos.numpy()[inactive], case["pos0"][inactive])


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_newton_matches_jax(group):
    """``group`` G: the JAX function's lanes-per-MXU-op layout against the
    port, which runs every G as G = 1; same tolerances. F = 36 lanes (the
    JAX layout needs F % G == 0)."""
    case = {k: (v[:36] if k != "wmask" else v) for k, v in make_case(5, 32, 32).items()}
    want_pos, want_st = j_newton.newton_level(
        *[jnp.asarray(case[k]) for k in ORDER], threshold=1e-3, max_iters=6,
        backend="xla", group=group)
    got_pos, got_st = t_newton.newton_level(
        *[torch.as_tensor(case[k]) for k in ORDER], threshold=1e-3, max_iters=6,
        group=group)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=1e-4)
    one_pos, one_st = t_newton.newton_level(
        *[torch.as_tensor(case[k]) for k in ORDER], threshold=1e-3, max_iters=6)
    assert torch.equal(got_pos, one_pos) and torch.equal(got_st, one_st)


def test_plain_newton_matches_pallas_interpret():
    case = make_case(7, 31, 32)
    want_pos, want_st = j_newton.newton_level(
        *[jnp.asarray(case[k]) for k in ORDER], threshold=1e-3, max_iters=6,
        backend="interpret")
    got_pos, got_st = t_newton.newton_level(
        *[torch.as_tensor(case[k]) for k in ORDER], threshold=1e-3, max_iters=6)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=1e-4)


def test_radial_mask_matches():
    np.testing.assert_array_equal(t_patch.radial_mask(13, 15.0).numpy(),
                                  np.asarray(j_patch.radial_mask(13, 15.0)))
