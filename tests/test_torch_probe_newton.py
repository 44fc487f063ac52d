"""The port's Newton probes (``slam_robot_tpu_torch.tools.probe_newton_*``,
the kernel's plain version on the CPU) against the JAX package's
``tools/probe_newton_bisect.py`` and ``tools/probe_newton_kernel.py``,
which run unchanged under ``pltpu.force_tpu_interpret_mode()``.

Both sides take the same arrays, made with numpy from a seed (the probes'
shapes: 256 lanes of uniform 32x32 windows and 13x13 references, every
lane at (9.3, 9.3), unit weights; and, for every stage, lanes spread over
the window and past its edges with the tracker's radial weights,
``probe_newton_kernel.edge_inputs``). The port writes the score's gradient
and Hessian out by hand; the probes take them by autodiff. Tolerances: the
stages atol 1e-4 (sums of 169 terms in another order on scores near 20;
measured 3.1e-5 at most, on jvp; 3.8e-5 on extract at the edges, scores
up to 60); the six Newton steps atol 2e-3 px, kernel B1's (measured 9.5e-7
px; 1.9e-6 at the edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
from slam_robot_tpu_torch.tools import probe_newton_kernel as t_nk
from tools import probe_newton_bisect as j_nb
from tools import probe_newton_kernel as j_nk

torch.set_num_threads(1)


def _inputs(seed=0):
    return [a.numpy() for a in t_nk.inputs(torch.device("cpu"), seed)]


@pytest.mark.parametrize("stage", ["extract", "grad", "jvp", "fori_grad"])
def test_bisect_stage_matches_jax(stage):
    arrays = _inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_nb.run(stage, *[jnp.asarray(a) for a in arrays]))
    got = pn.probe_newton(*[torch.as_tensor(a) for a in arrays], pn.STAGES[stage]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_newton_skeleton_matches_jax(seed):
    arrays = _inputs(seed)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_nk.run(*[jnp.asarray(a) for a in arrays]))
    got = pn.probe_newton(*[torch.as_tensor(a) for a in arrays], pn.NEWTON).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(got - arrays[1]).max() > 0.1  # the lanes moved


def test_hand_derived_terms_match_torch_autodiff():
    """The plain version's closed-form g and H against the tools' autodiff
    reference (the probes' method, in torch) on smooth windows too."""
    win, pos, ref, wmask = t_nk.inputs(torch.device("cpu"), 2)
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16
    smooth = torch.nn.functional.conv2d(win[:, None], (k[:, None] * k[None])[None, None],
                                        padding=2)[:, 0]
    for w in (win, smooth.contiguous()):
        for stage in (pn.GRAD, pn.JVP, pn.NEWTON):
            got = pn.probe_newton_plain(w, pos, ref, wmask, stage)
            want = t_nk.autodiff(w, pos, ref, wmask, stage)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("stage", ["extract", "grad", "jvp", "fori_grad", "newton"])
def test_stage_at_the_window_edges_matches_jax(stage):
    """Lanes spread over the window and past its edges (floors -6 to 25 on
    each axis: part of an edge lane's patch lies outside the window and its
    taps read 0) with the tracker's radial weights, through the JAX probes
    in interpret mode and the port's plain version, at the file's
    tolerances."""
    arrays = [a.numpy() for a in t_nk.edge_inputs(torch.device("cpu"), 3)]
    floors = np.floor(arrays[1])
    assert floors.min() == -6 and floors.max() == 25
    assert np.unique(arrays[3]).size > 1
    jax_args = [jnp.asarray(a) for a in arrays]
    with pltpu.force_tpu_interpret_mode():
        if stage == "newton":
            want = np.asarray(j_nk.run(*jax_args))
        else:
            want = np.asarray(j_nb.run(stage, *jax_args))
    got = pn.probe_newton(*[torch.as_tensor(a) for a in arrays], pn.STAGES[stage]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3 if stage == "newton" else 1e-4)
