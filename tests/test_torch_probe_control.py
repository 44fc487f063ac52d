"""The arithmetic that ``csrc/probe_control.cu`` rests on, on the CPU.

The kernel does not run the probes' loop ``while it < 5 and not
all(done)``: each element takes its own steps v_k = v_(k-1) + 0.5 and
finds n, the first k in 1..5 with v_k > 2.4 (6 if none; ROW_DONE takes its
row's n, from column 0), the block takes T = min(5, max n), and the element
ends at v_min(n, T). :func:`claim` writes that in numpy. It is held here
against the JAX package's probes (``tools/probe_mosaic.py`` p5,
``tools/probe_mosaic2.py`` g, ``tools/probe_mosaic3.py`` l, run unchanged
under ``pltpu.force_tpu_interpret_mode()``, their all-ones input swapped
for the port's seeded one) and against the port's plain loop
(``control_plain``) on inputs at the edges: NaN, infinities, signed zeros,
values that start past 2.4 and values that pass it after each of 1..5
steps. Exact throughout: both sides make the same float32 adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slam_robot_tpu_torch import tools
from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.tools import probe_mosaic2 as t_m2
from tools import probe_mosaic as j_m1
from tools import probe_mosaic2 as j_m2
from tools import probe_mosaic3 as j_m3

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOOPS = {"row_done": pc.ROW_DONE, "element_done": pc.ELEMENT_DONE}
SHAPES = [(1, 1), (8, 2), (8, 128), (24, 40), (1, 1024), (1023, 1), (3, 5)]
SEEDED = {c.name: c for c in tools.all_cases("SEEDED")}


def steps(x):
    """[6, *x.shape]: v_0 = x, then v_k = v_(k-1) + 0.5 in float32."""
    v = [np.asarray(x, np.float32)]
    for _ in range(pc.ITERS):
        v.append(v[-1] + np.float32(pc.STEP))
    return np.stack(v)


def pass_steps(x, case):
    """n for each element: the first k in 1..5 with v_k > 2.4, else 6;
    ROW_DONE: its row's, from column 0."""
    v = steps(x)[1:]
    if case == pc.ROW_DONE:
        v = v[:, :, :1]
    passed = v > np.float32(pc.LIMIT)
    n = np.where(passed.any(0), passed.argmax(0) + 1, pc.ITERS + 1)
    return np.broadcast_to(n, np.shape(x))


def claim(x, case):
    """What the kernel computes: v_min(n, T), T = min(5, max n)."""
    n = pass_steps(x, case)
    trips = min(pc.ITERS, int(n.max()))
    return np.take_along_axis(steps(x), np.minimum(n, trips)[None], 0)[0]


class _Input:
    """A probe module's ``jnp`` whose ``ones`` gives ``x`` instead."""

    def __init__(self, x):
        self.x = x

    def __getattr__(self, name):
        return getattr(jnp, name)

    def ones(self, shape, dtype=None):
        assert tuple(shape) == self.x.shape and dtype == jnp.float32
        return jnp.asarray(self.x)


@pytest.mark.parametrize("module,probe,name,case", [
    (j_m1, "p5", "P5 while_loop vector carry (seeded)", pc.ROW_DONE),
    (j_m2, "g", "G while vector-cond (P5) (seeded)", pc.ELEMENT_DONE),
    (j_m3, "l", "L while vector-cond 128-wide (seeded)", pc.ELEMENT_DONE),
])
def test_claim_matches_the_jax_probe_on_seeded_inputs(monkeypatch, module, probe, name, case):
    x = SEEDED[name].inputs(CPU)[0].numpy()
    monkeypatch.setattr(module, "jnp", _Input(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(module, probe)())
    assert not np.array_equal(want, x)
    np.testing.assert_array_equal(claim(x, case), want)
    np.testing.assert_array_equal(pc.control_plain(torch.as_tensor(x), case).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("loop", list(LOOPS))
def test_claim_matches_the_plain_loop_at_the_edges(loop, shape):
    case = LOOPS[loop]
    for seed in range(3):
        x = t_m2.loop_edges(CPU, seed, shape)
        np.testing.assert_array_equal(claim(x.numpy(), case), pc.control_plain(x, case).numpy())


@pytest.mark.parametrize("loop", list(LOOPS))
def test_claim_matches_the_plain_loop_on_each_edge_value_alone(loop):
    case = LOOPS[loop]
    for v in t_m2.LOOP_EDGES:
        x = torch.tensor([[v, 1.0]], dtype=torch.float32)
        np.testing.assert_array_equal(claim(x.numpy(), case), pc.control_plain(x, case).numpy())


def test_pass_steps_at_the_edges():
    """NaN and -inf never pass (6), +inf and 2.4 itself pass at the first
    step, -0.0 as 0.0 at the fifth, -0.5 never."""
    x = np.array([[np.nan, -np.inf, np.inf, 2.4, -0.0, 0.0, -0.5]], np.float32)
    assert pass_steps(x, pc.ELEMENT_DONE)[0].tolist() == [6, 6, 1, 1, 5, 5, 6]


@pytest.mark.parametrize("shape", [(8, 128), (24, 40), (1023, 1)])
def test_edge_inputs_reach_every_step_count(shape):
    """The edge inputs leave the loop at every step, 1 to 6, and, for
    ROW_DONE, rows leave at different steps."""
    x = t_m2.loop_edges(CPU, 0, shape).numpy()
    assert set(pass_steps(x, pc.ELEMENT_DONE).ravel()) == {1, 2, 3, 4, 5, 6}
    if shape[0] > 1:
        assert len(set(pass_steps(x, pc.ROW_DONE)[:, 0])) >= 3
    assert np.isnan(x).any() and np.isinf(x).any() and (np.signbit(x) & (x == 0)).any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", t_m2.SUM_KINDS)
def test_sum_edges_lie_where_named(shape, kind):
    x = t_m2.sum_edges(CPU, 1, shape, kind)
    total = float(x.double().sum())
    assert {"above": total > 10.0, "below": total < -10.0, "two": total == 2.0}[kind]
    got = pc.control_plain(x, pc.REDUCE)
    assert torch.equal(got, x * 2.0 if kind == "above" else x)
