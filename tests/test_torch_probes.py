"""The port's Mosaic probes (``slam_robot_tpu_torch.tools``, kernels' plain
versions on the CPU) against the JAX package's ``tools/probe_*.py``, which
run unchanged under ``pltpu.force_tpu_interpret_mode()``.

Each case feeds both sides identical inputs: the probes build theirs
inside, so the port's side evaluates the same jnp expressions. Tolerances:
copies, index, layout and control cases exact; P3, P4 and G6 rtol 1e-5
(float32 sums in another order); the two-level pyramid atol 1e-5 (kernel
B2's). P4's kernel is refused by interpret mode ("captures constants"),
so P4 is held against ``jax.grad`` / ``jax.jacfwd`` of its score written
in jnp. The Newton probes are in ``test_torch_probe_newton.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.ops.pallas import blur as j_blur
from slam_robot_tpu.ops.pallas import newton as j_newton
from slam_robot_tpu_torch import tools
from slam_robot_tpu_torch.ops.cuda import probe_banded as pb
from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
from slam_robot_tpu_torch.ops.cuda import probe_pyramid as pp
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from tools import probe_mosaic as j_m1
from tools import probe_mosaic2 as j_m2
from tools import probe_mosaic3 as j_m3
from tools import probe_mosaic4 as j_m4

torch.set_num_threads(1)

F, WS, S = 8, 32, 13


def T(a):
    return torch.as_tensor(np.asarray(a))


def interpret(fn):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


def img128():
    return np.arange(128 * 256, dtype=np.float32).reshape(128, 256)


def int_pos():
    return np.asarray(jnp.stack([jnp.arange(F) * 7 + 3, jnp.arange(F) * 5 + 2], -1)
                      .astype(jnp.int32))


# ---- tools/probe_mosaic.py ----

def test_p12_window_copy():
    got = pw.windows(T(img128()), T(int_pos()), WS, pw.INT)
    np.testing.assert_array_equal(got[:, 0, 0].numpy(), interpret(j_m1.p12))


def test_p2b_floored_positions():
    pos = np.asarray(jnp.stack([jnp.arange(F) * 7.3 + 3.2, jnp.arange(F) * 5.1 + 2.9], -1))
    got = pw.windows(T(img128()), T(pos), WS, pw.FLOORED)
    np.testing.assert_array_equal(got[:, 0, 0].numpy(), interpret(j_m1.p2b))


def test_p3_batched_product():
    got = pb.bmm(torch.ones((F, S, WS)), torch.ones((F, WS, WS)))
    np.testing.assert_allclose(got[:, 0, 0].numpy(), interpret(j_m1.p3), rtol=1e-5)


def test_p4_gradient_and_hessian_match_jax_autodiff():
    win = np.arange(WS * WS, dtype=np.float32).reshape(WS, WS) / 100.0
    xy = np.array([3.3, 1.7], np.float32)

    def score(p):  # p4's score, outside the kernel interpret mode refuses
        i = jax.lax.broadcasted_iota(jnp.int32, (S, WS), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (S, WS), 1)
        x0 = jnp.floor(p[0]).astype(jnp.int32)
        fx = p[0] - x0.astype(jnp.float32)
        rows = jnp.where(j == i + x0, 1.0 - fx, 0.0) + jnp.where(j == i + x0 + 1, fx, 0.0)
        q = jnp.dot(rows, jnp.asarray(win), preferred_element_type=jnp.float32)
        return jnp.sum(q * q) * p[1]

    g = jax.grad(score)(jnp.asarray(xy))
    h = jax.jacfwd(jax.grad(score))(jnp.asarray(xy))
    want = np.stack([np.asarray(g), np.asarray(h[0]), np.asarray(h[1])])
    got = pb.band_grad(T(win), T(xy), S).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_p5_while_loop_row_done():
    got = pc.control(torch.ones((F, 2)), pc.ROW_DONE)
    np.testing.assert_array_equal(got.numpy(), interpret(j_m1.p5))


def test_p6_masked_copy():
    mask = np.asarray((jnp.arange(F) % 2).astype(jnp.int32))
    got = pw.windows(torch.ones((128, 256)), None, WS, pw.MASKED, T(mask))
    np.testing.assert_array_equal(got[:, 0, 0].numpy(), interpret(j_m1.p6))


# ---- tools/probe_mosaic2.py and probe_mosaic3.py ----

def _m2_port(name):
    img, pos = T(j_m2.IMG), T(j_m2.POS)
    if name in "ab":
        return pw.windows(img, pos, WS, pw.INT)
    if name == "c":
        return pw.windows(img, pos, WS, pw.DIAGONAL)
    if name == "d":
        return pw.fill(pos, (8, 128), 0, 1)
    if name == "h":
        return pw.fill(pos, (8, 128), 3, 2)
    case, shape = {"e": (pc.FIXED, (F, 128)), "f": (pc.REDUCE, (F, 128)),
                   "g": (pc.ELEMENT_DONE, (F, 2))}[name]
    return pc.control(torch.ones(shape), case)


@pytest.mark.parametrize("name", list("abcdefgh"))
def test_mosaic2_case(name):
    want = interpret(getattr(j_m2, name))
    np.testing.assert_array_equal(_m2_port(name).numpy(), want)


def _m3_port(name):
    img, pos = T(j_m3.IMG), T(j_m3.POS)
    if name == "l":
        return pc.control(torch.ones((F, 128)), pc.ELEMENT_DONE)
    if name == "m":
        return pw.windows(img, pos, WS, pw.ROWS)
    case = {"i": pw.ONE_BY_ONE, "j": pw.ALL_THEN_WAIT, "k": pw.STAGED}[name]
    return pw.windows_async(img, pos, WS, case)


@pytest.mark.parametrize("name", list("ijklm"))
def test_mosaic3_case(name):
    want = interpret(getattr(j_m3, name))
    if name in "ijk":
        j_m3.want_windows(want)  # the probe's own check
    np.testing.assert_array_equal(_m3_port(name).numpy(), want)


# ---- tools/probe_mosaic4.py ----

B, G = 64 // 4, 4


def _g3_inputs():
    fr = np.asarray(jnp.linspace(0, 1, 64))
    st = np.asarray(jnp.clip(jnp.arange(64, dtype=jnp.int32) % 18, 0, 18))
    return fr, st


def _g6_inputs():
    win = np.asarray(jnp.arange(64 * 32 * 32, dtype=jnp.float32).reshape(64, 32, 32) % 255.0)
    fx, fy = np.asarray(jnp.linspace(0.1, 0.9, 64)), np.asarray(jnp.linspace(0.2, 0.8, 64))
    x0 = np.asarray(jnp.clip(jnp.arange(64, dtype=jnp.int32) % 18, 0, 18))
    y0 = np.asarray(jnp.clip((jnp.arange(64, dtype=jnp.int32) * 3) % 18, 0, 18))
    return win, fx, fy, x0, y0


def _m4_port(name):
    lanes = torch.arange(64, dtype=torch.float32).reshape(B, G)
    rows = torch.arange(B * G * 2 * S * 32, dtype=torch.float32).reshape(B, G * 2 * S, 32)
    if name == "g1":
        return pb.layout(lanes, pb.REPEAT, G, 2 * S)
    if name == "g4":
        return pb.layout(lanes, pb.MASKED_SUM, G, 2 * S)
    if name == "g2":
        return pb.layout(rows, pb.BROADCAST, G, 2 * S)
    if name == "g5":
        return pb.layout(rows, pb.BLOCK_TRANSPOSE, G, 2 * S)
    if name == "g3":
        fr, st = _g3_inputs()
        return pb.banded_pair_grouped(T(fr), T(st), 32, S, G)
    return pb.sample_grouped(*[T(a) for a in _g6_inputs()], S, G)


@pytest.mark.parametrize("name", ["g1", "g2", "g3", "g4", "g5", "g6"])
def test_mosaic4_case(name):
    want = interpret(getattr(j_m4, name))
    got = _m4_port(name).numpy()
    if name == "g6":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_g3_matches_banded_pair_grouped_directly():
    fr, st = _g3_inputs()
    want = np.asarray(j_newton._banded_pair_grouped(jnp.asarray(fr), jnp.asarray(st), 32, S, G))
    got = pb.banded_pair_grouped(T(fr), T(st), 32, S, G).numpy()
    np.testing.assert_array_equal(got, want)


def test_g6_matches_sample_grouped_directly():
    win, fx, fy, x0, y0 = _g6_inputs()
    want = np.asarray(j_newton._sample_grouped(*[jnp.asarray(a) for a in (win, fx, fy, x0, y0)],
                                               S, G))
    got = pb.sample_grouped(*[T(a) for a in (win, fx, fy, x0, y0)], S, G).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---- tools/probe_pyramid_fused.py (main() is timing scans: not called) ----

def _frame():
    return np.random.default_rng(0).random((480, 640), np.float32)


def test_probe1_decimate():
    img = _frame()
    np.testing.assert_array_equal(pp.decimate(T(img)).numpy(), img[::2, ::2])


def test_probe2_two_level_matches_jax_pyramid():
    img = _frame()
    l0, l1 = pp.two_level(T(img), pp.taps())
    g0 = j_pyr.blur(jnp.asarray(img), 1.1)
    g1 = j_pyr.blur(j_pyr.pyr_down(g0), 0.8)
    np.testing.assert_allclose(l0.numpy(), np.asarray(g0), atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), np.asarray(g1), atol=1e-5)
    p0 = j_blur.blur(jnp.asarray(img), 1.1, interpret=True)
    p1 = j_blur.blur(j_blur.pyr_down(p0, interpret=True), 0.8, interpret=True)
    np.testing.assert_allclose(l0.numpy(), np.asarray(p0), atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), np.asarray(p1), atol=1e-5)


def test_two_level_taps_match_jax_kernels():
    want = np.stack([np.asarray(j_pyr.gaussian_kernel(1.1, 5)),
                     np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0,
                     np.asarray(j_pyr.gaussian_kernel(0.8, 5))])
    np.testing.assert_allclose(pp.taps().numpy(), want, rtol=1e-6)


# ---- the tools' entry points ----

@pytest.mark.parametrize("name", tools.PROBES)
def test_probe_main_on_cpu_passes_every_case(name, capsys):
    mod = importlib.import_module(f"slam_robot_tpu_torch.tools.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(mod.CASES) and all(ln.startswith("PASS ") for ln in lines), lines
    assert [ln[5:].split(":")[0] for ln in lines] == [c.name for c in mod.CASES]


def test_probe_cases_are_the_originals_32():
    names = [c.name for n in tools.PROBES
             for c in importlib.import_module(f"slam_robot_tpu_torch.tools.{n}").CASES]
    assert len(names) == 32 and len(set(names)) == 32


SEEDED = {c.name: c for c in tools.all_cases("SEEDED")}


@pytest.mark.parametrize("name", list(SEEDED))
def test_seeded_case_meets_its_reference_on_cpu(name):
    ok, detail = tools.check(SEEDED[name], torch.device("cpu"))
    assert ok, detail


def _steps_to_finish(x):
    """Steps of +0.5 each value takes to pass 2.4 (6: not within 5)."""
    return np.clip(np.floor((pc.LIMIT - x) / pc.STEP) + 1, 1, 6).astype(int)


def test_seeded_inputs_tell_a_wrong_kernel_apart():
    """What the constant inputs could not: rows and elements that leave the
    loops at different steps, sums on each side of 2 with a row's partial
    sum on the other side, a random mask over a random image."""
    cpu = torch.device("cpu")
    p5 = SEEDED["P5 while_loop vector carry (seeded)"].inputs(cpu)[0].numpy()
    assert len(set(_steps_to_finish(p5[:, 0]))) >= 3
    g = SEEDED["G while vector-cond (P5) (seeded)"].inputs(cpu)[0].numpy()
    assert len(set(_steps_to_finish(g.ravel()))) >= 4
    x = SEEDED["L while vector-cond 128-wide (seeded)"].inputs(cpu)[0].numpy()
    assert set(_steps_to_finish(x.ravel())) == {1, 2, 3, 4, 5, 6}
    for tag, above in (("above", True), ("below", False)):
        x = SEEDED[f"F vector-reduce scalar control (seeded, sum {tag} 2)"].inputs(cpu)[0]
        assert (float(x.sum()) > 2.0) == above
        assert any((float(r) > 2.0) != above for r in x.sum(1))
    img, mask = SEEDED["P6 pl.when guarded lane copy (seeded)"].inputs(cpu)
    assert set(mask.tolist()) == {0, 1} and len(set(img[:WS, :WS].ravel().tolist())) > 1000


def test_tap_bytes_counts_distinct_window_pixels():
    y0 = torch.tensor([0, 30, -5])
    x0 = torch.tensor([0, 0, 2])
    # 4x4 blocks in 32x32 windows: whole, 2 rows cut at the bottom, 5 cut at the top
    assert tools.tap_bytes((3, 32, 32), [y0], [x0], 4, 4) == 4 * (16 + 8 + 0)
    # blocks 2 rows lower: half new rows (none past the bottom; row 0 of lane 3)
    assert tools.tap_bytes((3, 32, 32), [y0, y0 + 2], [x0, x0], 4, 4) == 4 * (24 + 8 + 4)


def test_probe_bounds_count_only_what_the_taps_reach():
    """P4 reads 14 of W's 32 rows, G6 a 14x14 region of each window, the
    Newton stages a 14x14 region (the lanes stay within one pixel), the
    decimation the even rows."""
    cpu = torch.device("cpu")
    m1, m4, nk, pf = (importlib.import_module(f"slam_robot_tpu_torch.tools.{n}") for n in
                      ("probe_mosaic", "probe_mosaic4", "probe_newton_kernel",
                       "probe_pyramid_fused"))
    assert m1.band_bytes(*m1.CASES[3].inputs(cpu)) == 4 * (14 * 32 + 2 + 6)
    assert m4.sample_bytes(*m4.sample_inputs(cpu)) == 4 * 64 * (14 * 14 + 4 + 26 * 26)
    args = nk.inputs(cpu)
    for stage in (pn.EXTRACT, pn.NEWTON):
        assert nk.stage_bytes(*args, stage) == 4 * (256 * (196 + 169 + 4) + 169)
    assert pf.decimate_bytes(torch.zeros((480, 640))) == 4 * 240 * (640 + 320)


def test_probe_main_fails_on_a_failing_case(capsys):
    bad = tools.Case("broken", pw.WINDOWS, "-", lambda d: (torch.zeros(2),),
                     lambda x: x + 1.0, lambda x: x, lambda x: np.zeros(2))
    assert tools.main_for("doc", [bad], ["--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("FAIL broken:")


def test_probe_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where torch sees no CUDA device")
    mod = importlib.import_module("slam_robot_tpu_torch.tools.probe_mosaic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_probe_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        pb.bmm(torch.ones((2, 3, 4)), torch.ones((2, 5, 4)))
    with pytest.raises(ValueError):
        pp.decimate(torch.ones((7, 8)))
    with pytest.raises(ValueError):
        pc.control(torch.ones((64, 32)), pc.FIXED)
    with pytest.raises(ValueError):
        pb.sample_grouped(torch.ones((6, 32, 32)), *[torch.zeros(6)] * 4, S, 4)
