"""The plain reference against the port's ``ops/ba_cg.solve`` at a tiny size
(the test may import both; the reference imports nothing of the port), its
closed-form Jacobians against finite differences, and the roofline count
against a hand count."""

import pytest
import torch

from benchmark import compare, roofline
from benchmark.drivers import bal_solve
from benchmark.gen import bal
from benchmark.reference import ba as reference
from benchmark.reference import geometry as geo
from benchmark.tests.tiny import tiny_cell
from slam_robot_tpu_torch.ops import ba_cg

CELLS = ("ladybug1723.full", "venice1778.full")
SEED = 2**31 + 23
EPS = 0.001


def _port_and_reference(cell, device):
    drv = bal_solve.Driver(cell, SEED, device)
    res, ok, cost = drv.solve()
    ref = reference.solve(drv.tables, drv.settings)
    return drv, res, ok, cost, ref


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_on_the_cpu(cell):
    drv, res, ok, cost, ref = _port_and_reference(tiny_cell(cell), "cpu")
    assert ok and ref["ok"]
    # the solve does work: the cost falls by a fifth or more
    assert float(ref["cost"]) < 0.8 * float(ref["cost0"])
    assert compare.relative(float(res.cost0), float(ref["cost0"])) < 1e-5
    assert compare.relative(cost, float(ref["cost"])) < 1e-5
    assert compare.px_gap(drv.tables, res._asdict(), ref, EPS) < 2e-3


@pytest.mark.cuda
def test_reference_follows_the_port_on_the_card(card):
    drv, res, ok, cost, ref = _port_and_reference(tiny_cell("ladybug1723.full"), card)
    assert ok and ref["ok"]
    assert compare.relative(cost, float(ref["cost"])) < 1e-5
    assert compare.px_gap(drv.tables, res._asdict(), ref, EPS) < 2e-3


def test_the_solver_settings_are_the_ports_fields():
    cell = tiny_cell("ladybug1723.full")
    settings = bal_solve.solver_settings(cell["config"])
    cgc = bal_solve.cg_config(settings, cell["config"]["observations"])
    assert cgc.max_free_frames == cell["config"]["cameras"]
    assert cgc.pad_spill == cell["config"]["observations"]
    assert (cgc.gn_iters, cgc.cg_iters, cgc.precond) == (5, 20, "diag")
    with pytest.raises(ValueError):
        bal_solve.cg_config(dict(settings, not_a_field=1), 10)


def test_the_reference_refuses_a_preconditioner_it_lacks():
    drv = bal_solve.Driver(tiny_cell("ladybug1723.full"), SEED, "cpu")
    with pytest.raises(ValueError, match="diag"):
        reference.solve(drv.tables, dict(drv.settings, precond="block"))


def test_jacobians_against_finite_differences():
    torch.manual_seed(0)
    n = 16
    q = geo.retract(torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64).expand(n, 4),
                    0.3 * torch.randn(n, 3, dtype=torch.float64))
    t = 100.0 * torch.randn(n, 3, dtype=torch.float64)
    X = torch.cat([t + torch.tensor([0.0, 0.0, 3000.0], dtype=torch.float64)
                   + 500.0 * torch.randn(n, 3, dtype=torch.float64),
                   1.0 + 0.1 * torch.rand(n, 1, dtype=torch.float64)], -1)
    k = torch.tensor([0.01, -0.002, 0.0005, 416.0, -416.0, 320.0, 240.0],
                     dtype=torch.float64).expand(n, 7)
    prec = geo.Precision()
    # points in front of the rotated cameras
    X[:, :3] = t * X[:, 3:] + (geo.rotation_matrix(q).transpose(1, 2)
                               @ (X[:, :3] - t * X[:, 3:])[..., None])[..., 0]

    def pix(q, t, X):
        return geo.pixel(geo.to_camera(geo.rotation_matrix(q), t, X, prec), k)

    R = geo.rotation_matrix(q)
    jf, jp = reference.jacobians(R, t, X, geo.to_camera(R, t, X, prec), k, prec)
    h = 1e-6
    for j in range(6):
        d = torch.zeros(n, 6, dtype=torch.float64)
        d[:, j] = h
        num = (pix(geo.retract(q, d[:, :3]), t + d[:, 3:], X)
               - pix(geo.retract(q, -d[:, :3]), t - d[:, 3:], X)) / (2 * h)
        torch.testing.assert_close(jf[..., j], num, rtol=1e-5, atol=1e-6)
    for j in range(4):
        d = torch.zeros(n, 4, dtype=torch.float64)
        d[:, j] = h
        num = (pix(q, t, X + d) - pix(q, t, X - d)) / (2 * d[:, j:j + 1])
        torch.testing.assert_close(jp[..., j], num, rtol=1e-5, atol=1e-6)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 1234.5678])
    y = geo.round_tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0 + 2**-10, 1.0 + 2**-10]
    assert y[3] == -3.0
    assert abs(float(y[4]) - 1234.5678) <= 1234.5678 * 2**-11


def test_roofline_count_by_hand_for_three_cameras():
    # 3 cameras (1 free slot each past the 2 anchors: W = 3 slots), 5 points,
    # 12 rows, 2 GN steps of 3 CG iterations
    O, P, W, C, gn, cg = 12, 5, 3, 3, 2, 3
    terms = roofline.solve_terms(O, P, W, C, gn, cg)
    state = 3 * 28 + 5 * 16
    assert terms["cost"] == (2 * (12 * 17 + state), 2 * 12 * 40)
    assert terms["linearize"] == (2 * (12 * (17 + 84) + state + 5 * (64 + 16) + 3 * (144 + 24)),
                                  2 * (12 * (40 + 130 + 300) + 5 * 200))
    assert terms["products"] == (2 * 5 * (12 * (84 + 8) + 5 * 64 + 3 * (144 + 48)),
                                 2 * 5 * (12 * 84 + 5 * 32 + 3 * 72))
    assert terms["update"] == (2 * (2 * state + 3 * 24 + 5 * 16), 2 * (3 * 40 + 5 * 4))
    n_bytes = sum(b for b, _ in terms.values())
    assert roofline.least_seconds(terms, "NVIDIA H100 80GB HBM3") == n_bytes / 3.35e12
    assert roofline.least_seconds(terms, "some other card") is None


def test_generator_hands_both_sides_the_same_tables():
    cell = tiny_cell("venice1778.full")
    drv = bal_solve.Driver(cell, SEED, "cpu")
    again = bal.generate(cell["config"], cell["traffic"]["anchors"], SEED, "cpu")
    for k in bal_solve.ARGS:
        assert torch.equal(drv.tables[k], again[k])
    assert isinstance(drv.cgc, ba_cg.CGConfig)


def test_px_gap_leaves_out_rows_the_reference_puts_behind_the_camera():
    """A point that the reference's answer puts behind its cameras (as a
    two-view point sent towards w = 0 lands) is no row of the answer: the
    two answers' gap there is left out; every other row still counts."""
    drv = bal_solve.Driver(tiny_cell("ladybug1723.full"), SEED, "cpu")
    ref = reference.solve(drv.tables, drv.settings)
    f, pts = drv.tables["obs_frame"].long(), drv.tables["obs_point"].long()
    p = 5
    rows = torch.nonzero(pts == p)[:, 0]
    f0 = int(f[rows[0]])
    forward = geo.rotation_matrix(ref["frame_quat"])[f0, 2]
    behind = dict(ref, point_loc=ref["point_loc"].clone())
    behind["point_loc"][p, :3] = ref["frame_trans"][f0] - 5000.0 * forward
    R = geo.rotation_matrix(behind["frame_quat"])[f[rows]]
    pc = geo.to_camera(R, behind["frame_trans"][f[rows]], behind["point_loc"][p].expand(
        len(rows), 4), geo.Precision())
    assert bool((pc[:, 2] < 0).all())
    nudged = dict(behind, point_loc=behind["point_loc"].clone())
    nudged["point_loc"][p, :3] += 1.0
    assert compare.px_gap(drv.tables, nudged, behind, EPS) == 0.0
    moved = dict(ref, point_loc=ref["point_loc"].clone())
    moved["point_loc"][p, :3] += 20.0
    assert compare.px_gap(drv.tables, moved, ref, EPS) > 0.1
