"""The comparison that decides ``correct`` fails what it must: the control
(the reference computed with TF32 inputs to its products, in the program's
place) fails each cell's limits, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have: a
solve that returns its state unchanged, half of the rows left out, an
answer altered where it is produced. A sound run of the same tiny cell
comes out correct. Runs here skip the look for a card and run on the CPU."""

import json

import pytest
import torch

from benchmark import compare, run, spec
from benchmark.drivers import bal_solve
from benchmark.reference import ba as reference
from benchmark.reference import geometry as geo
from benchmark.tests.tiny import tiny_cell
from slam_robot_tpu_torch.ops import ba_cg

CELLS = ("ladybug1723.full", "venice1778.full")
SEED = 2**31 + 41
ARGV = ["--seed", str(SEED), "--seconds", "0.5", "--trace", "0"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_fails_the_limits(cell, seed):
    c = tiny_cell(cell)
    drv = bal_solve.Driver(c, seed, "cpu")
    ref = reference.solve(drv.tables, drv.settings)
    ctl = reference.solve(drv.tables, drv.settings, geo.Precision(torch.float32, tf32=True))
    checks, failed = compare.check(drv.tables, ref, [float(ctl["cost"])], [ctl["ok"]],
                                   {0: ctl}, c["limits"], drv.settings["cheirality_eps"])
    assert not all(v["pass"] for v in checks.values()) and failed == 1


def _unchanged(solve, *args):
    res = solve(*args[:-1], args[-1]._replace(gn_iters=0))
    return res._replace(cost=res.cost0)


def _half_the_rows(solve, *args):
    args = list(args)
    ok = args[9].clone()
    ok[1::2] = False
    args[9] = ok
    return solve(*args)


def _one_point_altered(solve, *args):
    res = solve(*args)
    loc = res.point_loc.clone()
    loc[7, :3] += 20.0
    return res._replace(point_loc=loc)


def _result(monkeypatch, capsys, cell) -> dict:
    small = tiny_cell(cell)
    monkeypatch.setattr(spec, "load_cell", lambda name, bench=None: small)
    assert run.main(["--workload", cell] + ARGV, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(monkeypatch, capsys, cell):
    out = _result(monkeypatch, capsys, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(compare.NAMES)
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


def test_the_record_holds_every_window_key_but_the_answers():
    """A driver's readers read its own window keys, with no edit to run.py."""
    got = run.run_cell(tiny_cell("ladybug1723.full"), SEED, 0.5, False, "cpu", 0.0)
    rec = got["record"]
    assert {"window_s", "attempted", "solves", "solve_times", "costs", "oks",
            "peak_window_bytes"} <= set(rec) and "sampled" not in rec
    assert got["summary"].startswith(f"{rec['solves']} solves in ")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_the_rows, _one_point_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, cell, fault):
    real = ba_cg.solve
    # the timed solves break; the warm one (one GN step) runs as it is
    monkeypatch.setattr(bal_solve.ba_cg, "solve",
                        lambda *a: fault(real, *a) if a[-1].gn_iters > 1 else real(*a))
    out = _result(monkeypatch, capsys, cell)
    assert not out["correct"] and out["failed"] == out["attempted"]
