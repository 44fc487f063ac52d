"""``profile_cg_sharded`` and ``profile_cg`` on the CPU at the CI shape.

- The sharded validation with 1, 2 and 4 shards on the CPU: every row's
  ``cost_rel_err`` within 1e-4 and ``trans_max_diff_mm`` within 0.1 mm
  (tests/test_torch_sharded.py's tolerances), ``ok``, one shard exactly the
  unsharded solve.
- The projection's basis is this run's own measured rate (the one
  ``profile_cg.solve_rate`` returned), or ``--measured``; never the TPU's
  0.635. An observation row's bytes are the shard table's element sizes.
- ``profile_cg.run``'s profile: device time by category adds up to the
  total within 1 %.
"""

import json

import pytest
import torch

from slam_robot_tpu_torch.ops import ba_cg
from slam_robot_tpu_torch.tools import profile_cg, profile_cg_sharded

torch.set_num_threads(1)


def _run(monkeypatch, capsys, argv):
    rates = []
    real = profile_cg.solve_rate

    def recording(*a, **k):
        out = real(*a, **k)
        rates.append(out[2])
        return out

    monkeypatch.setattr(profile_cg, "solve_rate", recording)
    assert profile_cg_sharded.main(argv + ["--small", "--devices", "1,2,4",
                                           "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    start = next(i for i, x in enumerate(lines) if x == "{")
    return [json.loads(x) for x in lines[1:start]], json.loads("\n".join(lines[start:])), rates


def test_sharded_rows_meet_the_sharded_tolerances(monkeypatch, capsys):
    rows, out, rates = _run(monkeypatch, capsys, [])
    assert out["validation"] == rows and [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["ok"] and r["cost_rel_err"] <= 1e-4 and r["trans_max_diff_mm"] <= 0.1, r
    assert rows[0]["cost_rel_err"] == 0.0 and rows[0]["trans_max_diff_mm"] == 0.0
    basis = out["projection_basis"]
    assert len(rates) == 1 and basis["measured_single_chip_gn_iters_per_s"] == round(rates[0], 4)
    assert basis["measured_single_chip_gn_iters_per_s"] != 0.635
    assert basis["passes_per_gn"] == 41
    assert [p["devices"] for p in out["projection"]] == [2, 4, 8, 16, 64]


def test_projection_takes_a_given_rate_and_the_tables_row_bytes(monkeypatch, capsys):
    _, out, rates = _run(monkeypatch, capsys, ["--measured", "2.5"])
    assert rates == [] and out["projection_basis"]["measured_single_chip_gn_iters_per_s"] == 2.5
    args = profile_cg.problem(True, torch.device("cpu"))
    cols = (args[6], args[7], args[8], args[9])    # obs_frame, obs_point, obs_px, obs_ok
    want = sum(t.element_size() * t[0].numel() for t in cols)
    assert out["projection_basis"]["obs_row_bytes"] == want == 17
    basis, proj = profile_cg_sharded.projection(2.5, want, 1000, 500, 10, 20)
    assert proj[0]["projected_gn_iters_per_s"] == round(
        2.5 * 2 * (1000 * 17 * 41 / 2) / (1000 * 17 * 41 / 2 + 20 * 500 * 16 + 500 * 64
                                          + 10 * 144), 2)


@pytest.mark.parametrize("layout", ["scatter", "padded"])
def test_profile_cg_categories_add_up(layout):
    args = profile_cg.problem(True, torch.device("cpu"))
    cgc = ba_cg.CGConfig(max_free_frames=args[0].shape[0], gn_iters=2, cg_iters=5,
                         precond="diag", layout=layout)
    p = profile_cg.run(args, cgc, torch.device("cpu"), top=5, out_dir=None, emit=lambda s: None)
    assert p["gn_iters_per_s"] > 0 and p["units"] == 2
    assert sum(p["by_category_ms"].values()) == pytest.approx(p["device_ms"], rel=1e-2)
    assert p["host_ms_by_span"]["ba_cg_solve"] > 0 and p["syncs"] == 0
