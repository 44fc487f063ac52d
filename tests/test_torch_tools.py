"""The port's user tools: ``tools/calibrate`` (the SolveCameras flow) and
``tools/bench_suite`` (configs 1-5), on the CPU.

- calibrate: the port's tool replays 8 synthetic frames at 160x120, then
  runs the flow; the JAX package's flow (``reset_cameras``,
  ``solve_all_frames(solve_cameras=True)``, ``reproject``: the calls of
  tools/calibrate.py) runs on the same replayed map, carried across with
  ``bridge``. Both are compared on the same map, not after two closed-loop
  replays whose keyframe cadence is chaotic in float order. To keep the
  CPU time down the configuration's capacities are cut (16 frames, 128
  points, 2048 observations) and the camera solve to 3 LM iterations,
  where the two packages still follow one path (past that the solve
  crawls along the weakly determined k1..k3-versus-points direction and
  the packages part at float32 rounding, as the next test shows): the same
  iteration count and exit code, k1..k3 within 1e-4, fx, fy, cx, cy within
  0.01 px, the reprojection error at rtol 1e-3. The printed lines have the
  original's format.
- calibrate at the default iteration count (50, the cap the camera solve
  runs to): the port's solved k and reprojection error lie inside the JAX
  flow's own spread, the largest distance by which 16 one-ulp nudges of a
  frame's translation (every sign pattern over x, y, z of the newest and
  the middle frame) move JAX's result from its unnudged one, for k1..k3,
  fx..cy and the reprojection error each.
- bench_suite ``--small``: one JSON line per result of configs 1, 2, 4 and
  5, each with the name, unit and detail keys of the original's ``emit``
  call (read from tools/bench_suite.py's source), finite values, and the
  solves doing work; ``--configs 3`` runs the port's ``bench.main`` (at a
  small size) and prints its line.
"""

import ast
import dataclasses
import functools
import itertools
import json
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from slam_robot_tpu.config import SlamConfig as JCfg
from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import slam as j_slam
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch import config as t_config
from slam_robot_tpu_torch.tools import bench_suite, calibrate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = dict(max_frames=16, max_points=128, max_obs=2048, max_obs_per_point=16)
SMALL = dict(CAPS, ba_max_iters=3)
K_ROW = r" +-?\d+\.\d{5}(, +-?\d+\.\d{5}){6}"


def test_calibrate_matches_the_jax_flow(monkeypatch, capsys):
    monkeypatch.setattr(t_config, "SlamConfig",
                        functools.partial(t_config.SlamConfig, **SMALL))
    res = {}
    assert calibrate.main(["--synthetic", "8", "--device", "cpu", "--width", "160",
                           "--height", "120"], res) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "k1 k2 k3 fx fy cx cy   (initial)"
    assert re.fullmatch(r"k1 k2 k3 fx fy cx cy   \(solved, 3 iters, reproj \d+\.\d{3}px\)",
                        lines[3]), lines[3]
    for row in lines[1:3] + lines[4:6]:
        assert re.fullmatch(K_ROW, row), row
    assert len(lines) == 6
    got_k = res["solved_k"].numpy()
    assert lines[4] == " " + ", ".join(f"{v:9.5f}" for v in got_k[0])

    m = bridge.to_numpy(res["map"])
    jm = j_lm.MapState(**{f: jnp.asarray(getattr(m, f)) for f in j_lm.MapState._fields})
    jm = j_lm.reset_cameras(jm)
    jm, jr = j_slam.solve_all_frames(jm, 2.0, solve_cameras=True,
                                     cfg=JCfg(image_width=160, image_height=120, **SMALL))
    jm, jerr = j_lm.reproject(jm)
    tr = res["result"]
    assert bool(jr.ok) and bool(tr.ok)
    assert int(tr.iters) == int(jr.iters) == 3 and int(tr.term) == int(jr.term)
    want_k = np.asarray(jm.cam_k)
    assert np.abs(want_k - np.asarray(res["initial_k"])).max() > 1e-3  # the solve moved k
    np.testing.assert_allclose(got_k[:, :3], want_k[:, :3], atol=1e-4)
    np.testing.assert_allclose(got_k[:, 3:], want_k[:, 3:], atol=1e-2)
    np.testing.assert_allclose(res["reproj_px"], float(jerr), rtol=1e-3)


def _jax_flow(m, cfg, trans=None):
    """The JAX package's SolveCameras flow on the port's replayed map ``m``
    (numpy leaves), with ``trans`` for its frame translations when given:
    (solved k, LM iterations, reprojection px)."""
    jm = j_lm.MapState(**{f: jnp.asarray(getattr(m, f)) for f in j_lm.MapState._fields})
    if trans is not None:
        jm = jm._replace(frame_trans=jnp.asarray(trans))
    jm, jr = j_slam.solve_all_frames(j_lm.reset_cameras(jm), 2.0, solve_cameras=True, cfg=cfg)
    jm, jerr = j_lm.reproject(jm)
    return np.asarray(jm.cam_k), int(jr.iters), float(jerr)


def test_calibrate_at_full_iterations_is_inside_jax_own_spread(monkeypatch):
    monkeypatch.setattr(t_config, "SlamConfig",
                        functools.partial(t_config.SlamConfig, **CAPS))
    res = {}
    assert calibrate.main(["--synthetic", "8", "--device", "cpu", "--width", "160",
                           "--height", "120"], res) == 0
    m = bridge.to_numpy(res["map"])
    cfg = JCfg(image_width=160, image_height=120, **CAPS)
    want_k, iters, want_err = _jax_flow(m, cfg)
    assert int(res["result"].iters) == iters == cfg.ba_max_iters

    def dist(k, err):  # (k1..k3, fx..cy, reprojection) distances from JAX's result
        return (np.abs(k[:, :3] - want_k[:, :3]).max(), np.abs(k[:, 3:] - want_k[:, 3:]).max(),
                abs(err - want_err))

    trans = np.asarray(m.frame_trans)
    n = int(m.n_frames)
    spread = np.zeros(3)
    for f, signs in itertools.product((n - 1, n // 2), itertools.product((-1, 1), repeat=3)):
        nudged = trans.copy()
        for c, sgn in enumerate(signs):
            nudged[f, c] = np.nextafter(nudged[f, c], np.float32(sgn * np.inf))
        k, _, err = _jax_flow(m, cfg, nudged)
        spread = np.maximum(spread, dist(k, err))
    apart = np.array(dist(res["solved_k"].numpy(), res["reproj_px"]))
    print(f"port vs JAX (k1..k3, fx..cy, reproj px): {apart}; JAX's nudge spread: {spread}")
    assert spread[0] > 1e-4 and spread[1] > 1e-2  # the 3-iteration test's tolerances
    assert np.all(apart <= spread), (apart, spread)


def _jax_emits() -> dict:
    """{config name: (unit, detail keys)} of tools/bench_suite.py's emit calls."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "bench_suite.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "emit"):
            out[node.args[0].value] = (node.args[2].value, {k.arg for k in node.keywords})
    return out


def test_bench_suite_small_emits_the_originals_lines(capsys):
    assert bench_suite.main(["--small", "--configs", "1,2,4,5", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    want = _jax_emits()
    assert [r["config"] for r in rows] == [
        "1_replay_track_only", "2_window_ba_10x500", "4_closed_loop_64_rollouts",
        "5_large_ba", "5_large_ba_sharded", "5_multi_robot_shared_map"]
    for r in rows:
        unit, keys = want[r["config"]]
        assert r["unit"] == unit and keys <= set(r["detail"]), r
        assert math.isfinite(r["value"]) and r["value"] > 0, r
    d = {r["config"]: r["detail"] for r in rows}
    assert d["2_window_ba_10x500"]["lm_iters"] > 0
    assert d["2_window_ba_10x500"]["cost"] < d["2_window_ba_10x500"]["cost0"]
    assert d["4_closed_loop_64_rollouts"]["rollouts"] == 16
    assert d["5_large_ba"]["ok"] and d["5_large_ba"]["cost"] < d["5_large_ba"]["cost0"]
    np.testing.assert_allclose(d["5_large_ba_sharded"]["cost"], d["5_large_ba"]["cost"],
                               rtol=1e-4)
    assert d["5_large_ba_sharded"]["shards"] == 4
    mr = d["5_multi_robot_shared_map"]
    assert mr["robots"] == 2 and mr["mean_point_err_mm"] < mr["mean_point_err0_mm"]


def test_bench_suite_config_3_runs_the_ports_bench(monkeypatch, capsys):
    """Config 3 is the port's ``bench.main``: its one JSON line, exit 0.
    ``bench.run`` is cut to tests/test_pipeline.CFG, a 24-frame warm, 8
    timed frames and one seed (~80 s here)."""
    from slam_robot_tpu_torch import bench
    from tests.test_pipeline import CFG

    real, asked = bench.run, []

    def small(cfg, device=None):
        asked.append(cfg)
        return real(t_config.SlamConfig(**dataclasses.asdict(CFG)), n_warm=24, n_timed=8,
                    seeds=(0,), device=device)

    monkeypatch.setattr(bench, "run", small)
    assert bench_suite.main(["--configs", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert asked == [t_config.SlamConfig()] and len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == bench.METRIC and line["unit"] == "fps" and line["value"] > 0
    d = line["detail"]
    assert d["device"] == "cpu" and d["obs_dropped_total"] == d["live_obs_dropped"] == 0
    # bench.run rounds one unrounded fps twice: value = round(fps, 2) and
    # vs_baseline = round(fps / 60, 3); so the two agree within the sum of
    # the two roundings, wherever fps falls against a rounding step
    assert abs(line["vs_baseline"] - line["value"] / 60.0) <= 0.0005 + 0.005 / 60.0 + 1e-12
