"""The port's headline benchmark as a whole, on the CPU at
tests/test_pipeline.CFG (160x120, depth 4, 96 features): ``bench.run`` with
a 24-frame warm, 8 timed frames and one seed, going on from the state after
the sweep's first 4 frames (the route ``chip_smoke.py``'s phase 13 takes).

A closed-loop run is judged by gates, not against the JAX package
(ROADMAP's rule): the line has bench.py's keys (tests/test_torch_bench.py),
every number in it is finite, no observation row is dropped in the scan or
the live segment, every live frame's telemetry arrived, the two timed scan
passes end in states equal bit for bit (and equal to the first pass's), the
live segment's final state equals the scan's bit for bit, the timed passes'
counts are per frame what the step makes, and ``probe_errfresh.audit`` of
the scan's final map has the original probe's keys, with the median stored
and fresh errors of enabled rows equal within 1e-3 px.

One step here takes ~1 s on one CPU thread (BA's host dispatch), so the
run takes ~80 s; it has this file to itself.
"""

import ast
import json
import math
import os

import pytest
import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.tools import probe_errfresh
from slam_robot_tpu_torch.utils.benchscene import make_frames
from tests.test_pipeline import CFG
from tests.test_torch_bench import ROOT, jax_bench_keys
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)
N_WARM, N_TIMED, START = 24, 8, 4


def leaves(ps):
    return [x for v in ps for x in (leaves(v) if isinstance(v, tuple) else [v])]


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


@pytest.fixture(scope="module")
def slice_run():
    frames = make_frames(TCFG, START, device="cpu")
    ps = pipeline.init(TCFG, device="cpu")
    for i in range(START):
        ps, _ = pipeline.step(ps, frames[i], TCFG)
        ps = pipeline.maybe_polish(ps, i, TCFG)
    res = {}
    line = bench.run(TCFG, n_warm=N_WARM, n_timed=N_TIMED, seeds=(0,), device="cpu",
                     start=(ps, START), results=res)
    return json.loads(json.dumps(line)), res


def numbers(x):
    if isinstance(x, dict):
        return [n for v in x.values() for n in numbers(v)]
    if isinstance(x, list):
        return [n for v in x for n in numbers(v)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def test_line_has_bench_py_keys_and_finite_values(slice_run):
    line, _ = slice_run
    top, detail, split = jax_bench_keys()
    assert set(line) == top
    assert set(line["detail"]) == detail | {"scan_step_ms_reps"}
    assert set(line["detail"]["err_split"]) == split
    assert line["detail"]["device"] == "cpu"
    assert all(math.isfinite(v) for v in numbers(line))
    d = line["detail"]
    assert line["value"] > 0 and len(d["scan_step_ms_reps"]) == 2
    assert d["ate_pct_per_seed"] == {"0": d["ate_pct_of_path"]}
    assert d["n_points"] > 50 and d["n_obs"] > 300


def test_gates_no_drops_full_telemetry_canary(slice_run):
    line, res = slice_run
    d = line["detail"]
    assert d["obs_dropped_total"] == 0 and d["live_obs_dropped"] == 0
    assert d["live_canary_max_px"] < 0.1
    assert res["live_window"]["frames"] == N_TIMED
    for s in res["scan_states"] + [res["live_state"]]:
        for t in leaves(s):
            assert not t.is_floating_point() or bool(torch.isfinite(t).all())


def test_scan_passes_and_live_end_in_the_same_state(slice_run):
    _, res = slice_run
    first, *reps = res["scan_states"]
    assert len(reps) == 2
    assert all(equal(r, first) for r in reps)
    assert equal(res["live_state"], first)
    assert int(first.map.n_frames) == N_WARM + N_TIMED


def test_timed_window_counts(slice_run):
    _, res = slice_run
    w = res["scan_window"]
    assert w["frames"] == 2 * N_TIMED
    # on the CPU the kernels' plain versions run: no launch is counted
    assert w["pyramid_flat"] == w["newton_track"] == w["sep5_reflect101"] == 0
    assert w["sweeps"] > 0 and w["syncs"] >= 30 * w["frames"]


def _jax_audit_keys() -> set:
    tree = ast.parse(open(os.path.join(ROOT, "tools", "probe_errfresh.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "stale_rows_enabled" in keys:
                return keys
    raise AssertionError("no audit dict in tools/probe_errfresh.py")


def test_errfresh_audit_of_the_scans_map(slice_run):
    _, res = slice_run
    m = res["scan_states"][-1].map
    out = probe_errfresh.audit(m, TCFG)
    assert set(out) == _jax_audit_keys()
    assert out["n_obs"] == int(m.n_obs) and 0 < out["n_enabled_usable"] <= out["n_enabled"]
    assert all(math.isfinite(v) for v in numbers(out))
    # the last solve's window rows were reprojected after it: stored = fresh
    assert out["stored_enabled"]["p50"] == pytest.approx(out["fresh_enabled"]["p50"], abs=1e-3)
