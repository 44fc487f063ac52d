"""``profile_scan``'s runs on the CPU at tests/test_pipeline.CFG: a variant
timed from a given warm state (what ``chip_smoke.py`` phase 14 does) gives
the original's line with finite figures and BA iterations; ``noslam``
bootstraps and scans without a BA iteration (``bench.bootstrap`` and
``bench.run_scan`` with ``run_slam=False``), and ``run_scan`` keeps the
asked metrics a frame.
"""

import json
import math

import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.tools import profile_scan
from slam_robot_tpu_torch.utils.benchscene import make_frames
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)
N_WARM = 4


def test_a_variant_from_a_given_state():
    frames = make_frames(TCFG, N_WARM + 2, device="cpu")
    ps0, _, _ = bench.bootstrap(TCFG, frames, N_WARM, "cpu", n_eager=0)
    lines = []
    out = profile_scan.run_variant("default", TCFG, frames, N_WARM, torch.device("cpu"),
                                   start=ps0, reps=1, emit=lines.append)
    assert json.loads(lines[0]) == out and out["warm_s"] == 0.0
    assert out["mean_fast_iters"] > 0 and out["n_points"] >= int(ps0.map.n_points)
    assert all(math.isfinite(v) for v in out.values() if isinstance(v, float))
    _, res = bench.run_scan(ps0, torch.stack(frames[N_WARM:]), TCFG, keep=profile_scan.KEEP)
    assert len(res) == 2 + len(profile_scan.KEEP) and all(r.shape == (2,) for r in res)


def test_noslam_bootstraps_and_scans_without_ba():
    cfg, run_slam = profile_scan.variant_config("noslam", TCFG)
    frames = make_frames(cfg, N_WARM + 2, device="cpu")
    out = profile_scan.run_variant("noslam", cfg, frames, N_WARM, torch.device("cpu"), run_slam,
                                   reps=1, emit=lambda s: None)
    assert out["mean_fast_iters"] == out["mean_slow_iters"] == 0.0 and out["warm_s"] > 0
    ps, _, _ = bench.bootstrap(cfg, frames, N_WARM, "cpu", n_eager=0, run_slam=False)
    assert int(ps.total_ba_iters) == 0 and int(ps.map.n_frames) == N_WARM
