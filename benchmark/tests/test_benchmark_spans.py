"""The five ``ba_cg.spill_*`` readers on a tiny cell's solve, on the CPU,
traced by ``torch.profiler`` as the traced run's window is: each reads what
the same figures give by hand (the time shares from the program's span
record, the counters from a numpy count of the cell's own tables), each
reads None where nothing was recorded, and a second capture of the same
solve leaves the counters as they were and the times a solve's mean."""

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.drivers import bal_solve
from benchmark.tests.tiny import tiny_cell
from slam_robot_tpu_torch.device import SPAN_MS
from slam_robot_tpu_torch.ops import ba_cg

CELL = "ladybug1723.full"
SEED = 2**31 + 59
READERS = ("ba_cg.spill_pct", "ba_cg.spill_point_ms", "ba_cg.spill_frame_ms",
           "ba_cg.spill_useful_pct", "ba_cg.spill_run_max")


def _read() -> dict:
    return {name: spec.reader(name).read({}) for name in READERS}


@pytest.fixture
def drv():
    SPAN_MS.reset_device()
    ba_cg.SPILL.reset()
    yield bal_solve.Driver(tiny_cell(CELL), SEED, "cpu")
    SPAN_MS.reset_device()
    ba_cg.SPILL.reset()


def _traced_solve(drv) -> None:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.solve()


def _by_hand_counts(drv) -> tuple:
    """(useful %, longest run) from the tables: each side's rows past its
    pad, over every row walked (``pad_spill`` = the rows), both sides' spill
    sums called alike."""
    t, cfg = drv.tables, drv.cgc
    f, p = t["obs_frame"].numpy(), t["obs_point"].numpy()
    O, W = f.size, cfg.max_free_frames
    has_obs = np.bincount(f, minlength=t["present"].shape[0]) > 0
    free_f = t["free_frame"].numpy() & has_obs
    slot = np.where(free_f, np.cumsum(free_f) - 1, W)[f]
    real, runs = 0, []
    for ids, n, K in ((p, t["point_loc"].shape[0], cfg.pad_obs_per_point),
                      (slot, W, cfg.pad_obs_per_frame)):
        past = np.maximum(np.bincount(ids[ids < n], minlength=n) - K, 0)
        real += past.sum()
        runs += [O - past.sum(), past.max()]
    return 100.0 * real / (2 * O), max(runs)


def test_the_readers_read_the_figures_by_hand(drv):
    _traced_solve(drv)
    got = _read()
    spans = SPAN_MS.read_device()
    solve = spans["ba_cg_solve"]
    p, f = spans["ba_cg_seg_p_spill"], spans["ba_cg_seg_f_spill"]
    assert solve["calls"] == 1 and p["calls"] == f["calls"] > 0
    assert got["ba_cg.spill_pct"] == pytest.approx(
        100.0 * (p["self_ms"] + f["self_ms"]) / solve["ms"])
    assert 0 < got["ba_cg.spill_pct"] < 100
    assert got["ba_cg.spill_point_ms"] == pytest.approx(p["self_ms"])
    assert got["ba_cg.spill_frame_ms"] == pytest.approx(f["self_ms"])
    useful, run = _by_hand_counts(drv)
    assert got["ba_cg.spill_useful_pct"] == pytest.approx(useful, rel=1e-12)
    assert got["ba_cg.spill_run_max"] == run


def test_nothing_recorded_reads_none(drv):
    drv.solve()     # no profiler: nothing recorded
    assert _read() == dict.fromkeys(READERS)


def test_a_second_capture_reads_the_same(drv):
    _traced_solve(drv)
    first = _read()
    _traced_solve(drv)
    again = _read()
    for name in ("ba_cg.spill_useful_pct", "ba_cg.spill_run_max"):
        assert again[name] == first[name]
    spans = SPAN_MS.read_device()
    assert spans["ba_cg_solve"]["calls"] == 2
    for name, side in (("ba_cg.spill_point_ms", "p"), ("ba_cg.spill_frame_ms", "f")):
        assert again[name] == pytest.approx(spans[f"ba_cg_seg_{side}_spill"]["self_ms"] / 2)
        assert 0.5 < again[name] / first[name] < 2.0
    assert 0.5 < again["ba_cg.spill_pct"] / first["ba_cg.spill_pct"] < 2.0
