"""``chip_smoke.py``'s phases in processes of their own, without a card:
phases 10 and 12 run as ``python chip_smoke.py --part knobs|alt`` beside
phases 8 and 11 (and phase 9's parity processes), from the inputs the
script writes for them; a part that fails, or runs past its time, fails
the smoke, and the smoke ends every process it started.
"""

import json
import time

import pytest
import torch

import chip_smoke
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.utils import checkpoint
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg


@pytest.fixture
def parts_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PARTS_DIR", tmp_path)
    return tmp_path


def test_the_parts_are_phases_10_and_12():
    assert chip_smoke.PARTS == {"knobs": "phase 10", "alt": "phase 12"}
    # phase 12 at 32 frames takes the gates that exist for 32 frames
    assert all(chip_smoke.ALT_FRAMES in gates for gates in chip_smoke.ALT_MIN_POINTS.values())
    assert chip_smoke.ALT_STATE_FRAME + 1 < chip_smoke.ALT_FRAMES


def test_a_part_that_exits_other_than_0_fails_the_smoke_with_its_log(parts_dir):
    """Without a card the part's process exits 1 at once (phase 0): the
    smoke fails with the end of its log."""
    proc = chip_smoke._start_part("knobs")
    try:
        with pytest.raises(AssertionError, match="phase 10: its process exited 1(.|\\n)*"
                                                 "torch sees no CUDA device"):
            chip_smoke._part_result("knobs", proc, time.time() + 120)
    finally:
        chip_smoke._stop({"knobs": proc})
    assert (parts_dir / "knobs.log").exists()


def test_a_part_past_its_time_limit_fails_and_is_ended(parts_dir):
    proc = chip_smoke._start("slow", ["-c", "import time; time.sleep(60)"], parts_dir)
    t0 = time.time()
    with pytest.raises(AssertionError, match="phase 12: the process ran past its time limit"):
        try:
            chip_smoke._wait("phase 12", proc, time.time() + 0.5)
        finally:
            chip_smoke._stop({"slow": proc})
    assert time.time() - t0 < 30 and proc.poll() is not None


def test_a_part_s_result_and_lines_come_back(parts_dir, capsys):
    """A part that exits 0: its phase's lines printed, its counts and
    summary read back."""
    res = {"counts": {"pyramid_flat": 4}, "summary": {"frames": 2}}
    code = (f"import json, pathlib; print('phase 10 knobs: fired'); print('other'); "
            f"pathlib.Path({str(parts_dir / 'knobs.json')!r}).write_text(json.dumps({res!r}))")
    proc = chip_smoke._start("knobs", ["-c", code], parts_dir)
    counts, summary = chip_smoke._part_result("knobs", proc, time.time() + 60)
    assert (counts, summary) == (res["counts"], res["summary"])
    assert capsys.readouterr().out == "phase 10 knobs: fired\n"


def test_the_part_inputs_round_trip(parts_dir):
    """The frames, phase 4's state after 16 frames and phase 6's summary,
    as the parts read them."""
    cfg = port_cfg(CFG)
    frames = [torch.rand((cfg.image_height, cfg.image_width)) for _ in range(3)]
    ps = pipeline.init(cfg, device="cpu")
    chip_smoke._write_part_inputs(frames, ps, {"n_points": 7, "n_obs": 9, "fps": 1.5})
    got = torch.load(parts_dir / "frames.pt", weights_only=True)
    assert torch.equal(got, torch.stack(frames))
    back = checkpoint.restore(pipeline.init(cfg, device="cpu"), str(parts_dir / "direct.pt"),
                              torch.device("cpu"))
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(ps), strict=True))
    assert json.loads((parts_dir / "serve_baseline.json").read_text()) == {"n_points": 7,
                                                                            "n_obs": 9}



def test_the_processes_off_the_longest_path_run_niced(parts_dir):
    """Phase 9's and phase 10's processes run at PARTS_NICE, phase 12's at
    the script's own priority: its process is the block's longest."""
    import os

    assert chip_smoke.PART_NICE == {"knobs": chip_smoke.PARTS_NICE, "alt": 0}
    base = os.getpriority(os.PRIO_PROCESS, 0)
    proc = chip_smoke._start("slow", ["-c", "import time; time.sleep(60)"], parts_dir,
                             chip_smoke.PARTS_NICE)
    try:
        assert os.getpriority(os.PRIO_PROCESS, proc.pid) == min(base + chip_smoke.PARTS_NICE, 19)
    finally:
        chip_smoke._stop({"slow": proc})
