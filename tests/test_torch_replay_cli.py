"""The port's replay driver end to end on the CPU:
``python -m slam_robot_tpu_torch.run_replay ... --device cpu``.

Closed-loop runs are chaotic in float32 order, so the driver is held to the
JAX CLI only by its summary keys and gates, as tests/test_video_source.py
holds the JAX CLI: every frame processed, and a map of more than 5 points.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from slam_robot_tpu_torch import run_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX CLI's final JSON summary (slam_robot_tpu/run_replay.py:403-411)
SUMMARY_KEYS = {"frames", "wall_s", "fps", "iterations", "error", "n_points", "n_obs"}
SMALL = ["--device", "cpu", "--width", "160", "--height", "120"]


def run_cli(*args) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.run_replay", *args,
                          *SMALL, "--quiet"],
                         capture_output=True, text=True, timeout=560, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["replay", "live"])
def test_synthetic_cli_runs(mode):
    summary = run_cli("--synthetic", "6", *(["--live"] if mode == "live" else []))
    assert set(summary) == SUMMARY_KEYS
    assert summary["frames"] == 6 and summary["n_points"] > 5
    assert summary["iterations"] > 0 and np.isfinite(summary["error"])


def test_duo_video_cli_runs(tmp_path):
    pytest.importorskip("cv2")
    from tests.test_video_source import write_videos

    paths = write_videos(tmp_path, n_pairs=3)
    summary = run_cli("--video", *paths)
    assert set(summary) == SUMMARY_KEYS
    assert summary["frames"] == 6 and summary["n_points"] > 5


def test_outputs_of_every_flag(tmp_path, capsys):
    """--save, --view-dir, --patch-history, --dump and --final-ba in one
    in-process run; the frame lines carry the BriefReport analog."""
    pytest.importorskip("PIL")
    d = {k: tmp_path / k for k in ("save", "view", "phist")}
    rc = run_replay.main(["--synthetic", "4", *SMALL, "--save", str(d["save"]),
                          "--view-dir", str(d["view"]), "--view-every", "2",
                          "--patch-history", str(d["phist"]), "--dump", str(tmp_path / "z"),
                          "--final-ba"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert set(json.loads(out[-1])) == SUMMARY_KEYS
    assert sum(line.startswith("frame ") and "TIMER:" in line for line in out) == 4
    assert any(" ba " in line and "->" in line for line in out)
    assert any(line.startswith("final full BA: ") for line in out)
    assert sorted(p.name for p in d["save"].iterdir()) == [f"{i:08d}.png" for i in range(4)]
    assert sorted(p.name for p in d["view"].iterdir()) == ["frame_00000.png", "frame_00002.png"]
    assert any(d["phist"].iterdir())
    assert (tmp_path / "z").read_text().count("\n") >= 6


@pytest.mark.parametrize("argv,code,text", [
    (["--synthetic", "2", "--live", "--debug-numerics"], 1, "incompatible"),
    (["--synthetic", "2", "--live", "--patch-history", "x"], 1, "incompatible"),
    ([], 1, "need --load"),
    (["--load", "/nonexistent/frames"], 1, "source init failed"),
])
def test_refusals(argv, code, text, capsys):
    assert run_replay.main(argv + ["--device", "cpu"]) == code
    assert text in capsys.readouterr().err
