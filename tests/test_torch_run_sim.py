"""The port's closed-loop driver end to end on the CPU:
``python -m slam_robot_tpu_torch.run_sim ... --device cpu`` against the JAX
CLI (``slam_robot_tpu.run_sim``) run in this process.

Both print one JSON summary; every key and value must be equal except
``wall_s`` (values as the CLIs round them: distances to 1 mm, estimates to
0.1 mm). The runs compared: ``--goals 8 --steps 300`` and ``--slam --steps
4`` (the closed loop with SLAM is chaotic in float32 order past its fourth
step, tests/test_torch_sim.py).
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from slam_robot_tpu import run_sim as j_run_sim
from slam_robot_tpu_torch import run_sim
from tests.test_torch_config import ROOT

FLEET_KEYS = {"mode", "rollouts", "steps", "reached(<0.5m)", "median_dist_m", "wall_s"}
SLAM_KEYS = {"mode", "steps", "final_dist_m", "est_final_mm", "wall_s"}


def run_cli(*args) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.run_sim", *args],
                         capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def run_jax_cli(monkeypatch, capsys, *args) -> dict:
    """The JAX CLI in this process, on the CPU. It pins its compilation
    cache to a fixed directory; the test session's cache is kept instead."""
    update = jax.config.update

    def keep_cache(name, value):
        if name != "jax_compilation_cache_dir":
            update(name, value)

    monkeypatch.setattr(jax.config, "update", keep_cache)
    capsys.readouterr()
    assert j_run_sim.main([*args, "--platform", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _drop_wall(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k != "wall_s"}


@pytest.mark.parametrize("args,keys", [
    (("--goals", "8", "--steps", "300"), FLEET_KEYS),
    (("--slam", "--steps", "4"), SLAM_KEYS),
], ids=["fleet", "slam"])
def test_cli_prints_the_jax_summary(monkeypatch, capsys, args, keys):
    got = run_cli(*args, "--device", "cpu")
    want = run_jax_cli(monkeypatch, capsys, *args)
    assert set(got) == set(want) == keys
    assert _drop_wall(got) == _drop_wall(want)


def test_mesh_flag_gives_the_fleet_summary(capsys):
    assert run_sim.main(["--goals", "8", "--steps", "60", "--device", "cpu"]) == 0
    one = json.loads(capsys.readouterr().out)
    assert run_sim.main(["--goals", "8", "--steps", "60", "--device", "cpu", "--mesh"]) == 0
    mesh = json.loads(capsys.readouterr().out)
    assert _drop_wall(mesh) == _drop_wall(one)
    assert one["rollouts"] == 8 and one["steps"] == 60


def test_results_sink(capsys):
    res = {}
    assert run_sim.main(["--goals", "4", "--steps", "20", "--device", "cpu"], results=res) == 0
    assert res["traj"].shape == (4, 20, 2) and res["dist"].shape == (4,)
    summary = json.loads(capsys.readouterr().out)
    assert summary["reached(<0.5m)"] == int((res["dist"] < 0.5).sum())
    res = {}
    assert run_sim.main(["--slam", "--steps", "2", "--device", "cpu"], results=res) == 0
    assert res["traj"].shape == (2, 2) and res["est"].shape == (2, 3)
    assert len(res["step_ms"]) == 2 and int(res["pipeline"].map.n_frames) == 2
    assert json.loads(capsys.readouterr().out)["steps"] == 2


def test_cli_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where torch sees no CUDA device")
    res = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.run_sim", "--goals", "2",
                          "--steps", "2"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and '"mode"' not in res.stdout
