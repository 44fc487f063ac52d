"""The port's parity replay (``slam_robot_tpu_torch/tools/parity.py``):
its copy of the sequence table against ``tools/parity.py``'s and the
committed goldens, and forward_yaw replayed on the CPU inside every gate,
drift against the JAX package's golden included.

The other three sequences take ~10 minutes on a CPU, too long for this
suite: ``chip_smoke.py`` replays all four on the card (phase 9).
"""

import json
import time

import pytest
import torch

import chip_smoke

from slam_robot_tpu_torch.tools import parity as t_parity
from tools import parity as j_parity

torch.set_num_threads(1)


def test_sequence_table_equals_the_originals():
    assert t_parity._SMALL == j_parity._SMALL
    assert t_parity.SEQUENCES == j_parity.SEQUENCES
    for name, spec in t_parity.SEQUENCES.items():
        golden = json.loads((t_parity.FIXTURES / spec["golden"]).read_text())
        assert golden["sequence"] == spec["seq"], name
        assert golden.get("seeds") == spec.get("seeds"), name


def test_forward_yaw_replays_inside_every_gate(tmp_path):
    out = tmp_path / "parity.json"
    rc = t_parity.main(["--seq", "forward_yaw", "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    (rep,) = report["sequences"]
    assert rep["sequence"] == "forward_yaw" and rep["finite"]
    assert rep["n_obs"] > 0 and rep["n_points"] > 0
    assert rep["drift_ok"], f"drift {rep['ate_vs_golden_mm']} mm > gate {rep['gate_mm']} mm"
    assert rep["cap_ok"], f"truth ATE {rep['ate_pct_of_path']} % > {rep['truth_gate_pct']} %"
    assert rep["median_ok"], (f"median {rep['median_enabled_err_px']} px > golden "
                              f"{rep['golden_median_px']} + 0.1")
    assert rep["ok"] and report["ok"] and rc == 0


def test_the_smoke_s_parity_processes_fail_without_a_report(tmp_path):
    """chip_smoke.py's phase 9 runs each sequence in a process of its own:
    one that exits with no report fails the phase with its log's end (here
    an unknown sequence)."""
    procs = chip_smoke._start_parity(["no_such_sequence"], tmp_path)
    try:
        with pytest.raises(AssertionError, match="no_such_sequence: the replay exited 1 with no "
                                                 "report(.|\\n)*KeyError"):
            chip_smoke._parity_reports(procs, tmp_path, time.time() + 120)
    finally:
        chip_smoke._stop(procs)


def test_the_smoke_s_parity_processes_are_ended_at_their_time_limit(tmp_path, monkeypatch):
    """A parity process that runs past the phase's limit fails it, and the
    smoke ends every process it started (as its main does, in a finally)."""
    started = []
    popen = chip_smoke.subprocess.Popen

    def record(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", record)
    t0 = time.time()
    procs = chip_smoke._start_parity(["forward_yaw", "long_forward"], tmp_path)
    with pytest.raises(AssertionError, match="forward_yaw: the process ran past its time limit"):
        try:
            chip_smoke._parity_reports(procs, tmp_path, time.time() + 0.5)
        finally:
            chip_smoke._stop(procs)
    assert time.time() - t0 < 30
    assert len(started) == 2 and all(p.poll() is not None for p in started)
