"""Phase 14's fresh process on the CPU: ``profile_trace.write_job`` writes
the job (the state, the frames, the config and what to run) that
``python -m slam_robot_tpu_torch.tools.profile_trace --job DIR`` reads and
runs; ``run_job`` runs it and raises when the process exits other than 0
or runs out of time. A tiny job: the bench state at tests/test_pipeline.CFG
with every BA cap at 2, 2 frames, profile_cg's CI problem in one layout and
profile_cg_sharded over 1 and 2 shards.
"""

import dataclasses
import json
import os
import time

import pytest
import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.tools import profile_trace
from slam_robot_tpu_torch.utils.benchscene import make_frames
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = dataclasses.replace(port_cfg(CFG), ba_iters_fast=2, ba_iters_slow=2, ba_iters_xslow=2,
                           ba_iters_polish=2, ba_max_iters=2)
CG = {"layouts": ["scatter"], "gn_iters": 1, "cg_iters": 3, "top": 5, "small": True,
      "shards": [1, 2]}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A job directory: the state after one frame, the next 2 frames."""
    frames = make_frames(TCFG, 3, device=CPU)
    ps = pipeline.init(TCFG, device=CPU)
    ps, _ = bench.run_scan(ps, frames[0][None], TCFG)
    job_dir = str(tmp_path_factory.mktemp("job"))
    imgs = torch.stack(frames[1:])
    profile_trace.write_job(job_dir, ps, imgs, TCFG, top=7, cg=CG)
    return job_dir, ps, imgs


def _leaves(ps):
    return [t for t in torch.utils._pytree.tree_leaves(ps) if isinstance(t, torch.Tensor)]


def test_the_child_reads_what_the_job_wrote(job):
    job_dir, ps, imgs = job
    got, got_imgs, cfg, opts = profile_trace.read_job(job_dir, CPU)
    assert cfg == TCFG and opts == {"top": 7, "cg": CG}
    assert torch.equal(got_imgs, imgs)
    want = _leaves(ps)
    assert len(_leaves(got)) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got), want))


def test_the_job_runs_in_a_fresh_process(job):
    job_dir, _, _ = job
    res = profile_trace.run_job(job_dir, CPU, timeout=600)
    with open(os.path.join(job_dir, profile_trace.RESULT_FILE)) as f:
        assert json.load(f) == res
    assert list(res["tools"]) == ["profile_trace", "profile_cg scatter", "profile_cg_sharded"]
    trace = res["tools"]["profile_trace"]
    assert trace["figures"]["units"] == 2 and trace["figures"]["trace_units"] == 2
    assert trace["figures"]["trace"] == os.path.join(job_dir, "trace.json")
    assert any(line.startswith("scan: ") for line in trace["lines"]) and trace["s"] > 0
    cg = res["tools"]["profile_cg scatter"]["figures"]
    assert cg["units"] == CG["gn_iters"] and cg["gn_iters_per_s"] > 0
    sharded = res["tools"]["profile_cg_sharded"]["figures"]
    assert [r["devices"] for r in sharded["validation"]] == CG["shards"]
    # trace_detail read the export, and its rows stand against the counters
    assert res["detail"]["rows"] and set(res["detail"]["shortfall"]) == {"newton_track",
                                                                         "pyramid_flat"}
    assert set(res["launches"]) == set(bench.counts())


def test_a_job_whose_process_fails_raises(tmp_path, job):
    job_dir, _, _ = job
    for name in (profile_trace.JOB_FILE,):
        with open(os.path.join(job_dir, name)) as f:
            (tmp_path / name).write_text(f.read())
    # no state file: the process exits 1
    with pytest.raises(RuntimeError, match="exited 1"):
        profile_trace.run_job(str(tmp_path), CPU, timeout=600)


def test_a_job_past_its_time_raises_and_is_killed(job):
    job_dir, _, _ = job
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ran past 0.5 s"):
        profile_trace.run_job(job_dir, CPU, timeout=0.5)
    assert time.perf_counter() - t0 < 30
    assert not os.path.exists(os.path.join(job_dir, profile_trace.RESULT_FILE))
