"""Phase 14's fresh processes on the CPU: ``profile_trace.write_job`` writes
the job (the state, the frames, the config and what to run) that
``python -m slam_robot_tpu_torch.tools.profile_trace --job DIR --part P``
reads and runs, the trace in a first process and the config-5 tools in a
second; ``run_job`` runs them one after the other and raises when a process
exits other than 0 or the job runs out of time. A tiny job: the bench state at tests/test_pipeline.CFG
with every BA cap at 2, 2 frames, profile_cg's CI problem in one layout and
profile_cg_sharded over 1 and 2 shards; and one that also takes every busy
share that phases 8 and 11 of ``chip_smoke.py`` report (bench_suite's
lines at its --small size, the fleet), config 5's from profile_cg's padded
solve.
"""

import dataclasses
import json
import os
import time

import pytest
import torch

import chip_smoke
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
BUSY = {"small": True, "steps": 2, "fleet_goals": 4}
# bench_suite.busy_works' lines, then config 5's (profile_cg's padded solve)
BUSY_LINES = ["1", "2", "4", "5_sharded", "5_multi_robot", "fleet", "5"]


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


@pytest.fixture(scope="module")
def busy_job(tmp_path_factory, job):
    """The job of :func:`job` taking the busy shares too, profile_cg in the
    padded layout alone and no sharded tool."""
    _, ps, imgs = job
    job_dir = str(tmp_path_factory.mktemp("busy_job"))
    cg = dict(CG, layouts=["padded"], shards=[])
    profile_trace.write_job(job_dir, ps, imgs, TCFG, top=7, cg=cg, busy=BUSY)
    return job_dir


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
    # the config-5 tools ran in a second fresh process, after the first
    assert list(res["processes"]) == ["trace", "cg"]
    assert all(v > 0 for v in res["processes"].values())


def test_the_config_5_tools_run_in_a_second_fresh_process(job):
    """Every capture's record: the trace's in the first process, the
    config-5 tools' in the second, whose first session is profile_cg's;
    each with its session's index
    in its process, the launches before it, whether trace_detail's reader
    ran, and its audit's lost_at."""
    job_dir, _, _ = job
    res = profile_trace.run_job(job_dir, CPU, timeout=600)
    caps = res["captures"]
    assert [c["tool"] for c in caps if c["process"] == 1] == ["profile_trace"]
    second = [c for c in caps if c["process"] == 2]
    assert [c["tool"] for c in second] == ["profile_cg scatter"]
    for n in (1, 2):
        mine = [c for c in caps if c["process"] == n]
        assert [c["session"] for c in mine] == list(range(len(mine)))
    assert second[0]["session"] == 0 and second[0]["launches_before"] == 0
    for c in caps:
        assert c["lost_at"] == [] and c["launches"] == 0  # the CPU's captures launch nothing
        assert c["reader_running"] is False and c["s"] >= 0


def test_the_capture_log_counts_the_launches_before_each_capture():
    """CaptureLog: a session's record holds the launches of the captures
    and unprofiled runs before it, runs of its own work made just before it
    (before_next) counted once its audit tells their size."""
    log = profile_trace.CaptureLog()
    log.tool = "a"
    log.open()
    log.close({"kernel_launches": 3, "lost_at": []})
    log.ran(3)                      # a's unprofiled pass
    log.tool = "b"
    log.before_next(2)              # two runs of b's work, then b's capture
    log.open()
    log.close({"kernel_launches": 5, "lost_at": [0, 1], "lost_markers": 3})
    log.close({"kernel_launches": 9, "lost_at": []})   # no session open: nothing
    a, b = log.records
    assert (a["tool"], a["session"], a["launches_before"], a["launches"]) == ("a", 0, 0, 3)
    assert (b["tool"], b["session"], b["launches_before"], b["launches"]) == ("b", 1, 16, 5)
    assert b["lost_at"] == [0, 1] and b["lost_markers"] == 3 and log.launched == 21
    assert a["reader_running"] is False


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


def test_the_job_takes_every_busy_share_of_phases_8_and_11(busy_job):
    res = profile_trace.run_job(busy_job, CPU, timeout=600)
    assert list(res["tools"]) == ["profile_trace", "profile_cg padded"]
    busy = res["busy"]
    assert list(busy) == BUSY_LINES and res["busy_s"] > 0
    for line, f in busy.items():
        assert f["wall_ms"] > 0 and f["device_busy_ms"] > 0 and f["device_ops"] > 0, line
        assert f["busy_share"] == pytest.approx(f["device_busy_ms"] / f["wall_ms"]), line
        assert f["audit"]["lost_launches"] == 0, line   # the CPU's capture has no launches
        assert f["retakes"] == 0, line
    # config 5's share is profile_cg's padded solve, not a solve of its own
    cg = res["tools"]["profile_cg padded"]["figures"]
    assert busy["5"]["busy_share"] == cg["busy_share"] and busy["5"]["from"] == "profile_cg padded"
    assert busy["5"]["device_busy_ms"] == pytest.approx(cg["device_ms"] * cg["units"])
    # phase 11 prints one figure a suite line, by the job's names; phase 8
    # the fleet's per step
    got = chip_smoke._busy_lines(busy, "cpu")
    assert list(got["suite"]) == [x for x in BUSY_LINES if x != "fleet"]
    assert got["suite"]["5_sharded"] == busy["5_sharded"]
    assert got["fleet"]["device_busy_share"] == busy["fleet"]["busy_share"]


def test_the_audit_covers_the_run_after_its_start_marker():
    """traced() launches a marker just before the run; run_events keeps the
    run's events alone (the warm-up step's are left out)."""
    x = torch.ones(64)
    prof = profile_trace.traced(lambda: x.mul(3.0), CPU, [torch.profiler.ProfilerActivity.CPU])
    names = [e.name() for e in profile_trace.run_events(prof, CPU)]
    assert "aten::mul" in names and "aten::add_" not in names


def test_a_capture_that_lost_every_lead_marker_is_taken_again(monkeypatch):
    """A capture that kept none of traced()'s lead markers cannot tell its
    run apart: its audit names the fault, the smoke's gate fails on it, and
    profile() takes the capture again."""
    x = torch.ones(64)
    prof = profile_trace.traced(lambda: x.mul(3.0), CPU, [torch.profiler.ProfilerActivity.CPU])
    assert len(profile_trace.marks(profile_trace.capture_events(prof), CPU)) == \
        profile_trace.LEAD_MARKS + 1  # and the tail marker after the run
    real = profile_trace.marks
    monkeypatch.setattr(profile_trace, "marks", lambda events, dev: [])
    assert profile_trace.run_events(prof, CPU) is None
    a = profile_trace.run_audit(prof, CPU)
    assert a["lost_markers"] == profile_trace.LEAD_MARKS
    with pytest.raises(AssertionError, match="markers must tell the run apart"):
        chip_smoke._gate_capture("a capture without its markers", a)
    calls = []

    def first_lost(events, dev):
        calls.append(1)
        return [] if len(calls) == 1 else real(events, dev)

    monkeypatch.setattr(profile_trace, "marks", first_lost)
    p = profile_trace.profile(lambda: x.mul(3.0), CPU, 1)
    assert p["retakes"] == 1 and profile_trace.audit_fault(p["audit"]) is None


def test_a_busy_session_that_lost_its_first_lead_marker_splits_as_before(monkeypatch):
    """The works of a busy session start after the last lead marker kept:
    a session whose first marker is lost splits as a whole one does, and
    none of its lines is taken again."""
    x = torch.ones(64)
    real = profile_trace.marks
    monkeypatch.setattr(profile_trace, "marks", lambda events, dev: real(events, dev)[1:])
    works = {"many": lambda: [x.add(1.0) for _ in range(50)], "few": lambda: x.mul(2.0)}
    got = profile_trace.busy_share_session(works, CPU)
    assert got["many"]["device_ops"] >= 50 > got["few"]["device_ops"] >= 1
    for f in got.values():
        assert f["retakes"] == 0 and profile_trace.audit_fault(f["audit"]) is None


def test_a_busy_session_short_of_markers_takes_each_line_again(monkeypatch):
    """A busy session left with fewer markers than its works' bounds
    cannot split them: every line's audit names the fault and each is
    taken again alone."""
    x = torch.ones(64)
    real = profile_trace.marks
    calls = []

    def first_short(events, dev):
        calls.append(1)
        return real(events, dev)[-2:] if len(calls) == 1 else real(events, dev)

    monkeypatch.setattr(profile_trace, "marks", first_short)
    works = {"add": lambda: x.add(1.0), "mul": lambda: x.mul(2.0)}
    got = profile_trace.busy_share_session(works, CPU)
    assert len(calls) == 3
    for f in got.values():
        assert f["retakes"] == 1 and profile_trace.audit_fault(f["audit"]) is None
        assert f["device_ops"] >= 1


def test_one_busy_session_splits_its_capture_by_work():
    """The busy shares come from one traced session; each work's events
    are those between its markers (by correlation id)."""
    x = torch.ones(64)
    works = {"many": lambda: [x.add(1.0) for _ in range(50)], "few": lambda: x.mul(2.0)}
    got = profile_trace.busy_share_session(works, CPU)
    assert list(got) == ["many", "few"]
    assert got["many"]["device_ops"] >= 50 > got["few"]["device_ops"] >= 1
    for f in got.values():
        assert f["wall_ms"] > 0 and f["audit"]["lost_launches"] == 0


def test_a_capture_that_lost_a_kernel_is_taken_again():
    """retaken() takes a capture again while its audit finds a lost kernel,
    CAPTURE_TRIES times in all at most; the gate fails on a loss left."""
    lost = {"kernel_launches": 3, "kernels": 2, "lost_launches": 1, "unlaunched_kernels": 0,
            "lost_at": [1]}
    whole = dict(lost, kernels=3, lost_launches=0, lost_at=[])
    audits = iter([lost, whole, lost])
    got, retakes = profile_trace.retaken(lambda: next(audits), profile_trace.audit_fault)
    assert got == whole and retakes == 1
    calls = []
    got, retakes = profile_trace.retaken(lambda: calls.append(1) or lost,
                                         profile_trace.audit_fault)
    assert got == lost and len(calls) == profile_trace.CAPTURE_TRIES
    assert retakes == profile_trace.CAPTURE_TRIES - 1
    with pytest.raises(AssertionError, match="1 of 3 kernel launches lost their kernel"):
        chip_smoke._gate_capture("a capture lost every time", got)


def test_a_busy_line_whose_capture_lost_a_kernel_is_taken_again_alone(monkeypatch):
    lost = {"kernel_launches": 3, "kernels": 2, "lost_launches": 1, "unlaunched_kernels": 0,
            "lost_at": [1]}
    whole = dict(lost, kernels=3, lost_launches=0, lost_at=[])
    sessions = []

    def session(works, dev):
        sessions.append(list(works))
        first = len(sessions) == 1
        return {k: {"audit": lost if first and k == "b" else whole, "retakes": 0,
                    "session": len(sessions)} for k in works}

    monkeypatch.setattr(profile_trace, "_busy_session", session)
    got = profile_trace.busy_share_session({"a": None, "b": None, "c": None}, CPU)
    assert sessions == [["a", "b", "c"], ["b"]]
    assert [got[k]["session"] for k in "abc"] == [1, 2, 1]
    assert [got[k]["retakes"] for k in "abc"] == [0, 1, 0]


def test_busy_works_names_every_line_of_phases_8_and_11():
    from slam_robot_tpu_torch.tools import bench_suite, profile_cg

    works = bench_suite.busy_works(CPU, True, 2, 4, profile_cg.problem(True, CPU))
    assert list(works) == [x for x in BUSY_LINES if x != "5"]
    assert all(callable(w) for w in works.values())
