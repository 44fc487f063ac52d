"""Phase 14's gate on a profile's device time (``chip_smoke._gate_profile``
over ``profile_trace.device_time``), on hand-made captures: the device's
time is not over-counted, which it checks on the profiled pass's own events,
on the clock of their own time stamps, with no allowance. (a) On each
stream the summed time of its operations is at most the stream's span; (b)
the run's operations lie inside the window between its markers
(``profile_trace.traced``: the last lead marker's end, the tail marker's
start). The busy share against an unprofiled pass's wall, which host noise
moves to either side of 100 % at config 5, is printed and not gated; so is
the run's wall on the host's clock, which the device's clock parts from.
"""

from __future__ import annotations

import time

import pytest
import torch

import chip_smoke
from slam_robot_tpu_torch.tools import profile_trace

CPU = torch.device("cpu")
MS = 1_000_000  # ns


class _Op:
    """A device operation as Kineto gives it (``profile_trace.capture_events``)."""

    def __init__(self, start_ns, duration_ns, stream=7):
        self._start, self._dur, self._stream = start_ns, duration_ns, stream

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_resource_id(self):
        return self._stream


def _back_to_back(n, dur, start=0, gap=0, stream=7):
    """``n`` operations of ``dur`` ns on one stream, ``gap`` ns apart."""
    return [_Op(start + i * (dur + gap), dur, stream) for i in range(n)]


def _window(ops, lead=10_000, tail=10_000):
    """The markers' window around ``ops``: ``lead`` ns before the first
    operation's start, ``tail`` ns after the last one's end."""
    return (min(o.start_ns() for o in ops) - lead,
            max(o.start_ns() + o.duration_ns() for o in ops) + tail)


def _figures(ops, window, unprofiled_wall_ms, run_ns=None, units=5):
    """A profile's figures (``profile_trace.profile``'s keys that the gate
    reads) around ``ops`` and the markers' ``window``: a complete capture,
    B1/B2 launches equal to the counters, the host's wall ``run_ns``
    (default: the window's)."""
    busy_ms = sum(o.duration_ns() for o in ops) / 1e6
    launches = {"newton_track": 0, "pyramid_flat": 0}
    run_ns = window[1] - window[0] if run_ns is None and window else run_ns
    return {"units": units, "wall_ms": unprofiled_wall_ms / units, "device_ms": busy_ms / units,
            "busy_share": busy_ms / unprofiled_wall_ms, "device_ops": len(ops),
            "device_time": profile_trace.device_time(ops, window, run_ns),
            "audit": {"kernel_launches": len(ops), "kernels": len(ops), "lost_launches": 0,
                      "unlaunched_kernels": 0, "lost_at": []},
            "traced_launches": dict(launches), "counted_launches": dict(launches), "counts": {}}


def _old_gate_passes(p):
    """The gate phase 14 applied before: the busy share against the
    unprofiled wall at most 100 % plus the stamps' allowance."""
    stamps_ms = chip_smoke.CUPTI_NS_PER_OP * 1e-6 * p["device_ops"] / p["units"]
    return p["device_ms"] <= p["wall_ms"] + stamps_ms


def test_device_time_sums_and_spans_each_stream_and_the_run():
    ops = _back_to_back(3, 10, start=100, gap=5) + [_Op(90, 4, stream=9), _Op(200, 30, stream=9)]
    t = profile_trace.device_time(ops, (80, 240), 500)
    assert t["streams"] == {
        "7": {"ops": 3, "busy_ns": 30, "span_ns": 40, "busy_ms": 30e-6, "span_ms": 40e-6},
        "9": {"ops": 2, "busy_ns": 34, "span_ns": 140, "busy_ms": 34e-6, "span_ms": 140e-6}}
    assert (t["first_ns"], t["last_ns"], t["span_ns"]) == (90, 230, 140)
    assert (t["window"], t["window_ns"], t["run_ns"]) == ([80, 240], 160, 500)
    empty = profile_trace.device_time([], None, 7)
    assert empty["span_ns"] == 0 and empty["window"] is None


@pytest.mark.parametrize("unprofiled_ms", [705.0, 709.5, 710.0, 716.0])
def test_a_saturated_profile_passes_wherever_its_unprofiled_wall_lands(unprofiled_ms, capsys):
    """Config 5 keeps the device saturated: 2864 operations nearly back to
    back fill 710.4 ms between the run's markers. The unprofiled wall moves
    between runs, so the busy share lands over and under 100 % (100.75 to
    99.20 % here; the old gate failed the two fastest walls); the device's
    own time is sound in each."""
    ops = _back_to_back(2864, 248_000, start=40_000, gap=50)
    p = _figures(ops, _window(ops), unprofiled_wall_ms=unprofiled_ms)
    assert p["device_time"]["span_ns"] == 710_415_150
    chip_smoke._gate_profile("profile_cg scatter", p)
    out = capsys.readouterr().out
    assert "phase 14 profile_cg scatter device time:" in out and "busy share" in out
    assert (p["busy_share"] > 1.0) == (unprofiled_ms < 716.0)
    assert _old_gate_passes(p) == (unprofiled_ms >= 710.0)


def test_a_run_whose_host_wall_is_shorter_than_its_device_span_passes():
    """The device's time stamps and the host's clock part within a run:
    config 5's padded solve spanned 1209.341 ms on the device against the
    same run's 1198.862 ms on the host (an H100 run), which no run can hold.
    The run's operations inside its markers on the device's own clock pass;
    the host's wall is printed beside them."""
    ops = _back_to_back(20202, 59_760, start=40_000, gap=100)
    p = _figures(ops, _window(ops), unprofiled_wall_ms=1210.0, run_ns=1_198_862_456)
    assert p["device_time"]["span_ns"] > p["device_time"]["run_ns"]
    chip_smoke._gate_profile("profile_cg padded", p)


def test_two_streams_that_overlap_each_other_pass():
    """Work on two streams may run at once: the device's summed time then
    passes the run's span, and nothing is counted twice."""
    ops = _back_to_back(50, 2 * MS, stream=7) + _back_to_back(50, 2 * MS, start=MS, stream=13)
    p = _figures(ops, _window(ops), unprofiled_wall_ms=102.0)
    assert p["busy_share"] > 1.9
    chip_smoke._gate_profile("profile_trace", p)


def test_two_operations_of_one_stream_that_overlap_fail():
    """A saturated stream with one operation's time counted twice (a second
    record inside the first one's span): the old gate passed it, since its
    unprofiled wall is long enough; the stream's own span does not."""
    ops = _back_to_back(10, MS) + [_Op(MS // 2, MS)]
    p = _figures(ops, _window(ops), unprofiled_wall_ms=12.0)
    assert _old_gate_passes(p)
    with pytest.raises(AssertionError, match="stream 7's operations sum to 11000000 ns over its "
                                             "span of 10000000 ns"):
        chip_smoke._gate_profile("profile_cg padded", p)


@pytest.mark.parametrize("lead,tail", [(-MS, 0), (0, -MS), (-MS, -MS)])
def test_a_device_span_longer_than_the_profiled_runs_wall_fails(lead, tail):
    """The run's wall between its markers on the device's clock: 100 ms of
    operations that start before the lead marker's end, end after the tail
    marker's start, or both (99-98 ms between the markers), are not all the
    run's; the old gate passed them."""
    ops = _back_to_back(100, MS)
    p = _figures(ops, _window(ops, lead, tail), unprofiled_wall_ms=120.0)
    assert p["device_time"]["span_ns"] > p["device_time"]["window_ns"]
    assert _old_gate_passes(p)
    with pytest.raises(AssertionError, match="not inside its markers' window"):
        chip_smoke._gate_profile("profile_trace", p)


def test_a_run_without_its_markers_window_fails():
    ops = _back_to_back(4, MS)
    p = _figures(ops, None, unprofiled_wall_ms=5.0, run_ns=5 * MS)
    with pytest.raises(AssertionError, match="markers' window None"):
        chip_smoke._gate_profile("profile_trace", p)


def test_the_gate_keeps_its_capture_and_launch_checks():
    ops = _back_to_back(4, MS)
    p = _figures(ops, _window(ops), unprofiled_wall_ms=5.0)
    p["audit"] = dict(p["audit"], lost_launches=1, lost_at=[2])
    with pytest.raises(AssertionError, match="lost their kernel"):
        chip_smoke._gate_profile("profile_trace", p)
    p = _figures(ops, _window(ops), unprofiled_wall_ms=5.0)
    p["traced_launches"]["pyramid_flat"] = 1
    with pytest.raises(AssertionError, match="launches in the trace"):
        chip_smoke._gate_profile("profile_trace", p)


def test_traced_takes_the_runs_wall_between_the_markers_and_its_end():
    """The run's host wall: not the lead and tail sleeps around it, not the
    profiler's start and stop; its events lie between the last lead marker
    and the tail marker, which are left out."""
    def run():
        time.sleep(0.05)
        x.mul(3.0)

    x = torch.ones(64)
    t0 = time.perf_counter_ns()
    prof = profile_trace.traced(run, CPU, [torch.profiler.ProfilerActivity.CPU])
    whole = time.perf_counter_ns() - t0
    assert 50 * MS <= prof.run_ns < 50 * MS + profile_trace.TAIL_S * 1e9
    assert whole - prof.run_ns >= (profile_trace.LEAD_S + profile_trace.TAIL_S) * 1e9
    events = profile_trace.capture_events(prof)
    lead, tail = profile_trace.run_bounds(events, CPU)
    found = profile_trace.marks(events, CPU)
    assert [lead.correlation_id(), tail.correlation_id()] == found[-2:]
    assert len(found) == profile_trace.LEAD_MARKS + 1
    names = [e.name() for e in profile_trace.run_events(prof, CPU)]
    assert "aten::mul" in names and profile_trace.MARK not in names


def test_a_card_capture_that_lost_its_tail_marker_has_no_bounds():
    """On the card the tail marker is the capture's last kernel launch: a
    capture whose last launch has no marker kernel lost it, and its run has
    no bounds (its audit then names lost markers)."""
    class Ev:
        def __init__(self, name, corr):
            self._name, self._corr = name, corr

        def name(self):
            return self._name

        def correlation_id(self):
            return self._corr

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [Ev("cudaLaunchKernel", c) for c in (2, 3, 4, 5, 6)]
    events += [Ev(spin, 2), Ev(spin, 3), Ev(spin, 4), Ev("track_kernel", 5)]
    cuda = torch.device("cuda")
    assert profile_trace.run_bounds(events, cuda) is None
    lead, tail = profile_trace.run_bounds(events + [Ev(spin, 6)], cuda)
    assert (lead.correlation_id(), tail.correlation_id()) == (4, 6)


def test_profile_puts_the_profiled_runs_device_time_in_its_figures():
    x = torch.ones(256)
    p = profile_trace.profile(lambda: [x.mul(3.0) for _ in range(4)], CPU, 2)
    t = p["device_time"]
    assert sum(s["ops"] for s in t["streams"].values()) >= 4
    assert t["window"][0] <= t["first_ns"] <= t["last_ns"] <= t["window"][1]
    assert 0 < t["span_ns"] <= t["window_ns"]
    assert p["profiled_wall_ms"] == pytest.approx(t["run_ms"] / 2)
